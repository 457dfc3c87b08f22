"""c2ray_tpu: a JAX/XLA reionization radiative-transfer framework with
the capabilities of C2-Ray3Dm (garrelt/C2-Ray3Dm).

Built from scratch for accelerators: the serial short-characteristics ray
trace becomes a causal wavefront sweep of Chebyshev shells, MPI source
distribution becomes shard_map source sharding with psum rate reduction,
and all per-cell physics (photon-conserving rate lookups, analytic doric
ionization updates, subcycled thermal evolution) runs as vectorized XLA
programs over HBM-resident grids.
"""

from .config import (CosmologyParams, RunConfig, SEDConfig,
                     test_problem_config)
from .state import (GridState, MaterialState, initial_state,
                    mean_baryon_density, proper_fields, uniform_material)
from .solver import Evolve3D, EvolveInfo

__version__ = "0.1.0"
