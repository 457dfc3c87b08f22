"""Runtime configuration for the JAX C2-Ray framework.

One dataclass surface replaces the reference's entire compile-time +
link-time + stdin configuration: c2ray_parameters.f90 (solver knobs),
sed_parameters.f90 (SED), sizes.f90 (mesh size), cosmoparms*.f90
(cosmological parameter set, link-time swap), the nbody_* adapter
constants (box size, redshift list), and the stdin protocol
(C2Ray.F90:115-127, time_module.F90:44-54).

All reference compile-time constants become runtime config fields here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from . import constants as const


# ---------------------------------------------------------------------------
# cosmological parameter sets (cosmoparms.f90 and variants, link-time swap in
# the reference -> runtime selection here)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CosmologyParams:
    """Cosmological parameters. Reference: cosmoparms.f90:26-42."""

    cosmo_id: str = "WMAP3+"
    h: float = 0.7
    omega0: float = 0.27
    omega_b: float = 0.044
    cmbtemp: float = 2.726
    sigma8: float = 0.8
    n_s: float = 0.96

    @property
    def omega_l(self) -> float:
        return 1.0 - self.omega0

    @property
    def H0(self) -> float:
        """Hubble constant in cgs (1/s). cosmoparms.f90:41."""
        return self.h * 100.0 * 1e5 / const.MPC

    @property
    def rho_crit_0(self) -> float:
        """Critical density (cgs). cosmoparms.f90:42."""
        return 3.0 * self.H0 * self.H0 / (8.0 * np.pi * const.G_GRAV)


WMAP3PLUS = CosmologyParams()
WMAP1 = CosmologyParams(cosmo_id="WMAP1", h=0.73, omega0=0.27, omega_b=0.044,
                        sigma8=0.9, n_s=1.0)
WMAP3 = CosmologyParams(cosmo_id="WMAP3", h=0.73, omega0=0.238, omega_b=0.0418,
                        sigma8=0.74, n_s=0.95)
WMAP5 = CosmologyParams(cosmo_id="WMAP5", h=0.70, omega0=0.279, omega_b=0.0462,
                        sigma8=0.817, n_s=0.96)
EORKP = CosmologyParams(cosmo_id="EoRKP", h=0.678, omega0=0.308, omega_b=0.0482,
                        sigma8=0.829, n_s=0.961)

COSMOLOGY_SETS = {
    "WMAP3+": WMAP3PLUS, "WMAP1": WMAP1, "WMAP3": WMAP3,
    "WMAP5": WMAP5, "EoRKP": EORKP,
}


# ---------------------------------------------------------------------------
# SED configuration (sed_parameters.f90:23-56)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SEDConfig:
    """Source spectral energy distribution parameters.

    Reference: sed_parameters.f90. stellar_type 'B' = black body,
    'P' = power law (radiation_sed_parameters.F90:96-141).
    """

    stellar_type: str = "B"
    bb_teff: float = 5.0e4                 # sed_parameters.f90:31
    s_star: float = 1e48                   # reference photon rate, :33
    bb_min_freq: float = const.ION_FREQ_HI
    bb_max_freq: float = const.ION_FREQ_HEII * 10.0  # :36
    pl_index: float = 3.0                  # :40
    pl_s_star: float = 1e48
    pl_min_freq: float = const.ION_FREQ_HI
    pl_max_freq: float = const.ION_FREQ_HEII         # :45
    use_xray_sed: bool = False             # :56
    xray_type: str = "P"                   # X-ray sources use the PL tables

    @property
    def min_freq(self) -> float:
        return self.bb_min_freq if self.stellar_type == "B" else self.pl_min_freq

    @property
    def max_freq(self) -> float:
        return self.bb_max_freq if self.stellar_type == "B" else self.pl_max_freq


# ---------------------------------------------------------------------------
# main run configuration
# ---------------------------------------------------------------------------
# wavefront march backends (ops/sweep.py)
SWEEP_BACKENDS = ("facemajor", "grid")


@dataclass(frozen=True)
class RunConfig:
    """Union of the reference's compile-time + runtime configuration.

    Field-by-field citations into /root/reference/c2ray_parameters.f90
    unless noted otherwise.
    """

    # --- grid (sizes.f90:33, nbody_*.F90 boxsize) ---
    mesh: Tuple[int, int, int] = (64, 64, 64)
    boxsize_mpc_h: float = 100.0     # comoving box size in Mpc/h (nbody_test.F90:44)

    # --- numerics ---
    dtype: str = "float32"           # on-device working dtype ("float32"/"float64")
    convergence_fraction: float = 1.0e-4   # :25
    isothermal: bool = True                # :28
    epsilon: float = 1e-14                 # :31
    minimum_fractional_change: float = 1.0e-3  # :34
    minimum_fraction_of_atoms: float = 1.0e-8  # :40
    grey: bool = False                     # :43
    max_coldensh: float = 2e19             # evolve_point.F90:95
    max_global_iterations: int = 100       # evolve.F90:228
    max_chemistry_iterations: int = 400    # evolve_point.F90:541
    # run the whole convergence iteration as ONE device program
    # (lax.while_loop) in the non-adaptive regime: exactly one host
    # dispatch+fetch per TIMESTEP instead of one per iteration;
    # per-iteration audit scalars come back in a history buffer and the
    # conservation reports are replayed host-side, so the logs are
    # unchanged.  Auto-disabled for adaptive/windowed sweeps (host
    # re-bucketing) and for meshes > 512 (carry memory).
    on_device_loop: bool = True
    # request REAL per-iteration wall-clock in Timings.log: the device
    # loop's stamps are replayed at loop exit (format parity only), so
    # with this flag and a Clocks sink the host-driven loop runs instead
    # (the reference stamps elapsed time every iteration,
    # evolve.F90:272-273)
    timings_fidelity: bool = False
    # print per-iteration convergence statistics from the driver
    # (Test 1 conv_flag vs criterion, Test 2 relative changes — the
    # reference writes these to its log every iteration,
    # evolve.F90:206-209).  Forces the host-driven loop.
    log_convergence: bool = False
    # non-isothermal subcycle scheduling (ops/thermal.py):
    # thermal_compact finishes straggler cells in a compacted vector so
    # the dense O(N^3) while_loop trip count follows the typical cell,
    # not the coldest (bitwise-identical results);
    # thermal_chunk > 0 evaluates the subcycle loop in axis-0 slabs of
    # that many rows (bounds the loop's live-buffer sizes); 0 = whole
    # grid
    thermal_compact: bool = True
    thermal_chunk: int = 0

    # --- subbox / sweep work limiting (:54-67) ---
    subboxsize: int = 5
    max_subbox: int = 1000
    add_photon_losses: bool = False
    loss_fraction: float = 1e-2

    # --- clumping (:69-77) ---
    type_of_clumping: int = 1
    clumping_factor: float = 1.0

    # --- LLS (:79-99) ---
    use_lls: bool = True
    type_of_lls: int = 1
    lls_model: int = 5
    r_max_cmpc: float = 10.0

    # --- run behaviour (:101-112) ---
    stop_on_photon_violation: bool = False
    cosmological: bool = True
    minitemp: float = 1.0
    relative_denergy: float = 0.1
    initial_temperature: float = 1e4

    # --- source properties (:114-135) ---
    phot_per_atom: Tuple[float, float] = (10.0, 150.0)
    zeta: Tuple[float, float] = (50.0, 0.0)
    xray_phot_per_atom: float = 0.02
    lifetime: float = 10e6 * const.YEAR
    min_particle_content: float = 20.0
    still_neutral: float = 0.1

    # --- radiation table sizes (radiation_sizes.f90:13-17,21,85) ---
    num_freq: int = 128
    num_tau: int = 2000
    boundary_tau_hi: float = 0.0
    pl_index_cross_section_hi: float = 2.8
    # table tau range (radiation_tables.F90:45-47)
    minlogtau: float = -20.0
    maxlogtau: float = 4.0
    # optically-thin switch thresholds (radiation_photoionrates.F90:244,333)
    tau_photo_limit: float = 1.0e-7
    tau_heat_limit: float = 1.0e-4

    # --- SED + cosmology sub-configs ---
    sed: SEDConfig = field(default_factory=SEDConfig)
    cosmo: CosmologyParams = field(default_factory=lambda: WMAP3PLUS)

    # --- initial conditions (ionfractions_module.F90:41-50 RECFAST value) ---
    initial_xh: float = 2e-4
    # compressed ionization-fraction storage (the reference's compressed/
    # variant): store min(x_HI, x_HII) with the sign marking which, so
    # BOTH tails survive float32 (state.py compress_xh).  GridState.xh1
    # and the solver iterates then hold the signed compressed form.
    compressed_xfrac: bool = False

    # --- rate evaluation (no reference equivalent) ---
    # "table": linear interpolation in the tau tables (reference-exact);
    # "expsum": K-term exponential-mixture evaluation (gather-free, exact
    # photon-conserving differences via expm1); "auto": expsum for float32
    # (the production dtype), table for float64 (parity runs).
    rate_eval: str = "auto"
    num_exp_terms: int = 16

    # --- sweep engine knobs (no reference equivalent) ---
    # wavefront backend: "facemajor" carries the previous shell's planes
    # in-register with wedge fixups (minimal sequential op count);
    # "grid" keeps coldensh_out in grid layout (more ops, simpler).
    sweep_backend: str = "facemajor"
    # static cap on the sweep radius in shells (None = full grid, mesh/2);
    # the analogue of the reference's dynamic subboxes.
    max_shell: Optional[int] = None
    # how many Chebyshev shells are grouped per lax.scan bucket; 0 = fully
    # unrolled. Buckets trade padding overhead for small compiled graphs.
    shell_bucket_size: int = 0
    # adaptive per-source sweep radii (the reference's subbox work limiting,
    # evolve_source.F90:128-136): sources start at a flux-estimated radius
    # from a power-of-two ladder and are promoted between convergence
    # iterations while their escaping-photon fraction exceeds loss_fraction.
    # None = auto: on when a step has >= adaptive_auto_min_sources sources
    # (the production many-source regime), off for few-source runs.
    adaptive_sweep: Optional[bool] = None
    adaptive_min_shell: int = 8
    adaptive_auto_min_sources: int = 32
    # windowed sweeps: sources swept to radius r are staged, marched and
    # rate-evaluated entirely inside their (2r+1)^3 window, making the
    # per-source cost O(r^3) instead of O(N^3) (the equivalent of the
    # reference's subboxes being *work-limiting*, not just compute-limiting).
    window_sweep: bool = True
    # number of sources swept per vmapped batch inside one scan step.
    source_batch: int = 1

    def __post_init__(self):
        m = self.mesh
        if isinstance(m, int):
            object.__setattr__(self, "mesh", (m, m, m))
        if self.sweep_backend not in SWEEP_BACKENDS:
            raise ValueError(f"sweep_backend={self.sweep_backend!r}; "
                             f"expected one of {SWEEP_BACKENDS}")

    # ------------------------------------------------------------------
    @property
    def jnp_dtype(self):
        import jax.numpy as jnp

        return {"float32": jnp.float32, "float64": jnp.float64}[self.dtype]

    @property
    def np_dtype(self):
        return {"float32": np.float32, "float64": np.float64}[self.dtype]

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.mesh))

    @property
    def boxsize_cm(self) -> float:
        """Comoving box size in cm. grid.F90:97-99."""
        return self.boxsize_mpc_h * const.MPC / self.cosmo.h

    @property
    def dr_comoving(self) -> float:
        """Comoving cell size [cm]; cubic cells. grid.F90:102-104."""
        return self.boxsize_cm / self.mesh[0]

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def test_problem_config(mesh: int = 64, **overrides) -> RunConfig:
    """The reference 'test' problem setup (nbody_test.F90): 100/h Mpc box,
    uniform mean baryon density, z=9 start."""
    base = dict(mesh=(mesh, mesh, mesh), boxsize_mpc_h=100.0)
    base.update(overrides)
    return RunConfig(**base)
