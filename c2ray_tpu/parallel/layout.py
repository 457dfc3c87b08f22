"""Driver-reachable parallel layouts (the `link-time parallel mode`
surface of the reference, /root/reference/makefile_core:40-104: the same
driver runs serial, OpenMP, MPI or hybrid — here the same C2RayDriver
runs any device-mesh layout selected at runtime).

Four layouts:

  none  single device (the reference's serial build).
  src   source sharding over a 1D mesh, replicated grid + psum'd rates —
        the faithful port of the reference's MPI layout
        (master_slave.F90 + evolve.F90:599-609).
  dom   2D (src × dom) mesh: replicated march, slab-sharded rate physics
        and chemistry (parallel/domain.py domain_sharded_raytracer).
  halo  fully domain-decomposed: every O(N^3) field — state, material,
        march, rate grids — lives as a 1/ndom x-slab per device with
        per-shell halo exchange (ops/sweep_sharded.py).  The layout for
        meshes beyond one device's memory (sizes.f90:50-71 runs to 1200^3),
        and the Cartesian topology the reference built but never enabled
        (mpi.F90:183-275, reorder=.false. :69).

`LayoutRuntime` owns the mesh and everything the driver needs: the
raytracer/chemistry injections for Evolve3D, grid shardings, sharded
array construction from per-slab file reads (no process ever
materializes a full cube in the halo layout), and z-chunked host
gathering for the byte-exact output writers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclass
class ParallelLayout:
    """Runtime parallel-mode selection (CLI: --layout/--src-devices/
    --dom-devices)."""

    kind: str = "none"          # none | src | dom | halo
    n_src: int = 0              # devices on the source axis (0 = auto)
    n_dom: int = 0              # devices on the domain axis (0 = auto)


class LayoutRuntime:
    """Mesh + injections + sharded-I/O helpers for one layout."""

    def __init__(self, cfg, layout: ParallelLayout, cool=None):
        self.cfg = cfg
        self.kind = layout.kind
        self.mesh: Optional[Mesh] = None
        self.raytracer = None
        self.chemistry = None
        self.windowed = None        # sharded windowed-bucket sweeper
        self.rate_sharding = None   # adaptive rate-accumulator sharding
        self.grid_sharding: Optional[NamedSharding] = None
        ndev = len(jax.devices())

        if self.kind == "none":
            return
        if self.kind == "src":
            from .source_shard import (WindowedShardedSweeper,
                                       make_device_mesh, sharded_raytracer)
            n = layout.n_src or ndev
            self.mesh = make_device_mesh(n)
            self.raytracer = sharded_raytracer(self.mesh)
            self.windowed = WindowedShardedSweeper(self.mesh)
            return
        if self.kind not in ("dom", "halo"):
            raise ValueError(f"unknown parallel layout {self.kind!r}")

        from .domain import (domain_sharded_raytracer, halo_sharded_raytracer,
                             make_domain_mesh, sharded_chemistry)
        n_src = layout.n_src or 1
        n_dom = layout.n_dom or (ndev // n_src)
        self.mesh = make_domain_mesh(n_src, n_dom)
        n = cfg.mesh[0]
        if n % n_dom != 0:
            raise ValueError(f"mesh {n} not divisible by {n_dom} domain "
                             "devices")
        src_axis = "src" if n_src > 1 else None
        make_rt = (halo_sharded_raytracer if self.kind == "halo"
                   else domain_sharded_raytracer)
        self.raytracer = make_rt(self.mesh, src_axis=src_axis)
        self.chemistry = sharded_chemistry(self.mesh, "dom", cool=cool)
        if self.kind == "halo":
            from .domain import WindowedHaloSweeper
            # every O(N^3) field slab-sharded on grid axis 0 (replicated
            # over the src axis of the 2D mesh)
            self.grid_sharding = NamedSharding(self.mesh, P("dom"))
            self.windowed = WindowedHaloSweeper(self.mesh,
                                                src_axis=src_axis)
            self.rate_sharding = self.grid_sharding
        else:
            from .source_shard import WindowedShardedSweeper
            # dom layout: windows never touch its slab rate structure,
            # so windowed buckets shard sources over the WHOLE device
            # grid and psum (grid is replicated for the march anyway)
            axes = ("src", "dom") if src_axis else ("dom",)
            self.windowed = WindowedShardedSweeper(self.mesh, axes=axes)
        # every clumping/LLS model works under every layout (round 5):
        # types 3/4 evaluate elementwise on the sharded slab
        # (models/clumping.evaluate_device), type-5 clumping and type-2
        # LLS cubes slab-read like density (driver.py) — matching the
        # reference's any-model-any-parallel-mode property
        # (clumping_module.F90:327-487, LLS.F90:214-316)

    # ------------------------------------------------------------------
    @property
    def sharded_grid(self) -> bool:
        """True when O(N^3) state must stay sharded (halo layout)."""
        return self.grid_sharding is not None

    def shard_grid(self, x):
        """Lay a (possibly host) grid array out in this layout's grid
        sharding; identity for replicated layouts."""
        if x is None or self.grid_sharding is None:
            return x
        return jax.device_put(x, self.grid_sharding)

    def shard_state(self, state):
        """GridState pytree → layout sharding."""
        return type(state)(*[self.shard_grid(f) for f in state])

    def make_sharded(self, slab_fn: Callable[[int, int], np.ndarray],
                     dtype=None) -> jax.Array:
        """Build an (N,N,N) grid array from per-slab reads.

        slab_fn(row0, nrows) returns the C-order (nrows, N, N) slab of
        grid-axis-0 rows [row0, row0+nrows).  With a sharded layout the
        callback runs once per addressable shard — each PROCESS of a
        multi-host run reads only its slab rows (the reference instead
        BCASTs whole cubes into every distributed-memory rank,
        density_module.F90:82-125, which the halo layout must not do).
        """
        cfg = self.cfg
        n = cfg.mesh[0]
        dtype = dtype or cfg.np_dtype
        if self.grid_sharding is None:
            return jnp.asarray(slab_fn(0, n).astype(dtype))

        def cb(index: Tuple[slice, ...]):
            r0 = index[0].start or 0
            r1 = index[0].stop if index[0].stop is not None else n
            return slab_fn(r0, r1 - r0).astype(dtype)

        return jax.make_array_from_callback((n, n, n), self.grid_sharding,
                                            cb)

    # ------------------------------------------------------------------
    def z_chunks(self, arr, k_chunk: int = 32) -> Iterator[np.ndarray]:
        """Yield host (N, N, kc) blocks of a grid array in ascending
        z order — the streaming form the F-order cube writers consume
        (io_fortran.write_sm3d_stream).  Peak host memory is one block
        per shard (≈ N^2 * k_chunk), never the full cube."""
        yield from z_chunks(arr, k_chunk)


def replicate_to_host(x) -> np.ndarray:
    """np.asarray that also works for MULTI-PROCESS sharded arrays: the
    value is all-gathered to every process (an SPMD collective — every
    process must call this on the same array).  Use for small gathers
    (lines, planes, per-source values); cubes go through z_chunks."""
    if isinstance(x, jax.Array) and not isinstance(x, np.ndarray) \
            and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


# module-level jitted slicer: traces once per (shape, kc), not once per
# z-block of every cube write (advisor round-4 finding)
_jit_zslice = jax.jit(jax.lax.dynamic_slice_in_dim,
                      static_argnames=("slice_size", "axis"))


def z_chunks(arr, k_chunk: int = 32) -> Iterator[np.ndarray]:
    """Host (N1, N2, kc) z-blocks of a (possibly sharded) grid array.

    For an axis-0-sharded jax.Array the per-shard z-slices are fetched
    and reassembled per block; plain/replicated arrays slice directly.
    With a MULTI-PROCESS sharded array this is an SPMD collective (every
    process must drain the iterator): each block is all-gathered, so
    rank 0 can write the full cube while peak memory stays one block.
    """
    if isinstance(arr, jax.Array) and not isinstance(arr, np.ndarray) \
            and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils
        n3 = arr.shape[2]
        for k0 in range(0, n3, k_chunk):
            kc = min(k_chunk, n3 - k0)
            blk = _jit_zslice(arr, k0, slice_size=kc, axis=2)
            yield np.asarray(multihost_utils.process_allgather(blk,
                                                               tiled=True))
        return
    if isinstance(arr, jax.Array) and not isinstance(arr, np.ndarray) \
            and len(arr.sharding.device_set) > 1:
        # dedupe replicated copies (e.g. the src axis of a 2D mesh, or a
        # fully replicated array): one shard per distinct row range
        uniq = {}
        for s in arr.addressable_shards:
            uniq.setdefault(s.index[0].start or 0, s)
        shards = [uniq[k] for k in sorted(uniq)]
        n3 = arr.shape[2]
        for k0 in range(0, n3, k_chunk):
            kc = min(k_chunk, n3 - k0)
            yield np.concatenate(
                [np.asarray(s.data[:, :, k0:k0 + kc]) for s in shards],
                axis=0)
    else:
        a = arr
        n3 = a.shape[2]
        for k0 in range(0, n3, k_chunk):
            yield np.asarray(a[:, :, k0:k0 + min(k_chunk, n3 - k0)])
