"""Source-sharded ray tracing over a device mesh (parallel phase 1).

Replacement for the reference's MPI source distribution
(/root/reference/master_slave.F90 static round-robin + dynamic
master-slave farm, evolve.F90:577-616 ALLREDUCE of the rate grids):

  * sources are sharded across the 'src' axis of a jax.sharding.Mesh
    (each device sweeps its subset over the replicated grid),
  * the per-device rate grids and loss scalars are summed with lax.psum
    over the device interconnect - the exact analogue of
    MPI_ALLREDUCE(MPI_SUM),
  * load balance comes from host-side flux-sorted round-robin dealing
    (models/sources.sort_sources_by_flux) instead of the dynamic task
    farm - deterministic and synchronization-free.

Works identically on the local accelerators of one host and on the
virtual CPU mesh used in tests (xla_force_host_platform_device_count).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RunConfig
from ..ops.sweep import SweepScalars, raytrace_all_sources, \
    raytrace_windowed
from ..ops.tables import RadTables


def make_device_mesh(n_devices: Optional[int] = None,
                     axis_name: str = "src") -> Mesh:
    """1D device mesh over the source axis (jax.make_mesh equivalent of
    the reference's flat MPI communicator, mpi.F90:153-157)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def pad_sources(srcpos: np.ndarray, nflux: np.ndarray, multiple: int):
    """Pad the source list with zero-flux sources so it shards evenly.

    Zero-flux sources contribute exactly zero rates and losses (all table
    lookups scale with NFlux), mirroring the reference's NormFlux > 0
    guards (radiation_photoionrates.F90:126-137).
    """
    s = len(nflux)
    pad = (-s) % multiple
    if pad:
        srcpos = np.concatenate([srcpos, np.zeros((pad, 3), srcpos.dtype)])
        nflux = np.concatenate([nflux, np.zeros(pad, nflux.dtype)])
    return srcpos, nflux, s


def sharded_raytracer(mesh: Mesh, axis_name: str = "src"):
    """Build a raytracer with the raytrace_all_sources signature that
    shards sources over `mesh` and psums the results.

    Inject into Evolve3D via its `raytracer` argument.
    """

    def raytracer(cfg: RunConfig, tables: RadTables, ndens, xh_av1,
                  srcpos, nflux, sc: SweepScalars, lls_grid=None,
                  max_shell=None, nflux_xray=None):
        ndev = mesh.devices.size
        s = int(srcpos.shape[0])
        have_x = nflux_xray is not None
        if not have_x:
            nflux_xray = jnp.zeros_like(nflux)
        pad = (-s) % ndev
        if pad:
            srcpos = jnp.concatenate(
                [srcpos, jnp.zeros((pad, 3), srcpos.dtype)])
            nflux = jnp.concatenate([nflux, jnp.zeros((pad,), nflux.dtype)])
            nflux_xray = jnp.concatenate(
                [nflux_xray, jnp.zeros((pad,), nflux_xray.dtype)])

        def local(ndens, xh_av1, srcpos, nflux, sc, lls_grid, nfx):
            phih, heat, loss, lls_loss, per_src = raytrace_all_sources(
                cfg, tables, ndens, xh_av1, srcpos, nflux, sc,
                lls_grid=lls_grid, max_shell=max_shell,
                nflux_xray=nfx if have_x else None)
            # MPI_ALLREDUCE(SUM) equivalents (evolve.F90:585-614)
            phih = lax.psum(phih, axis_name)
            heat = lax.psum(heat, axis_name)
            loss = lax.psum(loss, axis_name)
            lls_loss = lax.psum(lls_loss, axis_name)
            # per-source losses come back replicated (all_gather) so the
            # host-side adaptive-radius promotion can read them on every
            # process of a multi-host run
            per_src = lax.all_gather(per_src, axis_name, tiled=True)
            return phih, heat, loss, lls_loss, per_src

        rep = P()                     # replicated
        shard = P(axis_name)          # sharded over sources
        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(rep, rep, shard, shard, rep, rep, shard),
            out_specs=(rep, rep, rep, rep, rep),
            check_vma=False)
        phih, heat, loss, lls_loss, per_src = fn(ndens, xh_av1, srcpos,
                                                 nflux, sc, lls_grid,
                                                 nflux_xray)
        return phih, heat, loss, lls_loss, per_src[:s]

    return raytracer

class WindowedShardedSweeper:
    """Windowed O(r^3) bucket sweeps under a source-sharded mesh — the
    composition of the adaptive subbox machinery with the distributed
    layouts (round 5, VERDICT item 1; the reference's production shape:
    each MPI rank traces its source subset WITH subboxes intact,
    master_slave.F90:74-96 + evolve_source.F90:128-212).

    Each device runs the full windowed path (ops.sweep.raytrace_windowed
    — window gather, r-shell march, scatter-add) on its shard of the
    bucket's sources over the replicated grid; the rate grids and loss
    scalars take ONE psum per bucket.  Injected into
    Evolve3D via `windowed=`; `axes` may span several mesh axes (the dom
    layout shards windowed sources over its whole src x dom device grid,
    since windows never touch the slab structure of its rate physics).
    """

    def __init__(self, mesh: Mesh, axes=("src",), out_spec=None):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.ndev = int(np.prod([mesh.shape[a] for a in self.axes]))
        self.out_spec = out_spec if out_spec is not None else P()
        self._cache = {}

    def supports(self, cfg: RunConfig, radius: int) -> bool:
        return True

    def _program(self, cfg, tables, radius, total, have_x, have_lls, iso):
        key = (radius, total, have_x, have_lls)
        fn = self._cache.get(key)
        if fn is not None:
            return fn
        axes = self.axes if len(self.axes) > 1 else self.axes[0]
        L = total // self.ndev
        from ..ops.sweep import windowed_batch, windowed_prepass

        def local(ndens, xh_av1, pos, nf, nfx, count, sc, lls):
            n = cfg.mesh[0]
            r = radius
            dtype = ndens.dtype
            ndhi_pad, lls_pad = windowed_prepass(
                cfg, ndens, xh_av1, lls if have_lls else None, r)
            sb = max(1, cfg.source_batch)
            b = min(L, 1 << (sb.bit_length() - 1))
            # the per-device source arrays are padded to the pow2
            # CAPACITY L (bounded compile set), but the batch loop runs
            # only ceil(count/b) dynamic trips — padding slots beyond
            # the last partial batch are never swept (a 10k bucket at
            # capacity 16384 would otherwise waste ~60% of the pass)
            nb = (count[0] + b - 1) // b
            acc0 = jnp.zeros((n, n, n), dtype)
            hacc0 = acc0 if not iso else jnp.zeros((), dtype)

            def body(ci, carry):
                acc, hacc, lo_t, ll_t, per = carry
                off = ci * b
                # index dtypes must match under jax_enable_x64 (a python
                # 0 promotes to int64 while the fori counter is int32)
                pb = lax.dynamic_slice(pos, (off, jnp.zeros((), off.dtype)),
                                       (b, 3))
                fb = lax.dynamic_slice(nf, (off,), (b,))
                xb = lax.dynamic_slice(nfx, (off,), (b,))
                acc, hacc, lo, ll, pw = windowed_batch(
                    cfg, tables, ndhi_pad, lls_pad, pb, fb,
                    xb if have_x else None, sc, r, acc, hacc)
                per = lax.dynamic_update_slice(per, pw, (off,))
                return (acc, hacc, lo_t + lo, ll_t + ll, per)

            zero = jnp.zeros((), dtype)
            phih, heat, loss, lls_loss, per = lax.fori_loop(
                0, nb, body, (acc0, hacc0, zero, zero,
                              jnp.zeros((L,), dtype)))
            # MPI_ALLREDUCE(SUM) analogue, one per bucket
            phih = lax.psum(phih, axes)
            if not iso:
                heat = lax.psum(heat, axes)
            loss = lax.psum(loss, axes)
            lls_loss = lax.psum(lls_loss, axes)
            # per-source losses back in global bucket order: place each
            # device's block by its flattened mesh position and psum
            # (robust to multi-axis device ordering, unlike a tiled
            # all_gather)
            i = lax.axis_index(axes)
            full = jnp.zeros((total,), per.dtype)
            full = lax.dynamic_update_slice(full, per, (i * L,))
            per_full = lax.psum(full, axes)
            return phih, heat, loss, lls_loss, per_full

        rep = P()
        shard = P(self.axes if len(self.axes) > 1 else self.axes[0])
        heat_spec = self.out_spec if not iso else rep
        fn = jax.jit(jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(rep, rep, shard, shard, shard, shard, rep, rep),
            out_specs=(self.out_spec, heat_spec, rep, rep, rep),
            check_vma=False))
        self._cache[key] = fn
        return fn

    def sweep(self, cfg, tables, radius, ndens, xh_av, lls_grid,
              pos_np, nf_np, nfx_np, sc):
        """Sweep one adaptive bucket; returns (phih, phiheat, loss,
        lls_loss, per_src) with per_src[:len(pos_np)] in bucket order."""
        s = len(nf_np)
        L = -(-s // self.ndev)
        L = 1 << (L - 1).bit_length()     # pow2 CAPACITY: bounded compiles
        total = self.ndev * L
        dtype = cfg.jnp_dtype
        pos = np.zeros((total, 3), np.int32)
        nf = np.zeros(total)
        pos[:s] = pos_np
        nf[:s] = nf_np
        have_x = nfx_np is not None
        fx = np.zeros(total)
        if have_x:
            fx[:s] = nfx_np
        # real sources per device block (the batch loops run only over
        # these; capacity padding is never swept)
        counts = np.clip(s - L * np.arange(self.ndev), 0, L).astype(
            np.int32)
        prog = self._program(cfg, tables, int(radius), total, have_x,
                             lls_grid is not None, cfg.isothermal)
        lls = (lls_grid if lls_grid is not None
               else jnp.zeros((), dtype))
        return prog(ndens, xh_av, jnp.asarray(pos), jnp.asarray(nf, dtype),
                    jnp.asarray(fx, dtype), jnp.asarray(counts), sc, lls)
