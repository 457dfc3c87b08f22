"""Domain (grid) decomposition — parallel phase 2.

Phase 1 (source_shard.py) replicates the grid and shards sources: the
faithful port of the reference's MPI layout (every rank holds the full
mesh, evolve.F90:599-609).  Phase 2 shards the *grid* itself, which the
reference never achieved (its Cartesian-topology code exists but is
disabled, mpi.F90:69,153-157).

Implemented here now:
  * slab-sharded global chemistry: the chemistry pass is embarrassingly
    parallel per cell, so each device evolves its x-slab of the mesh and
    the updated fractions are all-gathered (chemistry cost / n_devices).

Design for the sharded sweep (future round; SURVEY.md 7.3.3):
  * Shard the grid into x-slabs across the 'dom' mesh axis.  A source's
    wavefront crosses slab boundaries: shell steps whose planes fall in a
    neighbor's slab need that neighbor's coldensh_out boundary planes.
  * With the face-major formulation the exchange is natural: the x+/x-
    face stacks advance strictly along the sharded axis, so each shard
    runs the full shell loop on its slab and ppermute-sends the last
    computed x-face plane (plus the z/y plane *strips* overlapping the
    boundary) to the next shard - a wavefront pipeline with depth equal
    to the number of crossed shards, overlappable with the interior
    shells of other sources (pipeline sources round-robin so every shard
    is busy sweeping a different source's interior while waiting).
  * Rate deposition and chemistry then stay slab-local; only the scalar
    loss tallies need a psum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RunConfig
from ..ops.chemistry import global_chemistry
from ..ops.sweep import SweepScalars, raytrace_all_sources
from ..ops.tables import RadTables
from ..ops.thermal import CoolingTable


def make_domain_mesh(n_src: int, n_dom: int,
                     axis_names=("src", "dom")) -> Mesh:
    """2D device mesh: source data-parallelism x grid-slab domain
    decomposition.  The analogue of an MPI rank grid the reference
    builds but never enables (mpi.F90:183-227, reorder=.false. :69)."""
    devs = jax.devices()
    need = n_src * n_dom
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:need]).reshape(n_src, n_dom), axis_names)


def domain_sharded_raytracer(mesh: Mesh, dom_axis: str = "dom",
                             src_axis: Optional[str] = None):
    """Grid-slab domain decomposition of the ray sweep (parallel phase 2).

    Design (the inversion of the halo-exchange plan the reference's
    Cartesian topology hints at, mpi.F90:183-275): the causal column
    march is op-latency-bound - each shell step is O(N^2) work dominated
    by fixed per-op cost, so *sharding it would add a
    collective per shell and make it slower*.  Instead the march runs
    REPLICATED on every device of the `dom` axis, and everything that is
    O(N^3) FLOP/bandwidth work - coldensh_in reconstruction, the
    photon-conserving rate evaluation (the exponential-mixture math),
    rate deposition, loss reductions, and downstream chemistry - runs on
    a 1/ndom grid slab per device.  The rate grids stay slab-sharded
    across the convergence iteration (chemistry is elementwise), so the
    only replicated O(N^3) state is the march itself.

    Composes with phase-1 source sharding on a 2D (src, dom) mesh: pass
    src_axis="src"; each device then sweeps S/n_src sources over its
    slab, rate grids are psum'd over src and stay sharded over dom.

    Returns a raytracer with the raytrace_all_sources signature (inject
    into Evolve3D); phih comes back as a global jax.Array sharded
    P(dom) on grid axis 0.
    """

    def raytracer(cfg: RunConfig, tables: RadTables, ndens, xh_av1,
                  srcpos, nflux, sc: SweepScalars, lls_grid=None,
                  max_shell=None, nflux_xray=None):
        ndom = mesh.shape[dom_axis]
        n = cfg.mesh[0]
        if n % ndom != 0:
            raise ValueError(f"mesh {n} not divisible by dom axis {ndom}")
        m = n // ndom

        s = int(srcpos.shape[0])
        have_x = nflux_xray is not None
        if not have_x:
            nflux_xray = jnp.zeros_like(nflux)
        if src_axis is not None:
            nsrc_dev = mesh.shape[src_axis]
            pad = (-s) % nsrc_dev
            if pad:
                srcpos = jnp.concatenate(
                    [srcpos, jnp.zeros((pad, 3), srcpos.dtype)])
                nflux = jnp.concatenate(
                    [nflux, jnp.zeros((pad,), nflux.dtype)])
                nflux_xray = jnp.concatenate(
                    [nflux_xray, jnp.zeros((pad,), nflux_xray.dtype)])

        def local(ndens, xh_av1, srcpos, nflux, sc, lls_grid, nfx):
            x0 = lax.axis_index(dom_axis) * m
            phih, heat, loss, lls_loss, per_src = raytrace_all_sources(
                cfg, tables, ndens, xh_av1, srcpos, nflux, sc,
                lls_grid=lls_grid, max_shell=max_shell, slab=(x0, m),
                nflux_xray=nfx if have_x else None)
            # scalar losses: full reductions (ALLREDUCE analogue,
            # evolve.F90:585-614) over both mesh axes
            axes = (dom_axis,) if src_axis is None else (dom_axis, src_axis)
            loss = lax.psum(loss, axes)
            lls_loss = lax.psum(lls_loss, axes)
            per_src = lax.psum(per_src, dom_axis)
            if src_axis is not None:
                # rate slabs: sum over the source shards, stay dom-sharded
                phih = lax.psum(phih, src_axis)
                heat = lax.psum(heat, src_axis)
                # per-source losses replicated for host-side reads on
                # every process of a multi-host run
                per_src = lax.all_gather(per_src, src_axis, tiled=True)
            return phih, heat, loss, lls_loss, per_src

        rep = P()
        src_spec = P(src_axis) if src_axis is not None else rep
        dom_spec = P(dom_axis)   # slab along grid axis 0
        heat_spec = dom_spec if not cfg.isothermal else rep
        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(rep, rep, src_spec, src_spec, rep, rep, src_spec),
            out_specs=(dom_spec, heat_spec, rep, rep, rep),
            check_vma=False)
        phih, heat, loss, lls_loss, per_src = fn(ndens, xh_av1, srcpos,
                                                 nflux, sc, lls_grid,
                                                 nflux_xray)
        return phih, heat, loss, lls_loss, per_src[:s]

    return raytracer


def halo_sharded_raytracer(mesh: Mesh, dom_axis: str = "dom",
                           src_axis: Optional[str] = None):
    """Fully domain-decomposed ray sweep: the causal march itself runs
    sharded over grid x-slabs with per-shell halo exchange (parallel
    phase 2b, ops/sweep_sharded.py).

    Unlike domain_sharded_raytracer (replicated march, sharded rate
    physics), every O(N^3) array here — density, ionization, the march
    state, the column field, the rate grids — is a 1/ndom slab, so the
    memory footprint scales down with the mesh axis and grids larger
    than one device's memory become feasible.  The price is two ring
    ppermutes per wavefront shell (boundary halo rows + the x-face
    plane ownership handoff); these carry small (O(N) and O(N^2))
    payloads and can overlap with the strip compute.

    Input ndens/xh_av1/lls_grid may be host arrays or jax.Arrays; they
    are consumed with P(dom) sharding on grid axis 0 (pass arrays
    already device_put with that sharding to avoid any replicated
    materialization).  Outputs match domain_sharded_raytracer: phih
    (and phiheat) sharded P(dom) on axis 0, scalar losses replicated.
    """
    from ..ops.sweep import (SweepScalars, _rate_pass, neutral_density,
                             slab_rows)
    from ..ops.sweep_sharded import compute_columns_slab

    ndom = mesh.shape[dom_axis]

    def raytracer(cfg: RunConfig, tables: RadTables, ndens, xh_av1,
                  srcpos, nflux, sc: SweepScalars, lls_grid=None,
                  max_shell=None, nflux_xray=None):
        n = cfg.mesh[0]
        if n % ndom != 0:
            raise ValueError(f"mesh {n} not divisible by dom axis {ndom}")
        m = n // ndom
        c = n // 2
        d_sweep = max_shell
        if d_sweep is None:
            d_sweep = cfg.max_shell if cfg.max_shell is not None else c
        d_sweep = min(d_sweep, min(c, cfg.max_subbox))

        s = int(srcpos.shape[0])
        have_x = nflux_xray is not None
        if not have_x:
            nflux_xray = jnp.zeros_like(nflux)
        if src_axis is not None:
            nsrc_dev = mesh.shape[src_axis]
            pad = (-s) % nsrc_dev
            if pad:
                srcpos = jnp.concatenate(
                    [srcpos, jnp.zeros((pad, 3), srcpos.dtype)])
                nflux = jnp.concatenate(
                    [nflux, jnp.zeros((pad,), nflux.dtype)])
                nflux_xray = jnp.concatenate(
                    [nflux_xray, jnp.zeros((pad,), nflux_xray.dtype)])

        def local(ndens_s, xh_s, srcpos, nflux, sc, lls_s, nfx_all):
            r0 = lax.axis_index(dom_axis) * m
            ndhi_s = neutral_density(cfg, ndens_s, xh_s)
            dtype = ndens_s.dtype

            def sweep_one(carry, inp):
                phih, heat, loss_t, lls_t = carry
                pos, nf, nfx = inp
                sh = (c - pos[1], c - pos[2])
                ndhi_c = jnp.roll(ndhi_s, sh, axis=(1, 2))
                lls_c = (jnp.roll(lls_s, sh, axis=(1, 2))
                         if lls_s is not None else None)
                cdo = compute_columns_slab(cfg, ndhi_c, sc, lls_c,
                                           d_sweep, pos[0], r0, ndom,
                                           dom_axis)
                res = _rate_pass(cfg, tables, cdo, ndhi_c, nf, sc, lls_c,
                                 d_sweep,
                                 row_ci=slab_rows(n, m, r0, pos[0]),
                                 nflux_xray=nfx if have_x else None)
                back = (pos[1] - c, pos[2] - c)
                phih = phih + jnp.roll(res.phih, back, axis=(1, 2))
                if not cfg.isothermal:
                    heat = heat + jnp.roll(res.phiheat, back, axis=(1, 2))
                return (phih, heat, loss_t + res.photon_loss,
                        lls_t + res.lls_loss), res.photon_loss

            zero3 = jnp.zeros((m, n, n), dtype)
            heat0 = zero3 if not cfg.isothermal else jnp.zeros((), dtype)
            carry0 = (zero3, heat0, jnp.zeros((), dtype),
                      jnp.zeros((), dtype))
            (phih, heat, loss, lls_loss), per_src = lax.scan(
                sweep_one, carry0, (srcpos, nflux, nfx_all))

            axes = (dom_axis,) if src_axis is None else (dom_axis, src_axis)
            loss = lax.psum(loss, axes)
            lls_loss = lax.psum(lls_loss, axes)
            per_src = lax.psum(per_src, dom_axis)
            if src_axis is not None:
                phih = lax.psum(phih, src_axis)
                if not cfg.isothermal:
                    heat = lax.psum(heat, src_axis)
                per_src = lax.all_gather(per_src, src_axis, tiled=True)
            return phih, heat, loss, lls_loss, per_src

        rep = P()
        dom_spec = P(dom_axis)
        src_spec = P(src_axis) if src_axis is not None else rep
        heat_spec = dom_spec if not cfg.isothermal else rep
        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(dom_spec, dom_spec, src_spec, src_spec, rep,
                      dom_spec if lls_grid is not None else rep, src_spec),
            out_specs=(dom_spec, heat_spec, rep, rep, rep),
            check_vma=False)
        phih, heat, loss, lls_loss, per_src = fn(ndens, xh_av1, srcpos,
                                                 nflux, sc, lls_grid,
                                                 nflux_xray)
        return phih, heat, loss, lls_loss, per_src.reshape(-1)[:s]

    return raytracer


def sharded_chemistry(mesh: Mesh, axis_name: str = "src",
                      cool: Optional[CoolingTable] = None):
    """Build a global_chemistry drop-in that shards the mesh's first grid
    axis across the devices of `mesh` and all-gathers the results.

    The grid axis must be divisible by the device count.  Scalar/grid
    clumping and the photon-loss term are supported; all inputs arrive
    replicated (as in the phase-1 layout), so the only communication is
    the final all_gather of the slab results.
    """

    ndev = mesh.devices.size

    def chem(cfg: RunConfig, dt, ndens, xh1_old, xh1_intermed, xh1_av,
             phih, phiheat=None, temper_current=None, temper_av=None,
             clumping=1.0, cool_table=None, cosmo_cool_coeff=0.0,
             photon_loss_rate=0.0):
        n = ndens.shape[0]
        if n % ndev != 0:
            return global_chemistry(cfg, dt, ndens, xh1_old, xh1_intermed,
                                    xh1_av, phih, phiheat, temper_current,
                                    temper_av, clumping, cool_table or cool,
                                    cosmo_cool_coeff,
                                    photon_loss_rate=photon_loss_rate)

        def local(dt, ndens, xh1_old, xh1_int, xh1_av, phih, phiheat,
                  t_cur, t_av, clumping, ccc, plr):
            res = global_chemistry(cfg, dt, ndens, xh1_old, xh1_int, xh1_av,
                                   phih, phiheat, t_cur, t_av, clumping,
                                   cool_table or cool, ccc,
                                   photon_loss_rate=plr)
            conv = lax.psum(res.conv_flag, axis_name)
            nit = lax.pmax(res.n_iterations, axis_name)
            return res._replace(conv_flag=conv, n_iterations=nit)

        shard = P(axis_name)       # slab along grid axis 0
        rep = P()

        def grid_or_scalar(x):
            return shard if getattr(x, "ndim", 0) == 3 else rep

        from ..ops.chemistry import ChemistryResult

        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(rep, shard, shard, shard, shard, shard,
                      shard if phiheat is not None else rep,
                      shard if temper_current is not None else rep,
                      shard if temper_av is not None else rep,
                      grid_or_scalar(clumping), rep,
                      # add_photon_losses passes a full (N,N,N) rate grid
                      # (solver._lossrate); scalars stay replicated
                      grid_or_scalar(photon_loss_rate)),
            out_specs=ChemistryResult(shard, shard, shard, shard, rep, rep),
            check_vma=False)
        return fn(dt, ndens, xh1_old, xh1_intermed, xh1_av, phih,
                  phiheat, temper_current, temper_av, clumping,
                  cosmo_cool_coeff, photon_loss_rate)

    return chem

class WindowedHaloSweeper:
    """Windowed O(r^3) bucket sweeps under the fully grid-sharded halo
    layout (round 5, VERDICT item 1): the reference's production shape —
    big mesh x huge catalog x distributed — with subboxes intact
    (master_slave.F90:74-96, evolve_source.F90:128-212).

    Design (no reference analogue):
      * each device halo-extends its x-slab of the neutral-density field
        by r rows from both ring neighbors (two ppermutes, O(r N^2)
        payload on the interconnect), then wrap-pads axes 1/2 locally —
        after which ANY window centered in the slab is a contiguous (2r+1)^3 slice,
      * sources are dealt host-side to their OWNING slab (and split
        round-robin over the src axis of a 2D mesh), so every window is
        swept exactly once, by the device that holds its rows,
      * rates scatter into a padded slab accumulator (m+2r, n+2r, n+2r)
        with no mod arithmetic; at bucket end axes 1/2 fold mod-n
        locally and the axis-0 overflow strips ride a REVERSE halo
        exchange (two ppermutes) back to the neighbors' interiors,
      * requires radius <= slab height; buckets beyond that fall back to
        the strip-march full sweep (solver handles the split).

    Memory stays O(N^3/ndom) per device throughout — no field or rate
    grid is ever materialized whole, preserving the halo layout's
    flagship property.
    """

    def __init__(self, mesh: Mesh, dom_axis: str = "dom",
                 src_axis: Optional[str] = None):
        self.mesh = mesh
        self.dom_axis = dom_axis
        self.src_axis = src_axis
        self.ndom = int(mesh.shape[dom_axis])
        self.nsrc = int(mesh.shape[src_axis]) if src_axis else 1
        self._cache = {}

    def supports(self, cfg, radius: int) -> bool:
        m = cfg.mesh[0] // self.ndom
        return radius <= m

    # ------------------------------------------------------------------
    def _program(self, cfg, tables, radius, L, have_x, have_lls):
        from ..ops.sweep import fold_padded_acc, neutral_density, \
            windowed_batch

        key = (radius, L, have_x, have_lls)
        fn = self._cache.get(key)
        if fn is not None:
            return fn

        n = cfg.mesh[0]
        ndom, nsrc = self.ndom, self.nsrc
        m = n // ndom
        r = int(radius)
        dom_axis, src_axis = self.dom_axis, self.src_axis
        iso = cfg.isothermal
        total = ndom * nsrc * L
        sb = max(1, cfg.source_batch)
        b = min(L, 1 << (sb.bit_length() - 1))
        fwd = [(i, (i + 1) % ndom) for i in range(ndom)]
        bwd = [(i, (i - 1) % ndom) for i in range(ndom)]

        def halo_extend(x):
            # rows [d*m-r, d*m) from the previous slab, [d*m+m, d*m+m+r)
            # from the next (periodic ring == global mod-n wrap)
            top = lax.ppermute(x[m - r:], dom_axis, fwd)
            bot = lax.ppermute(x[:r], dom_axis, bwd)
            ext = jnp.concatenate([top, x, bot], axis=0)
            return jnp.pad(ext, ((0, 0), (r, r), (r, r)), mode="wrap")

        def ring_fold(acc):
            # reverse halo exchange: the slab accumulator's overflow
            # strips belong to the neighbors' interiors
            lo, core, hi = acc[:r], acc[r:r + m], acc[r + m:]
            recv_lo = lax.ppermute(lo, dom_axis, bwd)   # from next slab
            recv_hi = lax.ppermute(hi, dom_axis, fwd)   # from prev slab
            core = core.at[m - r:].add(recv_lo)
            core = core.at[:r].add(recv_hi)
            return core

        def local(ndens_s, xh_s, lls_s, pos, nf, nfx, count, sc):
            d = lax.axis_index(dom_axis)
            dtype = ndens_s.dtype
            ext = halo_extend(neutral_density(cfg, ndens_s, xh_s))
            lls_ext = halo_extend(lls_s) if have_lls else None
            # window centers in slab coordinates (= corner in the
            # extended/padded frame, the padded_acc convention)
            pos_loc = pos - jnp.stack(
                [jnp.full((pos.shape[0],), d * m, pos.dtype),
                 jnp.zeros((pos.shape[0],), pos.dtype),
                 jnp.zeros((pos.shape[0],), pos.dtype)], axis=1)
            acc0 = jnp.zeros((m + 2 * r, n + 2 * r, n + 2 * r), dtype)
            hacc0 = acc0 if not iso else jnp.zeros((), dtype)
            # dynamic trip count: slabs own different source counts —
            # each device sweeps only its real batches, not the pow2
            # capacity padding (counts arrive sharded per device)
            nb = (count[0] + b - 1) // b

            def body(ci, carry):
                acc, hacc, lo_t, ll_t, per = carry
                off = ci * b
                # matching index dtypes (python 0 promotes to int64
                # under jax_enable_x64; the fori counter is int32)
                pb = lax.dynamic_slice(pos_loc,
                                       (off, jnp.zeros((), off.dtype)),
                                       (b, 3))
                fb = lax.dynamic_slice(nf, (off,), (b,))
                xb = lax.dynamic_slice(nfx, (off,), (b,))
                acc, hacc, lo, ll, pw = windowed_batch(
                    cfg, tables, ext, lls_ext, pb, fb,
                    xb if have_x else None, sc, r, acc, hacc,
                    padded_acc=True)
                per = lax.dynamic_update_slice(per, pw, (off,))
                return (acc, hacc, lo_t + lo, ll_t + ll, per)

            zero = jnp.zeros((), dtype)
            acc, hacc, loss, lls_loss, per = lax.fori_loop(
                0, nb, body, (acc0, hacc0, zero, zero,
                              jnp.zeros((L,), dtype)))

            phih = ring_fold(fold_padded_acc(acc, n, r, axes=(1, 2)))
            heat = (ring_fold(fold_padded_acc(hacc, n, r, axes=(1, 2)))
                    if not iso else jnp.zeros((), dtype))

            axes = (dom_axis,) if src_axis is None else (dom_axis,
                                                         src_axis)
            loss = lax.psum(loss, axes)
            lls_loss = lax.psum(lls_loss, axes)
            if src_axis is not None:
                phih = lax.psum(phih, src_axis)
                if not iso:
                    heat = lax.psum(heat, src_axis)
            # per-source losses to global (ndom, nsrc, L) order: place
            # this device's block by its flattened position and psum
            # (every source is swept on exactly one device)
            si = lax.axis_index(src_axis) if src_axis else 0
            blk = d * nsrc + si
            full = jnp.zeros((total,), per.dtype)
            full = lax.dynamic_update_slice(full, per, (blk * L,))
            per_full = lax.psum(full, axes)
            return phih, heat, loss, lls_loss, per_full

        rep = P()
        dom_spec = P(dom_axis)
        pos_axes = ((dom_axis,) if src_axis is None
                    else (dom_axis, src_axis))
        pos_spec = P(pos_axes if len(pos_axes) > 1 else pos_axes[0])
        heat_spec = dom_spec if not iso else rep
        fn = jax.jit(jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(dom_spec, dom_spec,
                      dom_spec if have_lls else rep,
                      pos_spec, pos_spec, pos_spec, pos_spec, rep),
            out_specs=(dom_spec, heat_spec, rep, rep, rep),
            check_vma=False))
        self._cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    def sweep(self, cfg, tables, radius, ndens, xh_av, lls_grid,
              pos_np, nf_np, nfx_np, sc):
        """Sweep one adaptive bucket; returns (phih P(dom), phiheat,
        loss, lls_loss, per_src) with per_src in bucket order."""
        n = cfg.mesh[0]
        m = n // self.ndom
        nsrc = self.nsrc
        s = len(nf_np)
        own = (np.asarray(pos_np)[:, 0] // m).astype(np.int64)
        # deal each slab's sources round-robin over the src axis
        slots = {}
        for j in range(s):
            d = int(own[j])
            lst = slots.setdefault(d, [])
            lst.append(j)
        lmax = 1
        for lst in slots.values():
            lmax = max(lmax, -(-len(lst) // nsrc))
        L = 1 << (lmax - 1).bit_length()
        total = self.ndom * nsrc * L
        dtype = cfg.jnp_dtype
        pos = np.zeros((total, 3), np.int32)
        nf = np.zeros(total)
        fx = np.zeros(total)
        have_x = nfx_np is not None
        flatpos = np.zeros(s, np.int64)
        counts = np.zeros(self.ndom * nsrc, np.int32)
        for d, lst in slots.items():
            for k, j in enumerate(lst):
                si = k % nsrc
                slot = k // nsrc
                fp = (d * nsrc + si) * L + slot
                pos[fp] = pos_np[j]
                nf[fp] = nf_np[j]
                if have_x:
                    fx[fp] = nfx_np[j]
                flatpos[j] = fp
                counts[d * nsrc + si] = max(counts[d * nsrc + si],
                                            slot + 1)
        prog = self._program(cfg, tables, int(radius), L, have_x,
                             lls_grid is not None)
        lls = (lls_grid if lls_grid is not None
               else jnp.zeros((), dtype))
        phih, heat, loss, lls_loss, per_full = prog(
            ndens, xh_av, lls, jnp.asarray(pos), jnp.asarray(nf, dtype),
            jnp.asarray(fx, dtype), jnp.asarray(counts), sc)
        per_src = jnp.take(per_full, jnp.asarray(flatpos))
        return phih, heat, loss, lls_loss, per_src
