"""evolve3D: the global convergence iteration over sources + chemistry.

Re-implementation of /root/reference/evolve.F90:83-281.  One call evolves
the whole grid over a timestep dt by iterating
  [zero rates -> sweep all sources -> (psum) -> global chemistry pass]
until the grid converges.  The host drives the (typically 2-10 step)
convergence loop and reads back only a few scalars per iteration; all
heavy work is in two jitted device programs (the source sweep scan and
the vectorized chemistry pass).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .config import RunConfig
from .ops.chemistry import global_chemistry
from .ops.photonstats import GridCounts, PhotonStatistics, grid_counts
from .ops.sweep import SweepScalars, full_batch_cap, \
    raytrace_all_sources, windowed_batch, windowed_prepass
from .ops.tables import RadTables
from .ops.thermal import CoolingTable
from .state import GridState


class EvolveInfo(NamedTuple):
    niter: int
    conv_flag: int
    converged: bool
    mean_xh1: float
    photon_loss: float       # S_star units
    lls_loss: float          # S_star units
    per_source_loss: np.ndarray
    photon_stats: dict
    phih: Optional[jax.Array] = None      # last accumulated rate grid [1/s]
    phiheat: Optional[jax.Array] = None   # last heating grid [erg/s/cm^3]


class Evolve3D:
    """Compiled evolve3D solver for a fixed config + tables.

    `raytracer` may be overridden (parallel/source_shard.py injects a
    shard_map-wrapped version); it must have the signature of
    ops.sweep.raytrace_all_sources.
    """

    def __init__(self, cfg: RunConfig, tables: RadTables,
                 cool: Optional[CoolingTable] = None,
                 raytracer: Optional[Callable] = None,
                 chemistry: Optional[Callable] = None,
                 windowed=None, rate_sharding=None):
        self.cfg = cfg
        self.tables = tables
        self.cool = cool
        self._custom_raytracer = raytracer is not None
        # sharded windowed-bucket sweeper (parallel/source_shard.py
        # WindowedShardedSweeper or parallel/domain.py
        # WindowedHaloSweeper): lets the adaptive O(r^3) subbox path run
        # under a distributed layout — the reference's production shape
        # (master_slave.F90:74-96 + evolve_source.F90:128-212)
        self._windowed = windowed
        # sharding for the per-iteration rate accumulators (halo layout:
        # P('dom') slabs, so the adaptive path never materializes a
        # replicated O(N^3) grid); None = default placement
        self._rate_sharding = rate_sharding
        self._wchunk_cache = {}     # radius -> (prepass, chunk) jit fns
        # per-timestep cache of padded per-bucket device source arrays:
        # rebuilt only when promotions CHANGE the assignment, so the
        # steady-state production iteration skips the host bucketing
        # cost (O(sources) host work + transfers per iteration)
        self._abucket_cache = (None, {})
        rt = raytracer if raytracer is not None else raytrace_all_sources

        @jax.jit
        def _sweep(ndens, xh_av1, srcpos, nflux, sc, lls_grid, nflux_xray):
            return rt(cfg, tables, ndens, xh_av1, srcpos, nflux, sc,
                      lls_grid=lls_grid, nflux_xray=nflux_xray)

        from functools import partial as _partial

        @_partial(jax.jit, static_argnames=("max_shell",))
        def _sweep_r(ndens, xh_av1, srcpos, nflux, sc, lls_grid, nflux_xray,
                     max_shell):
            return rt(cfg, tables, ndens, xh_av1, srcpos, nflux, sc,
                      lls_grid=lls_grid, max_shell=max_shell,
                      nflux_xray=nflux_xray)

        def _chem_call(dt, ndens, xh1_old, xh1_int, xh1_av, phih, phiheat,
                       t_cur, t_av, clumping, cosmo_cool_coeff,
                       photon_loss_rate):
            if chemistry is not None:
                # injected distributed variant (parallel/domain.py)
                return chemistry(cfg, dt, ndens, xh1_old, xh1_int, xh1_av,
                                 phih, phiheat, t_cur, t_av, clumping,
                                 cool, cosmo_cool_coeff,
                                 photon_loss_rate=photon_loss_rate)
            return global_chemistry(cfg, dt, ndens, xh1_old, xh1_int, xh1_av,
                                    phih, phiheat, t_cur, t_av, clumping,
                                    cool, cosmo_cool_coeff,
                                    photon_loss_rate=photon_loss_rate)

        _chem = jax.jit(_chem_call)

        def _dense_x1(x):
            if cfg.compressed_xfrac:
                from .state import xh1_of
                return xh1_of(x)
            return x

        @jax.jit
        def _counts(ndens, xh1, t_av, clumping):
            # compressed inputs are decoded natively inside grid_counts so
            # the photon audit keeps the stored neutral tail (the
            # reference's compressed photonstatistics variant)
            return grid_counts(cfg, ndens, xh1, t_av, clumping,
                               compressed=cfg.compressed_xfrac)

        def _lossrate_body(ndens, xh_av1, sc, loss_per_cell):
            # redistribute boundary losses as a per-cell per-atom rate:
            # each cell absorbs its share through its own column (the
            # reference's dormant add_photon_losses block,
            # evolve_point.F90:497-506, with photon_loss =
            # photon_loss_all/N^3 from evolve.F90:525)
            from .ops.sweep import neutral_density
            from .ops.tables import photoion_rates
            ndhi = neutral_density(cfg, ndens, xh_av1)
            coldens_cell = ndhi * sc.dr
            phi = photoion_rates(cfg, tables,
                                 jnp.zeros_like(coldens_cell), coldens_cell,
                                 jnp.ones_like(coldens_cell), loss_per_cell)
            return phi.photo_cell * sc.rate_scale / ndhi

        _lossrate = jax.jit(_lossrate_body)

        @jax.jit
        def _sum(x):
            # total ionized fraction (decodes compressed storage)
            return jnp.sum(_dense_x1(x))

        from functools import partial as __partial

        @__partial(jax.jit, static_argnames=("with_stats",))
        def _tail(dt, ndens, xh1_old, xh1_int, xh1_av, phih, phiheat,
                  t_cur, t_av, clumping, cosmo_cool_coeff, sc, ploss, llsl,
                  with_stats):
            """Fused per-iteration tail: loss redistribution + global
            chemistry + photon-audit counts + convergence sum, one device
            program.  Every scalar the host needs for the convergence
            iteration comes back in ONE packed vector
            [conv_flag, sum_xh1, photon_loss, lls_loss,
             (h0_after, h1_after, rec_rate, coll_rate)]
            so the loop costs a single dispatch+wait round trip per
            iteration instead of ~8 host synchronisations."""
            with jax.named_scope("chemistry"):
                if cfg.add_photon_losses:
                    rate = _lossrate_body(ndens, xh1_av, sc,
                                          ploss / cfg.n_cells)
                    loss_rate = jnp.where(ploss > 0.0, rate,
                                          jnp.zeros_like(rate))
                else:
                    loss_rate = jnp.zeros((), ndens.dtype)
                chem = _chem_call(dt, ndens, xh1_old, xh1_int, xh1_av,
                                  phih, phiheat, t_cur, t_av, clumping,
                                  cosmo_cool_coeff, loss_rate)
                sum1 = jnp.sum(_dense_x1(chem.xh1_intermed))
                dtype_l = sum1.dtype
                scalars = [chem.conv_flag.astype(dtype_l), sum1,
                           jnp.asarray(ploss, dtype_l).reshape(()),
                           jnp.asarray(llsl, dtype_l).reshape(())]
                if with_stats:
                    # audit counts on the post-chemistry iterates, with the
                    # updated time-averaged temperature (non-isothermal)
                    t_stats = t_av if cfg.isothermal else chem.temper_av
                    comp = cfg.compressed_xfrac
                    ca = grid_counts(cfg, ndens, chem.xh1_intermed, t_stats,
                                     clumping, compressed=comp)
                    cr = grid_counts(cfg, ndens, chem.xh1_av, t_stats,
                                     clumping, compressed=comp)
                    scalars += [ca.h0, ca.h1, cr.rec_rate, cr.coll_rate]
                packed = jnp.stack([jnp.asarray(s, dtype_l)
                                    for s in scalars])
            return (chem.xh1_intermed, chem.xh1_av, chem.temper_intermed,
                    chem.temper_av, packed)

        self._sweep = _sweep
        self._sweep_r = _sweep_r
        self._chem = _chem
        self._counts = _counts
        self._sum = _sum
        self._lossrate = _lossrate
        self._tail = _tail
        self._tail_body = _tail               # jitted fn is fine to trace
        self._rt = rt
        self._loop_cache = {}                 # device-loop programs

    # ------------------------------------------------------------------
    def _radius_ladder(self):
        n = self.cfg.mesh[0]
        d_max = n // 2
        r = max(2, self.cfg.adaptive_min_shell)
        ladder = []
        while r < d_max:
            ladder.append(r)
            r *= 2
        ladder.append(d_max)
        return ladder

    def _initial_radii(self, nflux_np, ndens_mean, dr, dt):
        """Strömgren-style initial radius estimate per source, snapped up
        to the ladder (replaces the first subbox growth passes).

        In the many-source regime the isolated-Strömgren estimate
        over-reaches: bubbles merge, so each source's effective reach is
        bounded by the inter-source spacing.  The initial assignment is
        capped at ~the mean half-separation; genuinely leaky sources are
        promoted by the escaping-photon test within the convergence loop
        (exactly the reference's subbox growth criterion,
        evolve_source.F90:128-136), so the cap costs correctness nothing
        while keeping dense catalogs on cheap windowed sweeps."""
        cfg = self.cfg
        n = cfg.mesh[0]
        ladder = self._radius_ladder()
        s_phys = np.maximum(nflux_np, 1e-300) * cfg.sed.s_star
        r_est = (3.0 * s_phys * dt / (4.0 * np.pi * ndens_mean)) ** (1.0 / 3.0)
        cells = 1.3 * r_est / dr
        num_src = max(1, len(nflux_np))
        spacing_cap = 0.75 * n / num_src ** (1.0 / 3.0)
        capped = np.minimum(cells, max(spacing_cap,
                                       float(cfg.adaptive_min_shell)))
        # top-decile-flux sources are exempt from the spacing cap: in a
        # clustered catalog the cap assumes uniform spread and would start
        # a bright clumped source under-radiused, paying promotion
        # iterations to recover (evolve_source.F90:128-136 grows per
        # source, never capping by neighbor spacing)
        if num_src > 1:
            exempt = nflux_np >= np.quantile(nflux_np, 0.9)
            cells = np.where(exempt, cells, capped)
        else:
            cells = capped
        assign = np.searchsorted(np.asarray(ladder), cells)
        return np.minimum(assign, len(ladder) - 1).astype(np.int64)

    def _window_chunk_size(self, radius: int) -> int:
        """Fixed batch size for one windowed-chunk program at this rung:
        scaled so every chunk carries ~source_batch x 17^3 window cells
        (the same work per compiled chunk at every rung),
        pow2-floored for shape stability."""
        sb = max(1, self.cfg.source_batch)
        c = int(sb * (17 ** 3) / (2 * radius + 1) ** 3)
        c = max(4, min(sb, c))
        return 1 << (c.bit_length() - 1)

    def _full_chunk_size(self) -> int:
        """Fixed per-call source count for the full-radius rung (the
        full-cube sweep path), bounded by its staging memory cap."""
        b_mem = full_batch_cap(self.cfg.mesh[0], self.cfg.jnp_dtype)
        c = max(1, min(self.cfg.source_batch, b_mem))
        return 1 << (c.bit_length() - 1)

    def _windowed_fns(self, radius: int):
        """Jitted (prepass, chunk) programs for one windowed rung —
        cached per radius, so subbox promotions re-bucket sources without
        recompiling anything (program shapes depend only on the rung)."""
        fns = self._wchunk_cache.get(radius)
        if fns is None:
            cfg, tables = self.cfg, self.tables

            def prepass(ndens, xh_av1, lls_grid):
                return windowed_prepass(cfg, ndens, xh_av1, lls_grid,
                                        radius)

            def chunk(ndhi_pad, lls_pad, pos, nf, nfx, sc, acc, heat_acc):
                return windowed_batch(cfg, tables, ndhi_pad, lls_pad, pos,
                                      nf, nfx, sc, radius, acc, heat_acc)

            fns = (jax.jit(prepass), jax.jit(chunk, donate_argnums=(6, 7)))
            self._wchunk_cache[radius] = fns
        return fns

    def _adaptive_sweep(self, ndens, xh_av, srcpos_np, nflux_np, srcpos,
                        nflux, sc, lls_grid, assign, nfx_np=None):
        """Sweep sources grouped by their assigned radius (the
        analogue of the reference's subbox growth loop,
        evolve_source.F90:128-212).

        Buckets below the full-grid radius run through fixed-shape
        windowed-chunk programs (ops.sweep.windowed_batch) so their cost
        scales with sum(r^3) AND the compiled-program set depends only on
        the rung ladder — promotions re-bucket sources without
        recompiles.  NO host syncs happen here: the loss scalars come
        back as device values and the per-source losses as a `pending`
        list of (bucket indices, device array) pairs — the caller folds
        them into its single per-iteration fetch and applies the
        promotion rule afterwards (`_promote`)."""
        cfg = self.cfg
        dtype = cfg.jnp_dtype
        n = cfg.mesh[0]
        ladder = self._radius_ladder()
        if self._rate_sharding is not None:
            zeros = jax.jit(lambda: jnp.zeros((n, n, n), dtype),
                            out_shardings=self._rate_sharding)
            phih = zeros()
            heat = (zeros() if not cfg.isothermal
                    else jnp.zeros((), dtype))
        else:
            phih = jnp.zeros((n, n, n), dtype)
            heat = (jnp.zeros((n, n, n), dtype) if not cfg.isothermal
                    else jnp.zeros((), dtype))
        loss = jnp.zeros((), dtype)
        lls_loss = jnp.zeros((), dtype)
        pending = []   # (idx, device per-source losses) — synced by caller
        have_x = nfx_np is not None
        akey = assign.tobytes()
        for b, radius in enumerate(ladder):
            idx = np.where(assign == b)[0]
            if len(idx) == 0:
                continue
            win_ok = cfg.window_sweep and 2 * radius + 1 <= n - 1
            windowed = not self._custom_raytracer and win_ok
            if (self._custom_raytracer and self._windowed is not None
                    and win_ok
                    and self._windowed.supports(cfg, radius)):
                # sharded windowed bucket: O(r^3) subbox sweeps run
                # distributed (each device traces its source subset with
                # windows intact; one psum per bucket) — previously this
                # fell through to full-grid-staged sweeps
                ph, he, lo, ll, ps = self._windowed.sweep(
                    cfg, self.tables, radius, ndens, xh_av, lls_grid,
                    srcpos_np[idx], nflux_np[idx],
                    nfx_np[idx] if have_x else None, sc)
                phih = phih + ph
                if not cfg.isothermal:
                    heat = heat + he
                loss = loss + lo
                lls_loss = lls_loss + ll
                pending.append((idx, ps))
            elif self._custom_raytracer:
                # injected (sharded) raytracer: single call per bucket at
                # pow2 capacity — the raytracer owns source distribution
                # (parallel/source_shard.py shards + psums internally)
                cap = 1 << (len(idx) - 1).bit_length()
                pos_p, flux_p, fx_p = self._bucket_arrays(
                    akey, b, cap, idx, srcpos_np, nflux_np, nfx_np,
                    have_x)
                ph, he, lo, ll, ps = self._sweep_r(
                    ndens, xh_av, pos_p, flux_p, sc, lls_grid, fx_p,
                    max_shell=radius)
                phih = phih + ph
                if not cfg.isothermal:
                    heat = heat + he
                loss = loss + lo
                lls_loss = lls_loss + ll
                pending.append((idx, ps))
            elif windowed:
                prepass, chunk_fn = self._windowed_fns(radius)
                ndhi_pad, lls_pad = prepass(ndens, xh_av, lls_grid)
                chunk = self._window_chunk_size(radius)
                nchunk = -(-len(idx) // chunk)
                pos_p, flux_p, fx_p = self._bucket_arrays(
                    akey, b, nchunk * chunk, idx, srcpos_np, nflux_np,
                    nfx_np, have_x)
                acc, hacc = phih, heat
                parts = []
                for ci in range(nchunk):
                    sl = slice(ci * chunk, (ci + 1) * chunk)
                    acc, hacc, lo, ll, ps = chunk_fn(
                        ndhi_pad, lls_pad, pos_p[sl], flux_p[sl],
                        fx_p[sl] if have_x else None, sc, acc, hacc)
                    loss = loss + lo
                    lls_loss = lls_loss + ll
                    parts.append(ps)
                phih, heat = acc, hacc
                ps_all = (jnp.concatenate(parts) if len(parts) > 1
                          else parts[0])
                pending.append((idx, ps_all))
            else:
                # full-cube rung: fixed-capacity chunks through the
                # batched full sweep (shape-stable for the same reason)
                chunk = self._full_chunk_size()
                nchunk = -(-len(idx) // chunk)
                cap = nchunk * chunk
                pos_p, flux_p, fx_full = self._bucket_arrays(
                    akey, b, cap, idx, srcpos_np, nflux_np, nfx_np,
                    have_x)
                parts = []
                for ci in range(nchunk):
                    sl = slice(ci * chunk, (ci + 1) * chunk)
                    fx_c = fx_full[sl] if have_x else None
                    ph, he, lo, ll, ps = self._sweep_r(
                        ndens, xh_av, pos_p[sl], flux_p[sl], sc,
                        lls_grid, fx_c, max_shell=radius)
                    phih = phih + ph
                    if not cfg.isothermal:
                        heat = heat + he
                    loss = loss + lo
                    lls_loss = lls_loss + ll
                    parts.append(ps)
                ps_all = (jnp.concatenate(parts) if len(parts) > 1
                          else parts[0])
                pending.append((idx, ps_all))
        return phih, heat, loss, lls_loss, pending

    def _bucket_arrays(self, key, b, cap, idx, srcpos_np, nflux_np,
                       nfx_np, have_x):
        """Padded device source arrays for one bucket (cached across
        convergence iterations under the assignment key)."""
        ck, store = self._abucket_cache
        if ck != key:
            store = {}
            self._abucket_cache = (key, store)
        hit = store.get((b, cap))
        if hit is not None:
            return hit
        dtype = self.cfg.jnp_dtype
        pos_p = np.zeros((cap, 3), np.int32)
        flux_p = np.zeros(cap)
        pos_p[:len(idx)] = srcpos_np[idx]
        flux_p[:len(idx)] = nflux_np[idx]
        fx = None
        if have_x:
            fxh = np.zeros(cap)
            fxh[:len(idx)] = nfx_np[idx]
            fx = jnp.asarray(fxh, dtype)
        out = (jnp.asarray(pos_p), jnp.asarray(flux_p, dtype), fx)
        store[(b, cap)] = out
        return out

    def _promote(self, per_src, nflux_np, assign):
        """Escaping photons above loss_fraction of the source's output
        promote it to the next radius rung for the next convergence
        iteration (c2ray_parameters.f90:67, evolve_source.F90:128-136)."""
        ladder = self._radius_ladder()
        leaked = per_src > self.cfg.loss_fraction * np.maximum(nflux_np,
                                                               1e-300)
        return np.where(leaked & (assign < len(ladder) - 1),
                        assign + 1, assign)

    # ------------------------------------------------------------------
    def _loop_program(self, with_stats: bool, have_lls: bool,
                      have_x: bool, have_t: bool):
        """Jitted whole-convergence-loop program (lax.while_loop over
        [sweep -> fused tail]); cached per static signature."""
        key = (with_stats, have_lls, have_x, have_t)
        fn = self._loop_cache.get(key)
        if fn is not None:
            return fn
        cfg = self.cfg
        n_cells_f = float(cfg.n_cells)
        cf = cfg.convergence_fraction
        max_it = cfg.max_global_iterations
        k = 8 if with_stats else 4
        iso = cfg.isothermal

        def program(ndens, xh1, xh_av, xh_int, t_cur, t_av, t_int,
                    srcpos, nflux, nfx, sc, lls_grid, clump, dt_dev,
                    coeff_dev, conv_flag0, sum1_0, niter0, crit):
            dl = sum1_0.dtype
            S = srcpos.shape[0]
            n = cfg.mesh[0]
            dtype = ndens.dtype
            cube0 = jnp.zeros((n, n, n), dtype)
            heat0 = cube0 if not iso else jnp.zeros((), dtype)
            zt = jnp.zeros((), dtype)
            hist0 = jnp.zeros((max_it + 2, k), dl)
            big = jnp.asarray(2.0 * n_cells_f, dl)
            carry0 = (xh_int, xh_av,
                      t_int if have_t else zt, t_av if have_t else zt,
                      xh_int, xh_av,
                      t_int if have_t else zt, t_av if have_t else zt,
                      cube0, heat0, jnp.zeros((S,), dl),
                      big, big, sum1_0,
                      jnp.asarray(conv_flag0, dl), niter0,
                      jnp.asarray(0, jnp.int32), hist0)

            def cond(c):
                sum1 = c[13]
                sum0 = n_cells_f - sum1
                rel1 = jnp.where(sum1 > 0, jnp.abs(sum1 - c[11]) / sum1,
                                 jnp.ones((), sum1.dtype))
                rel0 = jnp.where(sum0 > 0, jnp.abs(sum0 - c[12]) / sum0,
                                 jnp.ones((), sum1.dtype))
                conv = (c[14] < crit.astype(c[14].dtype)) | \
                    ((rel1 < cf) & (rel0 < cf))
                return (~conv) & (c[15] <= max_it)

            def body(c):
                (xh_int, xh_av, t_int_c, t_av_c, _, _, _, _, _, _, _,
                 _, _, sum1, _, niter, it, hist) = c
                prev1 = sum1
                prev0 = n_cells_f - sum1
                phih, phiheat, ploss, llsl, psrc = self._rt_call(
                    ndens, xh_av, srcpos, nflux, sc, lls_grid,
                    nfx if have_x else None)
                (xh_int2, xh_av2, t_int2, t_av2, packed) = self._tail(
                    dt_dev, ndens, xh1, xh_int, xh_av, phih,
                    phiheat if not iso else None,
                    t_cur if have_t else None,
                    t_av_c if have_t else None,
                    clump, coeff_dev, sc, ploss, llsl,
                    with_stats=with_stats)
                hist2 = hist.at[it].set(packed)
                return (xh_int2, xh_av2,
                        t_int2 if have_t else t_int_c,
                        t_av2 if have_t else t_av_c,
                        xh_int, xh_av, t_int_c, t_av_c,
                        phih, phiheat if not iso else jnp.zeros((), dtype),
                        psrc.astype(dl),
                        prev1, prev0, packed[1], packed[0],
                        niter + 1, it + 1, hist2)

            final = lax.while_loop(cond, body, carry0)
            (xh_int_f, xh_av_f, t_int_f, t_av_f, xh_int_p, xh_av_p,
             t_int_p, t_av_p, phih_f, phiheat_f, psrc_f, prev1, prev0,
             sum1_f, convf, niter_f, it_f, hist_f) = final
            dlv = sum1_f.dtype
            scal = jnp.stack([sum1_f, convf, niter_f.astype(dlv),
                              it_f.astype(dlv), prev1, prev0])
            flat = jnp.concatenate([scal, hist_f.ravel(),
                                    psrc_f.astype(dlv)])
            return (xh_int_f, xh_av_f, t_int_f, t_av_f, xh_int_p,
                    xh_av_p, t_int_p, t_av_p, phih_f, phiheat_f, flat)

        fn = jax.jit(program)
        self._loop_cache[key] = fn
        return fn

    def _rt_call(self, ndens, xh_av, srcpos, nflux, sc, lls_grid, nfx):
        """Un-jitted sweep call (traced inside the device loop)."""
        from .ops.sweep import raytrace_all_sources
        rt = self._rt
        return rt(self.cfg, self.tables, ndens, xh_av, srcpos, nflux, sc,
                  lls_grid=lls_grid, nflux_xray=nfx)

    def _evolve_device_loop(self, cfg, state, ndens, dr_proper, srcpos,
                            nflux, nfx, sc, clump, lls_grid, dt_dev,
                            coeff_dev, dt, vol, xh1, xh_int, xh_av, t_cur,
                            t_av, t_int, niter0, conv_flag0, sum1_0,
                            conv_criterion, num_src, total_flux, stats,
                            with_stats, last_stat4, dumper, clocks,
                            photon_loss0, lls_loss0):
        """Whole-timestep device convergence loop + host-side replay of
        the per-iteration conservation reports and Timings stamps."""
        n_cells = cfg.n_cells
        k = 8 if with_stats else 4
        have_t = not cfg.isothermal
        prog = self._loop_program(with_stats, lls_grid is not None,
                                  nfx is not None, have_t)
        if sum1_0 is None:
            sum1_dev = self._sum(xh_int)
        else:
            sum1_dev = jnp.asarray(sum1_0, cfg.jnp_dtype)
        out = prog(ndens, xh1, xh_av, xh_int, t_cur, t_av, t_int,
                   srcpos, nflux,
                   nfx if nfx is not None else jnp.zeros_like(nflux),
                   sc, lls_grid, clump, dt_dev, coeff_dev,
                   jnp.asarray(conv_flag0, jnp.int32),
                   sum1_dev, jnp.asarray(niter0, jnp.int32),
                   jnp.asarray(conv_criterion, jnp.int32))
        (xh_int_f, xh_av_f, t_int_f, t_av_f, xh_int_p, xh_av_p,
         t_int_p, t_av_p, phih_f, phiheat_f, flat) = out

        got = np.asarray(flat)            # the ONE blocking fetch
        sum1 = float(got[0])
        conv_flag = int(got[1])
        niter = int(got[2])
        it_count = int(got[3])
        prev1, prev0 = float(got[4]), float(got[5])
        max_rows = cfg.max_global_iterations + 2
        hist = got[6:6 + max_rows * k].reshape(max_rows, k)
        psrc = got[6 + max_rows * k:].astype(np.float64)

        # host-side replay: per-iteration conservation reports + Timings
        # stamps, identical streams to the host-driven loop
        last_report = {}
        photon_loss, lls_loss = photon_loss0, lls_loss0
        stat4 = last_stat4
        for row in hist[:it_count]:
            photon_loss, lls_loss = float(row[2]), float(row[3])
            if with_stats:
                stat4 = tuple(float(v) for v in row[4:8])
                stats.calculate(GridCounts(stat4[0], stat4[1], 0.0, 0.0),
                                GridCounts(0.0, 0.0, stat4[2], stat4[3]),
                                vol, dt)
                last_report = stats.report(dt, photon_loss, lls_loss,
                                           total_flux)
        if clocks is not None:
            for i in range(niter - it_count + 1, niter + 1):
                clocks.stamp(f"Time after iteration {i}")

        # wall-clock iterdump (the dump carries the final iteration's
        # pre-chemistry iterates + rate grids, as in the host loop)
        if dumper is not None and it_count > 0:
            dumper.maybe_dump(niter, photon_loss, phih_f, xh_av_p,
                              xh_int_p,
                              phiheat_f if have_t else None,
                              t_int_p if have_t else None,
                              t_av_p if have_t else None)

        # final convergence classification (host replication of cond)
        sum0 = float(n_cells) - sum1
        rel1 = abs(sum1 - prev1) / sum1 if sum1 > 0 else 1.0
        rel0 = abs(sum0 - prev0) / sum0 if sum0 > 0 else 1.0
        converged = conv_flag < conv_criterion or (
            rel1 < cfg.convergence_fraction
            and rel0 < cfg.convergence_fraction)

        if stats is not None:
            if stat4 is None:
                ca = self._counts(ndens, xh_int_f, t_av_f if have_t
                                  else t_av, clump)
                cr = self._counts(ndens, xh_av_f, t_av_f if have_t
                                  else t_av, clump)
                stats.calculate(ca, cr, vol, dt)
            else:
                stats.calculate(GridCounts(stat4[0], stat4[1], 0.0, 0.0),
                                GridCounts(0.0, 0.0, stat4[2], stat4[3]),
                                vol, dt)
            last_report = stats.report(dt, photon_loss, lls_loss,
                                       total_flux)
            stats.update_grandtotal(dt, total_flux)

        new_state = GridState(
            xh1=xh_int_f,
            temper_current=t_int_f if have_t else None,
            temper_av=t_av_f if have_t else None,
            temper_intermed=t_int_f if have_t else None)
        per_src = psrc[:num_src]
        info = EvolveInfo(
            niter=niter, conv_flag=conv_flag, converged=converged,
            mean_xh1=sum1 / n_cells, photon_loss=photon_loss,
            lls_loss=lls_loss, per_source_loss=per_src,
            photon_stats=last_report, phih=phih_f,
            phiheat=phiheat_f if have_t else None)
        return new_state, info

    # ------------------------------------------------------------------
    def evolve3d(self, state: GridState, ndens_proper: jax.Array,
                 dr_proper: float, srcpos, nflux, dt: float,
                 clumping=1.0, lls_coldens: float = 0.0,
                 rmax_cells: float = 0.0, lls_grid=None,
                 cosmo_cool_coeff: float = 0.0,
                 stats: Optional[PhotonStatistics] = None,
                 dumper=None, iter_restart: Optional[dict] = None,
                 nflux_xray=None, verbose: bool = False, clocks=None):
        """One global timestep (evolve3D, evolve.F90:83-281).

        dumper: optional utils.checkpoint.IterDumper - writes the
        double-buffered 15-minute iteration dumps (evolve.F90:253-266).
        iter_restart: a dict from IterDumper.load to resume mid-iteration
        (start_from_dump, evolve.F90:328-426).
        """
        cfg = self.cfg
        n_cells = cfg.n_cells
        dtype = cfg.jnp_dtype
        vol = float(dr_proper) ** 3

        srcpos_np = np.asarray(srcpos, np.int64)
        nflux_np = np.asarray(nflux, np.float64)
        srcpos = jnp.asarray(srcpos, jnp.int32)
        nflux = jnp.asarray(nflux, dtype)
        num_src = int(srcpos.shape[0])
        use_xray = cfg.sed.use_xray_sed and nflux_xray is not None
        nfx_np = np.asarray(nflux_xray, np.float64) if use_xray else None
        nfx = jnp.asarray(nflux_xray, dtype) if use_xray else None
        radius_assign = None             # adaptive subbox state (per step)
        # the bucket-array cache is keyed by the assignment only — a new
        # timestep (new catalog) must invalidate it
        self._abucket_cache = (None, {})
        # auto: adaptive subbox radii for the many-source production regime
        # (evolve_source.F90:128-136; on request VERDICT r1 item 1)
        use_adaptive = (cfg.adaptive_sweep if cfg.adaptive_sweep is not None
                        else num_src >= cfg.adaptive_auto_min_sources)

        sc = SweepScalars(
            dr=jnp.asarray(dr_proper, dtype),
            rate_scale=jnp.asarray(cfg.sed.s_star / vol, dtype),
            lls_coldens=jnp.asarray(lls_coldens, dtype),
            rmax2_cells=jnp.asarray(rmax_cells * rmax_cells, dtype),
        )
        clump = (jnp.asarray(clumping, dtype)
                 if not isinstance(clumping, jax.Array) else clumping)

        # photon statistics: initial state (evolve.F90:136)
        if stats is not None:
            c0 = self._counts(ndens_proper, state.xh1, state.temper_av, clump)
            stats.state_before(c0, vol)

        # initialize iterates to the step-initial state (evolve.F90:140-153),
        # or resume from an iteration dump (:154-158)
        xh1 = state.xh1
        t_cur, t_av, t_int = (state.temper_current, state.temper_av,
                              state.temper_intermed)
        if iter_restart is not None:
            xh_av = jnp.asarray(iter_restart["xh_av"], dtype)
            xh_int = jnp.asarray(iter_restart["xh_intermed"], dtype)
            niter = int(iter_restart["niter"])
            # non-isothermal dumps also carry the mid-convergence
            # temperature iterates (start_from_dump restores the
            # temperature grid too, evolve.F90:328-426)
            if not cfg.isothermal and "temper" in iter_restart:
                t_int = jnp.asarray(iter_restart["temper"], dtype)
            if not cfg.isothermal and "temper_av" in iter_restart:
                t_av = jnp.asarray(iter_restart["temper_av"], dtype)
        else:
            xh_av = xh1
            xh_int = xh1
            niter = 0
        conv_flag = n_cells
        prev_sum1 = 2.0 * n_cells
        prev_sum0 = 2.0 * n_cells

        # conv_criterion (evolve.F90:162-163)
        conv_criterion = min(int(cfg.convergence_fraction * n_cells),
                             (num_src - 1) // 3)

        photon_loss = 0.0
        lls_loss = 0.0
        per_src_loss = np.zeros(num_src)
        converged = False
        last_report = {}
        last_stat4 = None        # floats from the last fused-tail fetch
        total_flux = float(nflux_np.sum())
        phih = None
        phiheat = None
        with_stats = stats is not None
        dt_dev = jnp.asarray(dt, dtype)
        coeff_dev = jnp.asarray(cosmo_cool_coeff, dtype)
        sum1 = None              # running total-ionized sum (host float)

        def _run_tail(ploss_dev, llsl_dev):
            """Dispatch the fused chemistry+audit+sum tail; returns the
            device handles without blocking."""
            return self._tail(dt_dev, ndens_proper, xh1, xh_int, xh_av,
                              phih, phiheat if not cfg.isothermal else None,
                              t_cur, t_av, clump, coeff_dev, sc, ploss_dev,
                              llsl_dev, with_stats=with_stats)

        def _apply_stat4(s4):
            # host-side float math from the tail's packed audit scalars
            stats.calculate(GridCounts(s4[0], s4[1], 0.0, 0.0),
                            GridCounts(0.0, 0.0, s4[2], s4[3]), vol, dt)

        # Pending global pass on resume: the dump is written after the
        # source sweep but *before* the chemistry pass (evolve.F90:253-269),
        # so start_from_dump restores the rate grids and photon loss and
        # runs the restored chemistry directly, with no redundant re-sweep
        # (evolve.F90:154-158 calls global_pass right after the restore).
        if iter_restart is not None and "phih" in iter_restart:
            phih = jnp.asarray(iter_restart["phih"], dtype)
            if not cfg.isothermal and "phiheat" in iter_restart:
                phiheat = jnp.asarray(iter_restart["phiheat"], dtype)
            photon_loss = float(iter_restart["photon_loss"])
            (xh_int, xh_av, t_int_d, t_av_d,
             packed) = _run_tail(jnp.asarray(photon_loss, dtype),
                                 jnp.asarray(0.0, dtype))
            if not cfg.isothermal:
                t_int, t_av = t_int_d, t_av_d
            got = np.asarray(packed)      # one D2H copy
            conv_flag = int(got[0])
            sum1 = float(got[1])
            if with_stats:
                last_stat4 = tuple(float(v) for v in got[4:8])
                _apply_stat4(last_stat4)
                last_report = stats.report(dt, photon_loss, lls_loss,
                                           total_flux)

        # ------------------------------------------------------------------
        # on-device convergence loop: in the non-adaptive regime the
        # whole [sweep -> fused tail] iteration runs as ONE
        # lax.while_loop program - a single host dispatch + fetch per
        # TIMESTEP instead of one round trip per iteration.
        # Per-iteration audit scalars come back in a history
        # buffer; the conservation reports and Timings stamps are
        # replayed host-side so the output streams are unchanged.
        # eligibility: adaptive sweeps re-bucket on the host; verbose
        # wants per-iteration prints; a dump due within the next minute
        # falls back to the host loop (which dumps per iteration), so
        # the 15-minute checkpoint cadence survives slow steps
        import time as _time
        dump_ok = (dumper is None or not getattr(dumper, "enabled", False)
                   or (_time.time() - dumper._last_wall)
                   < dumper.interval_s - 60.0)
        if dumper is not None and jax.process_count() > 1:
            # multi-process run: ranks near the interval threshold (or
            # with the dumper enabled on the I/O rank only) would
            # disagree on dump_ok and split between the device-loop and
            # host-loop programs, mismatching SPMD collectives — decide
            # on the I/O rank and broadcast (advisor round-4 finding)
            from .parallel import multihost as mh
            dump_ok = mh.broadcast_obj(dump_ok if mh.is_io_rank()
                                       else None)
        # timings_fidelity: the device loop's Timings stamps are replay
        # stamps (all written at loop exit) — when per-iteration
        # wall-clock fidelity is requested (the reference stamps real
        # elapsed time each iteration, evolve.F90:272-273), run the
        # host-driven loop instead
        fidelity_ok = clocks is None or not cfg.timings_fidelity
        # mesh cap: the loop program carries two full sets of iterates
        # plus the rate grids (~10 grid-size buffers beside the sweep's
        # own working set); larger meshes keep that state on the
        # host-driven loop, which holds one set at a time
        if (cfg.on_device_loop and not use_adaptive and not verbose
                and dump_ok and fidelity_ok
                and cfg.mesh[0] <= 512):
            return self._evolve_device_loop(
                cfg, state, ndens_proper, dr_proper, srcpos, nflux, nfx,
                sc, clump, lls_grid, dt_dev, coeff_dev, dt, vol,
                xh1, xh_int, xh_av, t_cur, t_av, t_int, niter,
                conv_flag, sum1, conv_criterion, num_src, total_flux,
                stats, with_stats, last_stat4, dumper, clocks,
                photon_loss, lls_loss)

        while True:
            # convergence tests (evolve.F90:179-233)
            if sum1 is None:
                sum1 = float(self._sum(xh_int))
            sum0 = float(n_cells) - sum1
            rel1 = abs(sum1 - prev_sum1) / sum1 if sum1 > 0.0 else 1.0
            rel0 = abs(sum0 - prev_sum0) / sum0 if sum0 > 0.0 else 1.0
            if verbose:
                print(f"  iter {niter}: conv_flag={conv_flag} "
                      f"rel_change=({rel1:.2e},{rel0:.2e}) mean_x={sum1/n_cells:.4e}")
            if conv_flag < conv_criterion or (
                    rel1 < cfg.convergence_fraction
                    and rel0 < cfg.convergence_fraction):
                xh1 = xh_int
                # set_final_temperature_point (temperature_module.F90:173-183)
                if not cfg.isothermal:
                    t_cur = t_int
                converged = True
                break
            if niter > cfg.max_global_iterations:
                # The reference abandons the step here, leaving xh at its
                # step-initial value (evolve.F90:227-233).  We instead commit
                # the best available iterate (flagged converged=False) -
                # strictly safer in the pathological few-source regime.
                xh1 = xh_int
                if not cfg.isothermal:
                    t_cur = t_int
                break

            prev_sum1, prev_sum0 = sum1, sum0
            niter += 1

            # pass over all sources (rates implicitly zeroed by functional
            # accumulation; evolve.F90:243-246).  Everything below up to
            # the device_get is async dispatch: the sweep, the fused
            # chemistry/audit tail, and the scalar reads cost ONE
            # dispatch+wait round trip per convergence iteration.
            pending = None
            if use_adaptive:
                if radius_assign is None:
                    nd_mean = float(jnp.mean(ndens_proper))
                    radius_assign = self._initial_radii(
                        nflux_np, nd_mean, float(dr_proper), dt)
                phih, phiheat, ploss_d, llsl_d, pending = \
                    self._adaptive_sweep(
                        ndens_proper, xh_av, srcpos_np, nflux_np, srcpos,
                        nflux, sc, lls_grid, radius_assign, nfx_np=nfx_np)
            else:
                phih, phiheat, ploss_d, llsl_d, psrc_d = self._sweep(
                    ndens_proper, xh_av, srcpos, nflux, sc, lls_grid, nfx)

            # pre-chemistry iterates, kept for the iteration dump below
            xh_av_pre, xh_int_pre = xh_av, xh_int
            t_int_pre, t_av_pre = t_int, t_av

            (xh_int, xh_av, t_int_d, t_av_d,
             packed) = _run_tail(ploss_d, llsl_d)
            if not cfg.isothermal:
                t_int, t_av = t_int_d, t_av_d

            # the single blocking fetch for this iteration: the tail's
            # packed scalar vector + the per-source losses, concatenated
            # into ONE buffer so exactly one D2H copy happens
            parts = ([ps.ravel().astype(packed.dtype) for _, ps in pending]
                     if use_adaptive
                     else [psrc_d.ravel().astype(packed.dtype)])
            got = np.asarray(jnp.concatenate([packed] + parts))
            conv_flag = int(got[0])
            sum1 = float(got[1])
            photon_loss = float(got[2])
            lls_loss = float(got[3])
            k = 4
            if with_stats:
                last_stat4 = tuple(float(v) for v in got[4:8])
                k = 8
            if use_adaptive:
                per_src_loss = np.zeros(num_src)
                for idx, ps in pending:
                    m = int(ps.shape[0])
                    per_src_loss[idx] = got[k:k + m][:len(idx)]
                    k += m
                radius_assign = self._promote(per_src_loss, nflux_np,
                                              radius_assign)
            else:
                m = int(psrc_d.shape[0])
                per_src_loss = got[k:k + m].astype(np.float64)

            # wall-clock-driven double-buffered dump: carries the
            # POST-sweep PRE-chemistry iterates + rate grids
            # (evolve.F90:253-266), so a resume re-enters at the pending
            # global pass.  (Called after the fetch only so photon_loss
            # is a host float; the dumped content is identical.)
            if dumper is not None:
                dumper.maybe_dump(niter, photon_loss, phih, xh_av_pre,
                                  xh_int_pre,
                                  phiheat if not cfg.isothermal else None,
                                  t_int_pre if not cfg.isothermal else None,
                                  t_av_pre if not cfg.isothermal else None)

            # per-iteration conservation report (global_pass :570-571)
            if with_stats:
                _apply_stat4(last_stat4)
                last_report = stats.report(dt, photon_loss, lls_loss,
                                           total_flux)
            # per-iteration Timings.log stamp (the reference stamps the
            # timefile every convergence iteration, evolve.F90:272-273)
            if clocks is not None:
                clocks.stamp(f"Time after iteration {niter}")

        # end-of-step statistics (evolve.F90:277-279).  The final state
        # equals the last iteration's post-chemistry iterates, so the
        # audit scalars from the last fused tail ARE the end-of-step
        # counts — no extra device pass needed.
        if stats is not None:
            if last_stat4 is None:
                # no tail ran this call (immediate convergence)
                ca = self._counts(ndens_proper, xh1, t_av, clump)
                cr = self._counts(ndens_proper, xh_av, t_av, clump)
                stats.calculate(ca, cr, vol, dt)
            else:
                _apply_stat4(last_stat4)
            last_report = stats.report(dt, photon_loss, lls_loss, total_flux)
            stats.update_grandtotal(dt, total_flux)

        if sum1 is None:
            sum1 = float(self._sum(xh1))
        new_state = GridState(xh1=xh1, temper_current=t_cur,
                              temper_av=t_av, temper_intermed=t_int)
        info = EvolveInfo(
            niter=niter, conv_flag=conv_flag, converged=converged,
            mean_xh1=sum1 / n_cells,
            photon_loss=photon_loss, lls_loss=lls_loss,
            per_source_loss=per_src_loss, photon_stats=last_report,
            phih=phih, phiheat=phiheat if not cfg.isothermal else None)
        return new_state, info
