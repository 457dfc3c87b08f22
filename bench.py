"""Headline benchmark: cell x source ray-sweep updates/s per chip.

Measures the throughput of the framework's hot path - the per-source
wavefront sweep (ops/sweep.py), which subsumes the reference's
do_source/evolve0D/cinterp/photoion_rates inner loops
(evolve_source.F90 + evolve_point.F90 + column_density.f90 +
radiation_photoionrates.F90).

One cell x source "update" = the full per-cell work of evolve0D: the
4-corner short-characteristics interpolation, column accumulation,
photon-conserving table lookups and rate deposition.  At the default
256^3 with a full-grid sweep a single source is 16.8M updates.

Baseline: the reference publishes no numbers (BASELINE.md).  We anchor
vs_baseline to an optimistic 1e7 updates/s for one CPU core of the
serial Fortran sweep (typical short-characteristics per-core rates),
so vs_baseline = chip throughput / one reference core.

Usage: python bench.py [--mesh 256] [--sources 4] [--iters 3] [--quick]
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
with the device it ran on.  It needs a GPU; `--cpu` runs the same code on
the CPU for a functional check and reports every device metric as
"not measured".
"""

import argparse
import json
import sys
import time

import numpy as np


REFERENCE_CORE_UPDATES_PER_S = 1.0e7
# the anchor is ASSUMED, not measured: no Fortran compiler exists on this
# image (BENCH_HISTORY.md), so vs_baseline is throughput / an optimistic
# 1e7 updates/s serial-Fortran core, labeled as such in the JSON
BASELINE_NOTE = "assumed 1e7 updates/s per serial Fortran core (no compiler on image; not measured)"
# Published device-memory bandwidth, keyed by jax device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM form factor
# (80 GB HBM3, 3.35 TB/s).
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}
NOT_MEASURED = "not measured"


def peak_hbm_gbps(device_kind: str) -> float:
    """Published memory bandwidth of `device_kind`; an unknown device is
    an error, never a default."""
    try:
        return HBM_PEAK_GBPS[device_kind]
    except KeyError:
        raise ValueError(f"no published peak for device_kind "
                         f"{device_kind!r}; add it to HBM_PEAK_GBPS "
                         f"with its source") from None


def device_info(cpu: bool) -> dict:
    """Platform, device_kind and count of the devices JAX sees.  Without
    `cpu` anything but a GPU is an error: a measurement never falls back
    to the CPU."""
    import jax
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if not cpu and info["platform"] != "gpu":
        raise SystemExit(f"bench.py needs a GPU, found {info}; "
                         f"pass --cpu for a functional CPU run")
    print(f"# device platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", file=sys.stderr)
    return info


def roofline(device_kind: str, bytes_moved: float, elapsed_s: float):
    """Achieved device-memory bandwidth and peak fraction for a pass.

    bytes_moved is an ALGORITHMIC LOWER BOUND (compulsory traffic of the
    pass), so the fraction understates true utilization; it is the
    honest complement to the assumed vs_baseline anchor."""
    gbps = bytes_moved / elapsed_s / 1e9
    return gbps, gbps / peak_hbm_gbps(device_kind)


def _setup_jax(args):
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from c2ray_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    return device_info(args.cpu)


def full_step_bench(args):
    """Time the complete global timestep (Evolve3D.evolve3d): source sweep
    + global chemistry pass + photon-statistics audit + the host-driven
    convergence loop's sync points.

    This is the reference's unit of work (evolve.F90:83-281 is called once
    per timestep); the headline sweep metric above covers only the
    raytracing pass.  Reported metric: grid-cell convergence-iterations/s
    = N^3 * niter / wall, with a phase breakdown on stderr.
    """
    dev = _setup_jax(args)
    import jax
    import jax.numpy as jnp

    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.ops.photonstats import PhotonStatistics
    from c2ray_tpu.ops.tables import build_rad_tables
    from c2ray_tpu.solver import Evolve3D
    from c2ray_tpu.state import initial_state

    n = args.mesh
    backend = args.backend
    batch = args.batch if args.batch else min(args.sources, 256)
    cfg = test_problem_config(mesh=n, dtype="float32", use_lls=True,
                              type_of_lls=1, cosmological=False,
                              sweep_backend=backend, source_batch=batch,
                              isothermal=not args.non_isothermal)
    tables = build_rad_tables(cfg)

    rng = np.random.default_rng(0)
    srcpos = rng.integers(0, n, (args.sources, 3)).astype(np.int32)
    # same flux range as the sweep bench so the two metrics compare
    nflux = (10.0 ** rng.uniform(6, 9, args.sources)).astype(np.float64)

    nh = 1.98e-4                       # mean density at z~9 [cm^-3]
    ndens = jnp.full(cfg.mesh, np.float32(nh))
    dr = 2.9e24 / (n / 64)
    # dt ~ a Myr: the reference's typical z-slice substep
    dt = 3.0e13

    if args.non_isothermal:
        from c2ray_tpu.ops.thermal import setup_cool
        solver = Evolve3D(cfg, tables, cool=setup_cool(cfg))
    else:
        solver = Evolve3D(cfg, tables)
    state = initial_state(cfg)
    # half-ionized medium (as in the sweep bench): the chemistry pass
    # relaxes toward equilibrium each step instead of a one-shot flash
    state = state._replace(xh1=jnp.asarray(
        rng.uniform(0.3, 0.9, cfg.mesh).astype(np.float32)))
    stats = PhotonStatistics(cfg)

    # warmup step: compiles sweep buckets + chemistry + counts
    t0 = time.time()
    state_w, info_w = solver.evolve3d(state, ndens, dr, srcpos, nflux, dt,
                                      lls_coldens=1e17, stats=stats)
    compile_s = time.time() - t0

    times, niters = [], []
    for _ in range(args.iters):
        t0 = time.time()
        state, info = solver.evolve3d(state, ndens, dr, srcpos, nflux, dt,
                                      lls_coldens=1e17, stats=stats)
        times.append(time.time() - t0)
        niters.append(info.niter)
    elapsed = float(np.sum(times))
    total_iters = int(np.sum(niters))
    per_iter = elapsed / max(total_iters, 1)
    rate = cfg.n_cells * total_iters / elapsed
    # steady state: the last benched step's per-iteration wall — by then
    # every rung/chunk program is compiled and the bucket-array cache is
    # warm, so this is the sustained production figure (the average
    # above amortizes one-time compiles; VERDICT r4 item 7)
    steady_per_iter = times[-1] / max(niters[-1], 1)

    # phase breakdown: time the fused tail (chemistry + audit counts +
    # convergence sum — the program the solver loop actually runs) warm
    import jax as _jax
    from c2ray_tpu.ops.sweep import SweepScalars
    sc_phih = info.phih
    sc_t = SweepScalars(dr=jnp.float32(dr), rate_scale=jnp.float32(1.0),
                        lls_coldens=jnp.float32(0.0),
                        rmax2_cells=jnp.float32(0.0))
    tail_args = (jnp.float32(dt), ndens, state.xh1, state.xh1, state.xh1,
                 sc_phih,
                 info.phiheat if args.non_isothermal else None,
                 state.temper_current, state.temper_av,
                 jnp.float32(1.0), jnp.float32(0.0), sc_t,
                 jnp.float32(0.0), jnp.float32(0.0))
    _jax.block_until_ready(solver._tail(*tail_args, with_stats=True))
    t0 = time.time()
    _jax.block_until_ready(solver._tail(*tail_args, with_stats=True))
    chem_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    c = solver._counts(ndens, state.xh1, state.temper_av, jnp.float32(1.0))
    _jax.block_until_ready(c)
    counts_ms = (time.time() - t0) * 1e3

    measured = not args.cpu
    print(json.dumps({
        "metric": f"full_timestep_cell_iters_per_s_{n}cube",
        "value": rate if measured else NOT_MEASURED,
        "unit": "cell*conv_iters/s/chip",
        "vs_baseline": (rate / REFERENCE_CORE_UPDATES_PER_S if measured
                        else NOT_MEASURED),
        "baseline": BASELINE_NOTE,
        "steady_ms_per_conv_iter": (steady_per_iter * 1e3 if measured
                                    else NOT_MEASURED),
        "device": dev,
    }))
    print(f"# FULL STEP mesh={n}^3 sources={args.sources} "
          f"steps={args.iters} total_iters={total_iters} "
          f"step={elapsed/args.iters*1e3:.0f} ms "
          f"per_conv_iter={per_iter*1e3:.1f} ms "
          f"steady={steady_per_iter*1e3:.1f} ms "
          f"fused_tail={chem_ms:.1f} ms counts={counts_ms:.1f} ms "
          f"compile+first_step={compile_s:.1f}s "
          f"mean_x={info.mean_xh1:.4f} "
          f"platform={dev['platform']} backend={backend}",
          file=sys.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, default=256)
    ap.add_argument("--sources", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="64^3 single-source smoke benchmark")
    ap.add_argument("--cpu", action="store_true",
                    help="functional run on the CPU (device metrics are "
                         "reported as not measured)")
    ap.add_argument("--max-shell", type=int, default=None,
                    help="cap sweep radius (subbox analogue)")
    ap.add_argument("--bucket", type=int, default=0,
                    help="shell bucket width (0 = single full-plane loop)")
    ap.add_argument("--batch", type=int, default=0,
                    help="source batch size (0 = all sources in one vmap batch)")
    ap.add_argument("--backend", default="facemajor",
                    choices=("facemajor", "grid"),
                    help="wavefront march backend")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of the timed "
                         "iterations to DIR")
    ap.add_argument("--non-isothermal", action="store_true",
                    help="(--full-step) heating tables + thermal subcycle "
                         "+ temperature states on the grid")
    ap.add_argument("--full-step", action="store_true",
                    help="benchmark the complete Evolve3D timestep "
                         "(sweep + chemistry + stats + host syncs) "
                         "instead of the sweep pass alone")
    args = ap.parse_args()
    if args.quick:
        args.mesh, args.sources, args.iters = 64, 4, 2
    if args.full_step:
        return full_step_bench(args)

    dev = _setup_jax(args)
    import jax
    import jax.numpy as jnp

    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.ops.sweep import SweepScalars, raytrace_all_sources
    from c2ray_tpu.ops.tables import build_rad_tables

    n = args.mesh
    backend = args.backend
    windowed = (args.max_shell is not None
                and 2 * args.max_shell + 1 <= n - 1)
    if args.batch:
        batch = args.batch
    elif windowed:
        # windowed sweeps: batch bounded so a batch of (2r+1)^3 windows
        # stays comfortably in HBM even at 10^4+ sources
        batch = min(args.sources, 256)
    else:
        batch = args.sources
    cfg = test_problem_config(mesh=n, dtype="float32", use_lls=True,
                              type_of_lls=1, cosmological=False,
                              shell_bucket_size=args.bucket,
                              sweep_backend=backend,
                              source_batch=batch)
    tables = build_rad_tables(cfg)

    rng = np.random.default_rng(0)
    srcpos = jnp.asarray(rng.integers(0, n, (args.sources, 3)), jnp.int32)
    nflux = jnp.asarray(10.0 ** rng.uniform(6, 9, args.sources), jnp.float32)
    # half-ionized medium: tables exercised across the thin/thick range
    ndens = jnp.full(cfg.mesh, np.float32(1.98e-4))
    xh_av = jnp.asarray(rng.uniform(0.3, 0.9, cfg.mesh).astype(np.float32))

    dr = 2.9e24 / (n / 64)
    sc = SweepScalars(dr=jnp.float32(dr),
                      rate_scale=jnp.float32(cfg.sed.s_star / dr**3),
                      lls_coldens=jnp.float32(1e17),
                      rmax2_cells=jnp.float32(0.0))

    @jax.jit
    def sweep(ndens, xh_av, srcpos, nflux, sc):
        return raytrace_all_sources(cfg, tables, ndens, xh_av, srcpos,
                                    nflux, sc, max_shell=args.max_shell)

    # warmup/compile
    t0 = time.time()
    out = sweep(ndens, xh_av, srcpos, nflux, sc)
    jax.block_until_ready(out)
    compile_s = time.time() - t0

    if args.profile:
        prof = jax.profiler.trace(args.profile)
        prof.__enter__()
    t0 = time.time()
    for _ in range(args.iters):
        out = sweep(ndens, xh_av, srcpos, nflux, sc)
    jax.block_until_ready(out)
    elapsed = (time.time() - t0) / args.iters
    if args.profile:
        prof.__exit__(None, None, None)

    shells = args.max_shell if args.max_shell else n // 2
    if shells >= n // 2:
        cells_per_source = n**3
    else:
        cells_per_source = min(n, 2 * shells + 1) ** 3
    updates = cells_per_source * args.sources
    rate = updates / elapsed

    # compulsory HBM traffic per source: read the staged neutral-density
    # cube twice (march + rate pass), write + read the column cube, and
    # update the shared rate grid (amortized r+w per batch ~ 2/sources):
    # ~4 cube-passes of 4 B/cell per source, a LOWER bound (staging
    # copies, transposes and LLS planes add real traffic on top)
    itemsize = 4
    bytes_moved = 4 * cells_per_source * args.sources * itemsize

    if args.cpu:
        print(json.dumps({
            "metric": f"cell_source_sweep_updates_per_s_{n}cube",
            "value": NOT_MEASURED, "unit": "updates/s/chip",
            "vs_baseline": NOT_MEASURED, "baseline": BASELINE_NOTE,
            "achieved_gbps_lower_bound": NOT_MEASURED,
            "hbm_peak_fraction": NOT_MEASURED, "device": dev}))
        print(f"# mesh={n}^3 sources={args.sources} functional CPU run "
              f"(compile+first call {compile_s:.1f}s, not a device "
              f"measurement)", file=sys.stderr)
        return
    gbps, frac = roofline(dev["kind"], bytes_moved, elapsed)
    print(json.dumps({
        "metric": f"cell_source_sweep_updates_per_s_{n}cube",
        "value": rate,
        "unit": "updates/s/chip",
        "vs_baseline": rate / REFERENCE_CORE_UPDATES_PER_S,
        "baseline": BASELINE_NOTE,
        "achieved_gbps_lower_bound": gbps,
        "hbm_peak_fraction": frac,
        "device": dev,
    }))
    print(f"# mesh={n}^3 sources={args.sources} sweep={elapsed*1e3:.3f} ms "
          f"compile={compile_s:.1f}s platform={dev['platform']} "
          f"backend={backend} roofline>={gbps:.1f} GB/s "
          f"({100*frac:.2f}% of {peak_hbm_gbps(dev['kind']):.0f} GB/s)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
