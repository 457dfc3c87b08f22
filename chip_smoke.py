#!/usr/bin/env python3
"""Bring-up check of the C2-Ray solver on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the multi-device layouts only

Run from the repository root.  There is no CPU fallback: without a GPU the
script exits non-zero before any phase.  One process drives every device.

Phases (one GPU):
  golden      the bundled f64 goldens (tests/fixtures/golden_*.npz) in f64
              on the device (xh1 and T within rtol 1e-9, identical niter),
              then in f32 with expsum rates (mean x and ionized volume
              within rel 2e-3)
  march       256^3 f32, 16 sources: batched facemajor vs single-source,
              the grid backend vs facemajor, windowed r=8 vs the capped
              full cube; each with type-1 and type-2 LLS (max rel phih
              < 1e-5 on cells above 1e-12 max, LLS loss within rel 1e-4)
  main        `python -m c2ray_tpu examples/input_test.in --mesh 256` with
              the bundled 10-source catalog, one slice of 10 timesteps,
              through c2ray_tpu.__main__.main: every timestep converged,
              |1 - photcons| <= 0.15, outputs written
  production  one Evolve3D timestep at 512^3 f32 with 10^4 seeded sources
              over three decades of flux (adaptive windowed sweeps) and
              type-1 LLS: converged, |1 - photcons| <= 0.15
  thermal     three successive non-isothermal 256^3 timesteps of 16 bright
              sources (normalized flux 1e6-1e9) from a partly ionized start
              (xh1 uniform in 0.3-0.9), type-1 LLS, each through the
              on-device convergence loop, f32 against f64: mean x within
              rel 1e-3, and p99 |dx| < 5e-3 and p99 rel dT < 5e-3 both over
              the whole cube and over the lit cells (photoionization rate
              times dt above 1e-3; at least 1000 of them)

`--four` runs the bundled 10-source problem for one 1-Myr timestep (the
first timestep of examples/input_test.in) through C2RayDriver under
`layout=src` and `layout=halo` with 4 domain devices, and compares each
with the one-device `layout=none` run on device 0:
  float64 at 512^3  every run converged, xh1 within rel 1e-5 (the layouts
                    differ only in psum order)
  float32 at 256^3  every run converged; mean x within rel 1e-3.  The
                    largest per-cell difference is printed, not bounded:
                    psum order shifts a cell's float32 iterate by ~1e-7 and
                    the global convergence test can then stop one layout an
                    iteration before another.

Each phase prints its compile and steady seconds (compile = XLA's
backend-compile time inside the phase, as JAX reports it; steady = the
rest of the phase's wall time, tracing included), niter, photon
conservation and the process's peak device memory so far.  The
last line of stdout is {"ok": true, "device": {...}}; a failed phase
makes the script exit 1 without it.

The sweep pass and the production step are also the workloads that
scripts/trace_bringup.py traces (`sweep_inputs`, `sweep_pass`,
`production_step`).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
WORKDIR = os.path.join(REPO, "results", "chip_smoke")

# the frozen golden problem (must match scripts/make_goldens.py)
NH = 1.98e-4
ZRED = 9.0


class PhaseFailure(AssertionError):
    pass


def check(ok: bool, msg: str) -> None:
    print(f"    {'ok  ' if ok else 'FAIL'} {msg}", flush=True)
    if not ok:
        raise PhaseFailure(msg)


def require_gpu() -> dict:
    """Platform, device_kind and count of JAX's devices; anything but a
    GPU is an error."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"chip_smoke.py needs a GPU; JAX found "
                           f"{len(devs)} {devs[0].platform} device(s)")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi() -> str:
    """Card name and power limit, read by a child process that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# per-phase accounting
# ---------------------------------------------------------------------------
# backend compiles never nest, unlike the tracing events of jitted
# functions that call other jitted functions, so their sum is exact
_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event == _COMPILE_EVENT:
        _compile_s[0] += duration


class Phase:
    """Times one phase and prints its summary line."""

    def __init__(self, name: str):
        self.name = name
        self.niter = "n/a"
        self.photcons = "n/a"

    def __enter__(self):
        print(f"[{self.name}]", flush=True)
        self.c0 = _compile_s[0]
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import jax
        wall = time.perf_counter() - self.t0
        comp = _compile_s[0] - self.c0
        peak = (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use")
        print(f"  {self.name}: compile_s={comp:.3f} "
              f"steady_s={wall - comp:.3f} niter={self.niter} "
              f"photcons={self.photcons} peak_bytes_in_use={peak}",
              flush=True)
        return False


@contextlib.contextmanager
def x64(on: bool):
    import jax
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# golden parity
# ---------------------------------------------------------------------------
def run_fixture(cfg, src_file, steps=1, **evolve_kw):
    """One source fixture through Evolve3D (tests/test_golden.py)."""
    import jax.numpy as jnp

    from c2ray_tpu import constants as const
    from c2ray_tpu.models.sources import SourceModel, read_source_file
    from c2ray_tpu.ops.photonstats import PhotonStatistics
    from c2ray_tpu.ops.tables import build_rad_tables
    from c2ray_tpu.ops.thermal import setup_cool
    from c2ray_tpu.solver import Evolve3D
    from c2ray_tpu.state import initial_state

    solver = Evolve3D(cfg, build_rad_tables(cfg),
                      cool=None if cfg.isothermal else setup_cool(cfg))
    rows = read_source_file(os.path.join(FIXDIR, src_file))
    state = initial_state(cfg)
    cat = SourceModel.from_recipe(cfg, 7).load(rows, np.asarray(state.xh1),
                                               0, cfg.lifetime)
    n = cfg.mesh[0]
    ndens = jnp.full((n, n, n), NH, cfg.jnp_dtype)
    dr = cfg.dr_comoving / (1.0 + ZRED)
    stats = PhotonStatistics(cfg)
    infos = []
    for _ in range(steps):
        state, info = solver.evolve3d(state, ndens, dr, cat.srcpos,
                                      cat.normflux_stellar,
                                      1e7 * const.YEAR, stats=stats,
                                      **evolve_kw)
        infos.append(info)
    return state, infos


GOLDENS = (
    # (golden file, mesh, source file, steps, thermal)
    ("golden_onesrc_100.npz", 100, "test_sources_onesrc.dat", 1, False),
    ("golden_standard_100.npz", 100, "test_sources_standard.dat", 1, False),
    ("golden_thermal_32.npz", 32, "test_sources_onesrc_32.dat", 2, True),
)


def phase_golden():
    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.models.lls import set_lls

    for fname, n, src, steps, thermal in GOLDENS:
        g = np.load(os.path.join(FIXDIR, fname))
        for dtype in ("float64", "float32"):
            kw = dict(mesh=n, dtype=dtype, use_lls=False,
                      cosmological=False,
                      rate_eval="table" if dtype == "float64" else "expsum")
            if thermal:
                kw.update(isothermal=False, use_lls=True, type_of_lls=1,
                          lls_model=5, initial_temperature=100.0)
            with Phase(f"golden {fname} {dtype}") as ph, \
                    x64(dtype == "float64"):
                cfg = test_problem_config(**kw)
                ekw = {}
                if thermal:
                    lls = set_lls(cfg, ZRED, cfg.dr_comoving / (1.0 + ZRED))
                    ekw["lls_coldens"] = lls.coldensh_lls
                state, infos = run_fixture(cfg, src, steps, **ekw)
                ph.niter = [i.niter for i in infos]
                ph.photcons = infos[-1].photon_stats.get("photon_cons")
                x = np.asarray(state.xh1, np.float64)
                if dtype == "float64":
                    dx = np.max(np.abs(x - g["xh1"]) / np.abs(g["xh1"]))
                    check(dx <= 1e-9, f"xh1 max rel diff {dx:.3e} <= 1e-9")
                    if thermal:
                        t = np.asarray(state.temper_current, np.float64)
                        dt = np.max(np.abs(t - g["temper"]) / g["temper"])
                        check(dt <= 1e-9, f"T max rel diff {dt:.3e} <= 1e-9")
                    want = [int(v) for v in g["niters"][:steps]]
                    check(ph.niter == want, f"niter {ph.niter} == {want}")
                else:
                    dm = rel(infos[-1].mean_xh1, float(g["mean_xh1"][-1]))
                    dv = rel(x.sum(), float(g["xh1"].sum()))
                    check(dm <= 2e-3, f"mean_xh1 rel diff {dm:.3e} <= 2e-3")
                    check(dv <= 2e-3, f"ionized volume rel diff {dv:.3e} "
                                      f"<= 2e-3")


# ---------------------------------------------------------------------------
# the sweep pass (march cross-check; traced by scripts/trace_bringup.py)
# ---------------------------------------------------------------------------
def sweep_inputs(n=256, s=16) -> dict:
    """Seeded f32 inputs of one sweep pass: s sources of normalized flux
    1e6-1e9 in an n^3 cube of partly ionized gas, and a type-2 LLS
    column grid."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    return dict(
        n=n,
        srcpos=jnp.asarray(rng.integers(0, n, (s, 3)), jnp.int32),
        nflux=jnp.asarray(10.0 ** rng.uniform(6, 9, s), jnp.float32),
        ndens=jnp.full((n, n, n), np.float32(NH)),
        xh_av=jnp.asarray(rng.uniform(0.3, 0.9, (n, n, n))
                          .astype(np.float32)),
        lls_cube=jnp.asarray((rng.uniform(0.0, 1.0, (n, n, n)) * 3e16)
                             .astype(np.float32)),
        dr=2.9e24 / (n / 64))


def sweep_pass(inp: dict, lls_type=1, backend="facemajor", batch=None,
               max_shell=None, window=False):
    """The jitted full sweep pass (raytrace_all_sources) over `inp` and
    its arguments; batch defaults to every source in one batch."""
    import jax
    import jax.numpy as jnp

    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.ops.sweep import SweepScalars, raytrace_all_sources
    from c2ray_tpu.ops.tables import build_rad_tables

    n, dr = inp["n"], inp["dr"]
    cfg = test_problem_config(
        mesh=n, dtype="float32", use_lls=True, type_of_lls=lls_type,
        cosmological=False, window_sweep=window, sweep_backend=backend,
        source_batch=batch or int(inp["srcpos"].shape[0]))
    tables = build_rad_tables(cfg)
    sc = SweepScalars(dr=jnp.float32(dr),
                      rate_scale=jnp.float32(cfg.sed.s_star / dr ** 3),
                      lls_coldens=jnp.float32(1e17 if lls_type == 1
                                              else 0.0),
                      rmax2_cells=jnp.float32(0.0))
    lg = inp["lls_cube"] if lls_type == 2 else None
    f = jax.jit(lambda nd, xa, sp, nf: raytrace_all_sources(
        cfg, tables, nd, xa, sp, nf, sc, lls_grid=lg, max_shell=max_shell))
    return f, (inp["ndens"], inp["xh_av"], inp["srcpos"], inp["nflux"])


def phase_march(n=256, s=16, r=8):
    import jax

    inp = sweep_inputs(n, s)

    def run(lls_type, **kw):
        f, args = sweep_pass(inp, lls_type, **kw)
        phih, _, loss, lls_loss, _ = jax.block_until_ready(f(*args))
        return np.asarray(phih, np.float64), float(loss), float(lls_loss)

    def compare(tag, got, ref):
        phih, _, lls = got
        ref_phih, _, ref_lls = ref
        mask = ref_phih > ref_phih.max() * 1e-12
        worst = float(np.max(np.abs(phih - ref_phih)[mask]
                             / np.abs(ref_phih)[mask]))
        check(worst < 1e-5, f"{tag}: max rel phih {worst:.3e} < 1e-5")
        d = rel(lls, ref_lls)
        check(d < 1e-4, f"{tag}: LLS loss rel {d:.3e} < 1e-4")

    for lls_type in (1, 2):
        with Phase(f"march {n}^3 b={s} lls_type={lls_type}"):
            ref = run(lls_type, batch=1)
            compare(f"facemajor b={s} vs b=1", run(lls_type), ref)
            compare(f"grid b={s} vs facemajor b=1",
                    run(lls_type, backend="grid"), ref)
            cap = run(lls_type, max_shell=r)
            compare(f"windowed r={r} vs capped full cube",
                    run(lls_type, max_shell=r, window=True), cap)


# ---------------------------------------------------------------------------
# main path through the CLI entry point
# ---------------------------------------------------------------------------
def read_run_log(results_dir):
    """(niter, converged, photcons) per timestep from the run log
    (C2Ray.log)."""
    steps = []
    with open(os.path.join(results_dir, "C2Ray.log")) as f:
        for line in f:
            if "niter=" not in line:
                continue
            kv = dict(tok.split("=", 1) for tok in line.split()
                      if "=" in tok)
            steps.append((int(kv["niter"]), kv["converged"] == "True",
                          float(kv["photcons"])))
    return steps


def fresh_run_dir(name):
    """An empty results directory holding the bundled 10-source catalog
    (1e54-1e57 photons/s)."""
    out = os.path.join(WORKDIR, name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    shutil.copy(os.path.join(FIXDIR, "test_sources_standard.dat"),
                os.path.join(out, "test_sources.dat"))
    return out


def check_run(out, nsteps, ph):
    steps = read_run_log(out)
    ph.niter = [s[0] for s in steps]
    ph.photcons = [s[2] for s in steps]
    check(len(steps) == nsteps, f"{len(steps)} timesteps == {nsteps}")
    check(all(s[1] for s in steps), "every timestep converged")
    worst = max(abs(1.0 - s[2]) for s in steps)
    check(worst <= 0.15, f"max |1 - photcons| {worst:.4f} <= 0.15")
    for pat in ("xfrac3D_*.bin", "PhotonCounts.out", "Timings.log"):
        hit = glob.glob(os.path.join(out, pat))
        check(bool(hit) and os.path.getsize(hit[0]) > 0,
              f"{pat} written")


def phase_main(mesh=256):
    from c2ray_tpu.__main__ import main

    with Phase(f"main {mesh}^3 10 sources, 10 timesteps") as ph:
        out = fresh_run_dir("main")
        rc = main([os.path.join(REPO, "examples", "input_test.in"),
                   "--mesh", str(mesh), "--dtype", "float32",
                   "--source-dir", out + "/", "--results-dir", out + "/",
                   "--max-slices", "1"])
        check(rc == 0, f"main() returned {rc}")
        check_run(out, 10, ph)


# ---------------------------------------------------------------------------
# production regime: 10^4 sources, adaptive windowed sweeps
# ---------------------------------------------------------------------------
def production_step(n=512, s=10_000):
    """A callable that runs one Evolve3D timestep of the production
    regime from a fresh state and returns its EvolveInfo: n^3 f32, s
    seeded sources of 1e51-1e54 photons/s, type-1 LLS, adaptive windowed
    sweeps (their default at >= 32 sources)."""
    import jax.numpy as jnp

    from c2ray_tpu import constants as const
    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.models.lls import set_lls
    from c2ray_tpu.ops.photonstats import PhotonStatistics
    from c2ray_tpu.ops.tables import build_rad_tables
    from c2ray_tpu.solver import Evolve3D
    from c2ray_tpu.state import initial_state

    cfg = test_problem_config(mesh=n, dtype="float32", use_lls=True,
                              type_of_lls=1, cosmological=False,
                              source_batch=256)
    solver = Evolve3D(cfg, build_rad_tables(cfg))
    rng = np.random.default_rng(1)
    srcpos = rng.integers(0, n, (s, 3)).astype(np.int32)
    nflux = 10.0 ** rng.uniform(3.0, 6.0, s)
    dr = cfg.dr_comoving / (1.0 + ZRED)
    lls = set_lls(cfg, ZRED, dr)
    ndens = jnp.full(cfg.mesh, np.float32(NH))

    def step():
        _, info = solver.evolve3d(
            initial_state(cfg), ndens, dr, srcpos, nflux, 1e6 * const.YEAR,
            lls_coldens=lls.coldensh_lls, stats=PhotonStatistics(cfg))
        return info

    return step


def phase_production(n=512, s=10_000):
    with Phase(f"production {n}^3 {s} sources windowed") as ph:
        info = production_step(n, s)()
        ph.niter = info.niter
        ph.photcons = info.photon_stats.get("photon_cons")
        check(info.converged, f"converged in {info.niter} iterations")
        check(abs(1.0 - ph.photcons) <= 0.15,
              f"|1 - photcons| {abs(1.0 - ph.photcons):.4f} <= 0.15")
        check(np.isfinite(info.mean_xh1) and info.mean_xh1 > 0,
              f"mean_xh1 {info.mean_xh1:.6e} finite")


# ---------------------------------------------------------------------------
# non-isothermal: f32 against f64
# ---------------------------------------------------------------------------
THERMAL_DT = 3.0e13     # s


def run_thermal(n, dtype, s=16, calls=3):
    """`calls` successive non-isothermal timesteps of s bright sources
    from a partly ionized start; returns xh1, T, the last step's rate
    grid and the EvolveInfo of every step, and checks that every step
    ran the on-device convergence loop."""
    import jax.numpy as jnp

    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.ops.photonstats import PhotonStatistics
    from c2ray_tpu.ops.tables import build_rad_tables
    from c2ray_tpu.ops.thermal import setup_cool
    from c2ray_tpu.solver import Evolve3D
    from c2ray_tpu.state import initial_state

    cfg = test_problem_config(mesh=n, dtype=dtype, use_lls=True,
                              type_of_lls=1, cosmological=False,
                              isothermal=False, source_batch=s)
    solver = Evolve3D(cfg, build_rad_tables(cfg), cool=setup_cool(cfg))
    loops = []
    device_loop = solver._evolve_device_loop
    solver._evolve_device_loop = (
        lambda *a, **k: loops.append(1) or device_loop(*a, **k))
    rng = np.random.default_rng(0)
    srcpos = rng.integers(0, n, (s, 3)).astype(np.int32)
    nflux = 10.0 ** rng.uniform(6, 9, s)
    state = initial_state(cfg)._replace(xh1=jnp.asarray(
        rng.uniform(0.3, 0.9, cfg.mesh).astype(cfg.np_dtype)))
    ndens = jnp.full(cfg.mesh, cfg.np_dtype(NH))
    stats = PhotonStatistics(cfg)
    infos = []
    for _ in range(calls):
        state, info = solver.evolve3d(state, ndens, 2.9e24 / (n / 64),
                                      srcpos, nflux, THERMAL_DT,
                                      lls_coldens=1e17, stats=stats)
        infos.append(info)
    check(len(loops) == calls,
          f"{len(loops)} of {calls} steps ran the on-device loop")
    return (np.asarray(state.xh1, np.float64),
            np.asarray(state.temper_current, np.float64),
            np.asarray(infos[-1].phih, np.float64), infos)


def phase_thermal(n=256):
    res = {}
    for dtype in ("float64", "float32"):
        with Phase(f"thermal {n}^3 non-isothermal {dtype}") as ph, \
                x64(dtype == "float64"):
            res[dtype] = run_thermal(n, dtype)
            infos = res[dtype][3]
            ph.niter = [i.niter for i in infos]
            ph.photcons = [i.photon_stats.get("photon_cons") for i in infos]
            check(all(i.converged for i in infos),
                  f"every step converged, niter {ph.niter}")
    x64_, t64, phih, i64 = res["float64"]
    x32, t32, _, i32 = res["float32"]
    dm = rel(i32[-1].mean_xh1, i64[-1].mean_xh1)
    check(dm < 1e-3, f"mean_x rel diff f32 vs f64 {dm:.3e} < 1e-3")
    lit = phih * THERMAL_DT > 1e-3
    check(lit.sum() >= 1000,
          f"{lit.sum()} lit cells ({lit.mean():.3%} of the cube) >= 1000")
    dx = np.abs(x32 - x64_)
    dT = np.abs(t32 - t64) / t64
    for where, m in (("cube", slice(None)), ("lit cells", lit)):
        px = float(np.percentile(dx[m], 99))
        pT = float(np.percentile(dT[m], 99))
        check(px < 5e-3, f"{where}: p99 |dxh1| {px:.3e} < 5e-3")
        check(pT < 5e-3, f"{where}: p99 rel dT {pT:.3e} < 5e-3")


# ---------------------------------------------------------------------------
# four devices: src and halo layouts against one device
# ---------------------------------------------------------------------------
def run_layout(name, kind, mesh, dtype):
    """One slice of one 1-Myr timestep of the bundled 10-source problem
    (the first timestep of examples/input_test.in) through C2RayDriver
    under one parallel layout; returns the run's directory."""
    from c2ray_tpu import constants as const
    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.driver import C2RayDriver, DriverConfig
    from c2ray_tpu.models.nbody import test_adapter
    from c2ray_tpu.parallel.layout import ParallelLayout

    out = fresh_run_dir(name)
    cfg = test_problem_config(mesh=mesh, dtype=dtype)
    C2RayDriver(cfg,
                adapter=test_adapter(cfg, slice_time=1e6 * const.YEAR,
                                     source_dir=out + "/"),
                driver_cfg=DriverConfig(number_timesteps=1,
                                        results_dir=out + "/"),
                layout=ParallelLayout(kind=kind,
                                      n_dom=4 if kind == "halo" else 0)
                ).run(max_slices=1)
    return out


def phase_four():
    from c2ray_tpu.utils.io_fortran import read_sm3d

    for dtype, mesh in (("float64", 512), ("float32", 256)):
        x = {}
        for kind in ("none", "src", "halo"):
            with Phase(f"four {mesh}^3 {dtype} layout={kind}") as ph, \
                    x64(dtype == "float64"):
                out = run_layout(f"four_{kind}_{dtype}", kind, mesh, dtype)
                check_run(out, 1, ph)
                x[kind] = read_sm3d(glob.glob(os.path.join(
                    out, "xfrac3D_*.bin"))[0]).astype(np.float64)
        for kind in ("src", "halo"):
            d = float(np.max(np.abs(x[kind] - x["none"])
                             / np.abs(x["none"])))
            dm = rel(x[kind].mean(), x["none"].mean())
            if dtype == "float64":
                check(d < 1e-5,
                      f"{dtype} {kind} vs none: max rel xh1 {d:.3e} < 1e-5")
            else:
                print(f"    {dtype} {kind} vs none: max rel xh1 {d:.3e}",
                      flush=True)
                check(dm < 1e-3,
                      f"{dtype} {kind} vs none: mean x rel {dm:.3e} < 1e-3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device layout comparison")
    args = ap.parse_args(argv)

    import jax
    dev = require_gpu()
    if args.four and dev["count"] < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {dev['count']}")
    from c2ray_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}")
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    print(f"nvidia-smi: {nvidia_smi()}")
    print(f"jax {jax.__version__} device_kind={dev['kind']} "
          f"count={dev['count']}", flush=True)

    phases = ([phase_four] if args.four else
              [phase_golden, phase_march, phase_main, phase_production,
               phase_thermal])
    failed = []
    for phase in phases:
        try:
            phase()
        except Exception:       # report every phase, then fail the run
            traceback.print_exc()
            failed.append(phase.__name__)
    if failed:
        print(f"FAILED phases: {failed}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
