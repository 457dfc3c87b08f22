"""Populate the persistent compilation cache for a production run.

Cold XLA compiles of the production programs take a long time at large
meshes; the persistent cache makes every subsequent process start
without them.  This script compiles (lowers, no
full-size execution beyond one warmup step) every jit signature a driver
run will hit — sweep buckets of the adaptive ladder, the windowed batch
kernel, chemistry, counts — so the real run never stalls on a compile.

Run once per (mesh, dtype, backend, batch) configuration, e.g. overnight
or while staging input data:

    python scripts/precompile.py --mesh 600
    python scripts/precompile.py --mesh 256 --windowed-radii 4 8 16

The cache key includes the XLA flags and jaxlib version; re-run after
upgrading either.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, default=256)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--backend", default="facemajor",
                    choices=["facemajor", "grid"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sources", type=int, default=16,
                    help="full-sweep vmap width to compile")
    ap.add_argument("--windowed-radii", type=int, nargs="*",
                    default=None,
                    help="windowed-sweep radii to compile (default: the "
                         "adaptive ladder below N/2)")
    ap.add_argument("--isothermal", action="store_true", default=True)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from c2ray_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()

    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.ops.sweep import SweepScalars, raytrace_all_sources
    from c2ray_tpu.ops.tables import build_rad_tables

    n = args.mesh
    backend = args.backend
    cfg = test_problem_config(mesh=n, dtype=args.dtype, use_lls=True,
                              type_of_lls=1, cosmological=False,
                              isothermal=args.isothermal,
                              sweep_backend=backend,
                              source_batch=args.batch)
    tables = build_rad_tables(cfg)
    dt = np.dtype(args.dtype)
    jdt = cfg.jnp_dtype

    ndens = jnp.full(cfg.mesh, jdt(1.98e-4))
    xh = jnp.full(cfg.mesh, jdt(0.5))
    dr = 2.9e24 / (n / 64)
    sc = SweepScalars(dr=jdt(dr), rate_scale=jdt(cfg.sed.s_star / dr**3),
                      lls_coldens=jdt(1e17), rmax2_cells=jdt(0.0))

    # the adaptive ladder radii a production step dispatches
    if args.windowed_radii is None:
        radii, r = [], 2
        while r < n // 2:
            radii.append(r)
            r *= 2
    else:
        radii = list(args.windowed_radii)

    rng = np.random.default_rng(0)

    def compile_one(label, num_src, max_shell):
        pos = jnp.asarray(rng.integers(0, n, (num_src, 3)), jnp.int32)
        nf = jnp.asarray(10.0 ** rng.uniform(6, 8, num_src), jdt)
        t0 = time.time()
        out = jax.jit(lambda *a: raytrace_all_sources(
            cfg, tables, *a, max_shell=max_shell))(ndens, xh, pos, nf, sc)
        jax.block_until_ready(out)
        print(f"  {label:36s} {time.time()-t0:7.1f} s", flush=True)

    print(f"precompiling mesh={n}^3 dtype={args.dtype} backend={backend} "
          f"batch={args.batch} cache={cache}", flush=True)
    for r in radii:
        # padded pow-2 bucket capacities the adaptive path uses
        compile_one(f"windowed r={r} batch={args.batch}",
                    min(args.batch, 1 << 8), r)
    compile_one(f"full sweep x{args.sources}", args.sources, None)

    # chemistry + counts + the audit reductions
    from c2ray_tpu.solver import Evolve3D
    solver = Evolve3D(cfg, tables)
    t0 = time.time()
    ch = solver._chem(jdt(3e13), ndens, xh, xh, xh,
                      jnp.zeros(cfg.mesh, jdt),
                      None if cfg.isothermal else jnp.zeros(cfg.mesh, jdt),
                      jnp.full(cfg.mesh, jdt(1e4)),
                      jnp.full(cfg.mesh, jdt(1e4)),
                      jdt(1.0), jdt(0.0), jnp.zeros((), jdt))
    c = solver._counts(ndens, xh, jnp.full(cfg.mesh, jdt(1e4)), jdt(1.0))
    s = solver._sum(xh)
    jax.block_until_ready((ch, c, s))
    print(f"  {'chemistry + counts + sum':36s} {time.time()-t0:7.1f} s",
          flush=True)
    # the fused per-iteration tail (the production solver loop path)
    from c2ray_tpu.ops.sweep import SweepScalars
    sc_t = SweepScalars(dr=jdt(2.9e24), rate_scale=jdt(1.0),
                        lls_coldens=jdt(0.0), rmax2_cells=jdt(0.0))
    for ws in (True, False):
        t0 = time.time()
        tl = solver._tail(jdt(3e13), ndens, xh, xh, xh,
                          jnp.zeros(cfg.mesh, jdt),
                          None if cfg.isothermal else jnp.zeros(cfg.mesh, jdt),
                          jnp.full(cfg.mesh, jdt(1e4)),
                          jnp.full(cfg.mesh, jdt(1e4)),
                          jdt(1.0), jdt(0.0), sc_t, jdt(0.0), jdt(0.0),
                          with_stats=ws)
        jax.block_until_ready(tl)
        print(f"  {'fused tail with_stats=' + str(ws):36s} "
              f"{time.time()-t0:7.1f} s", flush=True)
    print("cache populated.")


if __name__ == "__main__":
    main()
