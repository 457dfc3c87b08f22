"""Scaling-efficiency benchmark across device counts and parallel modes.

Measures grid-point updates/s of one full solver iteration (source sweep
+ rate reduction + global chemistry) at 1/2/4/8 devices for each
parallel layout, and reports efficiency vs the 1-device run — the
BASELINE.md north-star "≥80% grid-points/s scaling efficiency at
1 chip → 1 host → ≥2 hosts" measured the same way on real hardware.

The default run uses a virtual 8-device CPU mesh (functional scaling:
correctness + collective overhead structure, not device numbers).  With
--gpu it runs on the host's GPUs instead (one process drives them all);
the harness is unchanged.

Usage: python scripts/bench_scaling.py [--mesh 32] [--sources 8]
       [--iters 3] [--modes source domain halo] [--gpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ON_GPU = "--gpu" in sys.argv
if not _ON_GPU:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, default=32)
    ap.add_argument("--sources", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--modes", nargs="*",
                    default=["source", "domain", "halo"])
    ap.add_argument("--gpu", action="store_true",
                    help="run on the host's GPUs instead of the CPU mesh")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from c2ray_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.ops.chemistry import global_chemistry
    from c2ray_tpu.ops.sweep import SweepScalars, raytrace_all_sources
    from c2ray_tpu.ops.tables import build_rad_tables
    from c2ray_tpu.parallel.domain import (domain_sharded_raytracer,
                                           halo_sharded_raytracer,
                                           sharded_chemistry)
    from c2ray_tpu.parallel.source_shard import (make_device_mesh,
                                                 sharded_raytracer)

    ndev_all = len(jax.devices())
    counts = args.devices or [d for d in (1, 2, 4, 8) if d <= ndev_all]
    n = args.mesh
    cfg = test_problem_config(mesh=n, dtype="float32", use_lls=False,
                              cosmological=False)
    tables = build_rad_tables(cfg)
    rng = np.random.default_rng(0)
    ndens = jnp.full((n, n, n), jnp.float32(1.98e-4))
    xh = jnp.full((n, n, n), jnp.float32(2e-4))
    srcpos = jnp.asarray(rng.integers(0, n, (args.sources, 3)), jnp.int32)
    nflux = jnp.asarray(10.0 ** rng.uniform(7, 9, args.sources), jnp.float32)
    dr = jnp.float32(2.9e22)
    cbrt_s = float(cfg.sed.s_star) ** (1.0 / 3.0)
    sc = SweepScalars(dr=dr, rate_scale=(jnp.float32(cbrt_s) / dr) ** 3,
                      lls_coldens=jnp.float32(0.0),
                      rmax2_cells=jnp.float32(0.0))
    dt = jnp.float32(3.1e14)

    def build(mode, k):
        if k == 1 or mode == "serial":
            rt = lambda *a, **kw: raytrace_all_sources(cfg, tables, *a, **kw)
            chem = lambda *a, **kw: global_chemistry(cfg, *a, **kw)
        else:
            if mode == "source":
                mesh = make_device_mesh(k)
                rt0 = sharded_raytracer(mesh)
                chem0 = (sharded_chemistry(mesh)
                         if n % k == 0 else None)
            elif mode == "domain":
                mesh = make_device_mesh(k, axis_name="dom")
                rt0 = domain_sharded_raytracer(mesh)
                chem0 = sharded_chemistry(mesh, "dom")
            else:
                mesh = make_device_mesh(k, axis_name="dom")
                rt0 = halo_sharded_raytracer(mesh)
                chem0 = sharded_chemistry(mesh, "dom")
            rt = lambda *a, **kw: rt0(cfg, tables, *a, **kw)
            chem = (lambda *a, **kw: chem0(cfg, *a, **kw)) if chem0 else \
                (lambda *a, **kw: global_chemistry(cfg, *a, **kw))

        def step(nd, x, pos, f):
            phih, heat, loss, lls, per = rt(nd, x, pos, f, sc)
            res = chem(dt, nd, x, x, x, phih)
            return res.xh1_intermed, loss

        return jax.jit(step)

    print(f"# mesh={n}^3 sources={args.sources} platform="
          f"{jax.devices()[0].platform} devices={ndev_all}")
    base = {}
    for mode in args.modes:
        for k in counts:
            if n % k and mode in ("domain", "halo"):
                continue
            try:
                step = build(mode, k)
                out = step(ndens, xh, srcpos, nflux)
                jax.block_until_ready(out)
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    out = step(ndens, xh, srcpos, nflux)
                    jax.block_until_ready(out)
                el = (time.perf_counter() - t0) / args.iters
            except Exception as e:   # noqa: BLE001 - report and continue
                print(f"{mode:8s} k={k}: FAILED {type(e).__name__}: {e}")
                continue
            gps = n ** 3 * args.sources / el
            if (mode, 1) not in base and k == 1:
                base[(mode, 1)] = gps
            eff = gps / (base.get((mode, 1), gps) * k)
            print(f"{mode:8s} k={k}: {el * 1e3:8.1f} ms/iter  "
                  f"{gps:.3e} cell-src/s  efficiency {eff:6.1%}")


if __name__ == "__main__":
    main()
