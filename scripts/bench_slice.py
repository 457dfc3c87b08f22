"""End-to-end production-slice benchmark: the FULL driver pipeline
(catalog load -> suppression -> adaptive windowed sweeps -> convergence
iteration -> chemistry -> outputs) at 256^3 with a many-source catalog
on one chip.

bench.py measures the hot sweep kernel; this measures what a user pays
per redshift slice, the reference's operational unit (C2Ray.F90:267-427).

Usage: python scripts/bench_slice.py [--mesh 256] [--sources 1000]
Prints one JSON line {"metric": "slice_seconds", ...}.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, default=256)
    ap.add_argument("--sources", type=int, default=1000)
    ap.add_argument("--timesteps", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from c2ray_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.driver import C2RayDriver, DriverConfig
    from c2ray_tpu.models.nbody import test_adapter

    n = args.mesh
    platform = jax.devices()[0].platform
    cfg = test_problem_config(
        mesh=n, dtype="float32" if platform == "gpu" else "float64",
        use_lls=True, type_of_lls=1, cosmological=True)

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="bench_slice_")
    pos = rng.integers(1, n + 1, (args.sources, 3))       # 1-based
    flux = 10.0 ** rng.uniform(52.5, 55.5, args.sources)  # photons/s
    with open(os.path.join(tmp, "test_sources.dat"), "w") as f:
        f.write(f"{args.sources}\n")
        for p, s in zip(pos, flux):
            f.write(f"{p[0]} {p[1]} {p[2]} {s:.4e} 0.0\n")

    dc = DriverConfig(uv_recipe=7, number_timesteps=args.timesteps,
                      number_outputs=1,
                      results_dir=os.path.join(tmp, "results") + "/")
    ad = test_adapter(cfg, source_dir=tmp + "/")
    drv = C2RayDriver(cfg, adapter=ad, driver_cfg=dc, verbose=False)

    t0 = time.time()
    drv.run(max_slices=1)          # slice 1: includes all compiles
    warm = time.time() - t0

    dc2 = DriverConfig(uv_recipe=7, number_timesteps=args.timesteps,
                       number_outputs=1, nz0=1,
                       results_dir=os.path.join(tmp, "results") + "/")
    drv2 = C2RayDriver(cfg, adapter=ad, driver_cfg=dc2, verbose=False)
    t0 = time.time()
    state = drv2.run(max_slices=1)  # slice 2: steady-state cost
    slice_s = time.time() - t0
    mean_x = float(np.mean(drv2._x1(state)))
    niters = sum(h["niter"] for h in drv2.history)

    print(json.dumps({
        "metric": f"slice_seconds_{n}cube_{args.sources}src",
        "value": slice_s,
        "unit": "s/slice",
        "vs_baseline": 0.0,
    }))
    print(f"# mesh={n}^3 sources={args.sources} steps={args.timesteps} "
          f"iters={niters} mean_x={mean_x:.4f} "
          f"first_slice(with compiles)={warm:.1f}s "
          f"steady={slice_s:.1f}s platform={platform}", file=sys.stderr)


if __name__ == "__main__":
    main()
