"""864^3 halo-exchange march validation on the virtual 8-device CPU mesh.

The reference's largest production meshes (864^3-1200^3,
/root/reference/sizes.f90:50-71) exceed one chip's HBM for the staged
single-chip sweep; the halo-sharded march (ops/sweep_sharded.py) is the
designated path.  This script executes the march at 864^3 across 8 slab
domains and checks it against the replicated face-major march, reporting
max relative deviation, per-device slab shapes, wall times and peak RSS.

Run:  python scripts/validate_halo_large.py [--mesh 864] [--max-shell D]
(takes tens of minutes on 2 CPU cores; ~20 GB RSS at 864^3 f32)
"""

import argparse
import os
import resource
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

jax.config.update("jax_platforms", "cpu")
from c2ray_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, default=864)
    ap.add_argument("--max-shell", type=int, default=None)
    args = ap.parse_args()

    from c2ray_tpu.config import test_problem_config
    from c2ray_tpu.ops.sweep import (SweepScalars, compute_columns_facemajor,
                                     roll3)
    from c2ray_tpu.ops.sweep_sharded import compute_columns_slab
    from c2ray_tpu.parallel.source_shard import make_device_mesh

    n = args.mesh
    ndom = 8
    c = n // 2
    max_shell = args.max_shell if args.max_shell else c
    m = n // ndom
    cfg = test_problem_config(mesh=n, dtype="float32", use_lls=False,
                              cosmological=False)
    dr = 2.9e24 / (n / 64)
    sc = SweepScalars(dr=jnp.float32(dr),
                      rate_scale=jnp.float32(cfg.sed.s_star / dr**3),
                      lls_coldens=jnp.float32(0.0),
                      rmax2_cells=jnp.float32(0.0))
    rng = np.random.default_rng(864)
    print(f"mesh={n}^3 ndom={ndom} max_shell={max_shell} f32 "
          f"(cube = {n**3*4/1e9:.2f} GB)", flush=True)
    ndhi = rng.uniform(1e-4, 3e-4, (n, n, n)).astype(np.float32)
    px, py, pz = 131, 607, 250          # interior source off all axes
    ndhi_c = np.roll(ndhi, (c - px, c - py, c - pz), axis=(0, 1, 2))

    # --- replicated face-major march (single device) ---
    t0 = time.time()
    ref = jax.jit(lambda a: compute_columns_facemajor(
        cfg, a, sc, None, max_shell))(jnp.asarray(ndhi_c))
    jax.block_until_ready(ref)
    t_ref = time.time() - t0
    print(f"replicated march: {t_ref:.1f} s  rss={rss_gb():.1f} GB",
          flush=True)
    ref_grid_rows = np.roll(np.asarray(ref), px - c, axis=0)
    del ref

    # --- halo-sharded march over 8 slab domains ---
    mesh = make_device_mesh(ndom, axis_name="dom")
    sh = NamedSharding(mesh, P("dom"))
    nd_rows = jax.device_put(
        jnp.asarray(np.roll(ndhi_c, px - c, axis=0)), sh)
    del ndhi, ndhi_c

    def local(nd_slab):
        r0 = jax.lax.axis_index("dom") * m
        return compute_columns_slab(cfg, nd_slab, sc, None, max_shell,
                                    jnp.int32(px), r0, ndom, "dom")

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("dom"),
                               out_specs=P("dom"), check_vma=False))
    t0 = time.time()
    got = fn(nd_rows)
    jax.block_until_ready(got)
    t_halo = time.time() - t0
    shard_shapes = {s.data.shape for s in got.addressable_shards}
    print(f"halo march:       {t_halo:.1f} s  rss={rss_gb():.1f} GB  "
          f"per-device slab shards: {shard_shapes}", flush=True)
    assert shard_shapes == {(m, n, n)}

    got_np = np.asarray(got)
    del got, nd_rows
    # relative deviation where columns are significant (tiny columns at
    # the wavefront tail amplify f32 rounding harmlessly)
    denom = np.maximum(np.abs(ref_grid_rows), 1e12)
    rel = np.abs(got_np - ref_grid_rows) / denom
    print(f"max rel deviation: {rel.max():.3e}  "
          f"(mean {rel.mean():.3e})", flush=True)
    assert rel.max() < 1e-3, rel.max()
    print("OK: halo-sharded march matches the replicated march at "
          f"{n}^3 with N^3/{ndom} per-device slabs")


if __name__ == "__main__":
    main()
