"""The XLA sweep paths that replace the former hand-written kernels:
batched facemajor marches against single-source sweeps, the padded
window scatter against the mod-N scatter, and windowed batches against
the capped full cube."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from c2ray_tpu.config import test_problem_config as make_config
from c2ray_tpu.ops.sweep import (SweepScalars, fold_padded_acc,
                                 neutral_density, raytrace_all_sources,
                                 roll3, sweep_single_source, windowed_batch,
                                 windowed_prepass)
from c2ray_tpu.ops.tables import build_rad_tables


def _problem(n, lls_type, seed=5):
    cfg = make_config(mesh=n, dtype="float32", use_lls=True,
                      type_of_lls=lls_type, cosmological=False)
    rng = np.random.default_rng(seed)
    ndens = jnp.asarray(rng.uniform(1e-4, 3e-4, (n,) * 3).astype(np.float32))
    xh = jnp.asarray(rng.uniform(0.1, 0.9, (n,) * 3).astype(np.float32))
    lls = (jnp.asarray((rng.uniform(0, 1, (n,) * 3) * 3e16)
                       .astype(np.float32)) if lls_type == 2 else None)
    dr = 2.9e24 / (n / 64)
    sc = SweepScalars(dr=jnp.float32(dr),
                      rate_scale=jnp.float32(cfg.sed.s_star / dr ** 3),
                      lls_coldens=jnp.float32(1e16 if lls_type == 1
                                              else 0.0),
                      rmax2_cells=jnp.float32(0.0))
    return cfg, build_rad_tables(cfg), ndens, xh, lls, sc, rng


@pytest.mark.parametrize("b", [4, 7])
@pytest.mark.parametrize("lls_type", [1, 2])
def test_batched_facemajor_equals_single_source(b, lls_type):
    """A vmapped batch of facemajor sweeps gives each source exactly the
    rates of its own single-source sweep (the batched march must not
    change a single bit of any source's result)."""
    n = 16
    cfg, tables, ndens, xh, lls, sc, rng = _problem(n, lls_type)
    c = n // 2
    pos = rng.integers(0, n, (b, 3))
    nflux = jnp.asarray(10.0 ** rng.uniform(4, 6, b), jnp.float32)
    ndhi = neutral_density(cfg, ndens, xh)
    ndhi_c = jnp.stack([roll3(ndhi, c - p) for p in pos])
    lls_c = (jnp.stack([roll3(lls, c - p) for p in pos])
             if lls is not None else None)

    def one(x, f, lc):
        return sweep_single_source(cfg, tables, x, f, sc, lls_c=lc)

    batched = jax.jit(jax.vmap(one, in_axes=(0, 0, 0 if lls is not None
                                              else None)))(
        ndhi_c, nflux, lls_c)
    single = jax.jit(one)
    for i in range(b):
        ref = single(ndhi_c[i], nflux[i],
                     lls_c[i] if lls_c is not None else None)
        np.testing.assert_array_equal(np.asarray(batched.phih[i]),
                                      np.asarray(ref.phih))
        np.testing.assert_array_equal(np.asarray(batched.coldensh_out[i]),
                                      np.asarray(ref.coldensh_out))
        np.testing.assert_allclose(float(batched.photon_loss[i]),
                                   float(ref.photon_loss), rtol=1e-6)
        np.testing.assert_allclose(float(batched.lls_loss[i]),
                                   float(ref.lls_loss), rtol=1e-6)


@pytest.mark.parametrize("n,r", [(24, 4), (32, 6), (30, 4)])
def test_padded_window_scatter_folds_to_mod_n_scatter(n, r):
    """windowed_batch's padded-accumulator scatter, folded back with
    fold_padded_acc, equals its mod-N scatter-add (windows overlapping
    each other and the periodic boundary included)."""
    cfg, tables, ndens, xh, _, sc, rng = _problem(n, 1, seed=n + r)
    b = 7
    pos = jnp.asarray(rng.integers(0, n, (b, 3)), jnp.int32)
    pos = pos.at[0].set(jnp.asarray([0, n - 1, 1], jnp.int32))
    nf = jnp.asarray(10.0 ** rng.uniform(4, 6, b), jnp.float32)
    ndhi_pad, _ = windowed_prepass(cfg, ndens, xh, None, r)
    zero = jnp.zeros((), jnp.float32)

    acc_mod = windowed_batch(cfg, tables, ndhi_pad, None, pos, nf, None,
                             sc, r, jnp.zeros((n,) * 3, jnp.float32),
                             zero)[0]
    acc_pad = windowed_batch(cfg, tables, ndhi_pad, None, pos, nf, None,
                             sc, r, jnp.zeros((n + 2 * r,) * 3, jnp.float32),
                             zero, padded_acc=True)[0]
    got = fold_padded_acc(acc_pad, n, r)
    assert got.shape == (n, n, n)
    np.testing.assert_allclose(np.asarray(got), np.asarray(acc_mod),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("r", [2, 3])
def test_windowed_batch_equals_capped_full_cube(r):
    """Sources swept inside their (2r+1)^3 windows give the rates of the
    full-cube sweep capped at the same radius."""
    n = 16
    cfg, tables, ndens, xh, _, sc, rng = _problem(n, 1, seed=r)
    s = 5
    pos = jnp.asarray(rng.integers(0, n, (s, 3)), jnp.int32)
    nf = jnp.asarray(10.0 ** rng.uniform(4, 6, s), jnp.float32)

    def run(window):
        c = cfg.replace(window_sweep=window, source_batch=2)
        return jax.jit(lambda: raytrace_all_sources(
            c, tables, ndens, xh, pos, nf, sc, max_shell=r))()

    ref, got = run(False), run(True)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got[4]), np.asarray(ref[4]),
                               rtol=1e-5)


@pytest.mark.gpu
def test_march_cross_check_on_gpu(gpu):
    """The on-card march cross-check of chip_smoke.py at a small mesh."""
    import chip_smoke
    chip_smoke.phase_march(n=64, s=4, r=4)
