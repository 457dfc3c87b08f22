"""Entry-point guards: backend validation, the compile-cache location,
the benchmark's peak table and the on-card smoke's device check."""

import os

import pytest

import jax

from c2ray_tpu.config import test_problem_config as make_config
from c2ray_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_rejects_unknown_sweep_backend():
    with pytest.raises(ValueError, match="sweep_backend"):
        make_config(mesh=8, sweep_backend="pallas")
    assert make_config(mesh=8, sweep_backend="grid").sweep_backend == "grid"


def test_cli_rejects_unknown_sweep_backend(capsys):
    from c2ray_tpu.__main__ import main
    with pytest.raises(SystemExit) as exc:
        main(["--sweep-backend", "pallas"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path,
                                       restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # the environment's directory is JAX's own; no other is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_is_inside_checkout(monkeypatch,
                                                  restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == want
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_bench_peak_unknown_device_raises():
    import bench
    with pytest.raises(ValueError, match="no published peak"):
        bench.peak_hbm_gbps("cpu")


def test_bench_peak_resolves_h100():
    import bench
    assert bench.peak_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    gbps, frac = bench.roofline("NVIDIA H100 80GB HBM3", 3.35e9, 1e-3)
    assert gbps == pytest.approx(3350.0)
    assert frac == pytest.approx(1.0)


def test_chip_smoke_refuses_cpu():
    import chip_smoke
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu()


def _trace_bringup():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "trace_bringup", os.path.join(REPO, "scripts", "trace_bringup.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("op_name, scope", [
    ("jit(<lambda>)/while/body/march/mirror/dot_general", "mirror"),
    ("jit(chunk)/vmap(march)/while/body/add", "march"),
    ("jit(step)/jvp(deposition)/mul", "deposition"),
    ("jit(<lambda>)/while/body/closed_call", None),
])
def test_trace_scope_is_innermost_named_scope(op_name, scope):
    assert _trace_bringup().scope_of_op_name(op_name) == scope


def test_trace_summary_busy_and_idle():
    tb = _trace_bringup()
    evs = [(0, 10, "jit(f)/march/add", "m:a"),
           (5, 10, "jit(f)/march/mirror/dot", "m:b"),
           (30, 10, "jit(f)/copy", "m:c")]
    s = tb.summarize(evs)
    assert s["kernels"] == 3
    assert s["kernels_by_scope"] == {"march": 1, "mirror": 1, "other": 1}
    assert s["kernel_sum_ms"] == pytest.approx(30e-6)
    assert s["busy_ms"] == pytest.approx(25e-6)      # [0,15) and [30,40)
    assert s["window_ms"] == pytest.approx(40e-6)
    assert s["idle_share"] == pytest.approx(15 / 40)
    assert list(s["top_other"].values()) == [[pytest.approx(10e-6), 1]]
    with pytest.raises(RuntimeError, match="no device kernels"):
        tb.summarize([])


def test_trace_refuses_a_trace_without_gpu(tmp_path):
    import glob

    import jax.numpy as jnp
    tb = _trace_bringup()
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(jax.jit(lambda x: x * 2.0)(jnp.ones(8)))
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    with pytest.raises(RuntimeError, match="no GPU device plane"):
        tb.device_events(path)


def test_trace_bringup_refuses_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        _trace_bringup().main(["--out", str(tmp_path / "t.json")])
