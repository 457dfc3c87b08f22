"""Test environment: CPU backend with 8 virtual devices, float64 available.

Mirrors the reference's testing model (SURVEY.md section 4): the same code
runs serially or distributed; multi-device sharding is validated on a
virtual CPU mesh without accelerator hardware.

Tests marked `gpu` need a GPU and skip elsewhere; run them on a GPU host
with C2RAY_TEST_DEVICE=gpu python -m pytest -m gpu tests/ (the variable
keeps JAX off the forced CPU backend).
"""

import os

import pytest

ON_GPU = os.environ.get("C2RAY_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided when the test
    runs, never at import)."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's devices are {platform}")
