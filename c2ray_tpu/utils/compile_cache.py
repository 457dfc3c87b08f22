"""JAX persistent compilation cache location.

Compiling the sweep and convergence-loop programs dominates a cold start,
so every entry point (the CLI, bench.py, chip_smoke.py and the scripts)
calls `enable_compile_cache()` once before its first compile.  The cache
key includes the directory, so the default is a fixed path inside the
checkout rather than anything per-user or per-process.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache lives in: $JAX_COMPILATION_CACHE_DIR when
    set (JAX reads it itself), else DEFAULT_DIR."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory.  When the
    environment names a directory, JAX already uses it and no other is
    set here.  Programs that compile in under a second are not cached."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
