"""Where the persistent XLA compilation cache lives.

The benchmark scripts and `chip_smoke.py` call `configure_compile_cache()`
before their first compilation. When `JAX_COMPILATION_CACHE_DIR` is set,
JAX reads it on its own and nothing is set here. Otherwise the cache goes
to `.jax_cache/` at the root of the checkout, a fixed path (the path is
part of the cache key), which `.gitignore` lists.
"""

from __future__ import annotations

import os

import jax

__all__ = ["configure_compile_cache", "default_cache_dir"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """`.jax_cache/` beside the package, at the root of the checkout."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    # programs that compile in under a second are cheaper to rebuild than
    # to read back
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
