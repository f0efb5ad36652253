"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR, when set, is the
only cache location; otherwise `.jax_cache/` at the checkout's root."""

import os

import jax
import pytest

from gpmp2_jax import compile_cache


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_var_wins_and_sets_nothing(monkeypatch, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_checkout_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_empty_env_var_counts_as_unset(monkeypatch, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert (compile_cache.configure_compile_cache()
            == compile_cache.default_cache_dir())


def test_default_dir_is_gitignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
