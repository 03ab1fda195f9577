"""The persistent compile cache helper (slamrs_tpu.utils.compile_cache)."""

from pathlib import Path

import jax
import pytest

from slamrs_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_config():
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)


def test_env_dir_wins_and_code_sets_none(monkeypatch, tmp_path,
                                         restore_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; the helper points it nowhere else
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_fixed_dir_in_checkout(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    # the same path every time (it is part of the cache key), and git
    # never commits it
    assert compile_cache.enable() == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
