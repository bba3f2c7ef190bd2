"""The persistent compile-cache helper every entry point calls."""

import jax
import pytest

from mh_tpu.utils import compile_cache

_KEYS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_entry_size_bytes",
    "jax_persistent_cache_min_compile_time_secs",
)


@pytest.fixture
def restore_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_var_wins_and_nothing_is_set(monkeypatch, restore_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_env_uses_the_checkout_dir(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == compile_cache.CHECKOUT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == got
    # <checkout>/.jax_cache: beside the package, listed in .gitignore
    import os

    import mh_tpu

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(mh_tpu.__file__)))
    assert got == os.path.join(checkout, ".jax_cache")
    with open(os.path.join(checkout, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_path_is_stable_across_calls(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    assert compile_cache.enable_compile_cache() == first
    assert jax.config.jax_compilation_cache_dir == first
