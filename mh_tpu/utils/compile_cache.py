"""The persistent XLA compilation cache shared by every entry point.

A cold chain program takes seconds to compile; the cache keeps the
executables across processes. The directory is part of what a cached
entry is found by, so it never moves: ``JAX_COMPILATION_CACHE_DIR`` when
set (JAX reads that variable itself), otherwise ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory.

    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set. Call before the
    first compilation of the process.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return CHECKOUT_CACHE_DIR
