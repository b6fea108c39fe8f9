"""Placement of JAX's persistent compilation cache.

Every entry point (the CLI, ``bench.py``, ``chip_smoke.py``, the scripts)
calls :func:`enable_compile_cache` before its first compile, so all of
them share one cache:

* ``JAX_COMPILATION_CACHE_DIR``, when set, wins — JAX reads it itself
  and no other directory is set here;
* otherwise ``<checkout>/.jax_cache``, found from this file's own path,
  so the key stays the same whatever the working directory is (a cache
  whose path moves never hits).
"""

from __future__ import annotations

import os

# The decode programs compile in seconds each on an H100 (a cold
# chip_smoke.py phase compiles its two to four programs in 20-40 s).
# 0.5 s caches every one of them with a margin, while one-op eager
# programs, which cost less to compile than to look up, stay out.
MIN_COMPILE_SECONDS = 0.5

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The cache directory :func:`enable_compile_cache` uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir`; returns the directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECONDS)
    return path
