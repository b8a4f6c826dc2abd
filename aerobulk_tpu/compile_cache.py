"""JAX's persistent compilation cache, at one fixed place.

The flux step is a deep elementwise graph whose cold compile dominates a
short run, so every entry point that compiles it (``cli.main``,
``bench.py``, ``chip_smoke.py``) turns the persistent cache on first.
"""

from __future__ import annotations

import os

import jax

#: The cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: ``.jax_cache`` at the root of the checkout (git-ignored).  The path is
#: part of the cache key, so it must not move between runs.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here; otherwise the cache goes to
    :data:`DEFAULT_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
