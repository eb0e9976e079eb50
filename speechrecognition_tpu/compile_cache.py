"""JAX persistent compilation cache location.

One rule for every entry point (CLI, tools, bench, chip smoke test, test
suite): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here overrides it; otherwise the cache lives at ``<repo>/.jax_cache``.
The path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent cache for programs that take a second or
    more to compile, and return the directory it uses."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
