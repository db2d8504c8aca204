"""One place that points JAX's persistent compilation cache somewhere.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this sets no
directory in code. Otherwise the cache goes to the fixed path
`<checkout>/.jax_cache` (listed in .gitignore): the path is part of the
cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
MIN_COMPILE_SECS = 1.0     # programs that compile faster are not cached


def enable_compile_cache() -> str:
    """Turn on the persistent cache; returns the directory in use."""
    import jax

    path = os.environ.get(ENV)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    return path
