"""Placement of JAX's persistent compilation cache for the scripts.

The package never enables the cache on import; ``bench.py`` and
``chip_smoke.py`` call :func:`enable_compile_cache`.  The directory is
``JAX_COMPILATION_CACHE_DIR`` when that is set, otherwise the fixed
``<checkout>/.jax_cache`` (listed in ``.gitignore``): the path is part of
the cache key, so it is never temporary or per-process.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(checkout: str, environ=None) -> str:
    """The cache directory for a run from ``checkout``."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or os.path.join(
        os.path.abspath(checkout), ".jax_cache"
    )


def enable_compile_cache(checkout: str) -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return the directory."""
    import jax

    path = compile_cache_dir(checkout)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
