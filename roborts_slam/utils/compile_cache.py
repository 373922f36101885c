"""The persistent XLA compile cache, in one place.

A cold start compiles every program of the engine; the persistent cache
lets the next process on the same machine load them instead. Entry points
(the CLI, bench.py, chip_smoke.py, the examples) call
:func:`enable_compile_cache` once, before their first compile.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: The cache directory when the environment names none (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and this
    sets nothing. Otherwise the cache goes to ``<repo>/.jax_cache``, a fixed
    path (the path is part of the cache's key)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
