"""Persistent compilation cache rule shared by the repository's scripts.

The solver's programs are shape-stable, so JAX's persistent cache removes
almost all recompilation across processes.  Where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX reads it itself and nothing else is configured here; otherwise
the cache goes to one fixed directory that the caller names (the scripts
use ``<checkout>/.jax_cache``, which ``.gitignore`` lists), so every later
run from the same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(default_dir: str) -> str:
    """Turn on the persistent compilation cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``default_dir``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir
