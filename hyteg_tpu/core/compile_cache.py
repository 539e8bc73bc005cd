"""Where JAX keeps its persistent compilation cache.

A cache hits only when its directory stays the same from run to run, so
the directory is fixed: ``$JAX_COMPILATION_CACHE_DIR`` when it is set
(JAX reads that variable itself, and nothing else is set here), else
``.jax_cache/`` at the root of the checkout.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its fixed directory; returns it."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
