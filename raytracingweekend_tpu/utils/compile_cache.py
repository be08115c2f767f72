"""Persistent XLA compile cache for the entry points (CLI, bench, smoke).

Called from `main()`-style entry points only, never on import, so that a
library user's own cache settings are left alone.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Use $JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself,
    so nothing is changed); otherwise cache in `<checkout>/.jax_cache`.
    Returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
