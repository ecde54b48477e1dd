"""Persistent XLA compile cache placement, shared by the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here.  Otherwise the cache lives at the fixed in-checkout path
``.jax_cache/`` (listed in .gitignore): the path is part of the cache key,
so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def configure() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
