"""Persistent compilation cache at one fixed place.

JAX keys its cache on the directory, so a path that moves never hits.
"""
from __future__ import annotations

import os
import pathlib

import jax

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no other directory is set here.  Otherwise the cache is
    ``<checkout>/.jax_cache``, which git ignores.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CHECKOUT_CACHE)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
