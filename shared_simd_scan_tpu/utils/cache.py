"""The persistent compile cache's one home.

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and nothing
here overrides it.  Otherwise the cache lives at ``<checkout>/.jax_cache``,
a fixed path derived from this file's location (the path is part of the
cache key, so a moving directory would never hit).
"""
from __future__ import annotations

import os
import pathlib

import jax

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir` and cache
    every compiled program; returns the directory."""
    path = cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
