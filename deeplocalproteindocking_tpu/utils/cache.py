"""Persistent XLA compilation cache.

A repeat invocation (bench runs, CLI calls, test sessions) loads its
compiled programs from disk instead of compiling them again.  The
directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise a fixed path inside the checkout (``<repo>/.jax_cache``,
listed in ``.gitignore``): the path is part of the cache key, so a
directory that moved would never hit.  Safe to call multiple times.
"""
from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def cache_dir() -> str:
    """The persistent-cache directory (no JAX backend is initialized)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`,
    on every backend; returns the directory."""
    import jax
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
