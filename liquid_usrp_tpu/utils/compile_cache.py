"""Persistent XLA compilation cache whose place is set from outside.

A cold compile of the flagship receiver takes tens of seconds; the
persistent cache lets a later process reuse it.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache lives at the fixed path ``<repo>/.jax_cache``
(never a temp, pid or time-based path, which a later process could not
find again).
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Place the persistent compile cache; return its directory.

    Call before the first compile: JAX opens the cache lazily at the
    first compilation and keeps that directory for the process.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
