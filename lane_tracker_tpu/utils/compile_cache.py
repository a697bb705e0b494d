"""Where the persistent XLA compilation cache lives.

The full-geometry programs take tens of seconds to compile, so every
command that runs them (chip_smoke.py, bench.py, the CLI) keeps JAX's
persistent cache.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads
it itself and no other directory is configured here.  Otherwise the cache
sits at a fixed path, ``<repo>/.jax_cache`` (git-ignored), because the path
is part of what a later run must find again.
"""

from __future__ import annotations

import os
import pathlib

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def compile_cache_dir() -> str | None:
    """The directory this repo configures, or None when the environment's
    ``JAX_COMPILATION_CACHE_DIR`` already decides it."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(DEFAULT_CACHE_DIR)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory, unless
    the environment or an earlier caller (the test suite's conftest) has
    chosen one; returns the directory in effect."""
    import jax

    if compile_cache_dir() is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    return jax.config.jax_compilation_cache_dir
