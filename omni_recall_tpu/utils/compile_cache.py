"""JAX's persistent compilation cache: one rule for every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at ``<repo>/.jax_cache``,
a fixed path (the path is part of the cache key, so a directory that
moves never hits), listed in .gitignore. Called by the server
(server/__main__.py), bench.py and chip_smoke.py.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=os.environ) -> Path | None:
    """The directory to set in code, or None when the environment names
    one (JAX then honours it)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE


def enable_compile_cache() -> None:
    path = compile_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", str(path))
