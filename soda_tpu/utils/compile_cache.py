"""Persistent XLA compilation cache placement.

One rule for every entry point (`sodac`, `bench.py`, `chip_smoke.py`):
where `JAX_COMPILATION_CACHE_DIR` is set, JAX already keeps its cache
there and nothing is set in code; otherwise the cache lives at
`<repo>/.jax_cache`, a fixed path (the path is part of the cache key, so
a directory that moves never hits).
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its place; returns the directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
