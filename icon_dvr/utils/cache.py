"""Persistent XLA compilation cache.

The render loops are large fused programs whose first compile takes tens
of seconds; caching the executables across processes makes every later
run of the same shapes start in seconds.
"""
from __future__ import annotations

import os

#: the checkout's root (this file is icon_dvr/utils/cache.py)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR verbatim when set, else
    <checkout>/.jax_cache (listed in .gitignore)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir() and return
    that path."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
