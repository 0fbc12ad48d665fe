"""Persistent XLA compilation cache, in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as is (JAX reads it
itself) and no other directory is set in code. Otherwise the cache lives at
a fixed path inside the checkout, ``<repo>/.jax_cache`` (git-ignored): a
fixed path is part of what makes a later process find the entries again.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
