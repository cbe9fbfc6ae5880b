"""Where JAX keeps its persistent compilation cache.

One policy for every entry point (CLI, bench, smoke test, tests): where
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it; otherwise the cache lives at a fixed path inside the checkout,
`<checkout>/.jax_cache` (git-ignored). The path is part of the cache key, so
a fixed location is what lets a later process find earlier compiles.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def compile_cache_dir(environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """The directory this program must configure, or None when the
    environment already names one (JAX_COMPILATION_CACHE_DIR)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str:
    """Apply the policy above; returns the cache directory in effect."""
    path = compile_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    return path
