"""JAX's persistent compilation cache for every entry point of the repo.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here sets another path.  Otherwise the cache goes to one fixed directory
inside the checkout (gitignored), so every process of this checkout finds
what an earlier one compiled.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the cache on; returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
