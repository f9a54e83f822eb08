"""Where JAX keeps its persistent compile cache.

Every entry point (the CLI, ``chip_smoke.py``, ``bench.py``, the tests)
calls :func:`configure_compile_cache` before its first compilation, so all
of them share one cache and a warm start skips recompiling the placement
steps.
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_CACHE_DIR", "configure_compile_cache"]

#: fixed location inside the checkout (listed in .gitignore): the path is
#: part of the cache key, so it must not move between runs
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return it.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives in
    :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
