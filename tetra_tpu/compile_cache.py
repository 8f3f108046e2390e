"""JAX persistent compilation cache location for the entry points.

Entry points (chip_smoke.py, bench.py, scripts/bench_e2e.py, the apps/
mains) call `enable()` once before their first compile.  Package import
never touches the cache setting.
"""

from __future__ import annotations

import os

#: fixed in-checkout default (listed in .gitignore); the cache key includes
#: the path, so a fixed location is what lets a second run hit
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at JAX_COMPILATION_CACHE_DIR
    when that is set (JAX reads the variable itself, so nothing else is
    set), else at DEFAULT_DIR.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
