"""Where JAX keeps its persistent compile cache for this repository's programs.

``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing else is set (JAX
reads the variable itself).  Otherwise the cache lives in ``.jax_cache/`` at
the root of the checkout — a fixed path, since the path is part of the cache
key, listed in ``.gitignore``.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / '.jax_cache'
# programs that compile faster than this are not worth a cache entry
MIN_COMPILE_TIME_SECS = 0.5


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get('JAX_COMPILATION_CACHE_DIR') or str(CHECKOUT_CACHE)


def enable() -> str:
    """Turn the persistent compile cache on for this process; returns its
    directory."""
    import jax

    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir', str(CHECKOUT_CACHE))
    jax.config.update('jax_persistent_cache_min_compile_time_secs', MIN_COMPILE_TIME_SECS)
    return cache_dir()
