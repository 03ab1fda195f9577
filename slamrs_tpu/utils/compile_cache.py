"""JAX's persistent compilation cache, kept in one directory.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself);
otherwise the cache lives at a fixed path inside the checkout,
``<repo>/.jax_cache`` (listed in ``.gitignore``).  The path is part of
the cache key, so it never depends on a temporary name, a pid or the
time.  Entry points call :func:`enable` once; importing the package
does not.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = env
    else:
        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, not only the ones that took over a second
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
