"""JAX's persistent compilation cache, kept in one place.

The timestep graph takes tens of seconds to compile; the persistent
cache lets a later process on the same machine reload the executable.
"""

from __future__ import annotations

import os
import pathlib

#: the checkout this package was loaded from
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its path.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed; otherwise the cache goes to
    ``<checkout>/.jax_cache`` (listed in ``.gitignore``)."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
