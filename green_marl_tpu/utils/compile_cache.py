"""Persistent XLA compilation cache location, shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and no other
directory is set in code.  Otherwise the cache lives at a fixed path
inside the checkout (``data/jaxcache``): the path is part of the cache
key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
from typing import Optional

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data", "jaxcache")


def enable(default_dir: Optional[str] = None) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Precedence: ``$JAX_COMPILATION_CACHE_DIR``; else a directory this
    process already configured (an entry point called in-process, as the
    tests call the CLI, keeps its caller's cache); else ``default_dir``;
    else ``data/jaxcache``.
    """
    import jax
    path = (os.environ.get(ENV) or jax.config.jax_compilation_cache_dir
            or default_dir or DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
