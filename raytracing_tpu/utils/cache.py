"""Persistent XLA compile cache for the app, benchmarks, tests and
chip_smoke.py.

The reference pays its compile cost at rustc time; this framework pays it
at XLA trace time (the chunk programs of a full frame take tens of
seconds to compile). The persistent compilation cache keys on the stable
HLO fingerprint, so a once-compiled program is reused across processes.

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (and
nowhere else), otherwise `.jax_cache/` at the root of the checkout — a
fixed path, since the path is part of what makes a later process find
the entries. `.gitignore` lists it.

Call enable_persistent_cache() before the first jit dispatch; later calls
are no-ops.
"""

from __future__ import annotations

import os

import jax

_ENABLED = False
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Point jax's persistent compilation cache at its directory (created
    if needed). Returns the cache directory in use."""
    global _ENABLED
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    if _ENABLED:
        return cache_dir
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache programs that took real time to compile, of any size.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _ENABLED = True
    return cache_dir
