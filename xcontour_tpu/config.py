"""Runtime configuration: the LWA 'auto' method policy."""

from __future__ import annotations

import os
from typing import Optional

import jax

_LWA_FAST_OVERRIDE: Optional[bool] = None


def set_lwa_fast(value: Optional[bool]) -> None:
    """Allow/forbid the O(Ny log Ny) sort-merge LWA path in 'auto' method
    resolution (selected only above the measured Ny crossover; part='all'
    only); None restores the default (allowed).  Exact path control is the
    ``method`` kwarg on the LWA entry points.

    Clears the jit caches when the effective value changes: 'auto' resolves
    at trace time, and a cached trace embeds the previously-resolved path."""
    global _LWA_FAST_OVERRIDE
    old = lwa_fast()
    _LWA_FAST_OVERRIDE = value
    if lwa_fast() != old:
        jax.clear_caches()


def lwa_fast() -> bool:
    if _LWA_FAST_OVERRIDE is not None:
        return _LWA_FAST_OVERRIDE
    env = os.environ.get("XCONTOUR_LWA_FAST")
    if env is not None:
        return env not in ("0", "false", "False")
    return True


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads the
    variable itself).  Otherwise the cache lives in one fixed directory of
    the checkout, ``.jax_cache`` beside the package (listed in .gitignore),
    so every later run from the same checkout finds it.  Call it before the
    first compilation; the entry points (the CLI, bench.py, chip_smoke.py)
    do."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
