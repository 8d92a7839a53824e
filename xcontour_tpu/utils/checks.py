"""Runtime validity checks usable under jit.

The reference's only guard is ``_check_monotonicity`` (core.py:1328-1355),
which prints offending slices and raises — impossible inside a compiled device
program.  Here the same guards are expressed with ``jax.experimental.checkify``
so they run *inside* jit and surface as structured errors after the step, plus
eager helpers for host-side use.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify


def check_monotonic(var: jax.Array, axis: int = -1, name: str = "var") -> None:
    """checkify assertion: no zero difference along ``axis`` (the reference's
    monotonicity guard, core.py:1343-1355).  Use inside a checkify.checkify-
    wrapped jitted function."""
    d = jnp.diff(var, axis=axis)
    checkify.check(jnp.all(d != 0), f"{name} not strictly monotonic along "
                   f"axis {axis} (zero difference found)")


def check_uniform_direction(var: jax.Array, axis: int = -1,
                            name: str = "var") -> None:
    """checkify assertion: every batch element runs the same monotonic
    direction along ``axis`` — the reference's explicit table-direction error
    ("not every time or level is increasing/decreasing",
    core.py:1122-1134).  Use inside a checkify.checkify-wrapped function;
    eagerly (outside jit) it raises immediately."""
    v = jnp.moveaxis(var, axis, -1)
    v = v.reshape((-1, v.shape[-1]))
    inc = v[:, -1] > v[:, 0]
    checkify.check(jnp.all(inc == inc[0]),
                   f"{name}: not every batch element is "
                   f"increasing/decreasing along axis {axis} "
                   "(mixed-direction batch)")


def check_finite(var: jax.Array, name: str = "var",
                 allow_nan_frac: float = 0.0) -> None:
    """checkify assertion that the non-finite fraction stays below a bound."""
    frac = jnp.mean(~jnp.isfinite(var), dtype=jnp.float32)
    checkify.check(frac <= allow_nan_frac,
                   f"{name}: non-finite fraction exceeds {allow_nan_frac}")


def checked(fn, *, errors=checkify.user_checks):
    """Wrap a jitted function so embedded checks surface as Python errors:

        err, out = checked(f)(x); err.throw()
    """
    return checkify.checkify(fn, errors=errors)


def assert_monotonic_host(var, axis: int = -1, name: str = "var") -> None:
    """Eager host-side version, raising with the first offending index."""
    arr = np.asarray(var)
    d = np.diff(arr, axis=axis)
    if np.any(d == 0):
        idx = np.argwhere(d == 0)[0]
        raise ValueError(f"{name} not strictly monotonic along axis {axis}; "
                         f"first zero difference at index {tuple(idx)}")
