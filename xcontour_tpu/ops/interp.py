"""Vectorized monotone 1-D interpolation.

Replaces the reference's per-batch Python loop over ``np.interp``
(apply_ufunc(vectorize=True) at /root/reference/xcontour/core.py:1161-1169 and
:1091-1098) with a vmapped ``jnp.interp``.  Decreasing abscissae are handled by
reversal, exactly like the reference ``_interp1d`` (core.py:1405-1434);
out-of-range queries clamp to the endpoints (np.interp semantics).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _interp_single(x, xf, yf, inc, extrapolate):
    xf2 = jnp.where(inc, xf, xf[::-1])
    yf2 = jnp.where(inc, yf, yf[::-1])
    out = jnp.interp(x, xf2, yf2)
    if extrapolate == "nan":
        out = jnp.where((x < xf2[0]) | (x > xf2[-1]), jnp.nan, out)
    return out


# Above this table size the dense-compare form's O(M*N) work overtakes the
# binary search; every table in the diagnostics (contour counts 121-401,
# grid rows <= a few thousand) sits far below it.
_DENSE_N_MAX = 4096
# The dense form materializes several (B, M, N) temporaries; cap their total
# element count (~64 MB of f32 per temporary at this bound) so a huge query
# axis against a near-cap table cannot allocate multi-GB intermediates where
# the binary-search path is O(M log N) memory.
_DENSE_ELEMS_MAX = 1 << 24


def _interp_dense(x2, xf2, yf2, inc, extrapolate):
    """np.interp by dense compare + one-hot contraction, batched.

    jnp.interp lowers to a per-query binary search with gathers.  For small
    N the dense form (count xf <= x, then contract one-hot index masks
    against xf/yf) is pure elementwise compare/FMA work at O(M*N) with no
    gathers; which is faster on the GPU is not measured yet (ROADMAP S4).
    Matches np.interp:
    side='right' index, zero-width intervals return the right endpoint,
    out-of-range clamps (or NaN for extrapolate='nan').  One deliberate
    deviation: a NaN query always returns NaN, even against a fully
    degenerate (zero-width-everywhere) table where np.interp's arithmetic
    happens to pick a finite endpoint.
    """
    N = xf2.shape[-1]
    xfd = jnp.where(inc[:, None], xf2, xf2[:, ::-1])
    yfd = jnp.where(inc[:, None], yf2, yf2[:, ::-1])
    # i = clip(searchsorted(xf, x, side='right'), 1, N-1), as one compare sum
    cnt = jnp.sum(x2[:, :, None] >= xfd[:, None, :], axis=-1)
    i = jnp.clip(cnt, 1, N - 1)
    iota = jnp.arange(N)
    hi = iota[None, None, :] == i[:, :, None]
    lo = iota[None, None, :] == (i - 1)[:, :, None]
    # where-guarded contractions: a NaN table entry must only affect queries
    # that actually select it (NaN * 0 would poison the whole sum)
    xr = jnp.sum(jnp.where(hi, xfd[:, None, :], 0), axis=-1)
    xl = jnp.sum(jnp.where(lo, xfd[:, None, :], 0), axis=-1)
    yr = jnp.sum(jnp.where(hi, yfd[:, None, :], 0), axis=-1)
    yl = jnp.sum(jnp.where(lo, yfd[:, None, :], 0), axis=-1)
    dx = xr - xl
    t = (x2 - xl) / jnp.where(dx == 0, 1.0, dx)
    out = jnp.where(dx == 0, yr, yl + t * (yr - yl))
    lo_end, hi_end = xfd[:, :1], xfd[:, -1:]
    if extrapolate == "nan":
        edge = jnp.nan
        out = jnp.where((x2 < lo_end) | (x2 > hi_end), edge, out)
    else:
        out = jnp.where(x2 < lo_end, yfd[:, :1], out)
        out = jnp.where(x2 > hi_end, yfd[:, -1:], out)
    return out


def interp1d(x: jax.Array, xf: jax.Array, yf: jax.Array,
             increasing=None, extrapolate: str = "clamp") -> jax.Array:
    """Batched np.interp with direction handling.

    ``x``: (..., M) or (M,) query points; ``xf``/``yf``: (..., N) data points.
    ``increasing``: direction of ``xf``; None derives it per batch element, a
    bool/traced scalar applies one direction globally (the reference derives it
    from the first batch element — pass that in for exact parity).
    ``extrapolate``: 'clamp' (np.interp endpoint clamping, the reference's
    _interp1d behavior) or 'nan' (xarray-style NaN outside the data range).
    Batch dims of all arguments broadcast together.
    """
    # broadcast batch dims
    xb = x.shape[:-1] if x.ndim > 1 else ()
    batch = jnp.broadcast_shapes(xb, xf.shape[:-1], yf.shape[:-1])
    M = x.shape[-1]
    N = xf.shape[-1]
    x2 = jnp.broadcast_to(x, batch + (M,)).reshape((-1, M))
    xf2 = jnp.broadcast_to(xf, batch + (N,)).reshape((-1, N))
    yf2 = jnp.broadcast_to(yf, batch + (N,)).reshape((-1, N))

    if increasing is None:
        inc = xf2[:, -1] > xf2[:, 0]
    else:
        inc = jnp.broadcast_to(jnp.asarray(increasing), (x2.shape[0],))

    if N <= _DENSE_N_MAX and x2.shape[0] * M * N <= _DENSE_ELEMS_MAX:
        out = _interp_dense(x2, xf2, yf2, inc, extrapolate)
    else:
        out = jax.vmap(_interp_single, in_axes=(0, 0, 0, 0, None))(
            x2, xf2, yf2, inc, extrapolate)
    # NaN queries stay NaN on every path: against a fully degenerate
    # (zero-width) table the dx==0 endpoint select would otherwise pick a
    # finite value before the NaN can propagate through the blend
    out = jnp.where(jnp.isnan(x2), jnp.nan, out)
    return out.reshape(batch + (M,))
