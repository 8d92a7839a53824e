"""Exact sort-based conditional integrals — the rearrangement ideal.

The histogram path approximates the conditional integral
F(c) = sum_{q < c} w by binning (reference core.py:1202-1325); the broadcast
path computes it exactly but at O(N_contours * grid) cost and memory
(core.py:363-409, the documented memory cliff).  This module provides the
mathematically exact result at O(G log G):

    sort q -> prefix-sum the weights -> searchsorted the contour levels.

The sort and the prefix sum are XLA library operations. Exactness makes this
the preferred path when contour counts are large (the binning error of the hist
path grows with N because bins shrink below the field's quantization).

Semantics: strict comparison (q < c for lt, q > c for gt) exactly like the
broadcast path; NaN values and NaN weights contribute nothing; no in-range
restriction (unlike the histogram path's [min-step, max] window, which only
matters for user-supplied levels outside the tracer range).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _exact_single(values: jax.Array, bins: jax.Array, weights: jax.Array,
                  lt: bool) -> jax.Array:
    """values/weights: (G,), bins: (N,) (any direction).  Returns (N,)."""
    w = jnp.where(jnp.isnan(weights) | jnp.isnan(values), 0.0, weights)
    v = jnp.where(jnp.isnan(values), jnp.inf, values)  # NaNs sort to the top
    order = jnp.argsort(v)
    vs = v[order]
    ws = w[order]
    csum = jnp.cumsum(ws)
    total = csum[-1]
    # number of elements strictly below c: searchsorted left
    idx = jnp.searchsorted(vs, bins, side="left")
    below = jnp.where(idx > 0, csum[jnp.maximum(idx - 1, 0)], 0.0)
    if lt:
        return below
    # gt: sum of q > c = total - sum of q <= c
    idx_le = jnp.searchsorted(vs, bins, side="right")
    le = jnp.where(idx_le > 0, csum[jnp.maximum(idx_le - 1, 0)], 0.0)
    return total - le


def exact_conditional_integral(values: jax.Array, bins: jax.Array,
                               weights: jax.Array, lt: bool) -> jax.Array:
    """Batched exact F(c) = sum_{q <lt/gt> c} w.

    values : (..., Ny, Nx); bins : (N,) or (..., N); weights broadcastable.
    Returns (..., N), matching the broadcast path exactly (up to summation
    order) at sort cost.
    """
    batch_shape = values.shape[:-2]
    G = values.shape[-2] * values.shape[-1]
    v = jnp.reshape(values, batch_shape + (G,))
    w = jnp.reshape(jnp.broadcast_to(weights, values.shape), batch_shape + (G,))
    N = bins.shape[-1]
    if bins.ndim == 1 and not batch_shape:
        return _exact_single(v, bins, w, lt)
    b = jnp.broadcast_to(bins, batch_shape + (N,))
    vf = jnp.reshape(v, (-1, G))
    wf = jnp.reshape(w, (-1, G))
    bf = jnp.reshape(b, (-1, N))
    out = jax.vmap(_exact_single, in_axes=(0, 0, 0, None))(vf, bf, wf, lt)
    return jnp.reshape(out, batch_shape + (N,))
