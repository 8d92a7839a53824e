"""Weighted-histogram CDF engine — the rearrangement primitive.

This replaces the reference's xhistogram path
(/root/reference/xcontour/core.py:1202-1325 ``_histogram``): a digitize
(searchsorted) + segment-sum + prefix-scan pipeline instead of dask-chunked
numpy bincounts.  Exact reference edge semantics are preserved:

* one bin of width ``step`` is prepended so output length == number of
  contours (core.py:1277-1305);
* decreasing bin arrays are handled by ascending-order histogramming with the
  output mapped back so ``out[k]`` pairs with ``bins[k]``;
* values outside [b_min - step, b_max] are excluded; the top edge is
  right-inclusive (np.histogram semantics);
* ``lt=False`` flips the CDF via total - CDF (core.py:1322-1324);
* NaN weights count as zero (core.py:449); NaN values fall in no bin.

Unlike xhistogram, bins may vary per batch element (the reference cannot do
per-level bins and has to fall back to the memory-hungry broadcast path for 3-D
data — see SURVEY.md §0.2); here batched bins are simply vmapped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


_ROW = 512  # samples per partial histogram in _binned_sum


def _binned_sum(w: jax.Array, idx: jax.Array, N: int) -> jax.Array:
    """segment_sum of w (G,) into N bins with a two-level reduction: one
    partial histogram per row of _ROW samples, then a tree sum over rows.

    A flat float32 scatter-add sums ~G/N samples into each bin in arrival
    order; on the GPU that order is the atomics' and changes from run to
    run, and at 1e5-1e6 cells the rounding reached ~1e-6 of the total area.
    Partial histograms put only a few samples in each (row, bin) slot, and
    the row sum is an XLA reduction (a tree), so the error stays near
    eps * log(G) and the atomics rarely contend."""
    G = w.shape[-1]
    pad = (-G) % _ROW
    if pad:
        w = jnp.concatenate([w, jnp.zeros((pad,), w.dtype)])
        idx = jnp.concatenate([idx, jnp.zeros((pad,), idx.dtype)])
    rows = (G + pad) // _ROW
    seg = idx.reshape(rows, _ROW) + (jnp.arange(rows) * N)[:, None]
    part = jax.ops.segment_sum(w, seg.reshape(-1), num_segments=rows * N)
    return part.reshape(rows, N).sum(axis=0)


def bincount_single(values: jax.Array, bins: jax.Array, weights: jax.Array):
    """Ascending-order weighted histogram for one flattened sample set.

    values/weights: (G,), bins: (N,).  Returns (hist (N,), bincrease) where
    hist is in ascending-bin-value order.  This is the local building block
    the sharded (shard_map + psum) path reuses.
    """
    N = bins.shape[0]
    bincrease = bins[0] < bins[-1]
    asc = jnp.where(bincrease, bins, bins[::-1])
    step = (asc[-1] - asc[0]) / (N - 1)
    edges = jnp.concatenate([(asc[0] - step)[None], asc])

    # np.digitize(right=False): bin j covers [edges[j], edges[j+1]);
    # the final bin is right-inclusive like np.histogram.
    idx = jnp.searchsorted(edges, values, side="right") - 1
    idx = jnp.where(values == edges[-1], N - 1, idx)
    valid = (idx >= 0) & (idx <= N - 1) & ~jnp.isnan(values)

    w = jnp.where(jnp.isnan(weights), 0.0, weights)
    w = jnp.where(valid, w, 0.0)
    hist = _binned_sum(w, jnp.clip(idx, 0, N - 1), N)
    return hist, bincrease


def cdf_from_hist(hist: jax.Array, bincrease, lt: bool) -> jax.Array:
    """Prefix-scan an ascending-order histogram into the reference CDF
    (lt/gt flip + decreasing-bin re-pairing)."""
    cdf = jnp.cumsum(hist, axis=-1)
    if not lt:
        cdf = cdf[..., -1:] - cdf
    return jnp.where(bincrease, cdf, cdf[..., ::-1])


def _cdf_single(values: jax.Array, bins: jax.Array, weights: jax.Array,
                lt: bool) -> jax.Array:
    """CDF for one flattened sample set.  values/weights: (G,), bins: (N,)."""
    hist, bincrease = bincount_single(values, bins, weights)
    return cdf_from_hist(hist, bincrease, lt)


def _edges_cdf_xla(vf: jax.Array, edges: jax.Array, wf: jax.Array):
    """Several channels over one digitize: (B, G) values, (B, N+1) ascending
    edges, (B, C, G) weights -> (B, C, N) ascending CDF with the edge/NaN
    semantics of :func:`bincount_single`.  Linear in the weights;
    values/edges get the correct a.e.-zero cotangent through the integer
    digitize."""
    N = edges.shape[-1] - 1

    def one(v, e, w):
        idx = jnp.searchsorted(e, v, side="right") - 1
        idx = jnp.where(v == e[-1], N - 1, idx)         # top edge inclusive
        valid = (idx >= 0) & (idx <= N - 1) & ~jnp.isnan(v)
        wv = jnp.where(jnp.isnan(w), 0.0, w)
        wv = jnp.where(valid[None, :], wv, 0.0)
        hist = jax.vmap(lambda wc: _binned_sum(
            wc, jnp.clip(idx, 0, N - 1), N))(wv)
        return jnp.cumsum(hist, axis=-1)

    return jax.vmap(one)(vf, edges, wf)


def weighted_cdf_multi(values: jax.Array, bins: jax.Array, weights_list,
                       lt: bool):
    """Several weighted CDFs over the SAME values and bins in one pass.

    The Keff chain needs the area CDF and the |grad q|^2 CDF of the same
    tracer/levels: the values are digitized once and every channel is
    scattered against the shared bin indices.

    weights_list : sequence of arrays broadcastable to ``values``.
    Returns a list of (..., N) arrays in the same order.
    """
    C = len(weights_list)
    batch_shape = values.shape[:-2]
    G = values.shape[-2] * values.shape[-1]
    N = bins.shape[-1]
    vf = jnp.reshape(values, batch_shape + (G,)).reshape((-1, G))
    wf = jnp.stack([
        jnp.reshape(jnp.broadcast_to(w, values.shape),
                    batch_shape + (G,)).reshape((-1, G))
        for w in weights_list], axis=1)                       # (B, C, G)
    bf = jnp.reshape(jnp.broadcast_to(bins, batch_shape + (N,)), (-1, N))

    bincrease = bf[:, :1] < bf[:, -1:]
    asc = jnp.where(bincrease, bf, bf[:, ::-1])
    step = (asc[:, -1:] - asc[:, :1]) / (N - 1)
    edges = jnp.concatenate([asc[:, :1] - step, asc], axis=1)
    cdf = _edges_cdf_xla(vf, edges, wf)                       # (B, C, N)
    if not lt:
        cdf = cdf[:, :, -1:] - cdf
    cdf = jnp.where(bincrease[:, None, :], cdf, cdf[:, :, ::-1])
    return [jnp.reshape(cdf[:, c], batch_shape + (N,)) for c in range(C)]


def weighted_cdf(values: jax.Array, bins: jax.Array, weights: jax.Array,
                 lt: bool) -> jax.Array:
    """Batched weighted-histogram CDF.

    Parameters
    ----------
    values : (..., Ny, Nx) field to histogram (NaN = missing).
    bins : (N,) or (..., N) contour levels, monotonic per batch element.
        Batched bins are vmapped — a capability the reference lacks.
    weights : broadcastable to ``values``; NaN treated as 0.
    lt : CDF of "less than" (True) or "greater or equal" (False).  Static.

    Returns
    -------
    (..., N) with ``out[..., k]`` paired with ``bins[..., k]``.
    """
    batch_shape = values.shape[:-2]
    G = values.shape[-2] * values.shape[-1]
    v = jnp.reshape(values, batch_shape + (G,))
    w = jnp.reshape(jnp.broadcast_to(weights, values.shape), batch_shape + (G,))
    N = bins.shape[-1]

    if bins.ndim == 1 and not batch_shape:
        return _cdf_single(v, bins, w, lt)

    b = jnp.broadcast_to(bins, batch_shape + (N,))
    vf = jnp.reshape(v, (-1, G))
    wf = jnp.reshape(w, (-1, G))
    bf = jnp.reshape(b, (-1, N))
    out = jax.vmap(_cdf_single, in_axes=(0, 0, 0, None))(vf, bf, wf, lt)
    return jnp.reshape(out, batch_shape + (N,))
