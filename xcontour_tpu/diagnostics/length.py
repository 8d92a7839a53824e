"""Contour geometry: perimeter lengths and box-counting crossing lengths.

Perimeter: the reference runs scikit-image's serial marching-squares traversal
per (batch, contour) and sums numba-jit haversine polyline lengths
(/root/reference/xcontour/core.py:1437-1487, utils.py:565-609).  Total
perimeter is traversal-invariant, so here marching squares is *traversal-free*:
every grid cell independently classifies its 4-corner case, generates its
segment endpoints by the same linear interpolation skimage uses, measures them
geodesically, and a masked sum reduces per contour.  That turns the whole
computation into one data-parallel XLA kernel batched over
(batch, contour, cell) — no serial chasing, no host loops.

Saddle (ambiguous) cells follow skimage's default ``fully_connected='low'``
rule: corners above the level are cut off individually.  NaN corners generate
no segments, exactly like skimage.

Box counting: the reference numba kernel (core.py:1490-1566) loops every box
and corner serially.  Here each stride level is two ``reduce_window`` min/max
passes (NaN-aware) over the padded field, after which *every* contour level is
a pair of comparisons per box: crossing = (win_min <= c) & (win_max > c).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import Rearth as _REARTH


def _haversine(lon1, lon2, lat1, lat2):
    """Great-circle distance, unit sphere, radians (reference utils.py:734-761).

    Gradient-safe at the endpoints of arcsin(sqrt(.)): a == 0 (coincident
    points — guaranteed by cal_contours' endpoint-pinned levels, which
    create zero-length segments through cell corners) and a == 1 (antipodal)
    have infinite d/da; those lanes take the exact constant primal (0 or pi)
    instead, so jax.grad gets the zero subgradient rather than NaN."""
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = jnp.sin(dlat * 0.5) ** 2 + jnp.cos(lat1) * jnp.cos(lat2) * jnp.sin(dlon * 0.5) ** 2
    a = jnp.clip(a, 0.0, 1.0)
    bad = (a == 0.0) | (a == 1.0)
    core = 2.0 * jnp.arcsin(jnp.sqrt(jnp.where(bad, 0.25, a)))
    return jnp.where(bad, jnp.where(a == 0.0, 0.0, jnp.pi), core)


def _hypot_grad_safe(d0, d1):
    """jnp.hypot with the zero subgradient at (0, 0) (hypot's own jacobian
    is 0/0 = NaN there; zero-length segments are routine, see _haversine)."""
    deg = (d0 == 0.0) & (d1 == 0.0)
    safe = jnp.hypot(jnp.where(deg, 1.0, d0), jnp.where(deg, 1.0, d1))
    return jnp.where(deg, 0.0, safe)


def _level_total_length(level, v00, v01, v10, v11, y0, y1, x0, x1,
                        nan_cell, latlon: bool):
    """Sum of in-cell segment lengths for one contour level.

    NaN corners are substituted by zeros BEFORE classification: their cells
    are zeroed by ``nan_cell`` regardless (same primal), but letting NaN
    flow into the fractions gives the VJP a 0-cotangent x NaN-jacobian
    product and poisons gradients around every masked cell."""
    v00 = jnp.where(nan_cell, 0.0, v00)
    v01 = jnp.where(nan_cell, 0.0, v01)
    v10 = jnp.where(nan_cell, 0.0, v10)
    v11 = jnp.where(nan_cell, 0.0, v11)
    a00 = v00 > level
    a01 = v01 > level
    a10 = v10 > level
    a11 = v11 > level

    def frac(va, vb):
        d = vb - va
        return jnp.where(d == 0, 0.0, (level - va) / jnp.where(d == 0, 1.0, d))

    ft = frac(v00, v01)
    fb = frac(v10, v11)
    fl = frac(v00, v10)
    fr = frac(v01, v11)

    def lerp(f, c0, c1):
        # convex-combination form: f in {0, 1} (a corner EQUAL to the level,
        # guaranteed at the endpoint-pinned contours) lands bitwise on the
        # corner under ANY compilation — `c0 + f*(c1-c0)` does not once the
        # vectorizer picks an fma, and the surviving ~1e-10 segment length
        # broke the exact total==0 -> NaN empty-contour rule (fuzz campaign
        # seed 500002)
        return (1.0 - f) * c0 + f * c1

    top = (y0, lerp(ft, x0, x1))
    bot = (y1, lerp(fb, x0, x1))
    lef = (lerp(fl, y0, y1), x0)
    rig = (lerp(fr, y0, y1), x1)

    if latlon:
        def seglen(p, q):
            return _haversine(p[1], q[1], p[0], q[0])
    else:
        def seglen(p, q):
            return _hypot_grad_safe(p[0] - q[0], p[1] - q[1])

    iso00 = (a00 != a01) & (a00 != a10) & (a01 == a11)
    iso01 = (a01 != a00) & (a01 != a11) & (a00 == a10)
    iso10 = (a10 != a00) & (a10 != a11) & (a00 == a01)
    iso11 = (a11 != a01) & (a11 != a10) & (a01 == a00)
    horiz = (a00 == a01) & (a10 == a11) & (a00 != a10)
    verti = (a00 == a10) & (a01 == a11) & (a00 != a01)
    sad_main = a00 & a11 & ~a01 & ~a10     # high corners on the main diagonal
    sad_anti = a01 & a10 & ~a00 & ~a11

    # select segment endpoints FIRST, then evaluate the (transcendental)
    # length once per segment — 2 instead of 6 haversines per cell
    def sel(c, p, q):
        return (jnp.where(c, p[0], q[0]), jnp.where(c, p[1], q[1]))

    p1 = sel(horiz, lef, sel(iso10 | iso11, bot, top))
    q1 = sel(iso00 | iso10 | sad_main, lef,
             sel(verti, bot, rig))
    exists1 = iso00 | iso01 | iso10 | iso11 | horiz | verti | sad_main | sad_anti
    L = jnp.where(exists1, seglen(p1, q1), 0.0)

    saddle = sad_main | sad_anti
    q2 = sel(sad_main, rig, lef)
    L = L + jnp.where(saddle, seglen(bot, q2), 0.0)

    L = jnp.where(nan_cell, 0.0, L)
    return jnp.sum(L, axis=(-2, -1))


def _lengths_totals_xla(data, ctr, yc, xc, *, latlon: bool, chunk: int):
    """Raw per-level perimeter totals (..., N), evaluated in chunks of
    ``chunk`` levels.  The marching-squares vertex positions are linear
    interpolations of the corner values, so lengths are genuinely differentiable in the tracer
    (a.e.; the case classification is piecewise constant)."""
    v00 = data[..., :-1, :-1]
    v01 = data[..., :-1, 1:]
    v10 = data[..., 1:, :-1]
    v11 = data[..., 1:, 1:]
    nan_cell = jnp.isnan(v00) | jnp.isnan(v01) | jnp.isnan(v10) | jnp.isnan(v11)
    shape = v00.shape[-2:]
    y0 = jnp.broadcast_to(yc[:-1, None], shape)
    y1 = jnp.broadcast_to(yc[1:, None], shape)
    x0 = jnp.broadcast_to(xc[None, :-1], shape)
    x1 = jnp.broadcast_to(xc[None, 1:], shape)
    batch_shape = data.shape[:-2]
    N = ctr.shape[-1]

    def one_level(k):
        c = ctr[..., k]  # (...,) per-batch level
        # NaN levels (all-NaN batch elements in cal_contours) are evaluated
        # at 0 under the hood and re-zeroed, exactly like the local-window
        # twin: the raw NaN would poison the VJP of every cell it compares
        # against, while the primal is unchanged (0 -> NaN under the
        # caller's empty-contour rule either way)
        cs = jnp.where(jnp.isnan(c), 0.0, c)
        cb = cs[..., None, None] if batch_shape else cs
        tot = _level_total_length(cb, v00, v01, v10, v11, y0, y1, x0, x1,
                                  nan_cell, latlon)
        return jnp.where(jnp.isnan(c), 0.0, tot)

    chunk = max(1, min(chunk, N))
    npad = (-N) % chunk
    idx = jnp.arange(N + npad).reshape(-1, chunk)
    totals = jax.lax.map(jax.vmap(one_level), idx)
    totals = totals.reshape((-1,) + totals.shape[2:])[:N]      # (N, ...)
    return jnp.moveaxis(totals, 0, -1)                         # (..., N)


@partial(jax.jit, static_argnames=("latlon", "chunk"))
def contour_lengths(data, contours, ydef, xdef, *, latlon: bool = False,
                    Rearth: float = _REARTH, chunk: int = 8):
    """Perimeter of each contour level.

    data : (..., Ny, Nx); contours : (..., N) or (N,);
    ydef/xdef : coordinate vectors (degrees if latlon, meters otherwise).
    Returns (..., N); contours with zero total length give NaN
    (reference utils.py:603-604).
    """
    yc = jnp.deg2rad(ydef) if latlon else ydef
    xc = jnp.deg2rad(xdef) if latlon else xdef
    yc = yc.astype(data.dtype)
    xc = xc.astype(data.dtype)

    batch_shape = data.shape[:-2]
    ctr = jnp.broadcast_to(contours, batch_shape + contours.shape[-1:])
    totals = _lengths_totals_xla(data, ctr, yc, xc, latlon=latlon,
                                 chunk=chunk)
    totals = jnp.where(totals == 0.0, jnp.nan, totals)
    return totals * Rearth if latlon else totals


def _window_minmax(data, stride: int):
    """NaN-aware (min, max) over (stride+1)x(stride+1) windows advancing by
    stride; all-NaN windows give (+inf, -inf)."""
    nan = jnp.isnan(data)
    lo = jnp.where(nan, jnp.inf, data)
    hi = jnp.where(nan, -jnp.inf, data)
    win = (1,) * (data.ndim - 2) + (stride + 1, stride + 1)
    strd = (1,) * (data.ndim - 2) + (stride, stride)
    wmin = jax.lax.reduce_window(lo, jnp.inf, jax.lax.min, win, strd, "VALID")
    wmax = jax.lax.reduce_window(hi, -jnp.inf, jax.lax.max, win, strd, "VALID")
    return wmin, wmax


@partial(jax.jit, static_argnames=("stride", "pad_x", "mode", "quirks"))
def _crossing_one_stride(data, contours, area, stride: int, pad_x: int,
                         mode: str, quirks: bool):
    batch = data.shape[:-2]
    pad = [(0, 0)] * (data.ndim - 2) + [(0, 0), (0, pad_x)]
    d = jnp.pad(data, pad, mode=mode)
    a = jnp.pad(area, [(0, 0), (0, pad_x)], mode=mode)

    jj, nn = d.shape[-2:]
    Jn = int(np.round(jj / stride))
    In = int(np.round(nn / stride))
    i_bound = (Jn - 1) if quirks else (In - 1)

    # the reference's quirks loop can demand more column boxes than the
    # padded width holds (its numpy slices CLAMP at the edge and width-1
    # blocks still participate, core.py:1545-1550); extra NaN columns make
    # the NaN-aware window min/max reproduce exactly those clamped blocks
    # instead of a shape error (fuzz campaign seed 1004: Ny=11 Nx=8 s=2)
    extra = max(0, i_bound * stride + 1 - nn)
    if extra:
        d = jnp.pad(d, [(0, 0)] * (d.ndim - 1) + [(0, extra)],
                    constant_values=np.nan)
        a = jnp.pad(a, [(0, 0), (0, extra)], constant_values=np.nan)

    wmin, wmax = _window_minmax(d, stride)
    wmin = wmin[..., : Jn - 1, :i_bound]
    wmax = wmax[..., : Jn - 1, :i_bound]

    if quirks:
        # reference bug: area indexed by box index (core.py:1562)
        a_box = a[: Jn - 1, :i_bound]
    else:
        a_box = a[::stride, ::stride][: Jn - 1, :i_bound]
    contrib = jnp.sqrt(a_box) * stride
    contrib = jnp.where(jnp.isnan(contrib), 0.0, contrib)

    ctr = jnp.broadcast_to(contours, batch + contours.shape[-1:])

    def one_level(k):
        c = ctr[..., k]
        cb = c[..., None, None] if batch else c
        crossing = (wmin <= cb) & (wmax > cb)
        return jnp.sum(jnp.where(crossing, contrib, 0.0), axis=(-2, -1))

    N = ctr.shape[-1]
    out = jax.vmap(one_level)(jnp.arange(N))
    return jnp.moveaxis(out, 0, -1)


def contour_crossing(data, contours, area, stride=1, *, mode: str = "edge",
                     quirks: bool = False):
    """Box-counting crossing length(s) (reference core.py:640-693, 1490-1566).

    ``stride`` may be an int or a sequence of ints (returns a list, like the
    reference).  X is padded once by the max stride with ``mode``
    (core.py:673-675) so every stride sees the same padded field.
    ``quirks=True`` reproduces the reference's latent indexing bugs for
    bit-parity (SURVEY.md §0.2); the default computes the corrected full-width
    version.
    """
    if isinstance(stride, Sequence):
        pad_x = int(max(stride))
        return [_crossing_one_stride(data, contours, area, int(s), pad_x,
                                     mode, quirks) for s in stride]
    return _crossing_one_stride(data, contours, area, int(stride), int(stride),
                                mode, quirks)
