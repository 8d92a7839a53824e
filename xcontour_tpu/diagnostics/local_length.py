"""Windowed (local) contour lengths.

Re-design of the reference's rolling-window workload
(tests/test_localLength.py:41-69): for each window of the grid, the length of
the contour at that window's mean tracer value — a local stirring measure when
normalized by the window's zonal line length.

The reference materializes every (101 x 101) window through
``rolling(...).construct`` and runs the serial skimage+numba path per window
under dask.  Here the window means come from an integral-image (cumulative
sum) in O(grid), and the per-window geometry reuses the traversal-free
marching-squares cell kernel on dynamic slices — one fused XLA program,
batched over window columns via vmap and window rows via lax.map (bounded
memory).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.constants import Rearth as _REARTH
from .length import _level_total_length


def rolling_mean(data: jax.Array, window: int, stride: int,
                 min_count: int = 1):
    """NaN-skipping mean over (window x window) tiles anchored at strided
    top-left corners; windows with fewer than ``min_count`` valid points give
    NaN (the reference's ``min_periods``, tests/test_localLength.py:41)."""
    good = jnp.isfinite(data)
    # remove the field's constant offset before building the integral image:
    # a box sum is a small difference of huge cumsums, and in f32 a
    # Kelvin-scale offset (~3e2 over 1e6 cells -> ~3e8 partials) would leave
    # O(1e-3) relative error in the window mean vs the reference's direct
    # rolling(...).mean(); mean(f) = mean(f - c) + c restores it exactly
    c0 = jnp.nanmean(jnp.where(good, data, jnp.nan), axis=(-2, -1),
                     keepdims=True)
    c0 = jnp.where(jnp.isfinite(c0), c0, 0.0)
    vals = jnp.where(good, data - c0, 0.0)

    def integral(a):
        s = jnp.cumsum(jnp.cumsum(a, axis=-2), axis=-1)
        return jnp.pad(s, [(0, 0)] * (a.ndim - 2) + [(1, 0), (1, 0)])

    S = integral(vals)
    C = integral(good.astype(data.dtype))
    ny, nx = data.shape[-2:]
    oy = jnp.arange(0, ny - window + 1, stride)
    ox = jnp.arange(0, nx - window + 1, stride)

    def box(I, y0, x0):
        return (I[..., y0 + window, x0 + window] - I[..., y0 + window, x0]
                - I[..., y0, x0 + window] + I[..., y0, x0])

    yy, xx = jnp.meshgrid(oy, ox, indexing="ij")
    s = box(S, yy, xx)
    n = box(C, yy, xx)
    mean = s / jnp.maximum(n, 1) + c0   # c0 is (..., 1, 1): broadcasts
    return jnp.where(n >= min_count, mean, jnp.nan), oy, ox


def _cell_panels(data: jax.Array, yc: jax.Array, xc: jax.Array):
    """Corner values, NaN mask and corner-coordinate panels for every grid
    cell — the operand tuple of :func:`_one_window_length`.  Shared by the
    single-device XLA path and parallel.local_length's sharded path so the
    window semantics cannot drift between them."""
    v00 = data[:-1, :-1]
    v01 = data[:-1, 1:]
    v10 = data[1:, :-1]
    v11 = data[1:, 1:]
    nan_cell = jnp.isnan(v00) | jnp.isnan(v01) | jnp.isnan(v10) | jnp.isnan(v11)
    shape = v00.shape
    y0g = jnp.broadcast_to(yc[:-1, None], shape)
    y1g = jnp.broadcast_to(yc[1:, None], shape)
    x0g = jnp.broadcast_to(xc[None, :-1], shape)
    x1g = jnp.broadcast_to(xc[None, 1:], shape)
    return v00, v01, v10, v11, y0g, y1g, x0g, x1g, nan_cell


def _one_window_raw(panels, W: int, y0, x0, level, latlon: bool):
    """Raw contour length inside the (W x W)-cell window anchored at grid
    point (y0, x0).  NaN levels are substituted by 0 so the VJP never meets
    a NaN jacobian (the caller's NaN rule hides the substituted primal)."""
    sl = lambda a: jax.lax.dynamic_slice(a, (y0, x0), (W, W))
    lv = jnp.where(jnp.isnan(level), 0.0, level)
    return _level_total_length(lv, *(sl(a) for a in panels), latlon)


def _one_window_length(panels, W: int, y0, x0, level, latlon: bool):
    """Length of the ``level`` contour inside the (W x W)-cell window
    anchored at grid point (y0, x0); NaN for NaN levels and empty contours
    (the global kernel's rule)."""
    total = _one_window_raw(panels, W, y0, x0, level, latlon)
    return jnp.where(jnp.isnan(level) | (total == 0.0), jnp.nan, total)


def _local_totals_xla_raw(data, levels, yc, xc, *, window: int, stride: int,
                          latlon: bool):
    """(Wy, Wx) raw window totals: window columns vmapped, window rows
    through ``lax.map`` (bounded memory)."""
    ny, nx = data.shape[-2:]
    oy = jnp.arange(0, ny - window + 1, stride)
    ox = jnp.arange(0, nx - window + 1, stride)
    panels = _cell_panels(data, yc, xc)
    W = window - 1

    def one_row(iy):
        return jax.vmap(lambda ix: _one_window_raw(
            panels, W, oy[iy], ox[ix], levels[iy, ix], latlon))(
            jnp.arange(ox.shape[0]))

    return jax.lax.map(one_row, jnp.arange(oy.shape[0]))


def _window_centers(ydef, xdef, oy, ox, window: int):
    """Window-center coordinates (falls back to the anchors when the grid is
    narrower than half a window)."""
    cy = ydef[oy + window // 2] if window // 2 < ydef.shape[0] else ydef[oy]
    cx = xdef[ox + window // 2] if window // 2 < xdef.shape[0] else xdef[ox]
    return cy, cx


@partial(jax.jit, static_argnames=("window", "stride", "latlon", "min_count"))
def local_contour_lengths(data: jax.Array, ydef: jax.Array, xdef: jax.Array, *,
                          window: int = 101, stride: int = 10,
                          latlon: bool = True, min_count: int = 1,
                          levels: jax.Array | None = None,
                          Rearth: float = _REARTH):
    """Per-window contour length at the window-mean level.

    data : (Ny, Nx);  returns (lengths (Wy, Wx), window-center y, x coords).
    ``levels`` overrides the rolling-mean levels (same (Wy, Wx) shape).
    Empty windows/contours give NaN like the global kernel.
    """
    yc = jnp.deg2rad(ydef) if latlon else ydef
    xc = jnp.deg2rad(xdef) if latlon else xdef
    yc = yc.astype(data.dtype)
    xc = xc.astype(data.dtype)

    means, oy, ox = rolling_mean(data, window, stride, min_count)
    if levels is None:
        levels = means

    totals = _local_totals_xla_raw(data, levels, yc, xc, window=window,
                                   stride=stride, latlon=latlon)
    lengths = jnp.where(jnp.isnan(levels) | (totals == 0.0), jnp.nan, totals)
    if latlon:
        lengths = lengths * Rearth
    cy, cx = _window_centers(ydef, xdef, oy, ox, window)
    return lengths, cy, cx
