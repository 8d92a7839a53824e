"""Host-side contour extraction in coordinate space.

Implements the reference's newer script-facing symbols (used by
tests/test_breaking.py:412-421 and tests/test_clength.py:615-630):

* ``find_contour(data, dims, level, period=...)`` — marching-squares polylines
  mapped from index space to physical coordinates (with optional periodic
  coordinate interpolation, mirroring np.interp's ``period`` argument);
* ``contour_length`` — polyline length, BOTH reference API generations:
  the newer 1-arg coordinate-space form ``contour_length(segment, latlon=...)``
  and the older index-space form ``contour_length(segments, xdef, ydef,
  latlon)`` (reference utils.py:565-609, the one core.py:1477 calls);
* ``contour_area(verts)`` — shoelace area of a closed contour
  (reference utils.py:537-561).

Extraction runs on the native C++ traversal (csrc/marching.cpp) with a NumPy
fallback; this path is for *connectivity-aware* analyses (wave breaking,
contour grouping).  Total perimeter per contour — the only thing the bulk
pipelines need — runs as the traversal-free device kernel in
diagnostics/length.py instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils.constants import Rearth as _REARTH
from .native import find_contours


def find_contour(data, dims: Optional[Sequence] = None, level: float = 0.0,
                 period: Sequence = (None, None)) -> List[np.ndarray]:
    """Extract contour polylines at ``level`` in coordinate space.

    data : 2-D array (Ny, Nx) (NaN = missing);
    dims : (ydef, xdef) coordinate vectors, or None for index coordinates;
    period : optional per-dim coordinate periods (e.g. ``(None, 360)`` for
        global longitude).  A periodic axis is wrapped by one row/column
        before marching squares, so a contour crossing the 0/360 seam is
        traversed through the seam cells instead of being cut open there;
        vertices landing in the wrap column map to ``coord[0] + period``.

    Returns a list of (K, 2) arrays with columns (y, x), like the reference's
    ``find_contour`` (segments in coordinate units; usage
    /root/reference/tests/test_breaking.py:412-421,
    /root/reference/tests/test_clength.py:615-630).

    Note: the reference's script-level composition feeds ``period`` straight
    to np.interp over *index* space, where it silently reorders the abscissa
    whenever the grid is longer than the period — here the period acts on the
    coordinate values, which is the semantics the scripts intend.
    """
    d = np.asarray(data, np.float64)
    if dims is not None and len(dims) != 2:
        raise ValueError(f"dims must be (ydef, xdef) coordinate vectors or "
                         f"None, got {len(dims)} entr(y/ies)")
    py, px = period[0], period[1]
    if dims is None and (py is not None or px is not None):
        raise ValueError("period= requires coordinate dims")
    if px is not None:
        d = np.concatenate([d, d[:, :1]], axis=1)
    if py is not None:
        d = np.concatenate([d, d[:1, :]], axis=0)
    segs = find_contours(d, float(level))
    if dims is None:
        return segs
    ydef = np.asarray(dims[0], np.float64)
    xdef = np.asarray(dims[1], np.float64)
    if py is not None:
        ydef = np.append(ydef, ydef[0] + float(py))
    if px is not None:
        xdef = np.append(xdef, xdef[0] + float(px))
    yidx = np.arange(ydef.size)
    xidx = np.arange(xdef.size)
    out = []
    for seg in segs:
        ypos = np.interp(seg[:, 0], yidx, ydef)
        xpos = np.interp(seg[:, 1], xidx, xdef)
        out.append(np.c_[ypos, xpos])
    return out


def contour_lengths(data, contours, dims: Sequence = (None, None),
                    latlon: bool = True,
                    period: Sequence = (None, None)) -> np.ndarray:
    """Per-level total contour length in coordinate space — the reference's
    script-level composed helper (``contour_lengths`` at
    /root/reference/tests/test_breaking.py:352-421): for each level in
    ``contours``, marching-squares extraction mapped onto the ``dims``
    coordinates (periodic wrap per ``period``), then the sum of 1-arg
    ``contour_length`` over the pieces.

    data : 2-D (Ny, Nx); dims : (ydef, xdef) coordinate vectors;
    latlon : haversine x Rearth (degrees in) vs planar hypot;
    period : per-dim coordinate periods, see :func:`find_contour`.

    Matches the reference observable: a level with no contour yields 0.0
    (``sum([])``); a degenerate single-vertex piece yields NaN.
    """
    if dims is not None and all(d is None for d in dims):
        dims = None  # the advertised default: index-space lengths
    levels = np.atleast_1d(np.asarray(contours, np.float64))
    out = np.empty(levels.shape, np.float64)
    for i, c in enumerate(levels):
        segs = find_contour(data, dims, float(c), period=period)
        out[i] = sum(contour_length(seg, latlon=latlon) for seg in segs)
    return out


def _polyline_radians(y: np.ndarray, x: np.ndarray, latlon: bool) -> float:
    """Sum of segment lengths for one polyline with coordinates already in
    radians (latlon) or meters (cartesian); unit-sphere length for latlon."""
    if latlon:
        dlat = y[1:] - y[:-1]
        dlon = x[1:] - x[:-1]
        a = (np.sin(dlat / 2) ** 2 +
             np.cos(y[:-1]) * np.cos(y[1:]) * np.sin(dlon / 2) ** 2)
        return float(np.sum(2 * np.arcsin(np.sqrt(a))))
    return float(np.sum(np.hypot(np.diff(y), np.diff(x))))


def contour_length(segments, xdef=None, ydef=None, latlon: bool = True,
                   disp: bool = False, Rearth: float = _REARTH) -> float:
    """Contour perimeter — both reference API generations, dispatched on
    whether coordinate vectors are given.

    Newer 1-arg form (reference tests/test_breaking.py:391):
    ``contour_length(segment, latlon=...)`` with one coordinate-space
    polyline (columns (y, x), DEGREES if latlon); NaN for degenerate
    (single-vertex) segments.

    Older form (reference utils.py:565-609, called by core.py:1477):
    ``contour_length(segments, xdef, ydef, latlon)`` with a LIST of
    index-space marching-squares polylines (columns (y_idx, x_idx)) plus
    coordinate vectors in RADIANS (latlon) or meters; indices are np.interp'd
    onto the coordinates, lengths summed over all segments, and a zero total
    returns NaN.  ``disp`` is accepted for signature parity (the reference's
    debug print flag) and ignored.
    """
    del disp
    if xdef is None:
        seg = np.asarray(segments, np.float64)
        if seg.shape[0] <= 1:
            return float("nan")
        y = seg[:, 0]
        x = seg[:, 1]
        if latlon:
            return _polyline_radians(np.deg2rad(y), np.deg2rad(x),
                                     True) * Rearth
        return _polyline_radians(y, x, False)

    xdef = np.asarray(xdef, np.float64)
    ydef = np.asarray(ydef, np.float64)
    yidx = np.arange(ydef.size)
    xidx = np.arange(xdef.size)
    total = 0.0
    for segment in segments:
        seg = np.asarray(segment, np.float64)
        ypos = np.interp(seg[:, 0], yidx, ydef)
        xpos = np.interp(seg[:, 1], xidx, xdef)
        total += _polyline_radians(ypos, xpos, latlon)
    if total == 0.0:
        return float("nan")
    return total * Rearth if latlon else total


def contour_area(verts: np.ndarray) -> float:
    """Shoelace area enclosed by marching-squares vertices, orientation-
    independent (reference utils.py:537-561, after floater/rclv)."""
    v = np.asarray(verts, np.float64)
    vr = np.roll(v, 1, axis=0)
    elements = (vr[:, 1] + v[:, 1]) * (vr[:, 0] - v[:, 0])
    return abs(elements.sum()) / 2.0
