#!/usr/bin/env python
"""Derive the golden pins of examples 2, 4 and 7 from the float64 oracle.

The examples run on the seeded barotropic-vorticity field
(``utils.synth.synth_barotropic_vorticity``).  Their pinned statistics are
computed here with ``compat.py`` alone, on the float32-rounded field the
examples feed the pipelines, never from the JAX output they check.  Only the
grid metrics (cell areas, line elements) come from ``grid.from_latlon``.

    python tools/pin_examples.py      # prints one line per pin
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def _sorted_state(q, lat, dA, N):
    from xcontour_tpu import compat
    ctr = compat.contours_linspace(q, N, True)
    ia = compat.integral_within_contours_hist(q, ctr, dA, None, True)
    yc, tbl = compat.area_table_hist(np.ones_like(q), lat, dA, True, True)
    yeq = compat.table_lookup_coordinates(tbl, yc, ia)
    return ctr, ia, yeq, compat.interp_to_coords(lat, yeq, ctr,
                                                 yeq[0] < yeq[-1])


def _coarsen(a, s):
    """Block mean by s along both axes of a 2-D field (utils.coarsen)."""
    ny, nx = a.shape
    return a.reshape(ny // s, s, nx // s, s).mean(axis=(1, 3))


def _coarsen_axis(x, s):
    """Coordinate of the coarsened grid: block mean by s."""
    return x.reshape(-1, s).mean(1)


def _slope(x, y):
    ok = np.isfinite(x) & np.isfinite(y)
    if ok.sum() < 2:
        return np.nan
    return np.polyfit(x[ok], y[ok], 1)[0]


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    from xcontour_tpu import compat, grid as G
    from xcontour_tpu.utils import synth
    from xcontour_tpu.utils.constants import Rearth

    v, _ = synth.synth_barotropic_vorticity()
    lat32, lon32 = v["latitude"], v["longitude"]
    lat = np.asarray(lat32, np.float64)
    lon = np.asarray(lon32, np.float64)
    q = np.asarray(v["absolute_vorticity"], np.float64)   # float32 values
    grid = G.from_latlon(lat32, lon32, dtype=np.float64)
    dA = np.asarray(grid.dA, np.float64)

    # example 2: LWA with the wei*dy metric (pipeline metric='dy')
    _, _, _, Q = _sorted_state(q, lat, dA, 121)
    W = dA / dA.max() * np.asarray(grid.dyF, np.float64)
    lwa = compat.local_wave_activity(q, Q, dA, lat, True, weight=W)
    lwa2 = compat.local_wave_activity2(q, Q, dA, lat, True, weight=W)
    print(f"ex2 lwa_max {np.nanmax(lwa):.7g}")
    print(f"ex2 lwa2_min {np.nanmin(lwa2):.7g}")
    print(f"ex2 lwa_zonal_mean_peak {np.nanmax(np.nanmean(lwa, 1)):.7g}")

    # example 4: lengths, L/Lmin, and the marching-squares fractal dimension
    ctr, _, yeq, _ = _sorted_state(q, lat, dA, 121)
    L = compat.contour_lengths(q, ctr, lat, lon, latlon=True)
    Lmin = compat.interp_to_coords(yeq, lat, compat.latitude_lengths_at(lat),
                                   True)
    sl = slice(10, -10)
    strides = (1, 2, 4, 8, 16, 32)
    Ls = np.stack([compat.contour_lengths(
        _coarsen(q, s), ctr, _coarsen_axis(lat, s), _coarsen_axis(lon, s),
        latlon=True) for s in strides], -1)
    rulers = (np.asarray(strides)[None, :] * np.cos(np.deg2rad(yeq))[:, None]
              * np.deg2rad(lon[1] - lon[0]) * Rearth)
    D = np.array([_slope(-np.log(r), np.log(li / r))
                  for li, r in zip(Ls, rulers)])
    print(f"ex4 D_median {np.nanmedian(D):.7g}")
    print(f"ex4 L_over_Lmin_median {np.nanmedian((L / Lmin)[sl]):.7g}")
    print(f"ex4 L_median_km {np.nanmedian(L[sl]) / 1e3:.7g}")

    # example 7: the two adjoint losses' values on the 2x-subsampled field
    q2, lat2, lon2 = q[::2, ::2], lat[::2], lon[::2]
    g2 = G.from_latlon(lat32[::2], lon32[::2], dtype=np.float64)
    dA2 = np.asarray(g2.dA, np.float64)
    _, _, _, Q2 = _sorted_state(q2, lat2, dA2, 61)
    lw = compat.local_wave_activity(q2, Q2, dA2, lat2, True)
    print(f"ex7 sum_lwa_sq {np.nansum(lw * lw):.7g}")
    grdS = compat.squared_gradient(q2, lat2, lon2)
    k = compat.keff_snapshot(q2, grdS, lat2, dA2, None, np.ones_like(q2),
                             lat2, N=61, lmin="analytic")
    print(f"ex7 sum_nkeff {np.nansum(k['origin']['nkeff']):.7g}")


if __name__ == "__main__":
    main()
