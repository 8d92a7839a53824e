"""Windowed local contour-length tests (reference tests/test_localLength.py)."""

import numpy as np
import jax.numpy as jnp

from xcontour_tpu import compat
from xcontour_tpu.diagnostics.local_length import (
    local_contour_lengths, rolling_mean)


def test_rolling_mean_matches_direct(rng):
    d = rng.normal(size=(40, 50))
    d[5:9, 7:12] = np.nan
    got, oy, ox = rolling_mean(jnp.asarray(d), window=11, stride=5,
                               min_count=20)
    got = np.asarray(got)
    for i, y0 in enumerate(np.asarray(oy)):
        for j, x0 in enumerate(np.asarray(ox)):
            w = d[y0:y0 + 11, x0:x0 + 11]
            n = np.isfinite(w).sum()
            want = np.nanmean(w) if n >= 20 else np.nan
            np.testing.assert_allclose(got[i, j], want, rtol=1e-12,
                                       equal_nan=True)


def test_local_lengths_match_per_window_oracle(vorticity):
    lat, lon, vor = vorticity
    window, stride = 33, 16
    got, cy, cx = local_contour_lengths(
        jnp.asarray(vor), jnp.asarray(lat), jnp.asarray(lon),
        window=window, stride=stride, latlon=True, min_count=10)
    got = np.asarray(got)
    oy = np.arange(0, vor.shape[0] - window + 1, stride)
    ox = np.arange(0, vor.shape[1] - window + 1, stride)
    # spot-check a grid of windows against the NumPy per-window oracle
    for i in range(0, len(oy), 4):
        for j in range(0, len(ox), 5):
            w = vor[oy[i]:oy[i] + window, ox[j]:ox[j] + window]
            lev = np.nanmean(w)
            want = compat.contour_lengths(
                w, np.array([lev]), lat[oy[i]:oy[i] + window],
                lon[ox[j]:ox[j] + window], latlon=True)[0]
            np.testing.assert_allclose(got[i, j], want, rtol=1e-9,
                                       equal_nan=True, err_msg=f"{i},{j}")


def test_local_length_ratio_zonal_field():
    """For a purely zonal tracer the local contour is the zonal line through
    the window: ratio to the coordinate-field window length ~ 1 (the t=0
    invariant of the reference's ratio plot, tests/test_localLength.py:72)."""
    lat = np.linspace(-60, 60, 121)
    lon = np.linspace(0, 358, 180)
    f = np.broadcast_to(lat[:, None], (121, 180)).astype(np.float64).copy()
    num, cy, cx = local_contour_lengths(
        jnp.asarray(f), jnp.asarray(lat), jnp.asarray(lon),
        window=21, stride=10, latlon=True)
    mer = np.broadcast_to(lat[:, None], (121, 180)).copy()
    den, _, _ = local_contour_lengths(
        jnp.asarray(mer), jnp.asarray(lat), jnp.asarray(lon),
        window=21, stride=10, latlon=True)
    ratio = np.asarray(num) / np.asarray(den)
    assert np.nanmax(np.abs(ratio - 1)) < 1e-6


def test_local_length_pallas_window_batch_parity(vorticity):
    """Each window of the batched evaluation (window columns vmapped, rows
    through lax.map) equals the global contour-length kernel run on that
    window's own patch at the window level."""
    from xcontour_tpu.diagnostics.length import contour_lengths
    lat, lon, vor = vorticity
    data = jnp.asarray(vor[::4, ::4], jnp.float64)      # 64 x 128
    ydef = jnp.asarray(lat[::4], jnp.float64)
    xdef = jnp.asarray(lon[::4], jnp.float64)
    window, stride = 33, 8

    got, _, _ = local_contour_lengths(data, ydef, xdef, window=window,
                                      stride=stride, latlon=True)
    levels, oy, ox = rolling_mean(data, window, stride)
    patches = jnp.stack([jnp.stack([data[i:i + window, j:j + window]
                                    for j in np.asarray(ox)])
                         for i in np.asarray(oy)])
    want = np.empty(got.shape)
    for a, i in enumerate(np.asarray(oy)):
        for b, j in enumerate(np.asarray(ox)):
            want[a, b] = float(contour_lengths(
                patches[a, b], levels[a, b][None], ydef[i:i + window],
                xdef[j:j + window], latlon=True)[0])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9,
                               equal_nan=True)


def test_rolling_mean_f32_offset_field(rng):
    """A Kelvin-scale constant offset must not degrade the f32 window mean:
    the integral image is built on the de-meaned field (box sums of huge
    cumsums would otherwise lose ~1e-3 relative in f32)."""
    from xcontour_tpu.diagnostics.local_length import rolling_mean
    Ny, Nx, w = 256, 512, 64
    f = 300.0 + rng.normal(size=(Ny, Nx))          # ~Kelvin field
    got, oy, ox = rolling_mean(jnp.asarray(f, jnp.float32), w, 32)
    # f64 direct window means
    want = np.empty((len(oy), len(ox)))
    for i, y0 in enumerate(np.asarray(oy)):
        for j, x0 in enumerate(np.asarray(ox)):
            want[i, j] = f[y0:y0 + w, x0:x0 + w].mean()
    err = np.abs(np.asarray(got, np.float64) - want) / np.abs(want)
    assert err.max() < 3e-6, err.max()             # was ~1e-3 pre-fix
