"""Host-side contour extraction (native C++ traversal) tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from xcontour_tpu.host import find_contour, contour_length, contour_area
from xcontour_tpu.host import native, breaking
from xcontour_tpu.diagnostics.length import contour_lengths


def _circle_field(n=201):
    y = np.linspace(-1, 1, n)
    x = np.linspace(-1, 1, n)
    return y, x, np.hypot(y[:, None], x[None, :])


def test_native_builds_and_matches_numpy():
    y, x, r = _circle_field(101)
    got_native = native.find_contours_native(r, 0.5)
    assert got_native is not None, "C++ traversal should build in this image"
    got_numpy = native.find_contours_numpy(r, 0.5)
    # same total vertex count and total length regardless of ordering
    ln = sorted(len(s) for s in got_native)
    lp = sorted(len(s) for s in got_numpy)
    assert ln == lp
    def total(segs):
        return sum(np.sum(np.hypot(np.diff(s[:, 0]), np.diff(s[:, 1])))
                   for s in segs)
    np.testing.assert_allclose(total(got_native), total(got_numpy), rtol=1e-12)


def test_find_contour_circle_closed():
    y, x, r = _circle_field(301)
    segs = find_contour(r, (y, x), 0.6)
    assert len(segs) == 1
    seg = segs[0]
    # closed loop: endpoints coincide
    np.testing.assert_allclose(seg[0], seg[-1])
    L = contour_length(seg, latlon=False)
    np.testing.assert_allclose(L, 2 * np.pi * 0.6, rtol=2e-3)


def test_polyline_total_matches_device_lengths(vorticity):
    """Traversal-based total length == the traversal-free device kernel —
    the two implementations share only the per-cell rule definitions."""
    lat, lon, vor = vorticity
    for level in (4e-5, 7e-5):
        segs = find_contour(vor, (lat, lon), level)
        host_total = sum(contour_length(s, latlon=True) for s in segs)
        kern = float(np.asarray(contour_lengths(
            jnp.asarray(vor), jnp.asarray([level]), jnp.asarray(lat),
            jnp.asarray(lon), latlon=True))[0])
        np.testing.assert_allclose(host_total, kern, rtol=1e-9)


def test_contour_area_circle():
    y, x, r = _circle_field(401)
    segs = native.find_contours(r, 0.5)
    assert len(segs) == 1
    # area in index units: radius 0.5 spans 0.5/ (2/400) = 100 index units
    a = contour_area(segs[0])
    np.testing.assert_allclose(a, np.pi * 100.0 ** 2, rtol=1e-3)


def test_nan_region_splits_contours():
    y, x, r = _circle_field(201)
    r2 = r.copy()
    r2[:, 95:105] = np.nan  # cut a vertical band through the circle
    segs = find_contour(r2, (y, x), 0.6)
    assert len(segs) >= 2
    total = sum(contour_length(s, latlon=False) for s in segs)
    assert total < 2 * np.pi * 0.6


def test_breaking_chain_wraparound():
    """A circumpolar wavy contour crossing the periodic boundary is stitched
    into one full-coverage contour."""
    nlat, nlon = 91, 180
    lat = np.linspace(-89, 89, nlat)
    lon = np.linspace(0, 358, nlon)
    phi = np.deg2rad(lat)[:, None]
    lam = np.deg2rad(lon)[None, :]
    pv = np.sin(phi) + 0.15 * np.cos(phi) ** 2 * np.sin(3 * lam)
    c = breaking.breaking_contour(pv, lat, lon, level=0.5, y_overlap=3.0,
                                  x_extent=0.9, snap=True)
    cover = len(np.unique(np.round(c[:, 0]))) / nlon
    assert cover >= 0.9
    # the contour lives near the latitude where sin(lat)=0.5 (30N) +- wave
    assert 10 < np.mean(c[:, 1]) < 50


def test_extraction_handles_all_nan():
    f = np.full((10, 10), np.nan)
    assert native.find_contours(f, 0.5) == []


def test_legacy_contour_length_signature(vorticity):
    """Older API generation (reference utils.py:565-609, called by
    core.py:1477): index-space segments + coordinate vectors in radians,
    summed over all segments of one level, zero total -> NaN."""
    lat, lon, vor = vorticity
    level = float(np.nanmean(vor))
    segs = native.find_contours(vor, level)           # index space
    legacy = contour_length(segs, np.deg2rad(lon), np.deg2rad(lat),
                            latlon=True)
    # must equal interp-to-coords + newer per-segment form, summed
    newer = sum(contour_length(np.c_[np.interp(s[:, 0],
                                               np.arange(lat.size), lat),
                                     np.interp(s[:, 1],
                                               np.arange(lon.size), lon)],
                               latlon=True) for s in segs)
    np.testing.assert_allclose(legacy, newer, rtol=1e-12)
    # and agree with the traversal-free device kernel total at that level
    kernel = float(np.asarray(contour_lengths(
        jnp.asarray(vor), jnp.asarray([level]), jnp.asarray(lat),
        jnp.asarray(lon), latlon=True))[0])
    np.testing.assert_allclose(legacy, kernel, rtol=1e-6)
    # degenerate: a level outside the data range crosses nothing -> NaN
    assert np.isnan(contour_length(
        native.find_contours(vor, float(np.nanmax(vor)) + 1.0),
        np.deg2rad(lon), np.deg2rad(lat), latlon=True))


def test_legacy_contour_length_cartesian():
    y, x, r = _circle_field(301)
    segs = native.find_contours(r, 0.6)
    legacy = contour_length(segs, x, y, latlon=False)
    want = 2 * np.pi * 0.6
    np.testing.assert_allclose(legacy, want, rtol=2e-4)


def test_filter_and_single_contour_selection():
    """filter_contours keeps only full-longitude-coverage contours;
    single_contour picks the most equatorward full one (reference
    tests/test_breaking.py:176-231)."""
    lon = np.arange(0.0, 360.0, 2.5)          # 144 points
    full_hi = np.stack([lon, np.full(lon.size, 65.0)], axis=1)
    full_lo = np.stack([lon, np.full(lon.size, 48.0)], axis=1)
    partial = np.stack([lon[:40], np.full(40, 55.0)], axis=1)

    kept = breaking.filter_contours([full_hi, partial, full_lo], lon)
    assert len(kept) == 2
    assert all(c.shape[0] == lon.size for c in kept)

    sel = breaking.single_contour([full_hi, partial, full_lo], lon)
    np.testing.assert_array_equal(sel, full_lo)   # most equatorward

    # with a single full-coverage candidate, max coverage wins
    sel2 = breaking.single_contour([partial, full_hi], lon)
    np.testing.assert_array_equal(sel2, full_hi)


def test_find_contour_period_closes_seam_crossing():
    """A tracer blob straddling the 0/360 longitude seam: without period=
    the contour is cut open at the seam; with period=(None, 360) the wrap
    column closes it and the total haversine length matches the same blob
    centered mid-domain (reference find_contour(period=...) usage,
    tests/test_breaking.py:412-421 / test_clength.py:615-630)."""
    from xcontour_tpu.host import contour_lengths as host_lengths
    from xcontour_tpu.utils.constants import Rearth

    Ny, Nx = 64, 128
    lat = np.linspace(-80.0, 80.0, Ny)
    lon = np.arange(0.0, 360.0, 360.0 / Nx)

    def blob(center_lon):
        dlon = (lon[None, :] - center_lon + 180.0) % 360.0 - 180.0
        return np.exp(-(lat[:, None] / 25.0) ** 2 - (dlon / 40.0) ** 2)

    level = 0.5
    seam = blob(0.0)          # crosses the 0/360 seam
    mid = blob(180.0)         # same blob, mid-domain

    # open at the seam without a period: more pieces, shorter total
    open_segs = find_contour(seam, (lat, lon), level)
    closed_segs = find_contour(seam, (lat, lon), level, period=(None, 360.0))
    mid_segs = find_contour(mid, (lat, lon), level)
    assert len(closed_segs) < len(open_segs) or (
        sum(s.shape[0] for s in closed_segs)
        > sum(s.shape[0] for s in open_segs))

    L_closed = sum(contour_length(s, latlon=True) for s in closed_segs)
    L_mid = sum(contour_length(s, latlon=True) for s in mid_segs)
    np.testing.assert_allclose(L_closed, L_mid, rtol=1e-10)
    L_open = sum(contour_length(s, latlon=True) for s in open_segs)
    assert L_open < L_closed

    # wrap-column vertices map past xdef[-1] toward lon[0]+360
    assert max(s[:, 1].max() for s in closed_segs) > lon[-1]

    # composed helper agrees with the manual composition and with the
    # analytic circumference of a zonal circle for a zonally-flat field
    got = host_lengths(seam, [level], dims=(lat, lon), latlon=True,
                       period=(None, 360.0))
    np.testing.assert_allclose(got[0], L_closed, rtol=1e-12)

    zonal = np.sin(np.deg2rad(lat))[:, None] * np.ones((1, Nx))
    phi = 45.0
    Lz = host_lengths(zonal, [np.sin(np.deg2rad(phi))], dims=(lat, lon),
                      latlon=True, period=(None, 360.0))
    np.testing.assert_allclose(Lz[0], 2 * np.pi * Rearth
                               * np.cos(np.deg2rad(phi)), rtol=2e-3)
    # without the wrap the zonal circle is missing its seam segment
    Lz_open = host_lengths(zonal, [np.sin(np.deg2rad(phi))],
                           dims=(lat, lon), latlon=True)
    assert Lz_open[0] < Lz[0]


def test_host_contour_lengths_reference_observables():
    """Composed helper edge semantics match the reference script: a level
    with no crossings sums to 0.0; cartesian lengths ignore latlon scaling
    (reference tests/test_breaking.py:352-421)."""
    from xcontour_tpu.host import contour_lengths as host_lengths

    y, x, r = _circle_field(201)
    got = host_lengths(r, [0.6, 99.0], dims=(y, x), latlon=False)
    np.testing.assert_allclose(got[0], 2 * np.pi * 0.6, rtol=5e-4)
    assert got[1] == 0.0

    # the advertised default dims=(None, None) means index space (it used to
    # crash in np.asarray(None)); equals explicit index coordinates
    idx = host_lengths(r, [0.6], latlon=False)
    explicit = host_lengths(r, [0.6], dims=(np.arange(r.shape[0], dtype=float),
                                            np.arange(r.shape[1], dtype=float)),
                            latlon=False)
    np.testing.assert_allclose(idx, explicit, rtol=1e-12)


def test_df_contours_tabulates_pieces():
    """df_contours: single array and list-of-pieces forms both yield a
    lon/lat DataFrame (reference tests/test_breaking.py:236-255; the
    reference's list branch is dead code — intended semantics here)."""
    from xcontour_tpu.host import df_contours

    a = np.array([[10.0, 50.0], [20.0, 55.0]])
    b = np.array([[30.0, 60.0]])
    df = df_contours(a)
    assert list(df.columns) == ["lon", "lat"]
    np.testing.assert_array_equal(df["lon"].to_numpy(), [10.0, 20.0])
    np.testing.assert_array_equal(df["lat"].to_numpy(), [50.0, 55.0])

    df2 = df_contours([a, b])
    assert len(df2) == 3
    np.testing.assert_array_equal(df2["lat"].to_numpy(), [50.0, 55.0, 60.0])

    df3 = df_contours([])
    assert len(df3) == 0
