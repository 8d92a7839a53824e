"""Edge-case pins for the dense-compare 1-D interpolation (ops/interp.py).

interp1d's small-table path replaces vmapped jnp.interp with count-compares
plus where-guarded one-hot contractions (no gathers).  These tests pin exact np.interp agreement on every
edge the rewrite could plausibly break: exact abscissa hits, duplicate
(zero-width) intervals, out-of-range clamping, NaN queries, NaN table
entries, decreasing abscissae, and the 'nan' extrapolation mode.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from xcontour_tpu.ops.interp import interp1d


def _np_ref(x, xf, yf):
    return np.stack([np.interp(x[b], xf[b], yf[b]) for b in range(x.shape[0])])


def test_matches_np_interp_batched(rng):
    B, M, N = 16, 57, 33
    xf = np.sort(rng.standard_normal((B, N)), -1)
    yf = rng.standard_normal((B, N))
    x = rng.standard_normal((B, M)) * 1.5
    got = np.asarray(interp1d(jnp.asarray(x), jnp.asarray(xf), jnp.asarray(yf)))
    np.testing.assert_allclose(got, _np_ref(x, xf, yf), rtol=1e-12, atol=1e-12)


def test_exact_hits_and_duplicates(rng):
    xf = np.array([[0.0, 1.0, 1.0, 2.0, 3.0]])
    yf = np.array([[0.0, 10.0, 20.0, 30.0, 40.0]])
    x = np.array([[0.0, 0.5, 1.0, 1.5, 2.0, 3.0]])
    got = np.asarray(interp1d(jnp.asarray(x), jnp.asarray(xf), jnp.asarray(yf)))
    want = _np_ref(x, xf, yf)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the duplicated abscissa: jnp/np.interp return the RIGHT endpoint value
    assert got[0, 2] == want[0, 2]


def test_clamping_and_nan_query(rng):
    xf = np.sort(rng.standard_normal((3, 9)), -1)
    yf = rng.standard_normal((3, 9))
    x = np.array([[-10.0, 10.0, np.nan, 0.0]] * 3)
    got = np.asarray(interp1d(jnp.asarray(x), jnp.asarray(xf), jnp.asarray(yf)))
    assert np.allclose(got[:, 0], yf[:, 0])       # clamp left
    assert np.allclose(got[:, 1], yf[:, -1])      # clamp right
    assert np.isnan(got[:, 2]).all()              # NaN propagates


def test_nan_extrapolate_mode(rng):
    xf = np.sort(rng.standard_normal((2, 7)), -1)
    yf = rng.standard_normal((2, 7))
    x = np.array([[-10.0, 10.0, 0.0]] * 2)
    got = np.asarray(interp1d(jnp.asarray(x), jnp.asarray(xf),
                              jnp.asarray(yf), extrapolate="nan"))
    assert np.isnan(got[:, :2]).all()
    assert np.isfinite(got[:, 2]).all()


def test_decreasing_abscissae(rng):
    B, M, N = 4, 23, 17
    xf = np.sort(rng.standard_normal((B, N)), -1)[:, ::-1].copy()
    yf = rng.standard_normal((B, N))
    x = rng.standard_normal((B, M))
    got = np.asarray(interp1d(jnp.asarray(x), jnp.asarray(xf), jnp.asarray(yf)))
    want = np.stack([np.interp(x[b], xf[b][::-1], yf[b][::-1])
                     for b in range(B)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_nan_table_entry_is_local(rng):
    """A NaN yf entry must only poison queries whose interval touches it —
    the one-hot contractions are where-guarded (NaN * 0 would otherwise
    spread to every output)."""
    xf = np.linspace(0.0, 10.0, 11)[None]
    yf = np.arange(11.0)[None].copy()
    yf[0, 5] = np.nan
    x = np.array([[1.5, 4.2, 5.5, 7.3, 9.1]])
    got = np.asarray(interp1d(jnp.asarray(x), jnp.asarray(xf), jnp.asarray(yf)))
    assert np.isfinite(got[0, [0, 3, 4]]).all()
    assert np.isnan(got[0, [1, 2]]).all()         # intervals [4,5] and [5,6]
    # exact np.interp agreement incl. the NaN pattern
    want = np.interp(x[0], xf[0], yf[0])
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want))


def test_large_table_falls_back_to_searchsorted(rng):
    """Above _DENSE_N_MAX the O(M*N) compare form would blow up; the
    binary-search path takes over with identical results."""
    from xcontour_tpu.ops.interp import _DENSE_N_MAX
    N = _DENSE_N_MAX + 8
    xf = np.sort(rng.standard_normal((1, N)), -1)
    yf = rng.standard_normal((1, N))
    x = rng.standard_normal((1, 64))
    got = np.asarray(interp1d(jnp.asarray(x), jnp.asarray(xf), jnp.asarray(yf)))
    np.testing.assert_allclose(got, _np_ref(x, xf, yf), rtol=1e-12, atol=1e-12)


def test_nan_query_against_degenerate_table():
    """A NaN query returns NaN even when every table interval is zero-width
    (a constant tracer's contour levels): the dx==0 endpoint select must not
    swallow the NaN (ADVICE r2)."""
    xf = jnp.full((1, 8), 3.0)
    yf = jnp.arange(8.0)[None]
    x = jnp.asarray([[np.nan, 3.0, 2.0]])
    got = np.asarray(interp1d(x, xf, yf))
    assert np.isnan(got[0, 0])
    assert np.isfinite(got[0, 1:]).all()


def test_huge_query_axis_avoids_dense_blowup(rng):
    """Gate on the full element product, not table size alone: a big query
    axis against a near-cap table must route to the O(M log N)-memory
    binary-search path and still match np.interp."""
    from xcontour_tpu.ops.interp import _DENSE_ELEMS_MAX
    N = 2048
    M = _DENSE_ELEMS_MAX // N + 17          # just over the product budget
    xf = np.sort(rng.standard_normal((1, N)), -1)
    yf = rng.standard_normal((1, N))
    x = rng.standard_normal((1, M))
    got = np.asarray(interp1d(jnp.asarray(x), jnp.asarray(xf),
                              jnp.asarray(yf)))
    np.testing.assert_allclose(got, _np_ref(x, xf, yf), rtol=1e-12,
                               atol=1e-12)
