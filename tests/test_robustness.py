"""Degenerate-input robustness: the engine must not crash or emit garbage
silently on pathological fields (the reference raises deep inside xhistogram
or produces NaN storms)."""

import numpy as np
import pytest
import jax.numpy as jnp

from xcontour_tpu import core
from xcontour_tpu.ops.histogram import weighted_cdf
from xcontour_tpu.diagnostics.length import contour_lengths


def test_constant_field_contours():
    """A constant tracer gives equal (degenerate) contour levels; integrals
    must stay finite (the total or zero), not crash."""
    f = jnp.ones((8, 16))
    ctr = core.cal_contours(f, 5, increase=True)
    assert np.allclose(np.asarray(ctr), 1.0)
    dA = jnp.ones((8, 16))
    out = np.asarray(core.cal_integral_within_contours(f, ctr, dA, lt=True))
    np.testing.assert_allclose(out, 0.0)  # strict comparison: nothing below
    out = np.asarray(core.cal_integral_within_contours_exact(f, ctr, dA,
                                                             lt=False))
    np.testing.assert_allclose(out, 0.0)


@pytest.mark.slow
def test_all_nan_field():
    f = jnp.full((8, 16), jnp.nan)
    dA = jnp.ones((8, 16))
    bins = jnp.asarray(np.linspace(0, 1, 5))
    out = np.asarray(weighted_cdf(f, bins, dA, True))
    np.testing.assert_allclose(out, 0.0)
    L = np.asarray(contour_lengths(f, bins, jnp.arange(8.0), jnp.arange(16.0),
                                   latlon=False))
    assert np.all(np.isnan(L))


@pytest.mark.slow
def test_levels_outside_range(rng):
    """User-prescribed levels outside the tracer range: hist path windows
    them out; exact path extends naturally."""
    v = rng.normal(size=(10, 12))
    dA = np.ones((10, 12))
    bins = np.asarray([v.min() - 10.0, v.min(), v.max(), v.max() + 10.0])
    hist = np.asarray(weighted_cdf(jnp.asarray(v), jnp.asarray(bins),
                                   jnp.asarray(dA), True))
    exact = np.asarray(core.cal_integral_within_contours_exact(
        jnp.asarray(v), jnp.asarray(bins), jnp.asarray(dA), lt=True))
    # exact: nothing below min-10 or min; everything below max+10
    np.testing.assert_allclose(exact, [0.0, 0.0, 120.0 - 1, 120.0],
                               atol=1.5)
    assert np.all(np.isfinite(hist))


def test_single_row_and_column_fields(rng):
    """Degenerate 1-cell-wide planes go through without shape errors."""
    v = rng.normal(size=(1, 30))
    dA = np.ones((1, 30))
    ctr = core.cal_contours(jnp.asarray(v), 7, increase=True)
    out = core.cal_integral_within_contours_hist(jnp.asarray(v), ctr,
                                                 jnp.asarray(dA), lt=True)
    assert np.isfinite(np.asarray(out)).all()


def test_tiny_contour_counts(rng):
    v = rng.normal(size=(12, 12))
    dA = np.ones((12, 12))
    ctr = core.cal_contours(jnp.asarray(v), 2, increase=True)
    assert ctr.shape == (2,)
    out = np.asarray(core.cal_integral_within_contours_hist(
        jnp.asarray(v), ctr, jnp.asarray(dA), lt=True))
    np.testing.assert_allclose(out[-1], 144.0, rtol=1e-12)


def test_config_env_and_override_paths(monkeypatch):
    """set_lwa_fast overrides and the env-var parsing (XCONTOUR_LWA_FAST
    accepts 0/false/False)."""
    from xcontour_tpu import config

    old = config.lwa_fast()
    try:
        config.set_lwa_fast(False)
        assert config.lwa_fast() is False
        config.set_lwa_fast(True)
        assert config.lwa_fast() is True
        config.set_lwa_fast(None)
        monkeypatch.setenv("XCONTOUR_LWA_FAST", "false")
        assert config.lwa_fast() is False
        monkeypatch.setenv("XCONTOUR_LWA_FAST", "yes")
        assert config.lwa_fast() is True
        monkeypatch.delenv("XCONTOUR_LWA_FAST")
    finally:
        config.set_lwa_fast(None)
    assert config.lwa_fast() == old


def test_compile_cache_dir_env_then_checkout(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; without it the
    cache goes to the one fixed .jax_cache directory of the checkout."""
    import os
    import jax
    from xcontour_tpu import config

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        path = config.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert path == os.path.join(root, ".jax_cache")


def test_stopwatch_fetch_forced_sync():
    """Stopwatch syncs by fetching one element of every output; records
    carry compile/run separation."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu.utils.prof import Stopwatch

    sw = Stopwatch()
    rec = sw.time("sum", jax.jit(lambda x: jnp.sum(x * x)),
                  jnp.ones((64, 64)), reps=3)
    assert rec["per_call_s"] >= 0 and rec["first_call_s"] > 0
    assert sw.records and "sum" in sw.report()


def test_mitgcm_vertical_missing_drF_raises():
    import pytest as _pytest
    from xcontour_tpu.xcontour import add_MITgcm_missing_metrics
    ds = {"Z": -(np.arange(4) + 0.5), "XC": np.arange(8) + 0.5,
          "dxF": np.ones((4, 8))}
    with _pytest.raises(ValueError, match="drF"):
        add_MITgcm_missing_metrics(ds)


def test_single_contour_empty_raises():
    import pytest as _pytest
    from xcontour_tpu.host import breaking
    with _pytest.raises(ValueError, match="no contour"):
        breaking.single_contour([], np.arange(0.0, 360.0, 2.5))
