"""viz.py renders the reference's four figure shapes without error.

These pin structure (artists, labels, masking), not pixels: the reference's
visual layer (test_breaking.py:273-312, 425-437; notebooks 1-2) was
eyeball-only, so the contract here is "the same figure composes from our
array outputs".  Runs on the Agg backend — no display needed.
"""

import pytest

# matplotlib is optional (the package never imports it unless viz is used)
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from xcontour_tpu import viz  # noqa: E402


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def test_plot_field_with_contour_overlay():
    lat = np.linspace(-30.0, 30.0, 13)
    lon = np.linspace(0.0, 350.0, 36)
    field = np.sin(np.deg2rad(lat))[:, None] * np.cos(
        np.deg2rad(lon))[None, :]
    poly = np.stack([np.linspace(0, 350, 50),
                     10 * np.sin(np.linspace(0, 2 * np.pi, 50))], axis=1)
    ax = viz.plot_field(field, lat, lon, contours=[poly])
    # one pcolormesh + one overlay line
    assert len(ax.collections) == 1
    assert len(ax.lines) == 1
    assert ax.get_xlabel() == "longitude"
    x, y = ax.lines[0].get_data()
    np.testing.assert_allclose(x, poly[:, 0])
    np.testing.assert_allclose(y, poly[:, 1])


def test_plot_field_accepts_existing_axes_and_jax_arrays():
    import jax.numpy as jnp

    fig, ax0 = plt.subplots()
    ax = viz.plot_field(jnp.ones((4, 6)), jnp.arange(4.0), jnp.arange(6.0),
                        ax=ax0, colorbar=False)
    assert ax is ax0
    assert len(fig.axes) == 1  # colorbar=False adds no axes


def test_plot_keff_2d_masks_empty_bins():
    yeq = np.linspace(-80.0, 80.0, 21)
    nkeff = np.exp(np.linspace(0.0, 2.0, 21))[None, :] * np.ones((5, 1))
    nkeff[:, :3] = np.nan       # empty contour bins
    nkeff[0, 3] = 0.0           # log -> -inf, must be masked not raised
    ax = viz.plot_keff(nkeff, yeq, coord=np.arange(5.0) * 100.0)
    assert ax.get_xlabel() == "equivalent latitude"
    assert len(ax.collections) >= 1   # the contourf
    # no warnings escaped: errstate scoped inside


def test_plot_keff_1d_line():
    yeq = np.linspace(-80.0, 80.0, 11)
    ax = viz.plot_keff(np.exp(np.linspace(0, 1, 11)), yeq, log=True)
    assert len(ax.lines) == 1
    assert ax.get_ylabel() == "ln(nKeff)"


def test_plot_length_spectrum_masks_nan_and_draws_lmin():
    cs = np.linspace(-1.0, 1.0, 31)
    lengths = np.abs(cs) * 4e7
    lengths[[0, -1]] = np.nan   # empty endpoint contours
    ax = viz.plot_length_spectrum(lengths, cs, min_length=1e7)
    data_line = ax.lines[0]
    assert np.isfinite(data_line.get_ydata()).all()
    assert data_line.get_xdata().size == 29
    assert len(ax.lines) == 2   # spectrum + Lmin reference line


def test_plot_sorted_profile_2d_field_zonal_mean():
    lat = np.linspace(-60.0, 60.0, 25)
    tracer = np.sin(np.deg2rad(lat))[:, None] * np.ones((1, 16))
    yeq = np.linspace(-60.0, 60.0, 41)
    q = np.sin(np.deg2rad(yeq))
    q[0] = np.nan
    ax = viz.plot_sorted_profile(tracer, lat, q, yeq, scale=1e5)
    assert len(ax.lines) == 2
    # zonal mean of the separable field == its profile, scaled
    np.testing.assert_allclose(ax.lines[0].get_xdata(),
                               np.sin(np.deg2rad(lat)) * 1e5, rtol=1e-6)
    assert ax.lines[1].get_xdata().size == 40  # NaN lane masked


def test_viz_on_real_pipeline_outputs(vorticity):
    """End-to-end: the bundled barotropic-vorticity case through the keff
    pipeline renders the notebook figure pair."""
    import jax.numpy as jnp

    from xcontour_tpu import grid as G
    from xcontour_tpu import pipeline

    lat, lon, data = vorticity       # single (256, 512) snapshot
    g = G.from_latlon(jnp.asarray(lat, jnp.float32),
                      jnp.asarray(lon, jnp.float32))
    batch = jnp.stack([jnp.asarray(data, jnp.float32),
                       jnp.asarray(data * 0.9, jnp.float32)])
    out = pipeline.keff_pipeline(batch, g, N=41)["origin"]
    ax = viz.plot_keff(out["nkeff"], np.asarray(out["Yeq"][0]),
                       coord=np.arange(2.0))
    assert len(ax.collections) >= 1
    ax2 = viz.plot_sorted_profile(data, lat,
                                  np.asarray(out["contour"][0]),
                                  np.asarray(out["Yeq"][0]))
    assert len(ax2.lines) == 2
