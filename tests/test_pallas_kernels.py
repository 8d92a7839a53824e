"""Per-stage parity: the XLA forms of the CDF, stencil, and geometry stages
against the float64 oracle, and the Pallas (Triton route) LWA c-term kernel.

The kernel runs here in interpret mode on the CPU; the ``gpu``-marked tests
at the end compile it for the card and skip elsewhere.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xcontour_tpu import compat
from xcontour_tpu import grid as G
from xcontour_tpu.diagnostics import lwa as L
from xcontour_tpu.diagnostics.length import (_lengths_totals_xla,
                                             contour_lengths)
from xcontour_tpu.diagnostics.local_length import _local_totals_xla_raw
from xcontour_tpu.kernels.lwa_pallas import lwa_lin_pallas
from xcontour_tpu.ops.histogram import (bincount_single, _edges_cdf_xla,
                                        weighted_cdf, weighted_cdf_multi)
from xcontour_tpu.ops.stencil import squared_gradient


def _kernel_lwa(q, Q, W, increase, *, interpret=True, **blocks):
    """The variant-1 lin LWA with the c-term from the Pallas kernel."""
    qk, Qc, _, E = L._lin_v1_terms(q, Q, W, increase)
    Wb = jnp.broadcast_to(W, q.shape[-2:])
    Wz = jnp.where(jnp.isfinite(Wb), Wb, 0.0)
    out = lwa_lin_pallas(qk, Qc, Wz, E, increase=increase,
                         interpret=interpret, **blocks)
    return out.reshape(q.shape)


def _lwa_case(rng, B, Ny, Nx, increase=True):
    ydef = np.linspace(-60, 60, Ny) if increase else -np.linspace(5, 120, Ny)
    q = np.cumsum(rng.normal(size=(B, Ny, Nx)), axis=1)
    dA = rng.uniform(0.5, 2.0, size=(Ny, Nx))
    Q = np.sort(rng.normal(size=(B, Ny)), axis=-1)
    return ydef, q, dA, Q, dA / dA.max() * dA


def _oracle_lwa(q, Q, dA, ydef, increase, part="all", variant2=False):
    fn = compat.local_wave_activity2 if variant2 else \
        compat.local_wave_activity
    want = np.stack([fn(q[b], Q[b], dA, ydef, increase, part)
                     for b in range(q.shape[0])])
    return np.where(np.isnan(want), 0.0, want)


# --------------------------------------------------------------------------
# weighted CDF (digitize + segment-sum + prefix scan)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("decreasing", [False, True])
def test_weighted_cdf_batched_bins_match_oracle(rng, lt, decreasing):
    """Per-batch bins (ascending or descending), NaN values and NaN weights
    against the oracle's histogram CDF."""
    B, Ny, Nx, N = 2, 16, 24, 13
    v = rng.normal(size=(B, Ny, Nx))
    w = rng.uniform(0.5, 2.0, size=(B, Ny, Nx))
    v[0, 0, 5] = np.nan
    w[1, 0, 7] = np.nan
    bins = np.stack([np.linspace(np.nanmin(v[b]), np.nanmax(v[b]), N)
                     for b in range(B)])
    if decreasing:
        bins = bins[:, ::-1].copy()
    got = np.asarray(weighted_cdf(jnp.asarray(v), jnp.asarray(bins),
                                  jnp.asarray(w), lt))
    for b in range(B):
        want = compat.histogram_cdf(v[b].ravel(), bins[b], w[b].ravel(), lt)
        np.testing.assert_allclose(got[b], want, rtol=1e-10, err_msg=f"b={b}")


def test_weighted_cdf_batch_equals_per_snapshot(rng):
    """Shared 1-D bins over a batch give each snapshot's own CDF."""
    v = rng.normal(size=(3, 10, 12))
    w = rng.uniform(0.5, 2.0, size=(10, 12))
    bins = jnp.asarray(np.linspace(v.min(), v.max(), 9))
    got = weighted_cdf(jnp.asarray(v), bins, jnp.asarray(w), True)
    for b in range(3):
        want = weighted_cdf(jnp.asarray(v[b]), bins, jnp.asarray(w), True)
        np.testing.assert_allclose(np.asarray(got[b]), np.asarray(want),
                                   rtol=1e-12)


def test_edges_cdf_multi_channel_matches_single(rng):
    """One digitize serves every channel: each channel of _edges_cdf_xla
    equals the single-channel histogram's prefix sum."""
    B, G_, N = 2, 500, 11
    v = rng.normal(size=(B, G_))
    v[0, 3] = np.nan
    w = rng.uniform(0.5, 2.0, size=(B, 3, G_))
    w[1, 2, 5] = np.nan
    edges = np.stack([np.linspace(np.nanmin(v[b]) - 0.5, np.nanmax(v[b]),
                                  N + 1) for b in range(B)])
    got = np.asarray(_edges_cdf_xla(jnp.asarray(v), jnp.asarray(edges),
                                    jnp.asarray(w)))
    for b in range(B):
        for c in range(3):
            hist, _ = bincount_single(jnp.asarray(v[b]),
                                      jnp.asarray(edges[b, 1:]),
                                      jnp.asarray(w[b, c]))
            np.testing.assert_allclose(got[b, c], np.cumsum(hist),
                                       rtol=1e-12, err_msg=f"{b},{c}")


@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("decreasing", [False, True])
def test_weighted_cdf_multi_matches_oracle(rng, lt, decreasing):
    """weighted_cdf_multi's shared digitize, including the descending-bin
    reversal and the lt=False total-minus-CDF flip, per channel against
    the oracle."""
    v = rng.normal(size=(3, 10, 12))
    ws = [rng.uniform(0.5, 2.0, size=(10, 12)),
          rng.uniform(0.0, 1.0, size=(3, 10, 12))]
    bins = np.linspace(v.min(), v.max(), 9)
    if decreasing:
        bins = bins[::-1].copy()
    got = weighted_cdf_multi(jnp.asarray(v), jnp.asarray(bins),
                             [jnp.asarray(w) for w in ws], lt)
    assert len(got) == 2
    for c, w in enumerate(ws):
        wb = np.broadcast_to(w, v.shape)
        for b in range(3):
            want = compat.histogram_cdf(v[b].ravel(), bins, wb[b].ravel(), lt)
            np.testing.assert_allclose(np.asarray(got[c][b]), want,
                                       rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------
# |grad q|^2 stencil
# --------------------------------------------------------------------------
def _stencil_grid(periodic):
    Ny, Nx = 24, 32
    lat = np.linspace(-70, 70, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx) if periodic else \
        np.linspace(0, 180, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    assert grid.periodic_x == periodic
    return lat, lon, grid


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("bc_y", ["extend", "reflect"])
def test_squared_gradient_matches_numpy(rng, periodic, bc_y):
    """The XLA stencil against plain NumPy centred differences: the
    oracle's np.gradient form for 'extend' walls, and a mirror-padded
    difference (zero normal gradient at the wall) for 'reflect'."""
    lat, lon, grid = _stencil_grid(periodic)
    q = rng.normal(size=(2, lat.size, lon.size))
    got = np.asarray(squared_gradient(jnp.asarray(q), grid, bc_y=bc_y))
    if bc_y == "extend":
        want = np.stack([compat.squared_gradient(q[b], lat, lon, latlon=True,
                                                 periodic_x=periodic)
                         for b in range(2)])
    else:
        d2r = np.pi / 180.0
        R = 6371200.0
        dy = np.gradient(lat) * d2r * R
        dx = np.cos(lat * d2r)[:, None] * (np.gradient(lon) * d2r * R)
        qp = np.concatenate([q[:, 1:2], q, q[:, -2:-1]], axis=1)
        qy = (qp[:, 2:] - qp[:, :-2]) * 0.5 / dy[:, None]
        if periodic:
            qx = (np.roll(q, -1, -1) - np.roll(q, 1, -1)) / (2 * dx)
        else:
            qx = np.gradient(q, axis=-1) / dx
        want = qx ** 2 + qy ** 2
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_squared_gradient_grad_matches_finite_differences(rng):
    """jax.grad of the stencil (no custom rule: plain autodiff) against a
    central difference along a random direction, in float64."""
    Ny, Nx = 16, 24
    grid = G.from_latlon(np.linspace(-75, 75, Ny),
                         np.arange(Nx) * (360.0 / Nx), dtype=jnp.float64)
    q = jnp.asarray(rng.normal(size=(2, Ny, Nx)))
    d = jnp.asarray(rng.normal(size=(2, Ny, Nx)))

    def loss(t):
        return jnp.sum(squared_gradient(t, grid) ** 2)

    g = jax.grad(loss)(q)
    eps = 1e-6
    fd = (float(loss(q + eps * d)) - float(loss(q - eps * d))) / (2 * eps)
    np.testing.assert_allclose(float(jnp.sum(g * d)), fd, rtol=1e-6)


# --------------------------------------------------------------------------
# marching-squares contour lengths
# --------------------------------------------------------------------------
@pytest.mark.parametrize("latlon", [True, False])
def test_lengths_xla_matches_oracle(rng, latlon):
    B, Ny, Nx, N = 2, 20, 30, 9
    if latlon:
        y = np.linspace(-60, 60, Ny)
        x = np.linspace(0, 348, Nx)
    else:
        y = np.linspace(0.0, 1900.0, Ny)
        x = np.linspace(0.0, 2900.0, Nx)
    d = np.cumsum(rng.normal(size=(B, Ny, Nx)), axis=1)
    d[0, 4, 7] = np.nan
    levels = np.stack([np.linspace(np.nanmin(d[b]), np.nanmax(d[b]), N)
                       for b in range(B)])
    yc = np.deg2rad(y) if latlon else y
    xc = np.deg2rad(x) if latlon else x
    got = np.asarray(_lengths_totals_xla(
        jnp.asarray(d), jnp.asarray(levels), jnp.asarray(yc),
        jnp.asarray(xc), latlon=latlon, chunk=4))
    for b in range(B):
        want = compat.contour_lengths(d[b], levels[b], y, x, latlon=latlon,
                                      Rearth=1.0)
        want = np.where(np.isnan(want), 0.0, want)
        np.testing.assert_allclose(got[b], want, rtol=1e-9, atol=1e-12,
                                   err_msg=f"b={b} latlon={latlon}")


def test_lengths_coarse_cells_match_oracle(rng):
    """The fractal ladder coarsens the 0.7-degree grid by strides up to 32:
    ~22.5-degree cells.  The geodesic segment lengths must still match the
    oracle's haversine there."""
    Ny, Nx, N = 9, 17, 7
    y = np.linspace(-90, 90, Ny)
    x = np.linspace(0, 360, Nx)
    d = np.cumsum(rng.normal(size=(Ny, Nx)), axis=0) \
        + 0.5 * rng.normal(size=(Ny, Nx))
    levels = np.linspace(d.min(), d.max(), N)
    got = np.asarray(_lengths_totals_xla(
        jnp.asarray(d[None]), jnp.asarray(levels[None]),
        jnp.asarray(np.deg2rad(y)), jnp.asarray(np.deg2rad(x)),
        latlon=True, chunk=8))[0]
    want = compat.contour_lengths(d, levels, y, x, latlon=True, Rearth=1.0)
    want = np.where(np.isnan(want), 0.0, want)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_local_lengths_coarse_cells_match_oracle(rng):
    """Per-window lengths on 20 x 22.5-degree cells against the oracle on
    each window."""
    W = 9
    y = np.linspace(-80, 80, 2 * W)
    x = np.linspace(10, 190, 2 * W)
    data = np.cumsum(rng.normal(size=(2 * W, 2 * W)), axis=0)
    oy = np.arange(0, 2 * W - W + 1, 4)
    ox = np.arange(0, 2 * W - W + 1, 4)
    levels = np.array([[np.mean(data[i:i + W, j:j + W]) for j in ox]
                       for i in oy])
    got = np.asarray(_local_totals_xla_raw(
        jnp.asarray(data), jnp.asarray(levels), jnp.asarray(np.deg2rad(y)),
        jnp.asarray(np.deg2rad(x)), window=W, stride=4, latlon=True))
    for a, i in enumerate(oy):
        for b, j in enumerate(ox):
            want = compat.contour_lengths(
                data[i:i + W, j:j + W], levels[a, b:b + 1], y[i:i + W],
                x[j:j + W], latlon=True, Rearth=1.0)[0]
            want = 0.0 if np.isnan(want) else want
            np.testing.assert_allclose(got[a, b], want, rtol=1e-12,
                                       atol=1e-14)


def test_lengths_level_order_invariance(rng):
    """A decreasing or shuffled level vector (increase=False contours) gives
    the exact permutation of the ascending answer."""
    Ny, Nx, N = 20, 30, 9
    y = jnp.asarray(np.linspace(-60, 60, Ny))
    x = jnp.asarray(np.linspace(0, 348, Nx))
    d = jnp.asarray(np.cumsum(rng.normal(size=(1, Ny, Nx)), axis=1))
    up = np.linspace(float(d.min()), float(d.max()), N)
    perm = rng.permutation(N)
    ref = np.asarray(contour_lengths(d, jnp.asarray(up[None]), y, x,
                                     latlon=True))[0]
    down = np.asarray(contour_lengths(d, jnp.asarray(up[::-1].copy()[None]),
                                      y, x, latlon=True))[0]
    shuf = np.asarray(contour_lengths(d, jnp.asarray(up[perm][None]), y, x,
                                      latlon=True))[0]
    np.testing.assert_array_equal(down, ref[::-1])
    np.testing.assert_array_equal(shuf, ref[perm])


# --------------------------------------------------------------------------
# LWA: the dense (pairwise) form and the Pallas lin kernel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("part", ["all", "upper", "lower"])
def test_lwa_dense_matches_oracle(rng, variant2, increase, part):
    ydef, q, dA, Q, W = _lwa_case(rng, 2, 24, 16, increase)
    q[0, 3, 4] = np.nan
    want = _oracle_lwa(q, Q, dA, ydef, increase, part, variant2)
    got = L._lwa_dense_xla(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W),
                           jnp.asarray(ydef), increase=increase, part=part,
                           variant2=variant2, chunk=8)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("with_nan", [False, True])
def test_lwa_lin_kernel_matches_oracle(rng, increase, with_nan):
    """The kernel path reproduces the pairwise oracle: NaN tracer cells
    drop out of every surface's sum and NaN profile rows integrate to
    zero (in float64 the R/E cancellation noise is ~1e-12)."""
    ydef, q, dA, Q, W = _lwa_case(rng, 2, 24, 16, increase)
    if with_nan:
        q[0, 3, 4] = np.nan
        Q[1, 5] = np.nan
    want = _oracle_lwa(q, Q, dA, ydef, increase)
    got = _kernel_lwa(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W),
                      increase, tj=8, bx=16, yb=4)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-8, atol=1e-8)


def test_lwa_lin_kernel_ragged_tile(rng):
    """Ny not divisible by the surface tile exercises the j < Ny masks."""
    ydef, q, dA, Q, W = _lwa_case(rng, 1, 13, 8)
    want = _oracle_lwa(q, Q, dA, ydef, True)
    got = _kernel_lwa(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W), True,
                      tj=8, bx=8, yb=4)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


def test_lwa_lin_kernel_x_blocking(rng):
    """A width that no column block divides: the masked tail columns load
    zero weight and are never stored."""
    ydef, q, dA, Q, W = _lwa_case(rng, 1, 16, 200)
    want = _oracle_lwa(q, Q, dA, ydef, True)
    got = _kernel_lwa(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W), True,
                      tj=16, bx=64, yb=8)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("bx", [32, 128])
def test_lwa_lin_kernel_column_blocks(rng, bx):
    """Several column blocks (bx=32) and one block wider than the grid
    (bx=128) over Nx=100 give the same answer."""
    ydef, q, dA, Q, W = _lwa_case(rng, 2, 16, 100)
    want = _oracle_lwa(q, Q, dA, ydef, True)
    got = _kernel_lwa(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W), True,
                      tj=8, bx=bx, yb=8)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("yb,yk", [(16, 16), (32, 16), (4, 2), (8, 4)])
def test_lwa_lin_kernel_y_tiles(rng, yb, yk):
    """The y loop over (yb, bx) tiles summed in blocks of yk tiles, over
    Ny=48: three whole tiles in one block (16, 16); a masked ragged last
    tile (32, 16); six blocks of two (4, 2); and a last block that runs
    past Ny (8, 4)."""
    ydef, q, dA, Q, W = _lwa_case(rng, 1, 48, 40)
    q[0, 5, 3] = np.nan
    want = _oracle_lwa(q, Q, dA, ydef, True)
    got = _kernel_lwa(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W), True,
                      tj=16, bx=16, yb=yb, yk=yk)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("increase", [True, False])
def test_lwa_lin_kernel_inf_matches_xla_twin(rng, increase):
    """+/-inf tracer or weight cells are invalid in the lin family: the
    kernel must agree with _lwa_lin_xla, whose VJP the kernel path uses,
    or gradients detach from the primal."""
    B, Ny, Nx = 2, 16, 12
    q = np.cumsum(rng.normal(size=(B, Ny, Nx)), axis=1)
    q[0, 4, 2] = np.inf
    q[1, 7, 5] = -np.inf
    q[0, 9, 9] = np.nan
    dA = rng.uniform(0.5, 2.0, size=(Ny, Nx))
    W = dA / dA.max() * dA
    W[3, 3] = np.inf
    Q = np.sort(rng.normal(size=(B, Ny)), axis=-1)
    want = np.asarray(L._lwa_lin_xla(jnp.asarray(q), jnp.asarray(Q),
                                     jnp.asarray(W), increase, False, 4))
    got = np.asarray(_kernel_lwa(jnp.asarray(q), jnp.asarray(Q),
                                 jnp.asarray(W), increase, tj=8, bx=8, yb=4))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_lwa_lin_kernel_chosen_by_backend(monkeypatch):
    """'lin' takes the kernel exactly when the backend is the GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert L._lin_kernel() is True
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert L._lin_kernel() is False


# --------------------------------------------------------------------------
# on the card (skip elsewhere)
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 256, 512), (4, 721, 1440)])
def test_lwa_lin_kernel_compiled_matches_xla(gpu_device, shape):
    """The compiled kernel against the XLA lin form at real widths, float32.
    The two differ only in summation order, but R and E reach hundreds of
    times the result on this field and cancel, so one float32 ulp of R is
    2e-5 to 4e-5 of the max: the 'lin' policy, 2e-4 of the max, applies."""
    B, Ny, Nx = shape
    rng = np.random.default_rng(0)
    lat = np.linspace(-89.0, 89.0, Ny)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.1 * rng.standard_normal((B, Ny, Nx))).astype(np.float32)
    Q = np.sort(q.mean(-1), axis=-1).astype(np.float32)
    W = np.broadcast_to(np.cos(np.deg2rad(lat))[:, None] ** 2,
                        (Ny, Nx)).astype(np.float32)
    with jax.default_device(gpu_device):
        args = [jnp.asarray(a) for a in (q, Q, W)]
        got = np.asarray(_kernel_lwa(*args, True, interpret=False))
        want = np.asarray(L._lwa_lin_xla(*args, True, False, 16))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


@pytest.mark.gpu
def test_lin_path_uses_kernel_on_gpu(gpu_device):
    """On the GPU the 'lin' method takes the kernel, with no fallback."""
    assert L._lin_kernel() is True
    assert gpu_device.platform == "gpu"
