"""The rearrangement + LWA chain is differentiable (reverse-mode).

A capability the reference stack (xarray/numba/skimage) cannot offer: the
sensitivity of wave activity to tracer perturbations — an adjoint — via
jax.grad straight through contours -> weighted CDF -> equivalent-coordinate
lookup -> sorted profile -> LWA.  The histogram digitize is piecewise
constant in the tracer, so AD returns the almost-everywhere derivative
(bucket-interior), which finite differences confirm away from bucket
boundaries.  The Keff tail (Leq2/nkeff) keeps the reference's NaN-masking
semantics bit-for-bit yet is differentiable too: its 0/0 and NaN-operand
divisions route degenerate lanes through stop_gradient
(core._grad_safe_div), so the 0-cotangent x NaN-jacobian products that
would poison jax.grad never form.
"""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

pytestmark = pytest.mark.slow

from xcontour_tpu import grid as G
from xcontour_tpu import core
from xcontour_tpu.diagnostics import lwa as _lwa


def _loss_chain(grid, mask):
    ydef = grid.ydef
    dA = grid.dA

    def loss(t):
        table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                 increase=True, lt=True)
        ctr = core.cal_contours(t[None], 21, increase=True)
        ia = core.cal_integral_within_contours_hist(t[None], ctr, dA, lt=True)
        Q = core.interp_to_coords(ydef, table.lookup_coordinates(ia), ctr)
        lwa = _lwa.local_wave_activity(t[None], Q, dA, ydef, increase=True)
        return jnp.nansum(lwa * lwa)
    return loss


def test_lwa_adjoint_matches_finite_differences(rng):
    Ny, Nx = 24, 48
    lat = np.linspace(-75, 75, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    mask = jnp.ones((Ny, Nx))
    base = np.sin(np.deg2rad(lat))[:, None] + 0.15 * np.cos(
        3 * np.deg2rad(lon))[None, :] * np.cos(np.deg2rad(lat))[:, None]
    v = jnp.asarray(base + 0.02 * rng.standard_normal((Ny, Nx)))

    loss = _loss_chain(grid, mask)
    g = np.asarray(jax.grad(loss)(v))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0

    scale = np.abs(g).max()
    checked = 0
    for i, j in [(5, 7), (12, 20), (18, 33), (8, 41)]:
        if abs(g[i, j]) < 1e-3 * scale:
            continue                      # zero-gradient cell: FD is noise
        eps = 1e-7
        fd = (float(loss(v.at[i, j].add(eps)))
              - float(loss(v.at[i, j].add(-eps)))) / (2 * eps)
        rel = abs(fd - g[i, j]) / (abs(fd) + abs(g[i, j]))
        assert rel < 5e-3, (i, j, fd, g[i, j])
        checked += 1
    assert checked >= 2


def test_pallas_path_adjoint_matches_xla(rng, monkeypatch):
    """jax.grad flows through the GPU kernel path: the custom VJP in
    diagnostics/lwa.py differentiates the XLA lin form, so the
    kernel-forward gradient must equal the pure-XLA gradient (interpret
    mode stands in for the GPU on the CPU mesh)."""
    from xcontour_tpu.kernels import lwa_pallas as lk

    Ny, Nx = 16, 32
    lat = np.linspace(-70, 70, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    mask = jnp.ones((Ny, Nx))
    v = jnp.asarray(np.sin(np.deg2rad(lat))[:, None]
                    + 0.05 * rng.standard_normal((Ny, Nx)))

    loss = _loss_chain(grid, mask)
    l_xla = float(loss(v))
    g_xla = np.asarray(jax.grad(loss)(v))

    orig = lk.lwa_lin_pallas
    monkeypatch.setattr(lk, "lwa_lin_pallas",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setattr(_lwa, "_lin_kernel", lambda: True)
    g_pal = np.asarray(jax.grad(loss)(v))
    # the forward itself must also agree (f64 interpret parity)
    np.testing.assert_allclose(float(loss(v)), l_xla, rtol=1e-10)
    assert np.isfinite(g_pal).all()
    # f64 roundoff from different summation orders scales with the field
    np.testing.assert_allclose(g_pal, g_xla, rtol=1e-8,
                               atol=1e-12 * np.abs(g_xla).max())


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("part", ["upper", "lower"])
def test_part_selection_gradients_finite_and_match_fd(rng, part, variant2):
    """part='upper'/'lower' use NaN sentinels in the 3-valued mask; the
    dense form substitutes exact zeros before the product so the VJP stays
    NaN-free (nansum's cotangent would multiply 0*NaN=NaN and poison every
    element).  FD-checked at a probe cell away from mask boundaries."""
    Ny, Nx = 12, 16
    ydef = jnp.asarray(np.linspace(-60.0, 60.0, Ny))
    q = np.cumsum(rng.normal(size=(2, Ny, Nx)), axis=1)
    q[0, 3, 4] = np.nan                  # missing data must not poison grads
    q = jnp.asarray(q)
    dA = jnp.asarray(rng.uniform(0.5, 2.0, size=(Ny, Nx)))
    Q = jnp.sort(jnp.asarray(rng.normal(size=(2, Ny))), axis=-1)
    fn = _lwa.local_wave_activity2 if variant2 else _lwa.local_wave_activity

    def loss(t):
        out = fn(t, Q, dA, ydef, increase=True, part=part, method="dense")
        return jnp.nansum(out * out)

    g = np.asarray(jax.grad(loss)(q))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0

    scale = np.abs(g).max()
    f0 = float(loss(q))
    checked = 0
    for b, y, x in [(1, 5, 7), (1, 8, 11), (0, 6, 2), (0, 9, 13),
                    (1, 4, 3), (0, 7, 9)]:
        if abs(g[b, y, x]) < 1e-3 * scale:
            continue
        eps = 1e-6
        fp = float(loss(q.at[b, y, x].add(eps)))
        fm = float(loss(q.at[b, y, x].add(-eps)))
        # the part-selected LWA is piecewise smooth in q: a probe cell within
        # eps of a qe==0 kink makes the central difference misreport the
        # (valid) subgradient — detect via one-sided asymmetry and skip
        dp, dm = (fp - f0) / eps, (f0 - fm) / eps
        if abs(dp - dm) > 0.02 * (abs(dp) + abs(dm) + 1e-30):
            continue
        fd = (fp - fm) / (2 * eps)
        rel = abs(fd - g[b, y, x]) / (abs(fd) + abs(g[b, y, x]))
        assert rel < 5e-3, (b, y, x, fd, g[b, y, x])
        checked += 1
    assert checked >= 1


def test_grad_flag_matrix_fuzz(rng):
    """Random flag combinations (tracer direction, coordinate direction,
    part selection, both LWA variants, both dense/lin methods where legal):
    jax.grad of a sum-of-squares LWA loss is finite and FD-consistent at a
    probe cell.  Pins the a.e.-derivative semantics across the whole flag
    surface, not just the increase=True happy path."""
    Ny, Nx = 10, 12
    for trial in range(12):
        increase = bool(rng.integers(2))
        coord_down = bool(rng.integers(2))
        variant2 = bool(rng.integers(2))
        part = ["all", "upper", "lower"][rng.integers(3)]
        method = "dense" if part != "all" else ["dense", "lin"][rng.integers(2)]
        ydef = jnp.asarray(np.linspace(-60.0, 60.0, Ny)[::-1].copy()
                           if coord_down else np.linspace(-60.0, 60.0, Ny))
        base = np.cumsum(rng.normal(size=(Ny, Nx)), axis=0)
        if not increase:
            base = -base
        q = jnp.asarray(base)
        dA = jnp.asarray(rng.uniform(0.5, 2.0, size=(Ny, Nx)))
        Q = jnp.asarray(np.sort(rng.normal(size=(Ny,))))
        if not increase:
            Q = Q[::-1]
        fn = (_lwa.local_wave_activity2 if variant2
              else _lwa.local_wave_activity)

        def loss(t):
            out = fn(t, Q, dA, ydef, increase=increase, part=part,
                     method=method)
            return jnp.nansum(out * out)

        g = np.asarray(jax.grad(loss)(q))
        cfg = dict(trial=trial, increase=increase, coord_down=coord_down,
                   variant2=variant2, part=part, method=method)
        assert np.isfinite(g).all(), cfg
        if np.abs(g).max() == 0:
            continue                      # fully-excluded selection: fine
        idx = np.unravel_index(np.abs(g).argmax(), g.shape)
        eps = 1e-6
        fd = (float(loss(q.at[idx].add(eps)))
              - float(loss(q.at[idx].add(-eps)))) / (2 * eps)
        rel = abs(fd - g[idx]) / (abs(fd) + abs(g[idx]))
        assert rel < 5e-3, (cfg, idx, fd, g[idx])


def test_keff_grad_flag_matrix_fuzz(rng):
    """Random Keff pipeline flag combinations (tracer direction x CDF
    direction x hist/broadcast x all three lmin modes): jax.grad of
    nansum(nkeff) is finite and FD-consistent at the strongest probe cell.
    Sign/weight bugs in the adjoint hide exactly in the non-default flag
    corners."""
    from xcontour_tpu import pipeline

    Ny, Nx = 16, 24
    lat = np.linspace(-70, 70, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    for trial in range(8):
        increase = bool(rng.integers(2))
        lt = bool(rng.integers(2))
        hist = bool(rng.integers(2))
        lmin = ["analytic", "dxF", "frac"][rng.integers(3)]
        base = np.sin(np.deg2rad(lat))[:, None] + 0.15 * np.cos(
            3 * np.deg2rad(lon))[None, :] * np.cos(np.deg2rad(lat))[:, None]
        if not increase:
            base = -base
        v = jnp.asarray(base + 0.02 * rng.standard_normal((Ny, Nx)))

        def loss(t):
            out = pipeline.keff_pipeline(t[None], grid, N=15,
                                         increase=increase, lt=lt,
                                         hist=hist, lmin=lmin)
            return jnp.nansum(out["origin"]["nkeff"])

        g = np.asarray(jax.grad(loss)(v))
        cfg = dict(trial=trial, increase=increase, lt=lt, hist=hist,
                   lmin=lmin)
        assert np.isfinite(g).all(), cfg
        if np.abs(g).max() == 0:
            continue
        idx = np.unravel_index(np.abs(g).argmax(), g.shape)
        eps = 1e-6
        fd = (float(loss(v.at[idx].add(eps)))
              - float(loss(v.at[idx].add(-eps)))) / (2 * eps)
        rel = abs(fd - g[idx]) / (abs(fd) + abs(g[idx]))
        assert rel < 5e-3, (cfg, idx, fd, g[idx])


def test_contour_length_gradients(rng):
    """Marching-squares perimeters are genuinely differentiable in the
    tracer (vertex positions are linear interpolations of corner values):
    jax.grad is finite — including around NaN-masked cells — and matches
    central finite differences on a smooth field."""
    from xcontour_tpu.diagnostics.length import contour_lengths

    Ny, Nx = 20, 30
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 348.0, Nx)
    data = (np.sin(np.deg2rad(lat))[:, None]
            + 0.3 * rng.standard_normal((Ny, Nx)))
    ctr = jnp.linspace(-0.8, 0.8, 9)

    def loss(d):
        L = contour_lengths(d[None], ctr, jnp.asarray(lat), jnp.asarray(lon),
                            latlon=True)
        return jnp.nansum(L)

    g = np.asarray(jax.grad(loss)(jnp.asarray(data)))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0

    scale = np.abs(g).max()
    checked = 0
    for i, j in [(5, 7), (12, 20), (9, 3), (15, 25)]:
        if abs(g[i, j]) < 1e-4 * scale:
            continue
        eps = 1e-7
        fd = (float(loss(jnp.asarray(data).at[i, j].add(eps)))
              - float(loss(jnp.asarray(data).at[i, j].add(-eps)))) / (2 * eps)
        rel = abs(fd - g[i, j]) / (abs(fd) + abs(g[i, j]))
        assert rel < 5e-3, (i, j, fd, g[i, j])
        checked += 1
    assert checked >= 2

    # NaN-masked cells must not poison surrounding gradients
    d2 = data.copy()
    d2[5:8, 10:14] = np.nan
    g2 = np.asarray(jax.grad(loss)(jnp.asarray(d2)))
    assert np.isfinite(g2).all()


def test_contour_length_gradients_pipeline_levels(rng):
    """The gradient stays finite with cal_contours-generated levels — whose
    endpoints are pinned to the EXACT field min/max, creating zero-length
    segments through cell corners (hypot/haversine have infinite jacobians
    at zero separation; those lanes take the zero subgradient) — and with
    NaN levels from all-NaN batch elements."""
    from xcontour_tpu import core
    from xcontour_tpu.diagnostics.length import contour_lengths

    Ny, Nx = 20, 30
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 348.0, Nx)
    data = (np.sin(np.deg2rad(lat))[:, None]
            + 0.3 * rng.standard_normal((Ny, Nx)))

    def loss(d):
        ctr = core.cal_contours(d[None], 9, increase=True)
        L = contour_lengths(d[None], ctr, jnp.asarray(lat), jnp.asarray(lon),
                            latlon=True)
        return jnp.nansum(L)

    g = np.asarray(jax.grad(loss)(jnp.asarray(data)))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0

    # planar geometry too (hypot path)
    def loss_planar(d):
        ctr = core.cal_contours(d[None], 9, increase=True)
        L = contour_lengths(d[None], ctr, jnp.asarray(lat), jnp.asarray(lon),
                            latlon=False)
        return jnp.nansum(L)

    gp = np.asarray(jax.grad(loss_planar)(jnp.asarray(data)))
    assert np.isfinite(gp).all()

    # explicit NaN level (all-NaN batch elements produce these)
    def loss_nan_level(d):
        ctr = jnp.asarray([0.0, jnp.nan])
        L = contour_lengths(d[None], ctr, jnp.asarray(lat), jnp.asarray(lon),
                            latlon=True)
        return jnp.nansum(L)

    gn = np.asarray(jax.grad(loss_nan_level)(jnp.asarray(data)))
    assert np.isfinite(gn).all()
    assert np.abs(gn).max() > 0


def test_keff_pipeline_adjoint_matches_finite_differences(rng):
    """jax.grad flows through the FULL Keff chain (contours -> CDF -> table
    lookup -> d/dA -> Leq2 -> nkeff): the tail's 0/0 -> NaN divisions keep
    their reference primal but take degenerate lanes through stop_gradient,
    so the gradient is finite and FD-exact on live lanes."""
    from xcontour_tpu import pipeline

    Ny, Nx = 24, 48
    lat = np.linspace(-75, 75, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    base = np.sin(np.deg2rad(lat))[:, None] + 0.15 * np.cos(
        3 * np.deg2rad(lon))[None, :] * np.cos(np.deg2rad(lat))[:, None]
    v = jnp.asarray(base + 0.02 * rng.standard_normal((Ny, Nx)))

    def loss(t):
        out = pipeline.keff_pipeline(t[None], grid, N=21, lmin="analytic")
        return jnp.nansum(out["origin"]["nkeff"])

    g = np.asarray(jax.grad(loss)(v))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0

    scale = np.abs(g).max()
    checked = 0
    for i, j in [(5, 7), (12, 20), (18, 33), (8, 41), (10, 5)]:
        if abs(g[i, j]) < 1e-3 * scale:
            continue
        eps = 1e-6
        fd = (float(loss(v.at[i, j].add(eps)))
              - float(loss(v.at[i, j].add(-eps)))) / (2 * eps)
        rel = abs(fd - g[i, j]) / (abs(fd) + abs(g[i, j]))
        assert rel < 5e-3, (i, j, fd, g[i, j])
        checked += 1
    assert checked >= 3


def test_grad_safe_div_primal_matches_raw_division(rng):
    """core._grad_safe_div is bit-identical to plain division on the primal
    (0/0 -> NaN, x/0 -> +-inf, NaN/inf operands propagate) while its VJP is
    finite everywhere — including inf operands (which x/0 from an UPSTREAM
    safe division legitimately produces) and inf/inf lanes."""
    from xcontour_tpu.core import _grad_safe_div, _grad_safe_div_sq

    num = jnp.asarray([1.0, 0.0, -2.0, jnp.nan, 3.0, 0.0,
                       jnp.inf, 1.0, jnp.inf])
    den = jnp.asarray([2.0, 0.0, 0.0, 1.0, jnp.nan, 0.0,
                       2.0, jnp.inf, jnp.inf])
    with np.errstate(invalid="ignore", divide="ignore"):
        raw = np.asarray(num) / np.asarray(den)   # 0/0, x/0 on purpose
    out = np.asarray(_grad_safe_div(num, den))
    np.testing.assert_array_equal(out, raw)

    def loss(a, b):
        o = _grad_safe_div(a, b)
        return jnp.nansum(jnp.where(jnp.isfinite(o), o, 0.0))

    g = jax.grad(loss, argnums=(0, 1))(num, den)
    assert np.isfinite(np.asarray(g[0])).all()
    assert np.isfinite(np.asarray(g[1])).all()

    # the fused n/d^2 form: same primal as a plain n/d**2, finite VJP even
    # where den**2 under/overflows (primal inf with den != 0)
    num2 = jnp.asarray([1.0, 1.0, jnp.inf, 2.0], jnp.float32)
    den2 = jnp.asarray([1e-25, 1.0, jnp.inf, 3.0], jnp.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        want2 = np.asarray(num2) / np.asarray(den2) ** 2   # inf/inf -> NaN
    np.testing.assert_array_equal(np.asarray(_grad_safe_div_sq(num2, den2)),
                                  want2)

    def loss2(a, b):
        o = _grad_safe_div_sq(a, b)
        return jnp.nansum(jnp.where(jnp.isfinite(o), o, 0.0))

    g2 = jax.grad(loss2, argnums=(0, 1))(num2, den2)
    assert np.isfinite(np.asarray(g2[0])).all()
    assert np.isfinite(np.asarray(g2[1])).all()


def test_adjoint_through_batched_pipeline_is_finite(rng):
    """grad flows through a batched call (vmapped internals, both CDF
    channels) without NaN poisoning."""
    Ny, Nx = 16, 32
    lat = np.linspace(-70, 70, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    mask = jnp.ones((Ny, Nx))
    v = jnp.asarray(np.sin(np.deg2rad(lat))[:, None]
                    + 0.05 * rng.standard_normal((3, Ny, Nx)))

    def loss(t):
        table = core.cal_area_eqCoord_table_hist(mask, grid.ydef, grid.dA,
                                                 increase=True, lt=True)
        ctr = core.cal_contours(t, 11, increase=True)
        ia = core.cal_integral_within_contours_hist(t, ctr, grid.dA, lt=True)
        Q = core.interp_to_coords(grid.ydef, table.lookup_coordinates(ia),
                                  ctr)
        lwa = _lwa.local_wave_activity(t, Q, grid.dA, grid.ydef,
                                       increase=True)
        return jnp.nansum(jnp.abs(lwa))

    g = np.asarray(jax.grad(loss)(v))
    assert g.shape == v.shape
    assert np.isfinite(g).all()


def test_second_order_hvp_matches_fd(rng):
    """The full Keff+LWA chain is SECOND-order differentiable on the XLA
    path: Hessian-vector products (both reverse-over-reverse and
    forward-over-reverse) are finite and match finite differences of the
    gradient.  The custom-VJP safe divisions don't block this — once the
    inner grad expands them into their (plain-op) backward, the outer
    transform differentiates ordinary XLA ops.  Enables Newton/Gauss-Newton
    data assimilation on contour diagnostics, which the reference's
    xarray/numba stack cannot express at any order."""
    from xcontour_tpu import pipeline

    Ny, Nx = 16, 24
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 345.0, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    q = jnp.asarray(np.sin(np.deg2rad(lat))[:, None]
                    + 0.2 * rng.standard_normal((Ny, Nx)))

    def loss(t):
        o = pipeline.keff_lwa_pipeline(t[None], grid, N=9, increase=True,
                                       lt=True)
        nk = o["nkeff"]
        return jnp.nansum(jnp.where(jnp.isfinite(nk), nk, 0.0)) * 1e-6

    v = jnp.asarray(rng.standard_normal(q.shape))
    hvp_rr = jax.grad(lambda x: jnp.vdot(jax.grad(loss)(x), v))(q)
    assert np.isfinite(np.asarray(hvp_rr)).all()

    eps = 1e-5
    fd = (jax.grad(loss)(q + eps * v) - jax.grad(loss)(q - eps * v)) \
        / (2 * eps)
    denom = float(jnp.max(jnp.abs(fd)))
    assert denom > 0
    assert float(jnp.max(jnp.abs(hvp_rr - fd))) / denom < 1e-6

    # forward-over-reverse agrees with reverse-over-reverse
    _, hvp_fr = jax.jvp(jax.grad(loss), (q,), (v,))
    np.testing.assert_allclose(np.asarray(hvp_fr), np.asarray(hvp_rr),
                               rtol=1e-9, atol=denom * 1e-12)
