"""LWA / LAPE parity and physical-invariant tests.

Mirrors the reference's LWA workloads (tests/test_LWA.py for the barotropic
vorticity case, tests/test_LAPE.py for the vertical-plane buoyancy case) with
real assertions: JAX kernels vs the NumPy oracle, LWA-vs-variant-2 antisymmetry
(the reference's own difference-panel check, tests/test_LWA.py:121-124), and
positive-definiteness of -LAPE.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from xcontour_tpu import compat
from xcontour_tpu import grid as G
from xcontour_tpu.diagnostics.lwa import (
    local_wave_activity, local_wave_activity2, lwa_masks_at)
from xcontour_tpu.pipeline import lwa_pipeline


@pytest.fixture(scope="module")
def lwa_case(vorticity):
    lat, lon, vor = vorticity
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    mask = np.ones_like(vor)
    state = compat.lwa_snapshot(vor, lat, np.asarray(grid.dA), mask,
                                N=121, increase=True, lt=True)
    return lat, lon, vor, grid, mask, state


@pytest.mark.parametrize("part", ["all", "upper", "lower"])
def test_lwa_matches_oracle(lwa_case, part):
    lat, lon, vor, grid, mask, state = lwa_case
    Q = state["Q"]
    want = compat.local_wave_activity(vor, Q, np.asarray(grid.dA), lat,
                                      increase=True, part=part)
    # dense = pairwise path, bit-faithful to the reference summation order
    got = local_wave_activity(jnp.asarray(vor), jnp.asarray(Q), grid.dA,
                              grid.ydef, increase=True, part=part,
                              method="dense")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-8)
    if part == "all":
        fast = local_wave_activity(jnp.asarray(vor), jnp.asarray(Q), grid.dA,
                                   grid.ydef, increase=True, part=part,
                                   method="fast")
        scale = np.nanmax(np.abs(want))
        np.testing.assert_allclose(np.asarray(fast), want, rtol=1e-7,
                                   atol=1e-9 * scale)


def test_lwa2_matches_oracle(lwa_case):
    lat, lon, vor, grid, mask, state = lwa_case
    Q = state["Q"]
    want = compat.local_wave_activity2(vor, Q, np.asarray(grid.dA), lat,
                                       increase=True, part="all")
    got = local_wave_activity2(jnp.asarray(vor), jnp.asarray(Q), grid.dA,
                               grid.ydef, increase=True, part="all",
                               method="dense")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-8)
    fast = local_wave_activity2(jnp.asarray(vor), jnp.asarray(Q), grid.dA,
                                grid.ydef, increase=True, part="all",
                                method="fast")
    scale = np.nanmax(np.abs(want))
    np.testing.assert_allclose(np.asarray(fast), want, rtol=1e-7,
                               atol=1e-9 * scale)


def test_lwa_pipeline_matches_oracle(lwa_case):
    lat, lon, vor, grid, mask, state = lwa_case
    got = lwa_pipeline(jnp.asarray(vor), grid, jnp.asarray(mask),
                       N=121, increase=True, lt=True)
    np.testing.assert_allclose(np.asarray(got["latEq"]), state["latEq"],
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(got["Q"]), state["Q"], atol=1e-10)
    np.testing.assert_allclose(np.asarray(got["lwa"]), state["lwa"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got["lwa2"]), state["lwa2"],
                               rtol=1e-6, atol=1e-7)


def test_lwa_parts_decompose(lwa_case):
    """W+ and W- parts sum to the total (partition property of the 3-valued
    mask, reference core.py:772-784)."""
    lat, lon, vor, grid, mask, state = lwa_case
    Q = jnp.asarray(state["Q"])
    v = jnp.asarray(vor)
    allp = local_wave_activity(v, Q, grid.dA, grid.ydef, increase=True, part="all")
    up = local_wave_activity(v, Q, grid.dA, grid.ydef, increase=True, part="upper")
    lo = local_wave_activity(v, Q, grid.dA, grid.ydef, increase=True, part="lower")
    # allp rides the fast path (default); scale atol to the column-sum
    # magnitude its decomposed intermediates carry
    scale = np.nanmax(np.abs(np.asarray(allp)))
    np.testing.assert_allclose(np.asarray(up + lo), np.asarray(allp),
                               rtol=1e-7, atol=1e-9 * scale)


def test_lwa_sign_invariants(lwa_case):
    """LWA >= 0 and -LWA2 >= 0 for part='all' (the reference plots both as
    positive fields, tests/test_LWA.py:112-119)."""
    lat, lon, vor, grid, mask, state = lwa_case
    assert np.nanmin(state["lwa"]) >= -1e-9
    assert np.nanmin(-state["lwa2"]) >= -1e-9


def test_lwa_dy_metric_physical_scale(lwa_case):
    """With the intended wei*dy metric (reference core.py:787-788) LWA lands
    in the O(10 m/s) range of the reference's 0-30 plot levels
    (tests/test_LWA.py:112), unlike the vendored wei*dA composition."""
    lat, lon, vor, grid, mask, state = lwa_case
    got = lwa_pipeline(jnp.asarray(vor), grid, jnp.asarray(mask),
                       N=121, increase=True, lt=True, metric="dy")
    mx = float(np.nanmax(np.asarray(got["lwa"])))
    assert 5.0 < mx < 100.0
    assert float(np.nanmin(np.asarray(got["lwa"]))) >= -1e-9


def test_lwa_masks_capture(lwa_case):
    """Mask capture at selected surfaces matches the oracle mask build."""
    lat, lon, vor, grid, mask, state = lwa_case
    Q = state["Q"]
    idx = [37, 125, 170, 213]
    contours, masks = lwa_masks_at(jnp.asarray(vor), jnp.asarray(Q), grid.dA,
                                   grid.ydef, idx, increase=True)
    np.testing.assert_allclose(np.asarray(contours), Q[idx], rtol=1e-12)
    wei = np.ones_like(vor)
    for k, j in enumerate(idx):
        qe = vor - Q[j]
        m = lat >= lat[j]
        want = compat._lwa_masks(qe, m[:, None], True)
        np.testing.assert_allclose(np.asarray(masks[k]), want)


def test_lape_vertical_plane():
    """Vertical-plane LAPE on a synthetic stratified state: -LAPE is positive
    semi-definite (reference notebook 3 invariant) and matches the oracle.

    Uses the LAPE flag convention increase=False, lt=False
    (tests/test_LAPE.py:47-49) on an X-Z grid with depth decreasing downward.
    """
    rng = np.random.default_rng(7)
    Nz, Nx = 40, 64
    z = -np.linspace(2.5, 197.5, Nz)          # 0 .. -200 m, decreasing
    x = np.linspace(10, 8950, Nx)
    grid = G.from_xz(z, x, dim_names=("Z", "XC"), dtype=jnp.float64)

    # stable stratification + internal-wave displacement
    b0 = 1e-3 * (z / 200.0)                    # buoyancy decreasing with depth
    eta = 15.0 * np.sin(2 * np.pi * x / 4480.0)
    b = b0[:, None] + 1e-3 * eta[None, :] / 200.0
    b += 1e-6 * rng.standard_normal((Nz, Nx))

    state = compat.lwa_snapshot(b, z, np.asarray(grid.dA), np.ones_like(b),
                                N=81, increase=False, lt=False)
    got = lwa_pipeline(jnp.asarray(b), grid, jnp.asarray(np.ones_like(b)),
                       N=81, increase=False, lt=False)
    np.testing.assert_allclose(np.asarray(got["Q"]), state["Q"], atol=1e-9)
    np.testing.assert_allclose(np.asarray(got["lwa"]), state["lwa"],
                               rtol=1e-8, atol=1e-12)
    # -LAPE >= 0 up to roundoff (W&B13 positive-definite density)
    lape = np.asarray(got["lwa"])
    assert np.nanmin(-lape) > -1e-10


def test_lwa_batched_matches_loop(lwa_case):
    lat, lon, vor, grid, mask, state = lwa_case
    batch = np.stack([vor, 0.8 * vor])
    got = lwa_pipeline(jnp.asarray(batch), grid, jnp.asarray(mask),
                       N=61, increase=True, lt=True)
    for b in range(2):
        one = lwa_pipeline(jnp.asarray(batch[b]), grid, jnp.asarray(mask),
                           N=61, increase=True, lt=True)
        np.testing.assert_allclose(np.asarray(got["lwa"][b]),
                                   np.asarray(one["lwa"]), rtol=1e-10,
                                   atol=1e-10)


def test_sorted_state_conserves_tracer_integral(lwa_case):
    """Adiabatic rearrangement preserves the area integral of the tracer:
    integral of the sorted profile Q(y) over zonal bands matches the integral
    of q over the plane (to interpolation accuracy) — the conservation
    property underlying the whole contour-coordinate construction."""
    lat, lon, vor, grid, mask, state = lwa_case
    dA = np.asarray(grid.dA)
    total_q = np.nansum(vor * dA)
    band = dA.sum(axis=1)                       # zonal band areas
    total_Q = np.nansum(state["Q"] * band)
    # global vorticity integrates to ~0, so normalize by the L1 integral
    scale = np.nansum(np.abs(vor) * dA)
    assert abs(total_Q - total_q) / scale < 2e-2


def test_unknown_method_raises():
    """Typos like method='Lin' must not silently fall through to a different
    execution path (ADVICE r2)."""
    import pytest
    from xcontour_tpu.diagnostics.lwa import _resolve_method
    for bad in ("Lin", "linn", "pairwise", ""):
        with pytest.raises(ValueError):
            _resolve_method(bad, "all", 256)
    assert _resolve_method("dense", "upper", 256) == "dense"


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("method", ["lin", "dense", "fast"])
def test_method_matrix_through_pallas_dispatch(rng, monkeypatch, variant2,
                                               method):
    """Every (method, variant) cell of the dispatch table gives the same
    answer when 'lin' is routed to the Pallas kernel as on the CPU path —
    interpret mode stands in for the GPU.  Only variant-1 'lin' has a
    kernel; the other cells must be invariant to the routing."""
    from xcontour_tpu.diagnostics import lwa as lwa_mod
    from xcontour_tpu.kernels import lwa_pallas as lk

    Ny, Nx = 20, 16
    ydef = jnp.asarray(np.linspace(-60.0, 60.0, Ny))
    q = jnp.asarray(np.cumsum(rng.normal(size=(2, Ny, Nx)), axis=1))
    dA = jnp.asarray(rng.uniform(0.5, 2.0, size=(Ny, Nx)))
    Q = jnp.sort(jnp.asarray(rng.normal(size=(2, Ny))), axis=-1)
    fn = local_wave_activity2 if variant2 else local_wave_activity

    want = fn(q, Q, dA, ydef, increase=True, part="all", method=method)

    orig = lk.lwa_lin_pallas
    monkeypatch.setattr(lk, "lwa_lin_pallas",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setattr(lwa_mod, "_lin_kernel", lambda: True)
    got = fn(q, Q, dA, ydef, increase=True, part="all", method=method)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-9, atol=1e-9)
