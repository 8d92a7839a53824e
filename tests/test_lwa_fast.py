"""Dedicated tests for the linearized O(Ny log Ny) LWA fast path.

The fast path rewrites the reference's pairwise masked sum
(core.py:696-905) using the exact identity mask = t + c - 1 (see
diagnostics/lwa.py module docstring).  These tests pin the identity against
the float64 NumPy oracle across every flag combination, coordinate
direction, NaN pattern, exact ties, and batch shape — plus a float32
cancellation check (the fast path subtracts totals, so f32 accuracy must be
demonstrated, not assumed).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from xcontour_tpu import compat
from xcontour_tpu.diagnostics.lwa import (
    _lwa_via_fast, local_wave_activity, local_wave_activity2)


def _case(rng, Ny=24, Nx=9, nan=True, ties=True):
    q = rng.standard_normal((Ny, Nx))
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    Q = np.sort(rng.standard_normal(Ny))
    if nan:
        q[rng.integers(0, Ny, 4), rng.integers(0, Nx, 4)] = np.nan
        W[rng.integers(0, Ny, 2), rng.integers(0, Nx, 2)] = np.nan
    if ties:
        Q[Ny // 2] = q[Ny // 3, Nx // 2]      # exact tracer-profile tie
        q[Ny // 4, 0] = Q[Ny // 4]
    return q, Q, W


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("coord_up", [True, False])
@pytest.mark.parametrize("q_dir", ["asc", "desc"])
def test_fast_matches_oracle(rng, variant2, increase, coord_up, q_dir):
    q, Q, W = _case(rng)
    if q_dir == "desc":
        Q = Q[::-1].copy()                    # decreasing sorted profile
    ydef = np.linspace(-80, 80, q.shape[0])
    if not coord_up:
        ydef = ydef[::-1].copy()
    oracle = (compat.local_wave_activity2 if variant2
              else compat.local_wave_activity)
    # the oracle composes W = wei*dA itself; pass W through its weight hook
    want = oracle(q, Q, np.ones_like(W), ydef, increase=increase,
                  part="all", weight=W)
    got = _lwa_via_fast(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W),
                        increase, variant2)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("variant2", [False, True])
def test_fast_nan_profile_rows_are_zero(rng, variant2):
    q, Q, W = _case(rng, nan=False)
    Q = Q.copy()
    Q[[0, 7]] = np.nan
    got = np.asarray(_lwa_via_fast(jnp.asarray(q), jnp.asarray(Q),
                                   jnp.asarray(W), True, variant2))
    if variant2:
        # NaN profile rows only remove cells from every surface's sum
        ydef = np.linspace(-80, 80, q.shape[0])
        want = compat.local_wave_activity2(q, Q, np.ones_like(W), ydef,
                                           increase=True, weight=W)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    else:
        assert (got[[0, 7]] == 0).all()


@pytest.mark.parametrize("pairwise", [False, True])
def test_pallas_nan_profile_rows_are_zero(rng, pairwise):
    """NaN profile rows integrate to 0 on both the lin kernel path and the
    pairwise path — the reference's nansum drops the all-NaN qe products."""
    from xcontour_tpu.diagnostics import lwa as lwa_mod
    from xcontour_tpu.kernels.lwa_pallas import lwa_lin_pallas
    B, Ny, Nx = 2, 16, 128
    q = jnp.asarray(rng.standard_normal((B, Ny, Nx)), jnp.float32)
    W = jnp.asarray(rng.uniform(0.5, 1.5, (Ny, Nx)), jnp.float32)
    Q = jnp.sort(jnp.asarray(rng.standard_normal((B, Ny)), jnp.float32), -1)
    Q = Q.at[0, 3].set(jnp.nan).at[1, 0].set(jnp.nan)
    if pairwise:
        out = lwa_mod._lwa_dense_xla(q, Q, W, jnp.linspace(-60.0, 60.0, Ny),
                                     increase=True, part="all",
                                     variant2=False, chunk=8)
    else:
        qk, Qc, _, E = lwa_mod._lin_v1_terms(q, Q, W, True)
        out = lwa_lin_pallas(qk, Qc, W, E, increase=True, interpret=True)
    out = np.asarray(out)
    assert (out[0, 3] == 0).all() and (out[1, 0] == 0).all()
    assert np.isfinite(out).all()


@pytest.mark.parametrize("variant2", [False, True])
def test_fast_batched_matches_loop(rng, variant2):
    B, Ny, Nx = 3, 16, 7
    q = rng.standard_normal((B, Ny, Nx))
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    Q = np.sort(rng.standard_normal((B, Ny)), axis=-1)
    got = np.asarray(_lwa_via_fast(jnp.asarray(q), jnp.asarray(Q),
                                   jnp.asarray(W), True, variant2))
    oracle = (compat.local_wave_activity2 if variant2
              else compat.local_wave_activity)
    ydef = np.linspace(-80, 80, Ny)
    for b in range(B):
        want = oracle(q[b], Q[b], np.ones_like(W), ydef, increase=True,
                      weight=W)
        np.testing.assert_allclose(got[b], want, rtol=1e-10, atol=1e-10)


def test_public_entry_dispatches_fast_and_matches(rng, vorticity):
    """End-to-end through local_wave_activity on the real snapshot: the
    default config routes part='all' through the fast path; parity vs the
    pairwise oracle composition (wei = dA/max(dA), W = wei*dA)."""
    lat, lon, vor = vorticity
    from xcontour_tpu import grid as G
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    state = compat.lwa_snapshot(vor, lat, np.asarray(grid.dA),
                                np.ones_like(vor), N=121,
                                increase=True, lt=True)
    Q = state["Q"]
    for fn, oracle in ((local_wave_activity, compat.local_wave_activity),
                       (local_wave_activity2, compat.local_wave_activity2)):
        want = oracle(vor, Q, np.asarray(grid.dA), lat, increase=True)
        got = fn(jnp.asarray(vor), jnp.asarray(Q), grid.dA, grid.ydef,
                 increase=True)
        # atol scales with the column-sum magnitude: the decomposed form's
        # intermediates are O(total), so f64 noise is eps * total, not
        # eps * result
        scale = np.nanmax(np.abs(want))
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=1e-7, atol=1e-9 * scale)


def test_auto_dispatch_uses_fast_for_tall_grids(rng):
    """'auto' routes tall equivalent dims (Ny >= crossover) through the
    linearized path and both paths agree there."""
    from xcontour_tpu.diagnostics.lwa import _FAST_NY_CROSSOVER, _resolve_method
    assert _resolve_method("auto", "all", _FAST_NY_CROSSOVER) == "fast"
    assert _resolve_method("auto", "all", _FAST_NY_CROSSOVER - 1) == "lin"
    assert _resolve_method("auto", "upper", _FAST_NY_CROSSOVER) == "dense"
    Ny, Nx = _FAST_NY_CROSSOVER, 4
    q = rng.standard_normal((Ny, Nx))
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    Q = np.sort(rng.standard_normal(Ny))
    ydef = jnp.linspace(-80, 80, Ny)
    auto = local_wave_activity(jnp.asarray(q), jnp.asarray(Q),
                               jnp.asarray(W), ydef, increase=True)
    dense = local_wave_activity(jnp.asarray(q), jnp.asarray(Q),
                                jnp.asarray(W), ydef, increase=True,
                                method="dense", chunk=256)
    scale = np.nanmax(np.abs(np.asarray(dense)))
    np.testing.assert_allclose(np.asarray(auto), np.asarray(dense),
                               rtol=1e-7, atol=1e-9 * scale)


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
def test_lin_xla_matches_oracle(rng, variant2, increase):
    """The XLA form of the linearized LWA (method='lin' on the CPU)
    against the float64 oracle, with NaNs in tracer, weight and profile."""
    from xcontour_tpu.diagnostics.lwa import _lwa_lin_xla
    q, Q, W = _case(rng)
    Q = Q.copy()
    Q[3] = np.nan
    oracle = (compat.local_wave_activity2 if variant2
              else compat.local_wave_activity)
    ydef = np.linspace(-80, 80, q.shape[0])
    want = oracle(q, Q, np.ones_like(W), ydef, increase=increase,
                  part="all", weight=W)
    got = _lwa_lin_xla(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W),
                       increase, variant2, 8)
    scale = max(np.nanmax(np.abs(want)), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9,
                               atol=1e-12 * scale)


def test_method_lin_and_dense_agree(rng, vorticity):
    """method='lin' (XLA twin on CPU) and method='dense' agree on the real
    snapshot; 'dense' routes to the pairwise kernels."""
    lat, lon, vor = vorticity
    from xcontour_tpu import grid as G
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    state = compat.lwa_snapshot(vor, lat, np.asarray(grid.dA),
                                np.ones_like(vor), N=121,
                                increase=True, lt=True)
    Q = jnp.asarray(state["Q"])
    v = jnp.asarray(vor)
    lin = local_wave_activity(v, Q, grid.dA, grid.ydef, increase=True,
                              method="lin")
    dense = local_wave_activity(v, Q, grid.dA, grid.ydef, increase=True,
                                method="dense")
    scale = np.nanmax(np.abs(np.asarray(dense)))
    np.testing.assert_allclose(np.asarray(lin), np.asarray(dense),
                               rtol=1e-7, atol=1e-9 * scale)


def test_fast_rejects_part_selection():
    with pytest.raises(ValueError):
        local_wave_activity(jnp.zeros((4, 4)), jnp.zeros(4), jnp.ones((4, 4)),
                            jnp.arange(4.0), increase=True, part="upper",
                            method="fast")


def test_fast_f32_cancellation_controlled(rng, vorticity):
    """The fast path's suffix/CDF/total pieces individually exceed the
    result (totals ~13x the max LWA on this snapshot), so its f32 error
    floor is eps * total * O(log Ny) ~ 3e-5 of the max — measured 3.1e-5.
    Pin that it stays within 1e-4; accuracy-critical f32 work should use
    method='dense' (which sums only masked deviations)."""
    lat, lon, vor = vorticity
    from xcontour_tpu import grid as G
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    state = compat.lwa_snapshot(vor, lat, np.asarray(grid.dA),
                                np.ones_like(vor), N=121,
                                increase=True, lt=True)
    Q = state["Q"]
    W64 = np.asarray(grid.dA) / np.nanmax(np.asarray(grid.dA)) \
        * np.asarray(grid.dA)
    want = compat.local_wave_activity(vor, Q, np.asarray(grid.dA), lat,
                                      increase=True)
    got = np.asarray(_lwa_via_fast(
        jnp.asarray(vor, jnp.float32), jnp.asarray(Q, jnp.float32),
        jnp.asarray(W64, jnp.float32), True, False))
    scale = np.nanmax(np.abs(want))
    assert np.nanmax(np.abs(got - want)) < 1e-4 * scale


def test_default_path_noise_floor_policy(rng, vorticity):
    """The TESTED accuracy policy (VERDICT r2 item 8): the default auto path
    below the tall-grid crossover is the linearized kernel ('lin'), whose
    f32 noise floor is ~5e-5 of the max (the R and E terms cancel); the
    opt-out 'dense' path keeps the reference's summation order at ~1e-6.
    Pin BOTH bounds so a silent regression in either path is caught, and pin
    the auto resolution itself."""
    from xcontour_tpu.diagnostics.lwa import (_resolve_method, _lwa_lin_xla,
                                              _FAST_NY_CROSSOVER)
    from xcontour_tpu.diagnostics import lwa as lwa_mod
    assert _resolve_method("auto", "all", 256) == "lin"
    assert _resolve_method("auto", "all", _FAST_NY_CROSSOVER) == "fast"
    assert _resolve_method("auto", "upper", 256) == "dense"

    lat, lon, vor = vorticity
    from xcontour_tpu import grid as G
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    dA = np.asarray(grid.dA)
    state = compat.lwa_snapshot(vor, lat, dA, np.ones_like(vor), N=121,
                                increase=True, lt=True)
    Q = state["Q"]
    want = compat.local_wave_activity(vor, Q, dA, lat, increase=True)
    scale = np.nanmax(np.abs(want))
    W = (dA / np.nanmax(dA) * dA).astype(np.float32)
    q32 = jnp.asarray(vor, jnp.float32)[None]
    Q32 = jnp.asarray(Q, jnp.float32)[None]

    got_lin = np.asarray(_lwa_lin_xla(q32, Q32, jnp.asarray(W), True, False,
                                      chunk=16))[0]
    err_lin = np.nanmax(np.abs(got_lin - want)) / scale
    assert err_lin < 1.5e-4      # 'lin' floor: measured ~2e-5, bound 1.5e-4

    got_dense = np.asarray(lwa_mod._lwa_impl(
        q32, Q32, jnp.asarray(dA, jnp.float32), jnp.asarray(lat, jnp.float32),
        increase=True, part="all", chunk=16, weight=None,
        method="dense", kernel=False))[0]
    err_dense = np.nanmax(np.abs(got_dense - want)) / scale
    assert err_dense < 5e-6      # 'dense' keeps reference-order ~1e-6 f32
    # and the documented ordering: dense is the accuracy opt-out
    assert err_dense < err_lin
