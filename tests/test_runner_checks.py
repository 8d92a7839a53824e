"""Batch runner (checkpoint/resume) and checkify guard tests."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from xcontour_tpu.runner import run_batched, load_chunks
from xcontour_tpu.utils import checks


def _step(x):
    return {"mean": jnp.mean(x, axis=(-2, -1)), "double": x * 2}


def test_runner_in_memory(rng):
    snaps = rng.normal(size=(10, 8, 16))
    out = run_batched(jax.jit(_step), snaps, batch=4, log=lambda s: None)
    assert out["mean"].shape == (10,)
    np.testing.assert_allclose(out["mean"], snaps.mean(axis=(1, 2)), rtol=1e-6)
    np.testing.assert_allclose(out["double"], snaps * 2, rtol=1e-6)


def test_runner_resume(tmp_path, rng):
    snaps = rng.normal(size=(10, 8, 16))
    stem = str(tmp_path / "out")
    calls = []
    step = jax.jit(_step)

    def counting_step(x):
        calls.append(1)
        return step(x)

    run_batched(counting_step, snaps, batch=4, out_stem=stem,
                log=lambda s: None)
    assert len(calls) == 3
    # delete one chunk -> only that chunk recomputes
    os.remove(stem + "_ck00001.npz")
    run_batched(counting_step, snaps, batch=4, out_stem=stem,
                log=lambda s: None)
    assert len(calls) == 4
    out = load_chunks(stem)
    np.testing.assert_allclose(out["mean"], snaps.mean(axis=(1, 2)), rtol=1e-6)


def test_checkify_monotonic_guard():
    @jax.jit
    def f(a):
        checks.check_monotonic(a, name="area")
        return jnp.cumsum(a)

    checked = checks.checked(f)
    err, _ = checked(jnp.asarray([1.0, 2.0, 3.0]))
    err.throw()  # no error
    err, _ = checked(jnp.asarray([1.0, 1.0, 3.0]))
    with pytest.raises(Exception, match="monotonic"):
        err.throw()


def test_host_monotonic_guard():
    checks.assert_monotonic_host(np.array([1.0, 2.0, 3.0]))
    with pytest.raises(ValueError, match="monotonic"):
        checks.assert_monotonic_host(np.array([[1.0, 2.0], [2.0, 2.0]]))


# ---------------------------------------------------------------------------
# failure isolation (SURVEY.md §5 failure-detection row)
# ---------------------------------------------------------------------------
def _nan_poisoned(snaps, bad_chunk, batch):
    snaps = snaps.copy()
    snaps[bad_chunk * batch] = np.nan
    return snaps


def _validate_finite(out_np):
    for k, v in out_np.items():
        if not np.isfinite(v).all():
            raise ValueError(f"non-finite output in {k!r}")


def test_runner_skip_bad_chunk_in_memory(rng):
    """A NaN-poisoned chunk is retried, then NaN-filled; the rest of the
    archive survives with aligned time indices."""
    snaps = _nan_poisoned(rng.normal(size=(12, 8, 16)), bad_chunk=1, batch=4)
    attempts = []

    def step(x):
        attempts.append(1)
        return _step(x)

    out = run_batched(step, snaps, batch=4, log=lambda s: None,
                      retries=1, on_error="skip", retry_wait=0.0,
                      validate=_validate_finite)
    assert len(attempts) == 3 + 1          # 3 chunks + 1 retry of the bad one
    assert out["mean"].shape == (12,)
    assert np.isnan(out["mean"][4:8]).all()      # failed chunk NaN-filled
    good = np.r_[0:4, 8:12]
    np.testing.assert_allclose(out["mean"][good],
                               snaps[good].mean(axis=(1, 2)), rtol=1e-6)


def test_runner_raise_is_default(rng):
    snaps = _nan_poisoned(rng.normal(size=(8, 8, 16)), bad_chunk=0, batch=4)
    with pytest.raises(ValueError, match="non-finite"):
        run_batched(jax.jit(_step), snaps, batch=4, log=lambda s: None,
                    validate=_validate_finite)


def test_runner_failed_marker_and_resume_retry(tmp_path, rng):
    """File mode: the bad chunk leaves a structured .failed record,
    load_chunks refuses it by default / NaN-fills on request, and a resumed
    run with the poison removed repairs the archive and clears the marker."""
    snaps = _nan_poisoned(rng.normal(size=(12, 8, 16)), bad_chunk=2, batch=4)
    stem = str(tmp_path / "era")
    run_batched(jax.jit(_step), snaps, batch=4, out_stem=stem,
                log=lambda s: None, on_error="skip", retry_wait=0.0,
                validate=_validate_finite)
    marker = stem + "_ck00002.failed"
    assert os.path.exists(marker)
    with pytest.raises(RuntimeError, match="failed chunk"):
        load_chunks(stem)
    out = load_chunks(stem, allow_failed=True)
    assert out["mean"].shape == (12,) and np.isnan(out["mean"][8:]).all()

    # repair the data and resume: only the failed chunk recomputes
    calls = []
    fixed = snaps.copy()
    fixed[8] = 0.0

    def counting_step(x):
        calls.append(1)
        return _step(x)

    run_batched(counting_step, fixed, batch=4, out_stem=stem,
                log=lambda s: None, on_error="skip", retry_wait=0.0,
                validate=_validate_finite)
    assert len(calls) == 1
    assert not os.path.exists(marker)
    out = load_chunks(stem)
    assert np.isfinite(out["mean"]).all()


def test_runner_checkify_guard_surfaces_in_record(tmp_path, rng):
    """An in-jit checkify guard (utils.checks) rejects a chunk through the
    validate hook and its message lands in the .failed record."""
    snaps = rng.normal(size=(8, 8, 16))
    snaps[5] = 7.0                                  # constant row -> zero diff

    checked_step = checks.checked(
        jax.jit(lambda x: (checks.check_monotonic(x, axis=-1, name="tracer"),
                           _step(x))[1]))

    def step_with_guard(x):
        err, out = checked_step(x)
        err.throw()
        return out

    stem = str(tmp_path / "guard")
    run_batched(step_with_guard, snaps, batch=4, out_stem=stem,
                log=lambda s: None, on_error="skip", retry_wait=0.0)
    import json as _json
    with open(stem + "_ck00001.failed") as f:
        rec = _json.load(f)
    assert "monotonic" in rec["error"]
    assert rec["chunk"] == 1 and rec["nvalid"] == 4


def test_contour2d_check_mono_unified():
    """The object API's opt-in guard routes through checks.check_monotonic:
    eager calls raise immediately on a degenerate (constant) tracer whose
    area table has zero differences; check_mono=False stays silent (VERDICT
    r2 weak-7 unification — no full-array host sync in the guard)."""
    from xcontour_tpu.core import Contour2D
    Ny, Nx = 8, 12
    dA = np.ones((Ny, Nx))
    ydef = np.linspace(-60, 60, Ny)
    flat = np.ones((Ny, Nx))          # constant tracer -> constant integrals
    c = Contour2D.from_arrays(flat, dA, ydef, increase=True, lt=True,
                              check_mono=True, dtype=jnp.float64)
    ctr = jnp.linspace(0.0, 2.0, 5)
    with pytest.raises(Exception, match="monotonic"):
        c.cal_integral_within_contours(ctr)
    c2 = Contour2D.from_arrays(flat, dA, ydef, increase=True, lt=True,
                               check_mono=False, dtype=jnp.float64)
    c2.cal_integral_within_contours(ctr)  # silent


def test_packed_fetch_bit_identical(rng):
    """The round-trip-saving packed fetch (one device->host transfer per
    (dtype, batch) group) returns exactly what per-key np.asarray would,
    across mixed dtypes, ranks, and an unbatchable scalar."""
    from xcontour_tpu.runner import _fetch_packed
    x = rng.normal(size=(6, 4, 8)).astype(np.float32)

    def step(t):
        return {"a": jnp.mean(t, axis=(-2, -1)),            # (6,)
                "b": t * 2,                                 # (6, 4, 8)
                "c": jnp.argmax(t.reshape(6, -1), axis=1),  # (6,) int
                "s": jnp.sum(t)}                            # scalar

    out = jax.jit(step)(jnp.asarray(x))
    got = _fetch_packed(out)
    for k, v in out.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
        assert got[k].dtype == np.asarray(v).dtype
        assert got[k].shape == np.asarray(v).shape


# ---------------------------------------------------------------------------
# reduced-precision host->device transfers (link-bound streaming lever)
# ---------------------------------------------------------------------------
def test_transfer_dtype_f16_bounded_error(rng):
    """transfer_dtype='float16' halves the wire payload; outputs stay within
    the f16 INPUT-rounding bound (~5e-4 relative) of the f32 run — and the
    device still computes in f32 (the result is not bitwise-f16-coarse)."""
    snaps = rng.normal(size=(8, 16, 32)).astype(np.float32)
    f32 = run_batched(jax.jit(_step), snaps, batch=4, log=lambda s: None)
    f16 = run_batched(jax.jit(_step), snaps, batch=4, log=lambda s: None,
                      transfer_dtype=np.float16)
    assert not np.array_equal(f16["mean"], f32["mean"])     # really narrowed
    np.testing.assert_allclose(f16["mean"], f32["mean"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(f16["double"], f32["double"], rtol=2e-3)
    # compute precision unchanged: doubled f16-rounded inputs are exactly
    # representable, so 'double' must equal 2 * round_f16(x) bit-for-bit
    np.testing.assert_array_equal(
        f16["double"], 2.0 * snaps.astype(np.float16).astype(np.float32))


def test_transfer_dtype_bf16(rng):
    import jax.numpy as jnp
    snaps = rng.normal(size=(4, 8, 16)).astype(np.float32)
    out = run_batched(jax.jit(_step), snaps, batch=4, log=lambda s: None,
                      transfer_dtype=jnp.bfloat16)
    np.testing.assert_allclose(out["mean"], snaps.mean(axis=(1, 2)),
                               rtol=0, atol=2e-2)
    assert out["mean"].dtype == np.float32                  # upcast held


def test_transfer_dtype_must_narrow(rng):
    snaps = rng.normal(size=(4, 8, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="not narrower"):
        run_batched(jax.jit(_step), snaps, batch=4, log=lambda s: None,
                    transfer_dtype=np.float32)


def test_transfer_dtype_range_guard(rng):
    """Values outside the wire dtype's range must raise a named error, not
    silently become inf (overflow) or collapse into subnormals where the
    relative rounding is percent-level, not the documented ~5e-4 (f16)."""
    base = rng.normal(size=(4, 8, 16)).astype(np.float32)
    kw = dict(batch=4, log=lambda s: None)
    with pytest.raises(ValueError, match="overflow"):      # |v| > f16 max
        run_batched(jax.jit(_step), base * 1e5, transfer_dtype=np.float16,
                    **kw)
    with pytest.raises(ValueError, match="subnormal"):     # whole chunk tiny
        run_batched(jax.jit(_step), base * 1e-6, transfer_dtype=np.float16,
                    **kw)
    # the same magnitudes are fine on the wider-range bf16 wire
    out = run_batched(jax.jit(_step), base * 1e5,
                      transfer_dtype=jnp.bfloat16, **kw)
    np.testing.assert_allclose(out["mean"], (base * 1e5).mean(axis=(1, 2)),
                               rtol=0, atol=2e-2 * 1e5)
    # legitimate NaN/inf in the input (masks) do not trip the guard
    masked = base.copy()
    masked[:, 0, 0] = np.nan
    masked[:, 1, 1] = np.inf
    run_batched(jax.jit(_step), masked, transfer_dtype=np.float16, **kw)


def test_wire_range_error_is_not_retried_or_skipped(rng):
    """ADVICE r4 #1: a deterministic out-of-range chunk is a CONFIGURATION
    error (mis-scaled variable) — it must abort immediately, not burn the
    retries+backoff schedule, and on_error='skip' must NOT degrade it into
    NaN-filled/failed chunks."""
    from xcontour_tpu.runner import WireRangeError
    base = rng.normal(size=(4, 8, 16)).astype(np.float32) * 1e5
    sleeps = []
    import xcontour_tpu.runner as R
    orig_sleep = R.time.sleep
    R.time.sleep = sleeps.append
    try:
        with pytest.raises(WireRangeError, match="overflow"):
            run_batched(jax.jit(_step), base, batch=4, log=lambda s: None,
                        transfer_dtype=np.float16, retries=3,
                        on_error="skip")
    finally:
        R.time.sleep = orig_sleep
    assert sleeps == [], "config error must not enter the backoff schedule"


def test_wire_upcaster_shared_across_runs():
    """The device-side bitcast+upcast program must be cached at module level:
    a fresh jitted closure per run_batched call would recompile per call —
    and fusing it into the user step recompiles the WHOLE pipeline, measured
    2x slower end-to-end on the link-bound streaming path."""
    from xcontour_tpu.runner import _wire_upcaster
    assert _wire_upcaster("float16", "float32") \
        is _wire_upcaster("float16", "float32")
    up = _wire_upcaster("float16", "float32")
    x = np.array([1.5, -2.25], np.float16).view(np.uint16)
    np.testing.assert_array_equal(np.asarray(up(x)),
                                  np.array([1.5, -2.25], np.float32))


def test_runner_rejects_scalar_outputs(rng):
    """A 0-d step output cannot be tail-trimmed (padded snapshots would
    contaminate it): the runner names the offending key instead of the old
    IndexError-retried-until-failure behavior."""
    snaps = rng.normal(size=(6, 8, 16)).astype(np.float32)
    step = jax.jit(lambda x: {"total": jnp.sum(x)})
    with pytest.raises(ValueError, match="total"):
        run_batched(step, snaps, batch=4, log=lambda s: None)


def test_cli_transfer_flag(tmp_path, rng):
    """--transfer f16 streams through the CLI end-to-end; results track the
    f32 run within the input-rounding bound and a changed --transfer
    invalidates a resume stem (it is a compute-relevant argument)."""
    from xcontour_tpu import cli
    from xcontour_tpu.utils.ncio import load_dataset, save_dataset
    T, Ny, Nx = 4, 16, 24
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 345.0, Nx)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.2 * rng.standard_normal((T, Ny, Nx))).astype(np.float32)
    path = str(tmp_path / "t.nc")
    save_dataset(path, {"q": q}, {"q": ("time", "latitude", "longitude")},
                 coords={"latitude": lat, "longitude": lon,
                         "time": np.arange(T, dtype=np.int32)})
    outs = {}
    for mode in ("f32", "f16"):
        out = str(tmp_path / f"o_{mode}.nc")
        rc = cli.main(["keff", path, "--var", "q", "-N", "11", "--batch",
                       "2", "--transfer", mode, "--out", out])
        assert rc == 0
        outs[mode] = load_dataset(out)
    # Yeq is the robust (monotone-rearrangement) output: tight bound.
    # nkeff's d/dA chain AMPLIFIES input rounding at weak-gradient contours
    # (single elements can move ~20% under f16 inputs), so bound its error
    # DISTRIBUTION — the same trade the docstring warns about.
    ya, yb = outs["f32"]["Yeq"], outs["f16"]["Yeq"]
    np.testing.assert_allclose(yb, ya, rtol=0, atol=1.0)    # degrees
    a, b = outs["f32"]["nkeff"], outs["f16"]["nkeff"]
    fin = np.isfinite(a) & np.isfinite(b)
    assert fin.any() and not np.array_equal(a, b)
    rel = np.abs(b[fin] - a[fin]) / np.maximum(np.abs(a[fin]), 1e-6)
    assert np.median(rel) < 0.02 and rel.max() < 0.5

    stem = str(tmp_path / "ck")
    args = ["keff", path, "--var", "q", "-N", "11", "--batch", "2",
            "--stem", stem, "--out", str(tmp_path / "s1.nc")]
    assert cli.main(args + ["--transfer", "f16"]) == 0
    with pytest.raises(SystemExit, match="different run"):
        cli.main(args + ["--transfer", "bf16"])


def test_load_chunks_detects_index_gap(tmp_path, rng):
    snaps = rng.normal(size=(10, 8, 16))
    stem = str(tmp_path / "gap")
    run_batched(jax.jit(_step), snaps, batch=4, out_stem=stem,
                log=lambda s: None)
    # a deleted middle chunk with no .failed marker must not silently
    # misalign the reassembled time axis
    os.remove(stem + "_ck00001.npz")
    with pytest.raises(RuntimeError, match="gap"):
        load_chunks(stem)
    run_batched(jax.jit(_step), snaps, batch=4, out_stem=stem,
                log=lambda s: None)  # resume regenerates the hole
    out = load_chunks(stem)
    np.testing.assert_allclose(out["mean"], snaps.mean(axis=(1, 2)),
                               rtol=1e-6)
