"""Failure-contract tests for the bench harness (VERDICT r4 #1).

Round 4's driver capture was an uncaught FAILED_PRECONDITION traceback
(rc=1, parsed=null).  The contract under test: (a) ANY mid-run exception
still emits ONE parseable JSON line with value=null and an error field and a
nonzero exit; (b) transient backend faults
are retried with backoff before giving up; (c) the bench/entry grids carry
HOST leaves so no jit trace fetches device constants.
"""

import json
import os
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import bench  # noqa: E402


class _Boom(RuntimeError):
    pass


def test_midrun_fault_emits_parseable_error_line(monkeypatch, capsys):
    """A mid-run backend fault (the exact round-4 failure mode) must still
    produce a parseable one-line JSON artifact and exit nonzero."""
    monkeypatch.setenv("BENCH_RETRIES", "1")

    def boom(*a, **k):
        raise _Boom("FAILED_PRECONDITION: backend error (simulated)")

    monkeypatch.setattr(bench, "headline", boom)
    rc = bench.main(["--quick"])
    assert rc == 1
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE parseable line, got {lines}"
    parsed = json.loads(lines[0])
    assert parsed["value"] is None
    assert parsed["vs_baseline"] is None
    assert "FAILED_PRECONDITION" in parsed["error"]
    assert parsed["metric"] == bench.METRIC


def test_nonbackend_fault_also_emits_line(monkeypatch, capsys):
    """The contract covers ANY exception, not just backend faults."""
    monkeypatch.setattr(bench, "_load", lambda: (_ for _ in ()).throw(
        ValueError("corrupt fixture (simulated)")))
    rc = bench.main(["--quick"])
    assert rc == 1
    parsed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert parsed["value"] is None and "corrupt fixture" in parsed["error"]


def test_retry_heals_transient_fault(monkeypatch):
    """UNAVAILABLE/FAILED_PRECONDITION faults retry with geometric backoff
    and succeed when the backend heals."""
    sleeps = []
    monkeypatch.setattr(bench.time, "sleep", sleeps.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise _Boom("UNAVAILABLE: Socket closed (simulated outage)")
        return 42

    assert bench._retry("test", flaky, attempts=3, backoff_s=7.0) == 42
    assert calls["n"] == 3
    assert sleeps == [7.0, 14.0]          # geometric backoff


def test_retry_does_not_mask_nontransient(monkeypatch):
    """Deterministic errors must propagate immediately — retrying a
    configuration error just burns the schedule."""
    monkeypatch.setattr(bench.time, "sleep",
                        lambda s: pytest.fail("slept on a non-transient"))
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("bad config (simulated)")

    with pytest.raises(ValueError, match="bad config"):
        bench._retry("test", broken, attempts=3)
    assert calls["n"] == 1


def test_retry_exhausts_then_raises(monkeypatch):
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    calls = {"n": 0}

    def down():
        calls["n"] += 1
        raise _Boom("DEADLINE_EXCEEDED (simulated)")

    with pytest.raises(_Boom):
        bench._retry("test", down, attempts=3)
    assert calls["n"] == 3


def test_device_time_guards_slope_inversion(monkeypatch):
    """A congested window can make the long pass FASTER than the short one;
    the slope then goes <= 0 and the old 1e-9 clamp reported absurd rates
    (a committed '4e9 snap/s' table-reuse entry).  The amortized per-call
    time of the long pass is the conservative fallback/cap."""
    import jax.numpy as jnp
    x0 = jnp.ones((4,))
    # perf_counter sequence: warm(run(1)): 0,1; t1(run(2)): 0,10; t2(run(8)): 0,5
    ticks = iter([0.0, 1.0, 0.0, 10.0, 0.0, 5.0])
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))
    per = bench.device_time(lambda x: x + 1.0, x0, reps=6, r1=2)
    assert per == 5.0 / 8.0                     # amortized, not 1e-9

    # positive but contaminated slope (> amortized) is capped at amortized
    ticks = iter([0.0, 1.0, 0.0, 1.0, 0.0, 40.0])
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))
    per = bench.device_time(lambda x: x + 1.0, x0, reps=6, r1=2)
    assert per == 40.0 / 8.0                    # slope 6.5 capped at 5.0


def test_device_time_passes_min_raw_timings(monkeypatch):
    """passes>1 takes the min of EACH raw timing separately before the
    slope (the _kernel_time_best rule).  A window that relaxes between T1
    and T2 leaves a tiny POSITIVE slope the inversion guard cannot catch —
    the source of a 113x-inflated per-level-keff entry in one congested
    run; min-over-passes recovers the quiet-window slope."""
    import jax.numpy as jnp
    x0 = jnp.ones((4,))
    # warm: (0,1); t1 over 3 passes: 10, 4, 6 -> min 4;
    # t2 over 3 passes: 20, 12, 16 -> min 12
    ticks = iter([0.0, 1.0, 0.0, 10.0, 0.0, 4.0, 0.0, 6.0,
                  0.0, 20.0, 0.0, 12.0, 0.0, 16.0])
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))
    per = bench.device_time(lambda x: x + 1.0, x0, reps=6, r1=2, passes=3)
    assert per == (12.0 - 4.0) / 6.0            # slope of the min timings


def _stub_run_sections(monkeypatch, tmp_path, dense_calls):
    """Stub every measured section so _run's orchestration (mode gating,
    artifact writing) can run hermetically — artifacts land in tmp_path."""
    monkeypatch.setattr(bench, "__file__", str(tmp_path / "bench.py"))
    monkeypatch.setattr(bench, "_init_devices", lambda *a, **k: None)
    monkeypatch.setattr(bench, "_load", lambda: (
        np.linspace(-80, 80, 4), np.linspace(0, 315, 4), np.zeros((4, 4))))

    def fake_headline(lat, lon, vor, batch=32, **kw):
        dense_calls.append(kw.get("lwa_method", "default"))
        return 100.0
    monkeypatch.setattr(bench, "headline", fake_headline)
    monkeypatch.setattr(bench, "adjoint_section",
                        lambda *a, **k: {"grad_sps": 1.0})
    monkeypatch.setattr(bench, "lwa_tall", lambda: {
        "ny": 1, "fast_ms": 1.0, "lin_ms": 1.0, "auto_resolves_to": "fast",
        "fast_wins": True, "crossover_ny": 1})
    monkeypatch.setattr(bench, "workload_matrix", lambda *a, **k: {
        "era5_keff_lwa_sps": 1.0, "year_pv_s": 1.0})
    monkeypatch.setattr(bench, "out_of_core_section", lambda: {})
    monkeypatch.setattr(bench, "cpu_oracle_sps", lambda *a, **k: 2.0)
    monkeypatch.setattr(bench, "cpu_numpy_fast_sps", lambda *a, **k: 10.0)


def test_quick_mode_skips_dense_headline(monkeypatch, capsys, tmp_path):
    """--quick must not pay the dense-path compile (its <3 min re-run
    contract); the compact line then simply omits headline_dense_sps."""
    dense_calls = []
    _stub_run_sections(monkeypatch, tmp_path, dense_calls)
    assert bench.main(["--quick"]) is None
    parsed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert dense_calls == ["default"]
    assert "headline_dense_sps" not in parsed
    hist = (tmp_path / "BENCH_HISTORY.jsonl").read_text().splitlines()
    assert "headline_dense_sps" not in json.loads(hist[-1])


def test_full_mode_pins_dense_headline(monkeypatch, capsys, tmp_path):
    dense_calls = []
    _stub_run_sections(monkeypatch, tmp_path, dense_calls)
    assert bench.main([]) is None
    parsed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert dense_calls == ["default", "dense"]
    assert parsed["headline_dense_sps"] == 100.0
    hist = (tmp_path / "BENCH_HISTORY.jsonl").read_text().splitlines()
    assert json.loads(hist[-1])["headline_dense_sps"] == 100.0


def test_bench_grid_leaves_are_host_arrays():
    """The grids every jitted bench step closes over must have numpy leaves:
    device-resident leaves are fetched device->host at TRACE time."""
    import jax
    lat = np.linspace(-80, 80, 9)
    lon = np.linspace(0, 315, 8)
    g = bench.host_latlon_grid(lat, lon)
    leaves = jax.tree_util.tree_leaves(g)
    assert leaves, "grid pytree has no leaves?"
    for leaf in leaves:
        assert isinstance(leaf, np.ndarray), type(leaf)


def test_entry_grid_leaves_are_host_arrays():
    import jax
    import __graft_entry__ as ge
    import jax.numpy as jnp
    grid, vor = ge._load_case(jnp.float32)
    for leaf in jax.tree_util.tree_leaves(grid):
        assert isinstance(leaf, np.ndarray), type(leaf)
    # and the forward step still compiles and runs on these host constants
    fn, args = ge.entry()
    nk, lwa = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(nk)).any()
