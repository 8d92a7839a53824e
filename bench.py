#!/usr/bin/env python
"""Benchmark suite: headline throughput, the adjoint, the full
workload matrix, and an out-of-core streaming run — one JSON line out.

Headline (BASELINE.json north star): the combined effective-diffusivity +
local-wave-activity chain on 256x512 global vorticity snapshots, N=121
contours (the bundled Data/barotropic_vorticity.nc; reference
tests/test_LWA.py:26).

Timing methodology: ``device_time`` chains each call through a data
dependency, forces completion with a scalar fetch, and takes the slope
between two rep counts so fixed per-call overheads cancel.

Baselines: the float64 reference-semantics NumPy oracle (compat.py) and a
tougher hand-vectorized float32 NumPy chain, both timed per snapshot on this
host.  The reference's literal stack (xarray + dask + xhistogram) is not
installable in this image; those layers only add interpreter/graph overhead
on top of the same NumPy kernels, so both baselines are conservative.

Prints ONE compact (< 1.5 kB) JSON line — headline first — and writes the
full detail tree (op-model formulas, measured ceilings, workload matrix,
out-of-core run, methodology) to BENCH_DETAILS.json.  ``--quick`` /
BENCH_QUICK=1 skips the tall-grid ladder, workload matrix and out-of-core
sections (< 3 min); those sections of an existing BENCH_DETAILS.json are
carried over (and marked), never nulled out.
"""

import json
import os
import sys
import time

import numpy as np

D2R = np.pi / 180.0
REARTH = 6371200.0
METRIC = "keff+lwa snapshots/sec (256x512 global grid, N=121, f32)"


# ---- pinned CPU-baseline denominators (quiet-window medians; see
# BASELINE.md "Pinned denominators") ------------------------------------------
# The live oracle reading swings ~3x with host load (BENCH_HISTORY.jsonl:
# 0.88..2.86 sps across one day), so cross-round speedup claims carry BOTH the
# live ratio and this pinned one.  Re-pin with tools/pin_baseline.py on a
# quiet host.
# 2026-08-19, load 0.05, 5 passes (tools/pin_baseline.py):
# oracle 2.223/2.284/2.330/2.375/2.409; fast 8.68/10.21/10.28/10.32/11.44
PINNED_ORACLE_SPS = 2.33
PINNED_NUMPY_FAST_SPS = 10.28


# ---------------------------------------------------------------------------
# fault handling: transient FAILED_PRECONDITION/UNAVAILABLE backend faults
# are retried with backoff before the run gives up.
# ---------------------------------------------------------------------------
_TRANSIENT_MARKERS = ("UNAVAILABLE", "FAILED_PRECONDITION",
                      "DEADLINE_EXCEEDED", "ABORTED", "INTERNAL",
                      "Socket closed", "connection reset", "GOAWAY")


def _is_transient(exc: BaseException) -> bool:
    return any(m in repr(exc) for m in _TRANSIENT_MARKERS)


def _retry(section, fn, attempts=3, backoff_s=20.0):
    """Bounded retry on transient backend faults, geometric backoff.
    Non-transient errors propagate immediately (main() still emits the
    parseable error line)."""
    attempts = max(1, int(os.environ.get("BENCH_RETRIES", attempts)))
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classify, retry or re-raise
            if i == attempts - 1 or not _is_transient(e):
                raise
            wait = backoff_s * (2 ** i)
            print(f"# bench: transient backend fault in {section} "
                  f"(attempt {i + 1}/{attempts}): {repr(e)[:200]}; "
                  f"retrying in {wait:.0f}s", file=sys.stderr)
            time.sleep(wait)


def host_latlon_grid(lat, lon):
    """Grid with HOST (numpy) leaves, built on the CPU backend.

    Every jitted bench step *closes over* its grid, so the leaves embed as
    trace-time constants; device-resident leaves make XLA's constant handler
    fetch each one device->host during lowering.  Host leaves embed with
    zero device traffic."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu import grid as G
    with jax.default_device(jax.devices("cpu")[0]):
        g = G.from_latlon(lat, lon, dtype=jnp.float32)
    return G.to_host(g)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def device_time(step, x0, reps=20, r1=2, passes=1):
    """Median-free slope timing: run r1 and r1+reps dependency-chained calls,
    each ending in a scalar fetch; per-call = (T2 - T1) / reps.

    ``step`` must map its input to a same-structured output (chaining) and is
    expected to fold the *computation's result* into what it returns, so no
    call can be elided or overlapped past the fetch.

    ``passes`` > 1 repeats BOTH raw timings and takes the min of each
    SEPARATELY before the slope (the _kernel_time_best rule): contention on
    this shared chip only ever ADDS time, so each min approaches the quiet
    truth.  A single pass is exposed to window-relaxation inflation — the
    chip speeding up between T1 and T2 leaves a tiny POSITIVE slope that the
    slope<=0 guard cannot catch (observed: a 113x-inflated per-level-keff
    entry and a 17x fractal entry in one congested-window run).
    """
    import jax
    import jax.numpy as jnp

    def run(n):
        o = x0
        t0 = time.perf_counter()
        for _ in range(n):
            o = step(o)
        float(jnp.sum(o.ravel()[:8]))     # tiny fetch forces the whole chain
        return time.perf_counter() - t0

    run(1)                                 # compile + warm
    t1 = min(run(r1) for _ in range(passes))
    t2 = min(run(r1 + reps) for _ in range(passes))
    # congested-window guard (same rule as _kernel_time): the shared chip
    # can speed up between the two passes, driving the slope to <= 0 — the
    # old 1e-9 clamp then reported absurd rates (observed: a "4e9 snap/s"
    # table-reuse entry).  The long pass's amortized per-call time still
    # contains the fixed ~30 ms round-trip, so it is always a valid upper
    # bound on per-call time; clamping to it can only UNDER-claim.
    ub = t2 / (r1 + reps)
    slope = (t2 - t1) / reps
    return ub if slope <= 0 else min(slope, ub)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _load():
    from xcontour_tpu.utils import synth
    v, _ = synth.synth_barotropic_vorticity()
    return (np.asarray(v["latitude"], np.float64),
            np.asarray(v["longitude"], np.float64),
            np.asarray(v["absolute_vorticity"], np.float64))


# ---------------------------------------------------------------------------
# CPU baselines
# ---------------------------------------------------------------------------
def cpu_oracle_sps(lat, lon, vor, n_snap=10, N=121):
    """Reference-semantics float64 NumPy chain (compat.py), per-snapshot
    Python loop — the reference's execution model."""
    from xcontour_tpu import compat

    grid = host_latlon_grid(lat, lon)   # host leaves: no device fetches
    dA = np.asarray(grid.dA, np.float64)
    dxF = np.asarray(grid.dxF, np.float64)
    mask = np.ones_like(vor)
    pre_y = lat

    def one(tr):
        grdS = compat.squared_gradient(tr, lat, lon)
        out = compat.keff_snapshot(tr, grdS, lat, dA, dxF, mask, pre_y, N=N,
                                   increase=True, lt=True, hist=True,
                                   lmin="analytic")
        Q = compat.interp_to_coords(lat, out["origin"]["Yeq"],
                                    out["origin"]["contour"])
        compat.local_wave_activity(tr, Q, dA, lat, increase=True)

    one(vor)                                # warm caches
    t0 = time.perf_counter()
    for i in range(n_snap):
        one(vor * (1.0 + 1e-6 * (i + 1)))
    return n_snap / (time.perf_counter() - t0)


def cpu_numpy_fast_sps(lat, lon, vor, n_snap=10, N=121):
    """Tougher baseline: hand-vectorized float32 NumPy Keff+LWA — same
    algorithmic content as the pipeline (gradient, two weighted CDFs, table
    lookup, area derivatives, sorted profile, O(Ny^2 Nx) LWA), none of the
    oracle's generality."""
    n_snap = max(n_snap, 30)   # fast chain: time longer to keep run-to-run
    # variance under 10%
    lat32 = lat.astype(np.float32)
    Ny, Nx = vor.shape
    dy = (np.gradient(lat) * D2R * REARTH).astype(np.float32)
    dx = (np.cos(lat * D2R)[:, None]
          * (np.gradient(lon) * D2R * REARTH)[None, :]).astype(np.float32)
    latE = np.concatenate([[lat[0] - (lat[1] - lat[0]) / 2],
                           (lat[:-1] + lat[1:]) / 2,
                           [lat[-1] + (lat[-1] - lat[-2]) / 2]])
    latE = np.clip(latE, -90, 90)
    dlam = float(np.mean(np.gradient(lon)))
    dA = (REARTH ** 2 * np.abs(np.diff(np.sin(latE * D2R)))[:, None]
          * np.full((1, Nx), dlam * D2R)).astype(np.float32)
    areaY = np.cumsum(dA.sum(axis=1)).astype(np.float32)  # A(y<=y_k), lt=True

    def one(q):
        q = q.astype(np.float32)
        qx = (np.roll(q, -1, 1) - np.roll(q, 1, 1)) * 0.5 / dx
        qy = np.empty_like(q)
        qy[1:-1] = (q[2:] - q[:-2]) * 0.5
        qy[0] = q[1] - q[0]
        qy[-1] = q[-1] - q[-2]
        qy /= dy[:, None]
        grdS = qx * qx + qy * qy
        ctr = np.linspace(q.min(), q.max(), N, dtype=np.float32)
        edges = np.concatenate([[ctr[0] - (ctr[1] - ctr[0])], ctr])
        qf = q.ravel()
        h_a, _ = np.histogram(qf, bins=edges, weights=dA.ravel())
        h_g, _ = np.histogram(qf, bins=edges, weights=(grdS * dA).ravel())
        intArea = np.cumsum(h_a).astype(np.float32)
        intgrdS = np.cumsum(h_g).astype(np.float32)
        Yeq = np.interp(intArea, areaY, lat32)
        dgrdSdA = np.gradient(intgrdS) / np.gradient(intArea)
        dqdA = np.gradient(ctr) / np.gradient(intArea)
        Leq2 = dgrdSdA / (dqdA * dqdA)
        Lmin = 2 * np.pi * REARTH * np.cos(Yeq * D2R)
        nkeff = Leq2 / (Lmin * Lmin)
        Q = np.interp(lat32, Yeq, ctr).astype(np.float32)
        wei = (dA / dA.max() * dA).astype(np.float32)
        lwa = np.empty_like(q)
        for j in range(Ny):                  # O(Ny^2 Nx), vectorized inner
            qe = q - Q[j]
            m = np.zeros_like(q)
            sel = np.arange(Ny)[:, None] >= j
            m[sel & (qe < 0)] = 1.0
            m[~sel & (qe > 0)] = -1.0
            lwa[j] = -(qe * m * wei).sum(axis=0)
        return nkeff, lwa

    one(vor)
    t0 = time.perf_counter()
    for i in range(n_snap):
        one(vor * (1.0 + 1e-6 * (i + 1)))
    return n_snap / (time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# device sections
# ---------------------------------------------------------------------------
def headline(lat, lon, vor, batch=32, N=121, lwa_method="auto"):
    import jax
    import jax.numpy as jnp
    from xcontour_tpu.pipeline import keff_lwa_pipeline

    # host-leaf grid: the jitted step closes over it, and numpy constants
    # embed with no trace-time device->host fetch (VERDICT r4 #1c)
    grid = host_latlon_grid(lat, lon)
    rng = np.random.default_rng(0)
    snaps = vor[None] * (1.0 + 1e-4 * rng.standard_normal((batch, 1, 1)))
    tr = jnp.asarray(snaps, jnp.float32)

    @jax.jit
    def step(t):
        out = keff_lwa_pipeline(t, grid, N=N, increase=True, lt=True,
                                lmin="analytic", lwa_method=lwa_method)
        # fold the full result set back into the next input: nothing can be
        # dead-code-eliminated or deferred past the fetch
        dep = (out["lwa"] + out["nkeff"][..., 0, None, None]
               + out["Yeq"][..., 0, None, None])
        return t + 1e-30 * dep

    # median of three slope measurements: run-to-run variance on this shared
    # chip is ~10% and the headline should not ride an outlier
    per = float(np.median([device_time(step, tr, reps=16) for _ in range(3)]))
    sps = batch / per

    # output sanity on a real (unchained) call
    out = keff_lwa_pipeline(tr, grid, N=N, increase=True, lt=True,
                            lmin="analytic", lwa_method=lwa_method)
    nk = np.asarray(out["nkeff"])
    assert np.isfinite(nk).sum() > nk.size * 0.5, "benchmark output degenerate"
    return sps


def adjoint_section(lat, lon, vor, batch=32, N=121, era5=False):
    """Gradient-step throughput of the combined diagnostic: one
    jit(grad(nansum(LWA^2) + nansum(nkeff))) per batch — the adjoint
    capability the reference stack cannot express, measured at the headline
    workload shape.  The LWA kernel's custom VJP routes the backward
    through the XLA lin form."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu.pipeline import keff_lwa_pipeline

    grid = host_latlon_grid(lat, lon)
    rng = np.random.default_rng(0)
    snaps = vor[None] * (1.0 + 1e-4 * rng.standard_normal((batch, 1, 1)))
    tr = jnp.asarray(snaps, jnp.float32)

    def loss(t):
        out = keff_lwa_pipeline(t, grid, N=N, increase=True, lt=True,
                                lmin="analytic")
        return jnp.nansum(out["lwa"] * out["lwa"]) + jnp.nansum(out["nkeff"])

    @jax.jit
    def gstep(t):
        g = jax.grad(loss)(t)
        return t + 1e-30 * g

    g = np.asarray(jax.grad(loss)(tr))
    finite = float(np.isfinite(g).mean())
    per = float(np.median([device_time(gstep, tr, reps=8) for _ in range(3)]))
    out = {"grad_sps": round(batch / per, 1),
           "grad_finite_fraction": finite,
           "loss": "nansum(LWA^2) + nansum(nkeff), 256x512 N=121 f32",
           "note": "full forward+backward per step"}
    if era5:
        Ny, Nx, B2, N2 = 721, 1440, 4, 241
        lat2 = np.linspace(-90, 90, Ny)
        lon2 = np.linspace(0, 360 - 360 / Nx, Nx)
        grid2 = host_latlon_grid(lat2, lon2)
        base = (np.sin(np.deg2rad(lat2))[:, None]
                + 0.2 * np.cos(4 * np.deg2rad(lon2))[None, :]
                * np.cos(np.deg2rad(lat2))[:, None])
        tr2 = jnp.asarray(base[None] * (1 + 1e-3 * rng.standard_normal(
            (B2, 1, 1))), jnp.float32)

        def loss2(t):
            o = keff_lwa_pipeline(t, grid2, N=N2, lmin="analytic")
            return jnp.nansum(o["lwa"] * o["lwa"]) + jnp.nansum(o["nkeff"])

        @jax.jit
        def gstep2(t):
            return t + 1e-30 * jax.grad(loss2)(t)

        per2 = float(np.median([device_time(gstep2, tr2, reps=4)
                                for _ in range(2)]))
        out["era5_grad_sps"] = round(B2 / per2, 1)
        out["era5_shape"] = "721x1440 N=241 f32"
    return out


def _kernel_time(kernel_of_x, x0, inner_lo=2, inner_hi=10, reps=8):
    """Per-invocation kernel time with BOTH overheads cancelled: the outer
    slope (device_time) removes the per-call round trip, and an inner slope —
    the same kernel chained inner_lo vs inner_hi times inside one jitted
    program — removes the per-launch dispatch cost.  Chaining (x depends on
    the previous kernel's output) makes in-trace CSE impossible."""
    import jax

    def make(inner):
        @jax.jit
        def step(x):
            for _ in range(inner):
                x = x + 1e-30 * kernel_of_x(x)
            return x
        return step

    t_hi = device_time(make(inner_hi), x0, reps=reps)
    t_lo = device_time(make(inner_lo), x0, reps=reps)
    # same garbled-slope guard as _kernel_time_best: a congested window can
    # measure t_hi <= t_lo, and the raw slope then reports 0.0 ms for a real
    # workload (observed: clength/local_length in the 11:34 run).  The
    # amortized per-iteration time of the long chain is always a valid
    # upper bound, and clamping to it can only UNDER-claim.
    ub = t_hi / inner_hi
    slope = (t_hi - t_lo) / (inner_hi - inner_lo)
    return ub if slope <= 0 else min(slope, ub)


def _kernel_time_best(kernel_of_x, x0, passes=3, inner_lo=2, inner_hi=10,
                      reps=8):
    """Contention-robust kernel time.  Contention on this shared chip only
    ever ADDS time, so min-over-passes is the honest estimate — but it must
    be taken on the two RAW chain timings separately, not on their
    difference (a noisy pass can measure t_hi < t_lo, and min() over such
    differences latches onto the garbage).  Measured swing between windows
    is ~2x; a single pass can land a roofline claim on an outlier."""
    import jax

    def make(inner):
        @jax.jit
        def step(x):
            for _ in range(inner):
                x = x + 1e-30 * kernel_of_x(x)
            return x
        return step

    hi, lo = make(inner_hi), make(inner_lo)
    t_hi = min(device_time(hi, x0, reps=reps) for _ in range(passes))
    t_lo = min(device_time(lo, x0, reps=reps) for _ in range(passes))
    # t_hi/inner_hi = per-iteration time INCLUDING the amortized dispatch
    # cost, so it is always a valid upper bound on the true kernel time.
    # Clamping to it keeps a congestion-garbled slope (observed: negative,
    # or near-zero — which then inflates the self-calibrating ceiling and
    # zeroes every other kernel's roofline pct) from ever being reported;
    # the clamp can only UNDER-claim performance.
    ub = t_hi / inner_hi
    slope = (t_hi - t_lo) / (inner_hi - inner_lo)
    return ub if slope <= 0 else min(slope, ub)


def lwa_tall(batch=4, Ny=8192, Nx=512, N=121):
    """Tall-grid LWA: hardware evidence for the 'fast' (sort-merge) path
    auto-crossover at Ny >= _FAST_NY_CROSSOVER (diagnostics/lwa.py).  Returns
    per-method times and the auto-resolved pick."""
    import jax.numpy as jnp
    from xcontour_tpu.diagnostics.lwa import (local_wave_activity,
                                              _resolve_method,
                                              _FAST_NY_CROSSOVER)

    rng = np.random.default_rng(3)
    ydef = np.linspace(-89.9, 89.9, Ny)
    base = 2e-4 * np.sin(np.deg2rad(ydef))[:, None]
    qn = (base[None] * (1 + 1e-3 * rng.standard_normal((batch, 1, 1)))
          + 2e-6 * rng.standard_normal((batch, Ny, Nx))).astype(np.float32)
    q = jnp.asarray(qn)
    # closure constants stay numpy (host) — no trace-time device fetches
    dA = (np.cos(np.deg2rad(ydef))[:, None]
          * np.ones((1, Nx)) * 1e8).astype(np.float32)
    Q = np.sort(np.mean(qn, -1), -1)
    yd = ydef.astype(np.float32)

    res = {"ny": Ny, "auto_resolves_to": _resolve_method("auto", "all", Ny),
           "crossover_ny": _FAST_NY_CROSSOVER}
    for m in ("fast", "lin"):
        def step(x, m=m):
            o = local_wave_activity(x, Q, dA, yd, increase=True, method=m)
            return x + 1e-30 * o
        t = _kernel_time(step, q, inner_lo=1, inner_hi=5, reps=4)
        res[f"{m}_ms"] = round(t * 1e3, 2)
    res["fast_wins"] = bool(res["fast_ms"] < res["lin_ms"])
    return res


def workload_matrix(lat, lon, vor):
    import jax
    import jax.numpy as jnp
    from xcontour_tpu.pipeline import (keff_lwa_pipeline, clength_pipeline,
                                       fractal_pipeline)
    from xcontour_tpu.diagnostics.local_length import local_contour_lengths

    out = {}
    grid = host_latlon_grid(lat, lon)
    rng = np.random.default_rng(1)

    # ERA5-scale 0.25-degree grid (exercises the X-panel-blocked LWA kernel)
    NyE, NxE = 721, 1440
    latE = np.linspace(-90, 90, NyE)
    lonE = np.arange(0, 360, 0.25)
    gridE = host_latlon_grid(latE, lonE)
    base = (2e-4 * np.sin(np.deg2rad(latE))[:, None]
            + 4e-5 * np.sin(5 * np.deg2rad(lonE))[None, :])
    BE = 4
    trE = jnp.asarray(base[None] * (1 + 1e-3 * rng.standard_normal((BE, 1, 1)))
                      + 2e-6 * rng.standard_normal((BE, NyE, NxE)), jnp.float32)

    @jax.jit
    def stepE(t):
        o = keff_lwa_pipeline(t, gridE, N=241, increase=True, lt=True,
                              lmin="analytic")
        return t + 1e-30 * (o["lwa"] + o["nkeff"][..., 0, None, None])
    per = device_time(stepE, trE, reps=6, passes=3)
    out["era5_keff_lwa_sps"] = round(BE / per, 1)

    # production-loop variant: the A(Y_eq) table is tracer-independent, so
    # real archive sweeps build it once and pass it in (same convention as
    # the reference drivers, which construct the grid/metrics once)
    from xcontour_tpu import core as _core
    maskE = np.ones(gridE.shape, np.float32)
    tableE = _core.cal_area_eqCoord_table_hist(
        maskE, np.asarray(gridE.ydef, np.float32),
        np.asarray(gridE.dA, np.float32), increase=True, lt=True)
    # stepE2 closes over the table: pull its leaves to host ONCE here (a
    # bounded setup fetch under _retry) so lowering embeds numpy constants
    tableE = jax.tree_util.tree_map(np.asarray, tableE)

    @jax.jit
    def stepE2(t):
        o = keff_lwa_pipeline(t, gridE, N=241, increase=True, lt=True,
                              lmin="analytic", table=tableE)
        return t + 1e-30 * (o["lwa"] + o["nkeff"][..., 0, None, None])
    per = device_time(stepE2, trE, reps=6, passes=3)
    out["era5_keff_lwa_table_reuse_sps"] = round(BE / per, 1)

    # year of daily PV end-to-end through the batch runner (incl. host IO)
    from xcontour_tpu.runner import run_batched
    year = (vor[None] * (1 + 1e-3 * rng.standard_normal((365, 1, 1)))
            ).astype(np.float32)

    def stepY(t):
        o = keff_lwa_pipeline(t, grid, N=121, increase=True, lt=True,
                              lmin="analytic")
        return {"nkeff": o["nkeff"], "Yeq": o["Yeq"]}
    jstep = jax.jit(stepY)
    r = run_batched(jstep, year[:32], batch=32, log=lambda s: None)  # warm
    t0 = time.perf_counter()
    r = run_batched(jstep, year, batch=32, log=lambda s: None)
    dt = time.perf_counter() - t0
    assert r["nkeff"].shape == (365, 121)
    out["year_pv_s"] = round(dt, 2)
    out["year_pv_sps"] = round(365 / dt, 1)

    # isentropic Keff with PER-LEVEL contour bins (the 3-D atmosphere config,
    # reference notebooks/1.Keff_atmos.ipynb cells 0-4) — the case the
    # reference's xhistogram engine cannot bin per level (core.py:1259-1294)
    # and must route through the memory-hungry broadcast path; here the bins
    # are a vmapped batch axis
    pv, latP = workload_pv_fixture()
    gridP = host_latlon_grid(latP, np.arange(0, 360, 360 / pv.shape[-1]))
    trP = jnp.asarray(pv, jnp.float32)

    def depP(t):
        o = keff_lwa_pipeline(t, gridP, N=121, increase=True, lt=True,
                              lmin="analytic")
        # the dependency must consume EVERY output family or XLA dead-code
        # eliminates the stage (an lwa-free dep once measured 37k "snap/s")
        return (o["lwa"] + o["nkeff"].sum(-1)[:, None, None]
                + o["Yeq"].sum(-1)[:, None, None])
    per = _kernel_time_best(depP, trP, inner_lo=1, inner_hi=5, reps=6)
    out["keff_atmos_3d_perlevel_sps"] = round(pv.shape[0] / per, 1)

    # contour lengths at the two reference contour counts.  These are
    # sub-millisecond per call, so min-over-passes chained timing with long
    # chains (inner_hi=10) and reps=40 puts the work signal above the host
    # jitter.
    B = 8
    tr = jnp.asarray(vor[None] * (1 + 1e-4 * rng.standard_normal((B, 1, 1))),
                     jnp.float32)
    for n in (121, 401):
        # _kernel_time wraps as x + 1e-30*fn(x): return the raw dependency
        # term (pre-scaled deps would underflow to 1e-60 and break chaining)
        def depC(t, n=n):
            o = clength_pipeline(t, grid, N=n, increase=True, lt=True)
            return (o["lengths"].sum(-1)[:, None, None]
                    + o["cmGrd"].sum(-1)[:, None, None]
                    + o["Leq2"].sum(-1)[:, None, None])
        per = _kernel_time_best(depC, tr, inner_lo=2, inner_hi=10, reps=40)
        out[f"clength_N{n}_ms_per_snap"] = round(per / B * 1e3, 3)

    # fractal ladder, strides 1..32 with box counting
    BF = 8

    def depF(t):
        o = fractal_pipeline(t, grid, N=121, strides=(1, 2, 4, 8, 16, 32),
                             increase=True, lt=True)
        return (o["D"].sum(-1)[:, None, None]
                + o["bclens"].sum((-2, -1))[:, None, None])
    per = _kernel_time_best(depF, tr[:BF], inner_lo=2, inner_hi=10, reps=40)
    out["fractal_s1to32_ms_per_snap"] = round(per / BF * 1e3, 3)

    # local (windowed) lengths, the reference's 101-window/stride-10 config
    v32 = jnp.asarray(vor, jnp.float32)

    def depL(t):
        L, oy, ox = local_contour_lengths(t, grid.ydef, grid.xdef,
                                          window=101, stride=10, latlon=True)
        return jnp.nansum(L)
    per = _kernel_time_best(depL, v32, inner_lo=2, inner_hi=10, reps=24)
    out["local_length_w101_s10_ms_per_snap"] = round(per * 1e3, 3)
    return out


def workload_pv_fixture(nlev=16, nlat=256, nlon=512):
    """Synthesized isentropic-PV stack (level, lat, lon) — the schema of the
    reference's missing Data/PV.nc blob (SURVEY.md §2.3)."""
    from xcontour_tpu.utils import synth
    variables, _ = synth.synth_pv(nlev=nlev, nlat=nlat, nlon=nlon)
    return (np.asarray(variables["pv"], np.float32),
            np.asarray(variables["latitude"], np.float64))


class _LazyEra5Archive:
    """Procedural ERA5-scale snapshot archive: (T, 721, 1440) f32, generated
    chunk-by-chunk so neither host RAM nor device HBM ever holds it."""

    def __init__(self, T, base, seed=7):
        self.shape = (T,) + base.shape
        self._base = base.astype(np.float32)
        self._seed = seed

    def __getitem__(self, sl):
        idx = np.arange(*sl.indices(self.shape[0]))
        rng = np.random.default_rng(self._seed)
        coef = (1.0 + 1e-3 * np.sin(0.1 * idx)).astype(np.float32)
        chunk = self._base[None] * coef[:, None, None]
        chunk += 2e-6 * rng.standard_normal(self._base.shape).astype(np.float32)
        return chunk


def out_of_core(n_snap=4224):
    """Stream an archive through run_batched: 4224 x 721 x 1440 f32 =
    16.3 GiB of input, chunked host->device with overlapped transfers,
    small per-chunk outputs fetched (the dask out-of-core role, reference
    core.py:685, tests/test_dask.py).  The default bench run streams a
    sample (BENCH_OOC_SNAPS, default 320 snapshots)."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu.pipeline import keff_lwa_pipeline
    from xcontour_tpu.runner import run_batched

    NyE, NxE = 721, 1440
    latE = np.linspace(-90, 90, NyE)
    lonE = np.arange(0, 360, 0.25)
    gridE = host_latlon_grid(latE, lonE)
    base = (2e-4 * np.sin(np.deg2rad(latE))[:, None]
            + 4e-5 * np.sin(5 * np.deg2rad(lonE))[None, :]).astype(np.float32)
    arch = _LazyEra5Archive(n_snap, base)
    gib = n_snap * NyE * NxE * 4 / 2 ** 30

    def step(t):
        o = keff_lwa_pipeline(t, gridE, N=121, increase=True, lt=True,
                              lmin="analytic")
        return {"nkeff": o["nkeff"], "Yeq": o["Yeq"],
                "lwa_zm": jnp.nanmean(o["lwa"], axis=-1)}
    jstep = jax.jit(step)
    run_batched(jstep, _LazyEra5Archive(64, base), batch=32,
                log=lambda s: None)                       # warm compile
    t0 = time.perf_counter()
    out = run_batched(jstep, arch, batch=32, log=lambda s: None)
    dt = time.perf_counter() - t0
    assert out["nkeff"].shape == (n_snap, 121)
    assert np.isfinite(out["nkeff"][:: n_snap // 7]).any()

    # device-compute-only rate for the SAME step at the same shape: the gap
    # between this and the streaming sps is pure wire/IO — the number that
    # tells a multi-host deployment (local host DRAM) what to expect
    resident = jnp.asarray(_LazyEra5Archive(32, base)[0:32], jnp.float32)

    def dep(t):
        o = step(t)
        return t + 1e-30 * (o["lwa_zm"].sum(-1)[:, None, None]
                            + o["nkeff"].sum(-1)[:, None, None]
                            + o["Yeq"].sum(-1)[:, None, None])
    # jit the whole chained step: the unjitted form dispatches ~10 eager
    # glue ops per rep — per-call overhead the slope cannot cancel
    per = device_time(jax.jit(dep), resident, reps=6, passes=3)
    device_compute_sps = 32 / per

    # halve the wire format (runner transfer_dtype), in interleaved short
    # f32/f16 rounds: each round pairs the formats back to back, and the
    # pooled ratio cancels drift in the link's rate.  3 chunks per round:
    # single-chunk rounds measure only fixed costs (no transfer/compute
    # overlap)
    n16 = min(96, n_snap)
    rounds, t32s, t16s = 2, [], []
    o16 = None
    for _ in range(rounds):
        t0 = time.perf_counter()
        _ = run_batched(jstep, _LazyEra5Archive(n16, base), batch=32,
                        log=lambda s: None)
        t32s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        o16 = run_batched(jstep, _LazyEra5Archive(n16, base), batch=32,
                          log=lambda s: None, transfer_dtype=np.float16)
        t16s.append(time.perf_counter() - t0)
    dt16 = sum(t16s)
    ya, yb = out["Yeq"][:n16], o16["Yeq"]
    fin = np.isfinite(ya) & np.isfinite(yb)
    yeq_max_deg = float(np.abs(ya[fin] - yb[fin]).max())
    la, lb = out["lwa_zm"][:n16], o16["lwa_zm"]
    lfin = np.isfinite(la) & np.isfinite(lb)
    lwa_rel = float(np.abs(la[lfin] - lb[lfin]).max()
                    / max(np.abs(la[lfin]).max(), 1e-30))
    return dict(snapshots=n_snap, input_gib=round(gib, 2),
                wall_s=round(dt, 1), sps=round(n_snap / dt, 1),
                device_compute_sps=round(device_compute_sps, 1),
                f16_transfer=dict(
                    snapshots=rounds * n16,
                    sps=round(rounds * n16 / dt16, 1),
                    speedup=round(sum(t32s) / dt16, 2),
                    round_sps_f32=[round(n16 / t, 1) for t in t32s],
                    round_sps_f16=[round(n16 / t, 1) for t in t16s],
                    yeq_max_err_deg=yeq_max_deg,
                    lwa_zonal_mean_max_rel_err=lwa_rel,
                    note="interleaved f32/f16 rounds on the same archive "
                         "slice (speedup = pooled t32/t16, drift-cancelling"
                         "); wire ships the f16 bits as a u16 view, device "
                         "bitcasts and upcasts to f32 before compute; "
                         "errors are INPUT-rounding propagation vs the f32 "
                         "stream, opt-in via runner transfer_dtype / CLI "
                         "--transfer"),
                note="721x1440 f32 archive streamed in 32-snapshot chunks "
                     "with overlapped transfers; outputs fetched per chunk")


def out_of_core_section():
    n = int(os.environ.get("BENCH_OOC_SNAPS", "320"))
    sec = {"live_sample": out_of_core(n_snap=n)}
    full = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BENCH_OOC_FULL.json")
    if os.path.exists(full):
        with open(full) as f:
            sec["full_archive_recorded"] = json.load(f)
    return sec


def _init_devices(timeout_s: float):
    """``jax.devices()`` behind a watchdog: a device runtime that hangs at
    start-up would leave no artifact at all, so fail fast with a PARSEABLE
    error line instead and exit 2."""
    import threading
    box = {}

    def probe():
        try:
            import jax
            box["devices"] = [str(d) for d in jax.devices()]
        except Exception as e:  # noqa: BLE001 — report any init failure
            box["error"] = repr(e)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if "devices" in box:
        return box["devices"]
    err = box.get("error",
                  f"jax device init did not complete within {timeout_s:.0f}s")
    print(json.dumps({
        "metric": METRIC,
        "value": None, "unit": "snapshots/sec", "vs_baseline": None,
        "error": err}))
    sys.stdout.flush()
    os._exit(2)


def main(argv=None):
    """Print ONE compact (< ~1.5 kB) JSON line — headline + baselines first,
    then the adjoint and the tall-grid crossover check — and
    write the full detail tree (op-model formulas, ceilings, workload matrix,
    out-of-core run, timing methodology) to BENCH_DETAILS.json next to this
    file.  ``--quick`` (or BENCH_QUICK=1) runs headline + adjoint + baselines
    only, < 3 min, so a driver/judge re-run completes inside a timeout.

    Failure contract (VERDICT r4 #1): _init_devices fails fast with a
    parseable error line on init hangs; everything AFTER it runs under the
    same contract — any exception emits one parseable JSON line with
    ``value: null`` and an ``error`` field, exit 1 — and transient backend
    faults (FAILED_PRECONDITION/UNAVAILABLE) are retried with geometric backoff before giving up."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    default=os.environ.get("BENCH_QUICK", "") not in ("", "0"))
    ap.add_argument("--device-timeout", type=float,
                    default=float(os.environ.get("BENCH_DEVICE_TIMEOUT",
                                                 "240")))
    args = ap.parse_args(argv)

    from xcontour_tpu.config import enable_compile_cache
    enable_compile_cache()
    _init_devices(args.device_timeout)
    try:
        return _run(args)
    except Exception as e:  # noqa: BLE001 — ANY failure must still emit a
        # parseable one-line artifact for the driver (round 4's capture was
        # an uncaught traceback -> rc=1 with parsed=null)
        print(json.dumps({
            "metric": METRIC, "value": None, "unit": "snapshots/sec",
            "vs_baseline": None, "error": repr(e)[:800]}))
        sys.stdout.flush()
        return 1


def _run(args):
    lat, lon, vor = _retry("load", _load)
    n_cpu = int(os.environ.get("BENCH_CPU_SNAPS", "10"))
    batch = int(os.environ.get("BENCH_BATCH", "32"))

    sps = _retry("headline", lambda: headline(lat, lon, vor, batch=batch))
    # the <=1e-6-faithful configuration (BASELINE.json north star tolerance):
    # reference-exact f32 summation semantics via the pairwise 'dense' path,
    # pinned as its own cross-round series next to the default-path headline.
    # Full-mode only: on a cold cache it costs a second compile
    sps_dense = None if args.quick else _retry(
        "headline_dense",
        lambda: headline(lat, lon, vor, batch=batch, lwa_method="dense"))
    adjoint = _retry("adjoint", lambda: adjoint_section(
        lat, lon, vor, batch=batch, era5=not args.quick))
    tall = workloads = ooc = None
    if not args.quick:
        tall = _retry("lwa_tall", lwa_tall)
        workloads = _retry("workloads",
                           lambda: workload_matrix(lat, lon, vor))
        ooc = _retry("out_of_core", out_of_core_section)

    oracle = cpu_oracle_sps(lat, lon, vor, n_snap=n_cpu)
    fast = cpu_numpy_fast_sps(lat, lon, vor, n_snap=n_cpu)

    # a quick run must not destroy the expensive full-run sections already
    # on disk — carry them over, marked, instead of nulling them out
    detail_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BENCH_DETAILS.json")
    carried = []
    if args.quick and os.path.exists(detail_path):
        try:
            with open(detail_path) as f:
                prev = json.load(f)
        except (OSError, ValueError):
            prev = {}
        for key, cur in (("lwa_tall", tall), ("workloads", workloads),
                         ("out_of_core", ooc)):
            if cur is None and prev.get(key) is not None:
                if key == "lwa_tall":
                    tall = prev[key]
                elif key == "workloads":
                    workloads = prev[key]
                else:
                    ooc = prev[key]
                carried.append(key)

    details = {
        "adjoint": adjoint,
        "lwa_tall": tall,
        "workloads": workloads,
        "out_of_core": ooc,
        "baseline_note": ("xarray/dask/xhistogram are not installable in "
                          "this image; both baselines are pure NumPy on this "
                          "host — the literal reference stack adds overhead "
                          "on top, so the speedups are conservative lower "
                          "bounds"),
        "method": "fetch-forced dependency-chained slope timing",
        "mode": "quick" if args.quick else "full",
    }
    if carried:
        details["carried_from_previous_run"] = carried
        details["mode"] = "quick (carried: " + ",".join(carried) + ")"
    with open(detail_path, "w") as f:
        json.dump(details, f, indent=1)

    line = {
        "metric": METRIC,
        "value": round(sps, 1),
        "unit": "snapshots/sec",
        "vs_baseline": round(sps / oracle, 2),
        **({"headline_dense_sps": round(sps_dense, 1)}
           if sps_dense is not None else {}),
        "baselines": {"oracle_f64_sps": round(oracle, 3),
                      "numpy_fast_f32_sps": round(fast, 3),
                      "vs_numpy_fast": round(sps / fast, 2)},
        "mode": details["mode"],
        "details": "BENCH_DETAILS.json",
    }
    # pinned-denominator ratios: the live oracle reading swings ~3x with
    # host load; the committed quiet-window medians make the cross-round
    # speedup series comparable (VERDICT r4 #5)
    if PINNED_ORACLE_SPS:
        line["vs_baseline_pinned"] = round(sps / PINNED_ORACLE_SPS, 2)
        line["baselines"]["pinned_oracle_f64_sps"] = PINNED_ORACLE_SPS
    if PINNED_NUMPY_FAST_SPS:
        line["baselines"]["pinned_numpy_fast_f32_sps"] = PINNED_NUMPY_FAST_SPS
        line["baselines"]["vs_numpy_fast_pinned"] = round(
            sps / PINNED_NUMPY_FAST_SPS, 2)
    if tall is not None:
        line["lwa_tall"] = {"ny": tall["ny"], "fast_ms": tall["fast_ms"],
                            "lin_ms": tall["lin_ms"],
                            "auto": tall["auto_resolves_to"],
                            "fast_wins": tall["fast_wins"]}
    if workloads is not None:
        line["era5_sps"] = workloads["era5_keff_lwa_sps"]
        line["year_pv_s"] = workloads["year_pv_s"]
    line["adjoint_sps"] = adjoint["grad_sps"]
    # append-only run ledger: one row per bench invocation, committed to
    # git, so cross-round headline claims are falsifiable — a regression
    # shows a dropped headline at UNCHANGED contention index; a congested
    # window drops both together (round-3 verdict item 1)
    hist_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_HISTORY.jsonl")
    hist_row = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "headline_sps": round(sps, 1),
        **({"headline_dense_sps": round(sps_dense, 1)}
           if sps_dense is not None else {}),
        "vs_baseline_pinned": round(sps / PINNED_ORACLE_SPS, 2)
        if PINNED_ORACLE_SPS else None,
        "adjoint_sps": adjoint["grad_sps"],
        "oracle_sps": round(oracle, 3),
        "mode": details["mode"], "batch": batch,
    }
    with open(hist_path, "a") as f:
        f.write(json.dumps(hist_row) + "\n")

    out = json.dumps(line)
    assert len(out) < 1600, f"compact line grew to {len(out)} bytes"
    print(out)


if __name__ == "__main__":
    sys.exit(main())
