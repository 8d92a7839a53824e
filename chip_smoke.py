#!/usr/bin/env python
"""Proof that the Keff+LWA path runs on an NVIDIA GPU, checked against the
float64 oracle (``compat.py``) at real widths.

Run from the repository root, in one process that owns the card:

    python chip_smoke.py               # one GPU: phases (a)-(f) below
    python chip_smoke.py --four-cards  # four GPUs: the --mesh paths only

Phases (one card):
  (a) device: a GPU backend or exit 1 — there is no CPU fallback;
  (b) headline: keff_lwa_pipeline at 32x256x512, N=121, on the seeded
      barotropic-vorticity field, snapshot 0 against the oracle;
  (c) real size through the CLI: a seeded 16 x 721x1440 netCDF-3 archive
      through ``keff-lwa -N 241 --batch 4 --format nc3``, in this process,
      against a direct pipeline call;
  (d) the LWA kernel against the XLA lin form at three shapes, and the
      timings that decide whether the kernel stays (see PERF.md);
  (e) geometry pipelines and the adjoint;
  (f) the ``gpu``-marked tests.

Every comparison prints its error beside its tolerance; any failure raises,
and the process exits non-zero.  The last line of a passing run is one JSON
object naming the device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def _phase(title):
    print(f"{title}  [t={time.perf_counter() - T0:.1f} s]", flush=True)


def _check(name, err, tol, unit=""):
    ok = bool(np.isfinite(err) and err <= tol)
    print(f"  {'OK  ' if ok else 'FAIL'} {name}: {err:.3e}{unit} "
          f"(tol {tol:g}{unit})", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {err:.3e} exceeds {tol:g}")


def _rel(got, want):
    """max |got - want| over max |want|; NaNs must coincide."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return np.inf
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))


def _median_ms(fn, *args, n=7):
    """One warm call, then the median of n calls ending in
    block_until_ready, in milliseconds."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _route_lin(kernel: bool):
    """Send 'lin' LWA to the Pallas kernel or to the XLA lin form, for the
    timing comparison only; cached traces are dropped so the next call
    retraces with the new route."""
    import jax
    from xcontour_tpu.diagnostics import lwa
    lwa._lin_kernel = (lambda: True) if kernel else (lambda: False)
    jax.clear_caches()


def _latlon_grid(lat, lon):
    import jax.numpy as jnp
    from xcontour_tpu import grid as G
    return G.from_latlon(np.asarray(lat, np.float64),
                         np.asarray(lon, np.float64), dtype=jnp.float32)


def _lons(nx):
    return np.arange(nx) * (360.0 / nx)


def _tall_field(B, Ny, Nx, seed=0):
    """A cheap wavy field for tall grids: sin(latitude) displaced by a
    zonal wavenumber-3 wave of random phase per snapshot, plus weak
    noise."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(-89.0, 89.0, Ny)
    lam = np.deg2rad(_lons(Nx))
    ph = rng.uniform(0.0, 2 * np.pi, (B, 1, 1))
    q = (np.sin(np.deg2rad(lat)[None, :, None]
                + 0.2 * np.sin(3 * lam[None, None, :] + ph))
         + 0.01 * rng.standard_normal((B, Ny, Nx)))
    return lat, q.astype(np.float32)


def _lin_f64(q, Q, W):
    """The XLA lin form in float64 on the device: the reference for the
    float32 kernel and XLA forms at shapes the NumPy oracle cannot afford."""
    import jax
    from xcontour_tpu.diagnostics import lwa as L
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = [np.asarray(a, np.float64) for a in (q, Q, W)]
        return np.asarray(jax.jit(lambda a, b, c: L._lwa_lin_xla(
            a, b, c, True, False, 16))(*f64))
    finally:
        jax.config.update("jax_enable_x64", False)


def phase_device(expect: int):
    import jax
    from xcontour_tpu.config import enable_compile_cache
    cache = enable_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"no GPU: the JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        sys.exit(1)
    devs = jax.devices()
    print(f"(a) device: {devs[0].device_kind} x{len(devs)}, "
          f"jax {jax.__version__}, compile cache {cache}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    if len(devs) < expect:
        raise SystemExit(f"need {expect} GPUs, found {len(devs)}")
    return devs


def phase_headline():
    """(b) Tolerances, each against the oracle run in float64 on the
    float32-rounded input:
      intArea 1e-6 of the total — float32 CDF sums of ~1.3e5 cell areas
        round at ~eps per bin boundary, far below it;
      Yeq 1e-3 degrees — an area error of 1e-6 of the sphere moves an
        equivalent latitude by ~1e-4 degrees at most;
      'lin' LWA 2e-4 of the max — R and E are each up to ~10x the result
        and cancel, so the float32 floor is ~10 eps sqrt(Ny);
      'dense' LWA 5e-6 of the max — the reference's own masked sum, with
        no cancellation: float32 rounding of Ny-term column sums.
    The comparisons run at matmul precision 'highest', so a TF32 product
    could not hide an error (the pipeline has no contraction today)."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu import compat
    from xcontour_tpu.diagnostics.lwa import local_wave_activity
    from xcontour_tpu.pipeline import keff_lwa_pipeline
    from xcontour_tpu.utils import synth

    v, _ = synth.synth_barotropic_vorticity(nt=32)
    lat = np.asarray(v["latitude"], np.float64)
    q = jnp.asarray(v["absolute_vorticity"], jnp.float32)
    grid = _latlon_grid(lat, v["longitude"])
    _phase(f"(b) headline keff_lwa_pipeline {tuple(q.shape)} N=121")
    with jax.default_matmul_precision("highest"):
        out = jax.block_until_ready(keff_lwa_pipeline(q, grid, N=121))
        for k in ("nkeff", "lwa", "Yeq"):
            a = np.asarray(out[k])
            assert a.shape[0] == q.shape[0] and np.isfinite(a).any(), k
        q0 = np.asarray(q[0], np.float64)
        dA = np.asarray(grid.dA, np.float64)
        ctr = compat.contours_linspace(q0, 121, True)
        ia = compat.integral_within_contours_hist(q0, ctr, dA, None, True)
        yc, tbl = compat.area_table_hist(np.ones_like(q0), lat, dA, True,
                                         True)
        yeq = compat.table_lookup_coordinates(tbl, yc, ia)
        Q = compat.interp_to_coords(lat, yeq, ctr, yeq[0] < yeq[-1])
        _check("intArea vs oracle", _rel(out["intArea"][0], ia), 1e-6)
        _check("Yeq vs oracle", float(np.max(np.abs(
            np.asarray(out["Yeq"][0], np.float64) - yeq))), 1e-3, " deg")
        lwa = compat.local_wave_activity(q0, Q, dA, lat, True, "all")
        _check("LWA 'lin' (kernel) vs oracle", _rel(out["lwa"][0], lwa),
               2e-4)
        # 'dense' on the pipeline's own profile, so only the LWA sum differs
        Qp = np.asarray(out["Q"][0], np.float64)
        dense = local_wave_activity(q[:1], out["Q"][:1], grid.dA, grid.ydef,
                                    increase=True, method="dense")[0]
        _check("LWA 'dense' vs oracle", _rel(
            dense, compat.local_wave_activity(q0, Qp, dA, lat, True, "all")),
            5e-6)
    return v, q, grid


def _era5_archive(tmp, nt=16):
    """A seeded 721x1440 isentropic-PV archive as netCDF-3."""
    from xcontour_tpu.utils import synth
    from xcontour_tpu.utils.ncio import save_dataset_nc3
    v, d = synth.synth_pv(nlev=nt, nlat=721, nlon=1440, seed=7)
    path = os.path.join(tmp, "pv_721x1440.nc")
    keep = ("level", "latitude", "longitude", "pv")
    save_dataset_nc3(path, {k: v[k] for k in keep}, {k: d[k] for k in keep},
                     coords={k: v[k] for k in keep[:3]})
    return path, v


def _cli_keff_lwa(path, out_path, extra=()):
    from xcontour_tpu import cli
    from xcontour_tpu.utils.ncio import load_dataset
    t0 = time.perf_counter()
    rc = cli.main(["keff-lwa", path, "--var", "pv", "-N", "241", "--batch",
                   "4", "--format", "nc3", "--out", out_path, *extra])
    assert rc == 0, rc
    print(f"  CLI {' '.join(extra) or '(one card)'}: "
          f"{time.perf_counter() - t0:.1f} s wall, compile included",
          flush=True)
    return load_dataset(out_path)


def phase_cli(tmp):
    """(c) The archive through the CLI in this process, against a direct
    pipeline call on one chunk.  The CLI compiles the pipeline inside its
    own step, so the two programs fuse and round differently: float32
    rounding, 1e-5 of the max, for intArea and Yeq.  nkeff differentiates
    the area CDF (dgrdS/dA over (dq/dA)^2), which magnifies a relative area
    difference d by up to ~N at one contour spacing: with d ~1e-7 and N=241
    that is ~2.4e-5, hence 1e-4.  LWA takes the profile from Yeq and its
    'lin' form cancels terms ~10x its size, so it gets half the 2e-4
    'lin' policy, 1e-4."""
    import jax.numpy as jnp
    from xcontour_tpu.pipeline import keff_lwa_pipeline

    path, v = _era5_archive(tmp)
    _phase("(c) CLI keff-lwa on a 16 x 721x1440 netCDF-3 archive, N=241")
    got = _cli_keff_lwa(path, os.path.join(tmp, "pv_keff_lwa.nc"))
    grid = _latlon_grid(v["latitude"], v["longitude"])
    direct = keff_lwa_pipeline(jnp.asarray(v["pv"][4:8], jnp.float32), grid,
                               N=241)
    for k, tol in (("intArea", 1e-5), ("Yeq", 1e-5), ("nkeff", 1e-4),
                   ("lwa", 1e-4)):
        assert got[k].shape[0] == 16, (k, got[k].shape)
        _check(f"CLI {k} vs direct call", _rel(got[k][4:8], direct[k]), tol)
    return v


def phase_kernel(q_head, grid_head, v_era5):
    """(d) The Pallas kernel path and the XLA lin form, both float32,
    against each other and against the lin form in float64 at three
    shapes: each must stay within the 2e-4 'lin' policy (R and E each reach
    ~10x the result and cancel, so the float32 floor is ~10 eps sqrt(Ny):
    5e-5 of the max at Ny=8192).  Then the timings: keff_lwa_pipeline with the kernel and with the XLA lin form,
    the XLA stages the kernel leaves alone, and lin against fast LWA on
    tall grids."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu.diagnostics import lwa as L
    from xcontour_tpu.diagnostics.length import contour_lengths
    from xcontour_tpu.ops.histogram import weighted_cdf_multi
    from xcontour_tpu.ops.stencil import squared_gradient
    from xcontour_tpu.pipeline import keff_lwa_pipeline
    from xcontour_tpu import core

    _phase("(d) LWA kernel and XLA lin form vs float64")
    q_era5 = jnp.asarray(v_era5["pv"][:4], jnp.float32)
    grid_era5 = _latlon_grid(v_era5["latitude"], v_era5["longitude"])
    lat_t, q_t = _tall_field(4, 8192, 512)
    cases = [("32x256x512", q_head, grid_head.ydef, grid_head.dA),
             ("4x721x1440", q_era5, grid_era5.ydef, grid_era5.dA)]
    grid_t = _latlon_grid(lat_t, _lons(q_t.shape[-1]))
    cases.append(("4x8192x512", jnp.asarray(q_t), grid_t.ydef, grid_t.dA))
    for name, q, ydef, dA in cases:
        Q = jnp.sort(jnp.mean(q, axis=-1), axis=-1)
        W = dA / jnp.max(dA) * dA
        got = jax.jit(lambda a, b, c: L._lwa_lin_kernel(a, b, c, True))(
            q, Q, W)
        xla = jax.jit(lambda a, b, c: L._lwa_lin_xla(a, b, c, True, False,
                                                     16))(q, Q, W)
        ref = _lin_f64(q, Q, W)
        _check(f"kernel vs XLA lin at {name}", _rel(got, xla), 2e-4)
        _check(f"XLA lin vs float64 at {name}", _rel(xla, ref), 2e-4)
        _check(f"kernel vs float64 at {name}", _rel(got, ref), 2e-4)

    _phase("  timings (median of 7, warm, block_until_ready):")
    for name, q, grid, N in (("32x256x512 N=121", q_head, grid_head, 121),
                             ("4x721x1440 N=241", q_era5, grid_era5, 241)):
        def pipe(t, grid=grid, N=N):
            return keff_lwa_pipeline(t, grid, N=N)
        ms = {}
        for kernel in (True, False, True, False):
            _route_lin(kernel)
            ms.setdefault(kernel, []).append(_median_ms(pipe, q))
        _route_lin(True)
        print(f"  keff_lwa_pipeline {name}: kernel "
              f"{' / '.join(f'{t:.3f}' for t in ms[True])} ms, XLA lin "
              f"{' / '.join(f'{t:.3f}' for t in ms[False])} ms", flush=True)

        # every array is an argument: a closed-over device array would
        # become a constant that XLA folds at compile time
        dA = grid.dA
        W = dA / jnp.max(dA) * dA
        ctr = jax.jit(lambda t: core.cal_contours(t, N, increase=True))(q)
        gs = jax.jit(squared_gradient)
        grdS = gs(q, grid)
        cdf = jax.jit(lambda t, c, g, a: weighted_cdf_multi(
            t, c, [a, g * a], True))
        lens = jax.jit(lambda t, c, y, x: contour_lengths(t, c, y, x,
                                                          latlon=True))
        Qp = keff_lwa_pipeline(q, grid, N=N)["Q"]
        kern = jax.jit(lambda t, P, w: L._lwa_lin_kernel(t, P, w, True))
        xla = jax.jit(lambda t, P, w: L._lwa_lin_xla(t, P, w, True, False,
                                                     16))
        print(f"  stages {name}: stencil {_median_ms(gs, q, grid):.3f} ms, "
              f"CDF (2 channels) {_median_ms(cdf, q, ctr, grdS, dA):.3f} ms, "
              f"LWA kernel {_median_ms(kern, q, Qp, W):.3f} ms, "
              f"LWA XLA lin {_median_ms(xla, q, Qp, W):.3f} ms, "
              f"contour lengths "
              f"{_median_ms(lens, q, ctr, grid.ydef, grid.xdef):.3f} ms",
              flush=True)

    _phase("  lin against fast LWA on tall grids:")
    for Ny in (4096, 8192):
        lat, qn = _tall_field(4, Ny, 512, seed=Ny)
        g = _latlon_grid(lat, _lons(qn.shape[-1]))
        q = jnp.asarray(qn)
        Q = jnp.sort(jnp.mean(q, axis=-1), axis=-1)
        t = {m: _median_ms(jax.jit(
            lambda a, P, dA, y, m=m: L.local_wave_activity(
                a, P, dA, y, increase=True, method=m)), q, Q, g.dA, g.ydef)
             for m in ("lin", "fast")}
        print(f"  LWA 4x{Ny}x512: lin {t['lin']:.3f} ms, "
              f"fast {t['fast']:.3f} ms", flush=True)


def phase_geometry(v_head, q_head, grid):
    """(e) Geometry pipelines run; global lengths match the oracle at 1e-5
    of the max (float32 haversine sums over ~1e5 cells); the adjoint of
    the Keff+LWA loss is finite."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu import compat
    from xcontour_tpu.diagnostics.length import contour_lengths
    from xcontour_tpu.diagnostics.local_length import local_contour_lengths
    from xcontour_tpu.pipeline import (clength_pipeline, fractal_pipeline,
                                       keff_lwa_pipeline)

    _phase("(e) geometry and adjoint")
    lat = np.asarray(v_head["latitude"], np.float64)
    lon = np.asarray(v_head["longitude"], np.float64)
    cl = clength_pipeline(q_head[:8], grid, N=121)
    fr = fractal_pipeline(q_head[:8], grid, N=61, strides=(1, 2, 4, 8))
    D = np.asarray(fr["D"])
    assert np.isfinite(np.asarray(cl["lengths"])).mean() > 0.5
    assert 0.9 < np.nanmedian(D[np.isfinite(D)]) < 1.8
    loc, _, _ = local_contour_lengths(q_head[0], grid.ydef, grid.xdef,
                                      window=101, stride=10)
    assert np.isfinite(np.asarray(loc)).mean() > 0.5
    q0 = np.asarray(q_head[0], np.float64)
    ctr = compat.contours_linspace(q0, 121, True)
    got = contour_lengths(q_head[:1], jnp.asarray(ctr, jnp.float32)[None],
                          grid.ydef, grid.xdef, latlon=True)[0]
    _check("contour lengths vs oracle", _rel(
        got, compat.contour_lengths(q0, ctr, lat, lon, latlon=True)), 1e-5)

    def loss(t):
        o = keff_lwa_pipeline(t, grid, N=121)
        return jnp.nansum(o["lwa"] ** 2) + jnp.nansum(o["nkeff"])

    g = np.asarray(jax.jit(jax.grad(loss))(q_head[:4]))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    print(f"  OK   jax.grad of the Keff+LWA loss: finite, max |g| "
          f"{np.abs(g).max():.3e}", flush=True)


def phase_tests():
    """(f) The gpu-marked tests, in this process."""
    import pytest
    _phase("(f) gpu-marked tests")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests: pytest exit code {rc}")


def four_cards(tmp):
    """The multi-device path users rely on: ``keff-lwa --mesh`` over the
    721x1440 archive, and the explicit shard_map collectives, each against
    the one-card result on device 0 (rtol 1e-5: the same arithmetic split
    over devices, with partial sums reduced in another order; nkeff and LWA
    at 1e-4, for the reasons phase_cli gives)."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu import core
    from xcontour_tpu.diagnostics.length import contour_lengths
    from xcontour_tpu.ops.histogram import weighted_cdf
    from xcontour_tpu.parallel import (make_mesh, shard_batch_spec,
                                       sharded_contour_lengths,
                                       sharded_weighted_cdf)

    path, v = _era5_archive(tmp)
    _phase("(4) keff-lwa --mesh on a 16 x 721x1440 archive")
    with jax.default_device(jax.devices()[0]):
        one = _cli_keff_lwa(path, os.path.join(tmp, "one.nc"))
    for mesh in ("4", "1x4"):
        got = _cli_keff_lwa(path, os.path.join(tmp, f"m{mesh}.nc"),
                            ("--mesh", mesh))
        for k, tol in (("intArea", 1e-5), ("Yeq", 1e-5), ("nkeff", 1e-4),
                       ("lwa", 1e-4)):
            _check(f"--mesh {mesh} {k} vs one card", _rel(got[k], one[k]),
                   tol)

    grid = _latlon_grid(v["latitude"], v["longitude"])
    q = jnp.asarray(v["pv"][:4], jnp.float32)
    ctr = core.cal_contours(q, 241, increase=True)
    bins = ctr[0]                 # the sharded CDF takes one shared bin set
    with jax.default_device(jax.devices()[0]):
        want_c = weighted_cdf(q, bins, grid.dA, True)
        want_l = contour_lengths(q, ctr, grid.ydef, grid.xdef, latlon=True)
    mesh = make_mesh(4)
    qs = jax.device_put(q, shard_batch_spec(mesh, 3))
    _check("sharded_weighted_cdf vs one card", _rel(
        sharded_weighted_cdf(qs, bins, grid.dA, True, mesh), want_c), 1e-5)
    _check("sharded_contour_lengths vs one card", _rel(
        sharded_contour_lengths(qs, ctr, grid.ydef, grid.xdef, mesh,
                                latlon=True), want_l), 1e-5)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU --mesh path")
    args = ap.parse_args(argv)
    devs = phase_device(4 if args.four_cards else 1)
    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            four_cards(tmp)
        else:
            v_head, q_head, grid = phase_headline()
            v_era5 = phase_cli(tmp)
            phase_kernel(q_head, grid, v_era5)
            phase_geometry(v_head, q_head, grid)
            phase_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
