#!/usr/bin/env python
"""Pin the CPU-baseline denominators (VERDICT r4 #5).

Runs the two CPU baselines (float64 reference-semantics oracle; the
hand-vectorized f32 NumPy chain) several times on this host and prints their
medians plus the spread.  Run on a QUIET host (check `uptime`); commit the
medians into bench.py's PINNED_* constants and document them in BASELINE.md.

Usage: python tools/pin_baseline.py [passes]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    passes = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    import jax
    jax.config.update("jax_platforms", "cpu")   # baselines run on the host CPU
    import bench

    lat, lon, vor = bench._load()
    la = os.getloadavg()
    oracle, fast = [], []
    for i in range(passes):
        t0 = time.perf_counter()
        oracle.append(bench.cpu_oracle_sps(lat, lon, vor, n_snap=10))
        fast.append(bench.cpu_numpy_fast_sps(lat, lon, vor, n_snap=30))
        print(f"# pass {i + 1}/{passes}: oracle {oracle[-1]:.3f} sps, "
              f"fast {fast[-1]:.3f} sps "
              f"({time.perf_counter() - t0:.0f}s)", file=sys.stderr)
    print(json.dumps({
        "pinned_oracle_f64_sps": round(float(np.median(oracle)), 3),
        "pinned_numpy_fast_f32_sps": round(float(np.median(fast)), 3),
        "oracle_passes": [round(x, 3) for x in oracle],
        "fast_passes": [round(x, 3) for x in fast],
        "loadavg_at_start": la,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "passes": passes}))


if __name__ == "__main__":
    main()
