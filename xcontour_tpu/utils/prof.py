"""Profiling and observability helpers.

The reference has no tracing/profiling at all (SURVEY.md §5 — commented-out
prints only).  This module provides the two things a production diagnostics
pipeline needs:

* :func:`annotate` — name a pipeline stage so it shows up in XLA profiler
  traces (jax.profiler TraceAnnotation / named_scope);
* :class:`Stopwatch` — a structured wall-clock harness that times jitted
  callables with compile/run separation and a FETCH-forced sync (a tiny
  transfer of one element of every output).  For sub-millisecond kernels
  prefer ``bench.device_time``'s dependency-chained slope, which also
  cancels fixed per-call overheads.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import jax


@contextlib.contextmanager
def annotate(name: str):
    """Named scope visible in profiler traces and HLO metadata."""
    with jax.profiler.TraceAnnotation(name), jax.named_scope(name):
        yield


def _force(out) -> None:
    """Actually wait for device work: fetch one element of EVERY output leaf.

    All leaves are fetched (not just the first) so a callable composed of
    several independent dispatches is fully drained before the timer stops;
    the extra fetches are one element each."""
    import numpy as np
    for x in jax.tree_util.tree_leaves(out):
        if hasattr(x, "dtype"):
            np.asarray(jax.numpy.ravel(x)[:1])


@dataclass
class Stopwatch:
    """Compile-aware timing of jitted functions (fetch-forced sync)."""

    records: List[Dict[str, Any]] = field(default_factory=list)

    def time(self, name: str, fn: Callable, *args, reps: int = 10,
             **kwargs) -> Dict[str, Any]:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _force(out)
        compile_and_first = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args, **kwargs)
        _force(out)
        per_call = (time.perf_counter() - t0) / reps

        rec = dict(name=name, first_call_s=round(compile_and_first, 6),
                   per_call_s=round(per_call, 6), reps=reps)
        self.records.append(rec)
        return rec

    def report(self) -> str:
        return "\n".join(json.dumps(r) for r in self.records)


def trace(log_dir: str):
    """Context manager starting a device profiler trace (view with
    tensorboard/xprof)."""
    return jax.profiler.trace(log_dir)
