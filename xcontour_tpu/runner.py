"""Batch runner: stream large snapshot archives through a jitted pipeline.

The reference's production driver (tests/LWA.py) is a Python double loop over
time and level, writing one NetCDF at the end — no overlap, no resume, and
one bad snapshot kills the whole archive.  This runner provides the
aux-subsystem plan from SURVEY.md §5:

* fixed-size batching (one compiled program reused for every chunk; a padded
  tail chunk avoids a second compilation);
* two-stage prefetch: host read/decode of chunk k+2 (own thread) overlaps
  the host->device transfer of chunk k+1 (own thread) overlaps compute on
  chunk k — read, wire, and device all stay busy;
* idempotent per-chunk outputs: each chunk writes `<stem>_ck{k:05d}.npz` and
  is skipped when the file already exists, giving snapshot-granular
  checkpoint/resume for free;
* failure isolation: per-chunk retry with backoff, then — under
  ``on_error='skip'`` — a structured `<stem>_ck{k:05d}.failed` record (JSON:
  chunk, valid count, error text) instead of an aborted archive; in-memory
  runs fill the failed chunk with NaN so time indices stay aligned.
  Checkify errors raised by a ``validate`` hook (utils.checks) surface the
  in-jit guard message in the record;
* structured per-chunk logging (shapes + wall time).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp


def _failed_path(out_stem: str, k: int) -> str:
    return f"{out_stem}_ck{k:05d}.failed"


def _read_marker(path: str) -> dict:
    """Read a .failed record; a damaged marker names itself and its repair
    instead of surfacing a bare JSONDecodeError."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            f"failure marker {path} is unreadable ({e!r}); delete it and "
            "re-run run_batched(..., resume=True)") from e


import functools


@functools.lru_cache(maxsize=None)
def _wire_upcaster(wire_name: str, full_name: str):
    """One tiny jitted bitcast+upcast program per (wire, full) pair, cached
    at module level so repeated run_batched calls reuse the compilation —
    the two elementwise ops fuse into a single kernel (one HBM write
    instead of two eager dispatches)."""
    wire = jnp.dtype(wire_name)
    full = jnp.dtype(full_name)
    return jax.jit(lambda x: jax.lax.bitcast_convert_type(x, wire)
                   .astype(full))


class WireRangeError(ValueError):
    """``transfer_dtype`` cannot represent the data — a CONFIGURATION error
    (mis-scaled variable), deterministic on every retry.  The runner always
    re-raises it immediately: burning the retry/backoff schedule cannot heal
    it, and ``on_error='skip'`` must not degrade a config error into
    silently NaN-filled/failed chunks."""


def _check_wire_range(arr: np.ndarray, wire) -> None:
    """Guard a transfer_dtype cast against silent range failure: values past
    the wire dtype's max become inf, and a chunk whose whole magnitude sits
    below its smallest normal collapses into subnormals where the relative
    rounding is percent-level, not the documented mantissa bound (f16 ~5e-4).
    One cheap host-side abs-max per chunk; raises with the repair."""
    try:
        fi = np.finfo(wire)
    except ValueError:  # np.finfo rejects ml_dtypes (bfloat16)
        import ml_dtypes  # ships with jax
        fi = ml_dtypes.finfo(wire)
    with np.errstate(invalid="ignore"):
        m = float(np.max(np.abs(arr))) if arr.size else 0.0
    if not np.isfinite(m):  # input carries inf/NaN legitimately (masks);
        fin = arr[np.isfinite(arr)]  # judge only the finite values
        m = float(np.max(np.abs(fin))) if fin.size else 0.0
    if m > float(fi.max):
        raise WireRangeError(
            f"transfer_dtype {np.dtype(wire)} cannot carry this chunk: "
            f"|values| reach {m:.4g} > its max {float(fi.max):.4g}, the "
            "wire cast would overflow to inf — rescale the variable "
            "(CLI: --scale-var) or drop the transfer compression")
    if 0.0 < m < float(fi.tiny):
        raise WireRangeError(
            f"transfer_dtype {np.dtype(wire)} cannot carry this chunk: "
            f"|values| peak at {m:.4g} < its smallest normal "
            f"{float(fi.tiny):.4g}, so the whole chunk lands in subnormals "
            "where relative rounding far exceeds the documented bound — "
            "rescale the variable (CLI: --scale-var) or drop the transfer "
            "compression")


def _fetch_packed(out: Dict[str, jax.Array]) -> Dict[str, np.ndarray]:
    """Fetch a dict of device outputs with as FEW device->host round-trips
    as possible: every same-(dtype, batch) group is concatenated on device
    into one flat array and fetched once, so a step returning 9 small
    arrays pays one fetch latency per chunk instead of nine.  Values are
    bit-identical to per-key fetches (the
    device-side reshape/concatenate moves bytes, no arithmetic)."""
    groups: Dict[object, list] = {}
    for k, v in out.items():
        if not hasattr(v, "ndim") or v.ndim == 0:
            # 0-d: fetch directly (run_batched rejects these upstream —
            # they cannot be tail-trimmed — but stay robust for other callers)
            groups.setdefault(None, []).append(k)
        else:
            groups.setdefault((jnp.dtype(v.dtype), v.shape[0]), []).append(k)
    res: Dict[str, np.ndarray] = {}
    for g, ks in groups.items():
        if g is None or len(ks) == 1:
            for k in ks:
                res[k] = np.asarray(out[k])
            continue
        B = g[1]
        flats = [out[k].reshape(B, -1) for k in ks]
        widths = [f.shape[1] for f in flats]
        packed = np.asarray(jnp.concatenate(flats, axis=1))
        offs = np.cumsum([0] + widths)
        for k, lo, hi in zip(ks, offs[:-1], offs[1:]):
            res[k] = packed[:, lo:hi].reshape(np.shape(out[k]))
    return res


def run_batched(step: Callable[[jax.Array], Dict[str, jax.Array]],
                snapshots: np.ndarray, batch: int = 32,
                out_stem: Optional[str] = None,
                resume: bool = True, log: Callable[[str], None] = print,
                retries: int = 0, on_error: str = "raise",
                retry_wait: float = 0.25,
                validate: Optional[Callable[[Dict[str, np.ndarray]], None]]
                = None, sharding=None,
                transfer_dtype=None) -> Optional[Dict[str, np.ndarray]]:
    """Run ``step`` over ``snapshots`` (T, Ny, Nx) in fixed-size batches.

    With ``out_stem`` set, results are written per chunk and already-written
    chunks are skipped (resume); returns None.  Without it, results are
    concatenated in memory and returned.

    ``snapshots`` may be any sliceable (T, ...) source — an ndarray, a
    ``np.memmap``, or an object with ``shape`` and ``__getitem__`` (lazy
    loaders), so archives larger than host or device memory stream through.

    ``sharding`` (an optional ``jax.sharding.Sharding``) places each chunk
    directly onto a device mesh in the SAME overlapped ``device_put`` —
    one host->shards transfer per chunk, never a second resharding copy on
    the compute path.

    ``transfer_dtype`` (e.g. ``'float16'`` or ``jnp.bfloat16``) compresses
    the host->device payload: chunks are cast on the host, transferred at
    half width, and upcast back to the source dtype ON DEVICE before
    ``step`` runs — compute precision is unchanged, only the wire format
    narrows.  The wire carries the narrowed bits as a same-width UNSIGNED
    INT view (bitcast back on device — bit-identical to shipping the float
    dtype itself).  Opt-in because it rounds the INPUT (f16: 11
    significand bits, ~5e-4 relative; bf16: 8 bits, ~4e-3): use when the
    host->device link is the bottleneck and the tracer's information
    content is coarser than the mantissa loss — e.g. re-gridded/compressed
    archives.

    Failure handling: each chunk is attempted ``retries + 1`` times (with
    ``retry_wait * 2**attempt`` backoff).  ``validate(out_np)`` runs after
    each fetch and may raise to reject the chunk (e.g. NaN guards or a
    checkify ``err.throw()``).  When attempts are exhausted,
    ``on_error='raise'`` re-raises; ``on_error='skip'`` records the failure
    and continues with the remaining chunks.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    if transfer_dtype is not None:
        wire = jnp.dtype(transfer_dtype)
        full = np.dtype(getattr(snapshots, "dtype", np.float32))
        if wire.itemsize >= full.itemsize:
            raise ValueError(
                f"transfer_dtype {wire} is not narrower than the source "
                f"dtype {full}; compression would be a no-op")
        user_step = step
        wire_int = np.dtype(f"uint{8 * wire.itemsize}")
        upcast = _wire_upcaster(wire.name, full.name)

        def step(x):  # bitcast + upcast ON DEVICE: compute precision and
            # values are identical to shipping the float wire dtype itself.
            # NOT fused into user_step under one jit: that would compile a
            # brand-new copy of the whole pipeline (tens of seconds, and
            # once per run_batched call since the closure is fresh) to save
            # one full-width pass per chunk on a path that is link-bound by
            # definition.
            return user_step(upcast(x))
    T = snapshots.shape[0]
    nchunk = -(-T // batch)
    collected: List[Optional[Dict[str, np.ndarray]]] = []
    nvalids: List[int] = []
    failures: List[int] = []

    # two-stage prefetch pipeline (read || transfer || compute): the host
    # read/decode (+ wire cast) of chunk k+2 runs on its own thread WHILE the
    # transfer of chunk k+1 is on the wire and chunk k computes.  With read
    # and transfer on ONE thread they serialized against each other, so the
    # link idled during every decode.
    def read_chunk(k):
        """Stage 1 (read thread): slice + pad + optional wire narrowing —
        ALL host-side work, no device traffic."""
        lo = k * batch
        hi = min(lo + batch, T)
        arr = np.asarray(snapshots[lo:hi])
        if hi - lo < batch:  # pad the tail so the compiled shape is reused
            pad = np.repeat(arr[-1:], batch - (hi - lo), axis=0)
            arr = np.concatenate([arr, pad], axis=0)
        if transfer_dtype is not None:  # narrow the wire format on the host
            _check_wire_range(arr, wire)
            # ship the narrowed bits as an int view (see docstring);
            # astype returns a fresh contiguous array, so the view is free
            arr = arr.astype(transfer_dtype).view(wire_int)
        return arr, hi - lo

    def ship(read_fut):
        """Stage 2 (transfer thread): host->device.  device_put goes straight
        from the host array to the (sharded) devices — one transfer; routing
        through jnp.asarray would commit the whole chunk to the default
        device first and pay a second resharding copy."""
        arr, nvalid = read_fut.result()
        return jax.device_put(arr, sharding), nvalid

    def chunk_array(k):
        """Composed read+ship, for the retry re-read path (runs on the
        transfer thread; the read still routes through the read thread so
        the source is only ever touched by one thread)."""
        return ship(read_pool.submit(read_chunk, k))

    def attempt(dev, nvalid):
        out = step(dev)
        bad = [key for key, v in out.items() if getattr(v, "ndim", 1) == 0]
        if bad:
            raise ValueError(
                f"step outputs must keep a leading snapshot axis; 0-d "
                f"outputs {bad} cannot be trimmed to the valid tail-chunk "
                "snapshots (padded snapshots would contaminate them) — "
                "return per-snapshot values and reduce after load")
        out_np = {key: v[:nvalid] for key, v in _fetch_packed(out).items()}
        if validate is not None:
            validate(out_np)
        return out_np

    def nvalid_of(k):
        return min((k + 1) * batch, T) - k * batch

    def skippable(k):
        return (out_stem is not None and resume
                and os.path.exists(f"{out_stem}_ck{k:05d}.npz"))

    # a resumed archive must not be re-read/re-transferred just to skip:
    # prefetch targets the NEXT chunk that will actually compute
    def next_todo(k0):
        for k in range(k0, nchunk):
            if not skippable(k):
                return k
        return None

    # one single-worker pool per pipeline stage: each source/resource is
    # only ever touched by ONE thread (h5py is not thread-safe for
    # concurrent access; transfers serialize on the wire anyway), and the
    # stages overlap — read(k+2) || transfer(k+1) || compute(k).
    from concurrent.futures import ThreadPoolExecutor
    read_pool = ThreadPoolExecutor(max_workers=1)
    ship_pool = ThreadPoolExecutor(max_workers=1)

    try:
        k1 = next_todo(0)
        k2 = next_todo(k1 + 1) if k1 is not None else None
        # submit read(k1) from HERE, before read(k2): routing it through
        # chunk_array on the ship worker would race its read submission
        # against the main thread's read(k2) below and usually lose,
        # making the single read worker decode k2 first and delaying the
        # first compute by a full chunk read
        rf1 = read_pool.submit(read_chunk, k1) if k1 is not None else None
        pending_ship = (k1, ship_pool.submit(ship, rf1)) \
            if k1 is not None else (None, None)
        pending_read = (k2, read_pool.submit(read_chunk, k2)) \
            if k2 is not None else (None, None)
        for k in range(nchunk):
            nvalids.append(nvalid_of(k))
            path = f"{out_stem}_ck{k:05d}.npz" if out_stem else None
            if pending_ship[0] != k:
                log(f"[runner] chunk {k + 1}/{nchunk}: exists, skipped")
                continue
            # a prefetch-thread read failure (transient disk/HDF5 error on
            # the NOW-LAZY inputs) must flow through the SAME retries +
            # on_error machinery as a compute failure — not abort the
            # archive run at .result()
            dev, nvalid = None, nvalid_of(k)
            try:
                dev, nvalid = pending_ship[1].result()
            except WireRangeError:
                raise  # config error: deterministic, never heals (see class)
            except Exception as e:  # noqa: BLE001 — re-read under retries
                log(f"[runner] chunk {k + 1}/{nchunk}: prefetch read "
                    f"failed ({e}); re-reading under the retry policy")
            # promote the decoded chunk to the transfer stage and start the
            # read after it — the two stages advance independently
            if pending_read[0] is not None:
                rk, rf = pending_read
                pending_ship = (rk, ship_pool.submit(ship, rf))
                nxt = next_todo(rk + 1)
                pending_read = (nxt, read_pool.submit(read_chunk, nxt)) \
                    if nxt is not None else (None, None)
            else:
                pending_ship = (None, None)

            t0 = time.perf_counter()
            out_np, last_err = None, None
            for a in range(retries + 1):
                try:
                    if dev is None:  # prefetch (or a prior re-read) failed;
                        # go through the pools: the source must only ever be
                        # touched by one thread (h5py), and the workers may
                        # already be prefetching later chunks
                        dev, nvalid = ship_pool.submit(chunk_array, k).result()
                    out_np = attempt(dev, nvalid)
                    break
                except WireRangeError:
                    raise  # config error: retrying/skipping cannot heal it
                except Exception as e:  # noqa: BLE001 — isolate any failure
                    last_err = e
                    if a < retries:
                        wait = retry_wait * (2 ** a)
                        log(f"[runner] chunk {k + 1}/{nchunk}: attempt "
                            f"{a + 1} failed ({e}); retrying in {wait:.2f}s")
                        time.sleep(wait)

            if out_np is None:
                if on_error == "raise":
                    raise last_err
                failures.append(k)
                log(f"[runner] chunk {k + 1}/{nchunk}: FAILED after "
                    f"{retries + 1} attempts: {last_err}")
                if path:
                    rec = {"chunk": k, "nvalid": nvalid,
                           "error": repr(last_err)}
                    tmp = _failed_path(out_stem, k) + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(rec, f)
                    os.replace(tmp, _failed_path(out_stem, k))
                else:
                    collected.append(None)
                continue

            dt = time.perf_counter() - t0
            log(f"[runner] chunk {k + 1}/{nchunk}: {nvalid} snapshots "
                f"in {dt:.3f}s ({nvalid / dt:.1f}/s)")

            if path:
                tmp = path + ".tmp.npz"
                np.savez(tmp, **out_np)
                os.replace(tmp, path)  # atomic: complete or absent
                failed = _failed_path(out_stem, k)
                if os.path.exists(failed):  # a retry succeeded on resume
                    os.remove(failed)
            else:
                collected.append(out_np)
    finally:
        ship_pool.shutdown(wait=True)
        read_pool.shutdown(wait=True)

    if failures:
        log(f"[runner] {len(failures)}/{nchunk} chunks failed: {failures}")
    if out_stem:
        return None
    good = next((c for c in collected if c is not None), None)
    if good is None:
        raise RuntimeError("all chunks failed; nothing to return") from None
    parts: Dict[str, List[np.ndarray]] = {}
    for c, nv in zip(collected, nvalids):
        for key in good:
            if c is not None:
                parts.setdefault(key, []).append(c[key])
            else:  # NaN-fill so time indices stay aligned with the archive
                shape = (nv,) + good[key].shape[1:]
                parts.setdefault(key, []).append(
                    np.full(shape, np.nan, dtype=good[key].dtype))
    return {k: np.concatenate(v, axis=0) for k, v in parts.items()}


def load_chunks(out_stem: str, allow_failed: bool = False,
                expect_chunks: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Reassemble results written by :func:`run_batched`.

    Chunks recorded as failed (``*.failed`` markers) raise unless
    ``allow_failed=True``, in which case they are NaN-filled using the shape
    of the surviving chunks so the time axis stays aligned.

    ``expect_chunks`` (when the caller knows ``ceil(T / batch)``) extends the
    gap guard to MISSING TRAILING chunks — without it only interior holes are
    detectable, and a lost last chunk file would silently truncate the
    reassembled time axis.
    """
    import glob
    # a process killed mid-write leaves `*_ck*.npz.tmp.npz` (os.replace makes
    # the real chunk atomic) — in-flight litter, not data
    files = sorted(f for f in glob.glob(f"{out_stem}_ck*.npz")
                   if not f.endswith(".tmp.npz"))
    markers = sorted(glob.glob(f"{out_stem}_ck*.failed"))
    if not files and not markers:
        raise FileNotFoundError(f"no chunks matching {out_stem}_ck*.npz")
    if markers and not allow_failed:
        detail = [_read_marker(m) for m in markers]
        raise RuntimeError(
            f"{len(markers)} failed chunk(s) under {out_stem}: {detail}; "
            "re-run run_batched(..., resume=True) to retry them or pass "
            "allow_failed=True to NaN-fill")

    def _index(path: str) -> int:
        stem = os.path.basename(path)
        return int(stem.rsplit("_ck", 1)[1].split(".")[0])

    chunks: Dict[int, Optional[Dict[str, np.ndarray]]] = {}
    nvalid: Dict[int, int] = {}
    # a corrupt/truncated chunk file must not surface as a zipfile/pickle
    # traceback: name the file and the repair (.npz writes are atomic via
    # os.replace, so this only happens to externally damaged files)
    for f in files:
        try:
            with np.load(f) as z:
                chunks[_index(f)] = {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 — any unreadable chunk
            raise RuntimeError(
                f"checkpoint chunk {f} is corrupt or unreadable ({e!r}); "
                "delete it and re-run run_batched(..., resume=True) to "
                "regenerate it") from e
    for m in markers:
        rec = _read_marker(m)
        if rec["chunk"] not in chunks:
            chunks[rec["chunk"]] = None
            nvalid[rec["chunk"]] = rec["nvalid"]

    good = next((c for c in chunks.values() if c is not None), None)
    if good is None:
        raise RuntimeError(
            f"all {len(markers)} chunk(s) under {out_stem} failed; nothing "
            "to assemble — fix the step and re-run run_batched(..., "
            "resume=True)")
    # a hole in the index sequence (e.g. a manually deleted chunk file with
    # no .failed marker) would silently misalign the reassembled time axis;
    # expect_chunks additionally catches missing TRAILING chunks
    top = max(max(chunks) + 1, expect_chunks or 0)
    missing = sorted(set(range(top)) - set(chunks))
    if missing:
        raise RuntimeError(
            f"chunk index gap under {out_stem}: missing {missing} of "
            f"0..{top - 1}; re-run run_batched(..., resume=True) to "
            "regenerate them")
    parts: Dict[str, List[np.ndarray]] = {}
    for k in sorted(chunks):
        c = chunks[k]
        for key in good:
            if c is not None:
                parts.setdefault(key, []).append(c[key])
            else:
                shape = (nvalid[k],) + good[key].shape[1:]
                parts.setdefault(key, []).append(
                    np.full(shape, np.nan, dtype=good[key].dtype))
    return {k: np.concatenate(v, axis=0) for k, v in parts.items()}
