"""Device-mesh construction and sharding helpers.

The reference has no distributed backend at all — its only parallelism is
dask chunking over batch dims (SURVEY.md §2.4).  Here scaling is native JAX
SPMD: a 2-D ('batch', 'x') mesh where the snapshot batch is split across
devices and the grid's X dimension is sharded across the cards of one host.
On four NVLink-connected cards every card reaches every other at the same
rate, so the mesh shape follows the algorithm alone.  Every pipeline is
pure, so sharding is applied by annotating the inputs (GSPMD inserts the
psum/all-gather collectives) or explicitly via shard_map for the histogram
reduction (parallel/histogram.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("batch", "x"),
              x_size: Optional[int] = None) -> Mesh:
    """Build a ('batch', 'x') mesh over the first ``n_devices`` devices.

    ``x_size`` (spatial shards) defaults to 2 when the device count is even,
    else 1 — batch parallelism is the primary axis for this workload since
    snapshots are embarrassingly parallel (SURVEY.md §2.4).
    """
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    devs = devs[:n]
    if x_size is None:
        x_size = 2 if n % 2 == 0 and n >= 2 else 1
    if n % x_size:
        raise ValueError(f"{n} devices not divisible by x_size={x_size}")
    arr = np.asarray(devs).reshape(n // x_size, x_size)
    return Mesh(arr, axis_names)


def hybrid_device_array(devices: Sequence, x_size: int,
                        slice_of=None) -> np.ndarray:
    """Arrange ``devices`` into the hybrid (batch, x) array: hosts stack
    along the BATCH axis and each host's own devices form contiguous 'x'
    groups, so no 'x'-axis collective ever leaves a host's NVLink domain.

    Pure topology logic, factored out of :func:`make_hybrid_mesh` so the
    multi-host branch is unit-testable with fake attributed devices:
    ``slice_of`` maps a device to its host group and defaults to
    ``process_index`` (one process per host).
    """
    if slice_of is None:
        def slice_of(d):
            return getattr(d, "process_index", 0)
    groups = {}
    for d in devices:
        groups.setdefault(slice_of(d), []).append(d)
    sizes = {len(v) for v in groups.values()}
    if len(sizes) != 1:
        raise ValueError(
            f"uneven devices per slice: { {k: len(v) for k, v in groups.items()} }")
    local = sizes.pop()
    if x_size < 1 or local % x_size:
        raise ValueError(f"{local} devices per slice not divisible by "
                         f"x_size={x_size}")
    rows = [np.asarray(groups[k], object).reshape(local // x_size, x_size)
            for k in sorted(groups)]
    return np.concatenate(rows, axis=0)


def make_hybrid_mesh(axis_names: Sequence[str] = ("batch", "x"),
                     x_size: Optional[int] = None,
                     slice_of=None) -> Mesh:
    """Multi-host ('batch', 'x') mesh: batch across hosts, x within one.

    With several processes (``jax.process_count() > 1``, one per host) the
    batch axis maps to the slower inter-host network and the spatial axis
    to the cards of one host; :func:`hybrid_device_array` places devices so
    each host's local devices form the 'x' groups.  Snapshots are
    embarrassingly parallel, so the batch axis tolerates network latency;
    the histogram psum and length reductions stay within a host
    (SURVEY.md §2.4, §5).

    A single process (one host of one or four cards, the tests, the
    virtual CPU mesh) reduces exactly to :func:`make_mesh` over all visible
    devices — unless ``slice_of`` is given, which forces the hybrid
    placement with the caller's host attribution (how the dryrun executes
    the multi-host branch on the virtual mesh).
    """
    if jax.process_count() <= 1 and slice_of is None:
        return make_mesh(axis_names=axis_names, x_size=x_size)
    devs = jax.devices()
    custom_slicing = slice_of is not None
    if slice_of is None:
        def slice_of(d):
            return d.process_index
    n_slices = len({slice_of(d) for d in devs})
    local = len(devs) // n_slices
    if x_size is None:
        x_size = local            # whole-host x groups by default
    if not custom_slicing:
        # several hosts, one process each: let jax's topology-aware
        # placement lay each host's (batch, x) tile onto its own devices.
        # Falls back to enumeration order where the backend exposes no
        # coords (CPU/virtual devices).
        try:
            from jax.experimental import mesh_utils
            arr = mesh_utils.create_hybrid_device_mesh(
                (local // x_size, x_size), (n_slices, 1), devices=devs,
                process_is_granule=True)
        except Exception as e:  # noqa: BLE001 — expected for backends with
            # no device coords (CPU/virtual devices fall back silently)
            _warn_topology_fallback(devs, e)
            arr = hybrid_device_array(devs, x_size, slice_of=slice_of)
    else:
        arr = hybrid_device_array(devs, x_size, slice_of=slice_of)
    assert arr.shape == (len(devs) // x_size, x_size)
    return Mesh(arr, axis_names)


def _warn_topology_fallback(devs, e: Exception) -> None:
    """On real accelerators a topology/misconfiguration error from the
    coords-aware placement would otherwise silently degrade the placement to
    enumeration order, so name it there; CPU/virtual devices (which expose
    no coords) fall back silently by design."""
    if any(d.platform != "cpu" for d in devs):
        import warnings
        warnings.warn(
            "make_hybrid_mesh: topology-aware placement unavailable "
            f"({type(e).__name__}: {e}); falling back to "
            "enumeration-order device layout — check the mesh shape "
            "against the hosts' device layout", stacklevel=3)


def shard_batch_spec(mesh: Mesh, ndim: int, batch_axis: str = "batch",
                     x_axis: str = "x") -> NamedSharding:
    """Sharding for a (..., Ny, Nx) field batch: leading axis over ``batch``,
    the last (X) axis over ``x``; Ny replicated (the equivalent dimension is
    reduced over in every diagnostic, so splitting it would put the heavy
    LWA reduction across devices for no benefit)."""
    spec = [None] * ndim
    if ndim >= 3:
        spec[0] = batch_axis
    spec[-1] = x_axis
    return NamedSharding(mesh, P(*spec))
