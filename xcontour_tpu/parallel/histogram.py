"""Explicitly sharded weighted-histogram CDF: local bincount + psum.

The histogram is the one reduction in the framework whose input (the full
grid) may be sharded spatially.  Under shard_map each device bins only its
local X slab — the bins are replicated, tiny (N ~ 10^2), and the psum over the
'x' axis moves just N floats per device over NVLink, after which the prefix scan
and lt/gt flip run replicated.  This is the hand-written equivalent of what
GSPMD derives for the jit path; it exists so the collective layout is explicit
and testable (SURVEY.md §5, distributed communication plan).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.histogram import bincount_single, cdf_from_hist


def sharded_weighted_cdf(values: jax.Array, bins: jax.Array,
                         weights: jax.Array, lt: bool, mesh: Mesh,
                         batch_axis: str = "batch", x_axis: str = "x"):
    """Batched weighted CDF with the grid X axis sharded over ``x_axis`` and
    the snapshot batch over ``batch_axis``.

    values/weights: (B, Ny, Nx); bins: (N,) replicated.
    Returns (B, N) replicated over 'x', sharded over 'batch'.
    """

    def _local(v, b, w):
        # v, w: (B_local, Ny, Nx_local); b: (N,)
        def one(vi, wi):
            hist, binc = bincount_single(vi.ravel(), b, wi.ravel())
            return hist, binc
        hist, binc = jax.vmap(one)(v, w)
        hist = jax.lax.psum(hist, x_axis)          # N floats over NVLink
        return cdf_from_hist(hist, binc[:, None], lt)

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(batch_axis, None, x_axis), P(), P(batch_axis, None, x_axis)),
        out_specs=P(batch_axis, None),
        check_vma=False)
    return fn(values, bins, jnp.broadcast_to(weights, values.shape))
