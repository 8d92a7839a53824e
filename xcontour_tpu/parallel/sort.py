"""Explicitly sharded EXACT (sort-based) conditional integrals.

Completes the SURVEY §2.4 plan ("global sort/CDF = local sort + merge") for
the exact path: ``ops.sort.exact_conditional_integral`` scales the reference's
strict conditional sums (/root/reference/xcontour/core.py:363-409) to one
device at O(G log G); this module scales it to a spatially sharded grid.

The merge is cheaper than a distributed sort: the conditional sum
F(c) = sum_{q <lt/gt> c} w splits elementwise across shards, so each device
sorts ONLY its local X slab (O(G_local log G_local)), prefix-sums the local
weights, reads the N level values off the local CDF, and a single ``psum``
of those N floats per batch element over the 'x' axis reconstructs the
exact global answer — no all-to-all, no global sort, values never leave
their shard.  Levels are few (N ~ 10^2) and replicated, exactly like the
sharded histogram engine (parallel/histogram.py).

Bitwise note: within a shard the summation order is the sorted order (same
as the single-device engine); across shards psum adds one partial per device.
Reassociation differences vs the single-device result are ~1 ulp of the
partial sums — asserted at f64 parity in tests/test_parallel.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.sort import exact_conditional_integral


def sharded_exact_conditional_integral(
        values: jax.Array, bins: jax.Array, weights: jax.Array, lt: bool,
        mesh: Mesh, batch_axis: str = "batch", x_axis: str = "x"):
    """Batched exact F(c) with the grid X axis sharded over ``x_axis`` and
    the snapshot batch over ``batch_axis``.

    values/weights: (B, Ny, Nx); bins: (N,) replicated or (B, N) batched.
    Returns (B, N) replicated over 'x', sharded over 'batch' — the exact
    twin of :func:`parallel.histogram.sharded_weighted_cdf`.
    """
    batched_bins = bins.ndim == 2
    bins_spec = P(batch_axis, None) if batched_bins else P()

    def _local(v, b, w):
        # v, w: (B_local, Ny, Nx_local); b: (N,) or (B_local, N).
        # Local slab: exact sort + prefix + searchsorted at the levels...
        part = exact_conditional_integral(v, b, w, lt)
        # ...then N floats per batch element over NVLink merge the shards
        return jax.lax.psum(part, x_axis)

    fn = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P(batch_axis, None, x_axis), bins_spec,
                  P(batch_axis, None, x_axis)),
        out_specs=P(batch_axis, None),
        check_vma=False)
    return fn(values, bins, jnp.broadcast_to(weights, values.shape))
