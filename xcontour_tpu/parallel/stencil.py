"""Halo-exchange finite-difference stencil for spatially sharded grids.

When the X axis of the plane is sharded across the mesh, the centered
difference at shard boundaries needs each neighbor's edge column.  Under
shard_map that is one `lax.ppermute` per direction — a single-column
(Ny x 1) message to the ring neighbor over NVLink — after which the stencil is
the ordinary local computation (SURVEY.md §2.4 spatial-decomposition plan).

GSPMD derives an equivalent program for `jnp.roll` automatically; this module
is the explicit, testable version of that collective layout, and the pattern
blocks for multi-host meshes where the X axis should stay within a host.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..grid import Grid
from ..utils.constants import Rearth as _REARTH


def sharded_squared_gradient(q: jax.Array, grid: Grid, mesh: Mesh,
                             batch_axis: str = "batch", x_axis: str = "x"):
    """|grad q|^2 with q (B, Ny, Nx) sharded (batch, -, x) over the mesh.

    Matches ops.stencil.squared_gradient for THIS grid's flags: periodic X
    rides the halo exchange; non-periodic X takes one-sided differences at
    the global edge columns (only on the first/last shard); the Y wall BC
    is the grid's ``bc_y`` ('extend'/'reflect'/'fill'), evaluated by the
    same ``ops.stencil._centered_y`` the single-device path uses.
    Each shard must hold at least 2 columns.
    """
    y = grid.ydef
    x = grid.xdef
    gy = jnp.gradient(y.astype(q.dtype))
    gx = jnp.gradient(x.astype(q.dtype))
    if grid.latlon:
        d2r = np.pi / 180.0
        dy = gy * d2r * _REARTH
        dx_row = gx * d2r * _REARTH
        coslat = jnp.cos(y.astype(q.dtype) * d2r)
    else:
        dy = gy
        dx_row = gx
        coslat = jnp.ones_like(y, q.dtype)

    nshards = mesh.shape[x_axis]
    if not grid.periodic_x and q.shape[-1] // nshards < 2:
        raise ValueError(
            f"non-periodic sharded stencil needs >= 2 columns per shard; "
            f"Nx={q.shape[-1]} over {nshards} shards gives "
            f"{q.shape[-1] // nshards}")

    from ..ops.stencil import _centered_y

    def local(qs, dxs):
        # qs: (Bl, Ny, Nxl); halo exchange one column each way over the ring
        idx = jax.lax.axis_index(x_axis)
        nsh = nshards
        right = [(i, (i + 1) % nsh) for i in range(nsh)]
        left = [(i, (i - 1) % nsh) for i in range(nsh)]
        from_left = jax.lax.ppermute(qs[..., -1:], x_axis, right)
        from_right = jax.lax.ppermute(qs[..., :1], x_axis, left)
        ext = jnp.concatenate([from_left, qs, from_right], axis=-1)
        num = (ext[..., 2:] - ext[..., :-2]) * 0.5
        if not grid.periodic_x:
            # global edge columns live only on the first/last shard: replace
            # the wrapped halo difference with the one-sided full difference
            # (ops.stencil._centered_x non-periodic walls)
            one0 = qs[..., 1:2] - qs[..., 0:1]
            one1 = qs[..., -1:] - qs[..., -2:-1]
            num = jnp.concatenate(
                [jnp.where(idx == 0, one0, num[..., :1]), num[..., 1:-1],
                 jnp.where(idx == nsh - 1, one1, num[..., -1:])], axis=-1)
        qx = num / dxs
        qy = _centered_y(qs, grid.bc_y) / dy[:, None]
        return qx * qx + qy * qy

    dx2d = coslat[:, None] * dx_row[None, :]
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(batch_axis, None, x_axis), P(None, x_axis)),
        out_specs=P(batch_axis, None, x_axis))
    return fn(q, dx2d)
