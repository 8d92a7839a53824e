"""Spatially sharded contour perimeter lengths: halo + local cells + psum.

Marching-squares cells are local except at shard boundaries, where a cell
spans the last local column and the right neighbor's first column.  Under
shard_map each device fetches that single column over NVLink (`lax.ppermute`),
evaluates its own cells with the ordinary traversal-free kernel, and a psum
of the (N,)-vector totals finishes the reduction — the spatial-decomposition
plan of SURVEY.md §2.4 applied to the geometry path (reference
core.py:969-1014 semantics).

The global cell set is columns 0..Nx-2 (no periodic seam cell — matching the
single-device path and skimage): the last shard's wrapped halo column is
NaN-masked so its phantom seam cells vanish through the standard NaN rule.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..diagnostics.length import _level_total_length
from ..utils.constants import Rearth as _REARTH


def sharded_contour_lengths(data: jax.Array, contours: jax.Array,
                            ydef: jax.Array, xdef: jax.Array, mesh: Mesh, *,
                            latlon: bool = False, Rearth: float = _REARTH,
                            batch_axis: str = "batch", x_axis: str = "x"):
    """Perimeter of each contour level with the grid X axis sharded.

    data : (B, Ny, Nx) sharded (batch, -, x); contours : (B, N) or (N,)
    replicated; ydef/xdef coordinate vectors (degrees if latlon).
    Returns (B, N), sharded over batch, replicated over x — matching
    diagnostics.length.contour_lengths exactly.
    """
    B, Ny, Nx = data.shape
    yc = jnp.deg2rad(ydef) if latlon else ydef
    xc = jnp.deg2rad(xdef) if latlon else xdef
    yc = yc.astype(data.dtype)
    xc = xc.astype(data.dtype)
    ctr = jnp.broadcast_to(contours, (B, contours.shape[-1]))
    N = ctr.shape[-1]
    nsh = mesh.shape[x_axis]
    assert Nx % nsh == 0, "X axis must divide evenly across the mesh"
    nxl = Nx // nsh
    # one wrap column so the coordinate slice below stays in bounds for the
    # last shard (its phantom cells are NaN-masked anyway)
    xpad = jnp.concatenate([xc, xc[:1]])

    def local(qs, cs):
        # qs: (Bl, Ny, nxl).  Fetch the right neighbor's first column.
        idx = jax.lax.axis_index(x_axis)
        left_shift = [(i, (i - 1) % nsh) for i in range(nsh)]
        halo = jax.lax.ppermute(qs[..., :1], x_axis, left_shift)
        # the last shard's halo wrapped around the seam: mask it to NaN so
        # the seam cells do not exist (single-device parity)
        halo = jnp.where(idx == nsh - 1, jnp.nan, halo)
        ext = jnp.concatenate([qs, halo], axis=-1)       # (Bl, Ny, nxl+1)

        xl = jax.lax.dynamic_slice(xpad, (idx * nxl,), (nxl + 1,))
        v00 = ext[..., :-1, :-1]
        v01 = ext[..., :-1, 1:]
        v10 = ext[..., 1:, :-1]
        v11 = ext[..., 1:, 1:]
        nan_cell = (jnp.isnan(v00) | jnp.isnan(v01) | jnp.isnan(v10)
                    | jnp.isnan(v11))
        shape = v00.shape[-2:]
        y0 = jnp.broadcast_to(yc[:-1, None], shape)
        y1 = jnp.broadcast_to(yc[1:, None], shape)
        x0 = jnp.broadcast_to(xl[None, :-1], shape)
        x1 = jnp.broadcast_to(xl[None, 1:], shape)

        def one_level(k):
            c = cs[:, k][:, None, None]
            return _level_total_length(c, v00, v01, v10, v11, y0, y1, x0, x1,
                                       nan_cell, latlon)

        totals = jax.lax.map(one_level, jnp.arange(N))   # (N, Bl)
        totals = jnp.moveaxis(totals, 0, -1)             # (Bl, N)
        return jax.lax.psum(totals, x_axis)              # N floats over NVLink

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(batch_axis, None, x_axis), P(batch_axis, None)),
        out_specs=P(batch_axis, None))
    totals = fn(data, ctr)
    totals = jnp.where(totals == 0.0, jnp.nan, totals)
    return totals * Rearth if latlon else totals
