"""Sharded windowed (local) contour lengths: gather grid, shard windows.

The windowed workload (reference tests/test_localLength.py:41-69, re-designed
in diagnostics/local_length.py) is compute-dominated by the per-window
marching-squares evaluation — O(n_windows * window^2) — while its operand is
one (Ny, Nx) snapshot.  The natural decomposition is therefore
gather-then-compute: each device `all_gather`s the X-sharded tracer once over
NVLink (the only collective; cheap relative to the window evaluations), the
flattened window-anchor list is block-sharded across the mesh axis, and each
device evaluates exactly its own chunk with the traversal-free cell kernel on
dynamic slices.  Window levels (the rolling means) come from the O(grid)
integral image, computed replicated — recomputing them everywhere is far
cheaper than communicating them.

For grids too large to replicate even transiently, the X-halo decomposition
of parallel/length.py applies instead; at the reference's actual scales
(<= ERA5) the gathered panel is a few MB and this form wins.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..diagnostics.local_length import (_cell_panels, _one_window_length,
                                        _window_centers, rolling_mean)
from ..utils.constants import Rearth as _REARTH


def sharded_local_lengths(data: jax.Array, ydef: jax.Array, xdef: jax.Array,
                          mesh: Mesh, *, window: int = 101, stride: int = 10,
                          latlon: bool = True, min_count: int = 1,
                          levels: jax.Array | None = None,
                          Rearth: float = _REARTH, axis: str = "x"):
    """Per-window contour length at the window-mean level, windows sharded
    over ``mesh.shape[axis]`` devices.

    data : (Ny, Nx), replicated or X-sharded over ``axis``; returns
    (lengths (Wy, Wx), window-center y, x coords) — identical to
    diagnostics.local_length.local_contour_lengths.
    """
    yc = jnp.deg2rad(ydef) if latlon else ydef
    xc = jnp.deg2rad(xdef) if latlon else xdef
    yc = yc.astype(data.dtype)
    xc = xc.astype(data.dtype)

    means, oy, ox = rolling_mean(data, window, stride, min_count)
    if levels is None:
        levels = means
    Wy, Wx = oy.shape[0], ox.shape[0]
    nw = Wy * Wx
    nsh = mesh.shape[axis]
    pad = (-nw) % nsh

    lv = jnp.concatenate(
        [levels.reshape(nw), jnp.full((pad,), jnp.nan, levels.dtype)])
    ys = jnp.concatenate([jnp.repeat(oy, Wx), jnp.zeros((pad,), oy.dtype)])
    xs = jnp.concatenate([jnp.tile(ox, Wy), jnp.zeros((pad,), ox.dtype)])
    W = window - 1                     # cells per window side

    Nx = data.shape[-1]
    assert Nx % nsh == 0, "X axis must divide evenly across the mesh"

    def local(dchunk, lvc, ysc, xsc):
        # one collective: reassemble the panel, then pure local compute
        # with the same window evaluation as the single-device XLA path
        d = jax.lax.all_gather(dchunk, axis, axis=1, tiled=True)   # (Ny, Nx)
        panels = _cell_panels(d, yc, xc)

        def one(args):
            y0, x0, level = args
            return _one_window_length(panels, W, y0, x0, level, latlon)

        return jax.lax.map(one, (ysc, xsc, lvc))

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(None, axis), P(axis), P(axis), P(axis)),
                       out_specs=P(axis))
    lengths = fn(data, lv, ys, xs)[:nw].reshape(Wy, Wx)
    if latlon:
        lengths = lengths * Rearth
    cy, cx = _window_centers(ydef, xdef, oy, ox, window)
    return lengths, cy, cx
