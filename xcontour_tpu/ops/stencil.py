"""Finite-difference gradients on the analysis plane.

The reference drivers obtain |grad q|^2 from external packages (GeoApps
``Dynamics.cal_squared_gradient`` / xinvert ``FiniteDiff``, e.g.
/root/reference/tests/test_Keff_atmos.py:51-55) that are not part of the
reference repo.  This module supplies those semantics natively: second-order
centered differences, periodic or extended boundaries, spherical metric
dx = R cos(lat) dlon.  The NumPy oracle (compat.squared_gradient) defines the
exact discretization; this matches it in jnp.

For sharded grids, halo exchange lives in ``parallel/`` — this single-device
stencil is what runs inside each shard.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid
from ..utils.constants import Rearth as _REARTH


def _spacing(grid: Grid, dtype):
    """Physical grid spacings matching compat.squared_gradient: per-axis
    center-difference spacing (np.gradient of the coordinate vectors)."""
    y = grid.ydef.astype(dtype)
    x = grid.xdef.astype(dtype)
    gy = jnp.gradient(y)
    gx = jnp.gradient(x)
    if grid.latlon:
        d2r = np.pi / 180.0
        dy = gy * d2r * _REARTH
        dx = jnp.cos(y * d2r)[:, None] * (gx * d2r * _REARTH)[None, :]
    else:
        dy = gy
        dx = jnp.broadcast_to(gx[None, :], (y.shape[0], x.shape[0]))
    return dy, dx


def _centered_x(q, periodic: bool):
    if periodic:
        return (jnp.roll(q, -1, axis=-1) - jnp.roll(q, 1, axis=-1)) * 0.5
    interior = (q[..., 2:] - q[..., :-2]) * 0.5
    first = q[..., 1:2] - q[..., 0:1]
    last = q[..., -1:] - q[..., -2:-1]
    return jnp.concatenate([first, interior, last], axis=-1)


def _centered_y(q, bc: str = "extend"):
    interior = (q[..., 2:, :] - q[..., :-2, :]) * 0.5
    if bc == "extend":
        # replicate-pad then center == one-sided full difference at the walls
        first = q[..., 1:2, :] - q[..., 0:1, :]
        last = q[..., -1:, :] - q[..., -2:-1, :]
    elif bc == "reflect":
        # mirror-pad: the ghost row equals the first interior row, so the
        # centered difference at the wall vanishes for symmetric fields
        # (xinvert FiniteDiff's 'reflect' BC, tests/test_Keff_atmos.py:52)
        first = (q[..., 1:2, :] - q[..., 1:2, :]) * 0.0
        last = first
    elif bc == "fill":
        # zero-pad (xgcm 'fill'): the ghost row is 0
        first = q[..., 1:2, :] * 0.5
        last = -q[..., -2:-1, :] * 0.5
    else:
        raise ValueError(f"unknown y boundary condition {bc!r}")
    return jnp.concatenate([first, interior, last], axis=-2)


def gradient(q: jax.Array, grid: Grid, bc_y: str | None = None):
    """(dq/dy, dq/dx) in physical units on the plane (..., Ny, Nx).

    ``bc_y``: 'extend' (one-sided walls) or 'reflect' (zero normal gradient
    at the walls, the pole-safe choice for scalar fields); None selects the
    grid's ``bc_y`` (wired from the metric builders' ``boundary`` kwarg)."""
    if bc_y is None:
        bc_y = grid.bc_y
    dy, dx = _spacing(grid, q.dtype)
    qx = _centered_x(q, grid.periodic_x) / dx
    qy = _centered_y(q, bc_y) / dy[:, None]
    return qy, qx


def squared_gradient(q: jax.Array, grid: Grid, bc_y: str | None = None) -> jax.Array:
    """|grad q|^2 (the Keff integrand), matching compat.squared_gradient."""
    qy, qx = gradient(q, grid, bc_y)
    return qx * qx + qy * qy
