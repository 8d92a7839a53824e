"""Grid metrics: the L1 layer.

The reference builds xgcm grids with staggered metric bookkeeping
(/root/reference/xcontour/utils.py:43-259 ``add_latlon_metrics``,
utils.py:418-488 ``add_MITgcm_missing_metrics``).  Here the same information is
carried by a single frozen pytree of plain arrays — no staggered-grid object
model, because every consumer in the reference ultimately reads just four
things: cell areas ``dA``, zonal/meridional line elements ``dxF``/``dyF``, the
coordinate vectors, and periodicity.

Conventions
-----------
* The 2-D analysis plane is always the LAST TWO axes of a field, ordered
  ``(ydef, xdef)`` — e.g. (lat, lon) for horizontal planes or (Z, X) for
  vertical planes.  Leading axes are batch (time, level, ...).
* ``ydef`` is the *equivalent dimension* coordinate (latitude or depth).
* Areas follow the reference's exact spherical formula
  S = R^2 * |sin(phi_top) - sin(phi_bot)| * dlambda with pole clamping
  (utils.py:179-208), not the rectangle approximation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .utils.constants import Rearth as _REARTH


def _edges_from_centers(c: np.ndarray) -> np.ndarray:
    """Cell-edge positions: interior midpoints, end edges extrapolated by half
    the boundary spacing (semantics of xgcm.autogenerate's 'left' positions plus
    the closing right edge; reference utils.py:119-122)."""
    c = np.asarray(c, dtype=np.float64)
    e = np.empty(c.size + 1, dtype=np.float64)
    e[1:-1] = 0.5 * (c[:-1] + c[1:])
    e[0] = c[0] - 0.5 * (c[1] - c[0])
    e[-1] = c[-1] + 0.5 * (c[-1] - c[-2])
    return e


def is_periodic_lon(lon: np.ndarray, period: float = 360.0) -> bool:
    """Periodicity sniffing with the reference's 1e-4 relative-to-delta
    tolerance (utils.py:679-701)."""
    lon = np.asarray(lon, dtype=np.float64)
    if lon.size <= 1:
        return False
    delta = lon[1] - lon[0]
    start = lon[-1] + delta - period
    return bool(abs((start - lon[0]) / delta) <= 1e-4)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Grid:
    """Plane metrics for contour analysis.

    Data fields are arrays (leaves); ``dim_names``, ``latlon`` and
    ``periodic_x`` are static metadata so a :class:`Grid` can cross a ``jit``
    boundary unchanged.
    """

    ydef: jax.Array  # (Ny,)  equivalent-dim coordinate (deg lat, or m depth)
    xdef: jax.Array  # (Nx,)  along-plane coordinate (deg lon, or m)
    dA: jax.Array    # (Ny, Nx) cell areas (m^2)
    dxF: jax.Array   # (Ny, Nx) x line element through cell center (m)
    dyF: jax.Array   # (Ny, Nx) y line element through cell center (m)
    mask: Optional[jax.Array] = None  # (Ny, Nx) 1=fluid, 0=solid; None => all fluid
    dim_names: Tuple[str, str] = dataclasses.field(
        default=("y", "x"), metadata=dict(static=True))
    latlon: bool = dataclasses.field(default=False, metadata=dict(static=True))
    periodic_x: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # Y-wall boundary condition for finite-difference stencils on this grid
    # ('extend' or 'reflect'); selected by the metric builders' ``boundary``
    # kwarg (reference utils.py:96-116) and consumed by ops.stencil.
    bc_y: str = dataclasses.field(default="extend", metadata=dict(static=True))

    # ---- derived helpers -------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.ydef.shape[0], self.xdef.shape[0])

    def fluid_mask(self, dtype=jnp.float32) -> jax.Array:
        if self.mask is None:
            return jnp.ones(self.shape, dtype)
        return self.mask.astype(dtype)

    def total_area(self) -> jax.Array:
        return jnp.sum(self.dA * self.fluid_mask(self.dA.dtype))

    def integrate(self, field: jax.Array) -> jax.Array:
        """NaN-skipping area integral over the plane (reference core.py:1358-1378
        composed with xarray's skipna-by-default sum)."""
        return jnp.nansum(field * self.dA, axis=(-2, -1))


def from_latlon(lat, lon, Rearth: float = _REARTH,
                mask: Optional[np.ndarray] = None,
                dim_names: Tuple[str, str] = ("latitude", "longitude"),
                dtype=jnp.float32, exact_area: bool = True,
                bc_y: str = "extend") -> Grid:
    """Spherical metrics from 1-D lat/lon center coordinates (degrees).

    Mirrors the math of the reference ``add_latlon_metrics``
    (utils.py:43-259): exact spherical cell areas with pole clamping, and dxF
    as the Y-average of the edge zonal elements with the cos(±90) threshold
    (utils.py:641-645).  ``exact_area=False`` selects the legacy rectangle
    areas rA = dyF * dxF of ``add_latlon_metrics_old`` (utils.py:261-415).
    """
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    if lat.size > 1 and lat[0] > lat[-1]:
        import warnings
        warnings.warn(
            "from_latlon: latitude is DESCENDING (the ERA5 90..-90 storage "
            "convention).  The contour chain accumulates area from the "
            "south pole (reference semantics) and will return wrong "
            "equivalent latitudes / LWA on descending rows — flip the "
            "coordinate and the field rows to ascending first (the batch "
            "CLI does this automatically).", stacklevel=2)
    latE = _edges_from_centers(lat)
    lonE = _edges_from_centers(lon)
    periodic = is_periodic_lon(lon)

    d2r = np.pi / 180.0
    # clamp edge latitudes into [-90, 90] (utils.py:186-189 pole processing)
    latEc = np.clip(latE, -90.0, 90.0)
    dlam = np.diff(lonE)  # (Nx,) in degrees
    if periodic:
        dlam = np.where(dlam < 0, dlam + 360.0, dlam)
        dlam = np.where(dlam > 360.0, dlam - 360.0, dlam)

    # zonal line elements at edges, pole-clamped (utils.py:638-645)
    dxG = np.cos(latEc * d2r)[:, None] * dlam[None, :] * d2r * Rearth
    dxG = np.abs(dxG)
    dxG = np.where(dxG < 1e-15, 0.0, dxG)
    dxF = 0.5 * (dxG[:-1, :] + dxG[1:, :])

    # |diff|: dyF is a LINE ELEMENT (m, positive) — descending-latitude files
    # (the ERA5 90..-90 convention) must not sign-flip the LWA 'dy' metric or
    # the legacy rectangle areas (directional spacing for gradients comes
    # from ops.stencil._spacing, which keeps the coordinate's sign)
    dyF = np.abs(np.diff(latE) * d2r * Rearth)[:, None] \
        * np.ones_like(dlam)[None, :]

    if exact_area:
        # exact spherical areas: R^2 |sin(phi1)-sin(phi2)| dlambda (utils.py:190)
        sinphi = np.sin(latEc * d2r)
        band = np.abs(np.diff(sinphi))  # (Ny,)
        rA = (Rearth * Rearth) * band[:, None] * (dlam[None, :] * d2r)
    else:
        # legacy rectangle areas rA = dyF * dxF (utils.py:361)
        rA = dyF * dxF

    return Grid(
        ydef=jnp.asarray(lat, dtype), xdef=jnp.asarray(lon, dtype),
        dA=jnp.asarray(rA, dtype), dxF=jnp.asarray(dxF, dtype),
        dyF=jnp.asarray(dyF, dtype),
        mask=None if mask is None else jnp.asarray(mask, dtype),
        dim_names=dim_names, latlon=True, periodic_x=periodic, bc_y=bc_y)


def from_cartesian(y, x, mask: Optional[np.ndarray] = None,
                   dim_names: Tuple[str, str] = ("y", "x"),
                   periodic_x: bool = False, dtype=jnp.float32) -> Grid:
    """Cartesian plane metrics from 1-D coordinates in meters."""
    y = np.asarray(y, np.float64)
    x = np.asarray(x, np.float64)
    dy = np.abs(np.diff(_edges_from_centers(y)))
    dx = np.abs(np.diff(_edges_from_centers(x)))
    dA = dy[:, None] * dx[None, :]
    return Grid(
        ydef=jnp.asarray(y, dtype), xdef=jnp.asarray(x, dtype),
        dA=jnp.asarray(dA, dtype),
        dxF=jnp.asarray(np.broadcast_to(dx[None, :], dA.shape), dtype),
        dyF=jnp.asarray(np.broadcast_to(dy[:, None], dA.shape), dtype),
        mask=None if mask is None else jnp.asarray(mask, dtype),
        dim_names=dim_names, latlon=False, periodic_x=periodic_x)


def from_xz(z, x, hFacC: Optional[np.ndarray] = None,
            mask: Optional[np.ndarray] = None,
            dim_names: Tuple[str, str] = ("Z", "XC"),
            periodic_x: bool = True, dtype=jnp.float32) -> Grid:
    """Vertical-plane (X-Z) metrics, MITgcm style.

    ``dA`` is the X-Z face area yA = drF * hFacC * dxF with partial cells
    (reference utils.py:468-470); drF/drG construction follows
    utils.py:210-221.
    """
    z = np.asarray(z, np.float64)
    x = np.asarray(x, np.float64)
    dx = np.abs(np.diff(_edges_from_centers(x)))
    # drF: level thicknesses from center diffs (utils.py:211-218)
    tmp = np.diff(z)
    tmp = np.concatenate([[z[0] - tmp[0]], z])
    drF = np.abs(np.diff(tmp))
    hf = np.ones((z.size, x.size)) if hFacC is None else np.asarray(hFacC, np.float64)
    yA = drF[:, None] * hf * dx[None, :]
    return Grid(
        ydef=jnp.asarray(z, dtype), xdef=jnp.asarray(x, dtype),
        dA=jnp.asarray(yA, dtype),
        dxF=jnp.asarray(np.broadcast_to(dx[None, :], yA.shape), dtype),
        dyF=jnp.asarray(np.broadcast_to(drF[:, None], yA.shape) * hf, dtype),
        mask=None if mask is None else jnp.asarray(mask, dtype),
        dim_names=dim_names, latlon=False, periodic_x=periodic_x)


def from_metrics(ydef, xdef, dA, dxF=None, dyF=None, mask=None,
                 dim_names: Tuple[str, str] = ("y", "x"), latlon: bool = False,
                 periodic_x: bool = False, dtype=jnp.float32) -> Grid:
    """Wrap externally supplied metrics (e.g. read from an MITgcm dataset)."""
    dA = jnp.asarray(dA, dtype)
    if dxF is None:
        dxF = jnp.ones_like(dA)
    if dyF is None:
        dyF = jnp.ones_like(dA)
    # MITgcm squeezed slices carry 1-D distances (e.g. dxF on (XC,) for an
    # X-Z plane); normalize to the plane shape so every consumer can index
    dxF = jnp.broadcast_to(jnp.asarray(dxF, dtype), dA.shape)
    dyF = jnp.broadcast_to(jnp.asarray(dyF, dtype), dA.shape)
    return Grid(
        ydef=jnp.asarray(ydef, dtype), xdef=jnp.asarray(xdef, dtype),
        dA=dA, dxF=jnp.asarray(dxF, dtype), dyF=jnp.asarray(dyF, dtype),
        mask=None if mask is None else jnp.asarray(mask, dtype),
        dim_names=dim_names, latlon=latlon, periodic_x=periodic_x)


def to_host(grid: Grid) -> Grid:
    """The same grid with HOST (numpy) leaves.

    A jitted function that *closes over* a grid embeds its metric arrays as
    trace-time constants; when those leaves are device-resident, XLA's
    constant handler fetches each one device->host during lowering.  Numpy
    leaves embed with no device traffic at all.  Grids passed as jit
    *arguments* don't need this (they are traced, not embedded)."""
    return jax.tree_util.tree_map(np.asarray, grid)


def equivalent_latitudes(areas, Rearth: float = _REARTH):
    """lat_eq from contour-enclosed area: 2*pi*R^2*(sin(latEq)+1) = area,
    clipped into [-1, 1] (reference utils.py:491-515)."""
    ratio = areas / (2.0 * np.pi * Rearth * Rearth) - 1.0
    ratio = jnp.clip(ratio, -1.0, 1.0)
    return jnp.rad2deg(jnp.arcsin(ratio)).astype(jnp.asarray(areas).dtype)


def latitude_lengths_at(lats, Rearth: float = _REARTH):
    """Minimum possible contour length at given latitudes: 2*pi*R*cos(lat)
    (reference utils.py:518-534)."""
    lats = jnp.asarray(lats)
    return (2.0 * np.pi * Rearth * jnp.cos(jnp.deg2rad(lats))).astype(lats.dtype)
