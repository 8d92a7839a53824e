"""End-to-end jitted workloads mirroring the reference driver scripts.

Each pipeline is one jit-compiled function over the whole diagnostic chain —
the composition the reference scripts build step-by-step through xarray
(tests/test_hist.py:16-101 ``computeKeff``/``computeKeff_hist``,
tests/test_Keff_atmos.py:58-92, tests/test_LWA.py:48-87) — so XLA fuses the
histogram, table lookups, interpolation and Keff algebra into a handful of
kernels, and batching over time/level is a leading array axis instead of a
Python loop.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .grid import Grid, latitude_lengths_at
from . import core
from .ops.stencil import squared_gradient, gradient
from .ops.interp import interp1d
from .diagnostics import lwa as _lwa
from .diagnostics import length as _length
from .diagnostics.fractal import fractal_dimension
from .utils.coarsen import coarsen
from .utils.constants import Rearth as _REARTH


@partial(jax.jit, static_argnames=("N", "increase", "lt", "hist", "lmin"))
def keff_pipeline(tracer: jax.Array, grid: Grid, grdS: Optional[jax.Array] = None,
                  mask: Optional[jax.Array] = None,
                  pre_y: Optional[jax.Array] = None, *, N: int = 251,
                  increase: bool = True, lt: bool = True, hist: bool = True,
                  lmin: str = "dxF", nkeff_mask: float = 2e7,
                  table: Optional[core.Table] = None) -> dict:
    """Full effective-diffusivity chain on (..., Ny, Nx) snapshots.

    Mirrors reference tests/test_hist.py:16-101: contours -> conditional
    area/gradient integrals -> A(Yeq) table lookup -> d/dA -> Leq^2 -> nkeff,
    plus interpolation onto ``pre_y``.

    lmin : 'dxF'      — masked zonal sum of dxF interpolated to Yeq
                        (tests/test_Keff_ocean.py:59-65);
           'analytic' — 2*pi*R*cos(Yeq) (tests/test_Keff_atmos.py:64);
           'frac'     — latitude_lengths_at(lat) * zonal fluid fraction
                        (tests/test_clength.py:78-85).
    """
    ydef = grid.ydef.astype(tracer.dtype)
    dA = grid.dA.astype(tracer.dtype)
    if mask is None:
        mask = grid.fluid_mask(tracer.dtype)
    if grdS is None:
        grdS = squared_gradient(tracer, grid)

    ctr = core.cal_contours(tracer, N, increase=increase)
    if hist:
        if table is None:
            table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                     increase=increase, lt=lt)
        # both conditional integrals share one digitize pass
        from .ops.histogram import weighted_cdf_multi
        intArea, intgrdS = weighted_cdf_multi(tracer, ctr, [dA, grdS * dA], lt)
    else:
        if table is None:
            table = core.cal_area_eqCoord_table(mask, ydef, dA,
                                                increase=increase, lt=lt)
        intArea = core.cal_integral_within_contours(tracer, ctr, dA, lt=lt)
        intgrdS = core.cal_integral_within_contours(tracer, ctr, dA, grdS,
                                                    lt=lt)
    Yeq = table.lookup_coordinates(intArea)

    if lmin == "analytic":
        Lmin = latitude_lengths_at(Yeq)
    elif lmin == "dxF":
        pre_lmin = jnp.sum(mask * grid.dxF.astype(tracer.dtype), axis=-1)
        Lmin = interp1d(Yeq, ydef, pre_lmin, increasing=ydef[-1] > ydef[0])
    elif lmin == "frac":
        lat_len = latitude_lengths_at(ydef)
        frac = jnp.sum(mask, axis=-1) / mask.shape[-1]
        Lmin = interp1d(Yeq, ydef, frac * lat_len,
                        increasing=ydef[-1] > ydef[0])
    else:
        raise ValueError(f"unknown lmin mode {lmin!r}")

    dgrdSdA = core.cal_gradient_wrt_area(intgrdS, intArea)
    dqdA = core.cal_gradient_wrt_area(ctr, intArea)
    Leq2 = core.cal_sqared_equivalent_length(dgrdSdA, dqdA)
    nkeff = core.cal_normalized_Keff(Leq2, Lmin, nkeff_mask)

    origin = dict(contour=ctr, intArea=intArea, Yeq=Yeq, intgrdS=intgrdS,
                  dgrdSdA=dgrdSdA, dqdA=dqdA, Leq2=Leq2, Lmin=Lmin,
                  nkeff=nkeff, table=table.values)
    out = dict(origin=origin)
    if pre_y is not None:
        pre_y = pre_y.astype(tracer.dtype)
        interp = {k: core.interp_to_coords(pre_y, Yeq, v)
                  for k, v in origin.items() if k != "table"}
        out["interp"] = interp
    return out


@partial(jax.jit, static_argnames=("N", "increase", "lt", "part", "metric",
                                   "lwa_method"))
def lwa_pipeline(tracer: jax.Array, grid: Grid,
                 mask: Optional[jax.Array] = None, *, N: int = 121,
                 increase: bool = True, lt: bool = True,
                 part: str = "all", metric: str = "dA",
                 lwa_method: str = "auto",
                 table: Optional[core.Table] = None) -> dict:
    """Sorted-state + local wave activity chain (tests/test_LWA.py:48-87):
    contours -> areas -> latEq -> sorted profile Q on the grid latitudes ->
    LWA and the impulse-Casimir variant.

    metric : 'dA' — the reference's literal wei*dA composition
             (core.py:723-724, 789);
             'dy' — wei*dyF, the physically-united (m/s) form the reference's
             commented-out grid metric intends (core.py:787-788).
    lwa_method : LWA execution path ('auto'|'lin'|'dense'|'fast', see
             diagnostics.lwa.local_wave_activity).  Accuracy policy: the
             default auto path ('lin' below the tall-grid crossover) has an
             f32 noise floor of ~5e-5 of the field max; 'dense' keeps the
             reference's exact summation order (~1e-6) at ~2x the cost.
             Both bounds are pinned by tests/test_lwa_fast.py::
             test_default_path_noise_floor_policy.
    """
    ydef = grid.ydef.astype(tracer.dtype)
    dA = grid.dA.astype(tracer.dtype)
    if metric == "dA":
        weight = None
    elif metric == "dy":
        weight = dA / jnp.nanmax(dA) * grid.dyF.astype(tracer.dtype)
    else:
        raise ValueError(f"unknown LWA metric {metric!r}")
    if mask is None:
        mask = grid.fluid_mask(tracer.dtype)

    if table is None:
        table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                 increase=increase, lt=lt)
    ctr = core.cal_contours(tracer, N, increase=increase)
    intArea = core.cal_integral_within_contours_hist(tracer, ctr, dA, lt=lt)
    latEq = table.lookup_coordinates(intArea)

    # sorted reference state Q on the original grid latitudes
    Q = core.interp_to_coords(ydef, latEq, ctr)

    lwa = _lwa.local_wave_activity(tracer, Q, dA, ydef,
                                   increase=increase, part=part, weight=weight,
                                   method=lwa_method)
    lwa2 = _lwa.local_wave_activity2(tracer, Q, dA, ydef,
                                     increase=increase, part=part,
                                     weight=weight, method=lwa_method)
    return dict(contour=ctr, intArea=intArea, latEq=latEq, Q=Q,
                lwa=lwa, lwa2=lwa2)


@partial(jax.jit, static_argnames=("N", "increase", "lt", "lmin", "metric",
                                   "with_lwa2", "lwa_method"))
def keff_lwa_pipeline(tracer: jax.Array, grid: Grid,
                      grdS: Optional[jax.Array] = None,
                      mask: Optional[jax.Array] = None,
                      pre_y: Optional[jax.Array] = None, *, N: int = 121,
                      increase: bool = True, lt: bool = True,
                      lmin: str = "analytic", metric: str = "dA",
                      with_lwa2: bool = False,
                      lwa_method: str = "auto",
                      table: Optional[core.Table] = None) -> dict:
    """The flagship combined step: full Keff chain + LWA from one shared
    sorted state (table, contours, areas computed once).  This is the
    BASELINE.json north-star workload — Keff + LWA over batches of global PV
    snapshots — as a single fused XLA program.

    ``table``: every pipeline accepts a precomputed A(Y_eq) table (a pytree,
    jit-friendly).  The table depends only on (mask, ydef, dA) — not the
    tracer — so production loops over many snapshots should build it once
    with core.cal_area_eqCoord_table_hist and pass it in; at ERA5 scale the
    in-pipeline rebuild is a 721-bin weighted CDF over the full grid per
    call."""
    ydef = grid.ydef.astype(tracer.dtype)
    dA = grid.dA.astype(tracer.dtype)
    if mask is None:
        mask = grid.fluid_mask(tracer.dtype)
    if grdS is None:
        grdS = squared_gradient(tracer, grid)

    if table is None:
        table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                 increase=increase, lt=lt)
    ctr = core.cal_contours(tracer, N, increase=increase)
    # area and |grad q|^2 integrals share one digitize pass
    from .ops.histogram import weighted_cdf_multi
    intArea, intgrdS = weighted_cdf_multi(tracer, ctr, [dA, grdS * dA], lt)
    Yeq = table.lookup_coordinates(intArea)

    if lmin == "analytic":
        Lmin = latitude_lengths_at(Yeq)
    elif lmin == "dxF":
        pre_lmin = jnp.sum(mask * grid.dxF.astype(tracer.dtype), axis=-1)
        Lmin = interp1d(Yeq, ydef, pre_lmin, increasing=ydef[-1] > ydef[0])
    elif lmin == "frac":
        lat_len = latitude_lengths_at(ydef)
        frac = jnp.sum(mask, axis=-1) / mask.shape[-1]
        Lmin = interp1d(Yeq, ydef, frac * lat_len,
                        increasing=ydef[-1] > ydef[0])
    else:
        raise ValueError(f"unknown lmin mode {lmin!r}")

    dgrdSdA = core.cal_gradient_wrt_area(intgrdS, intArea)
    dqdA = core.cal_gradient_wrt_area(ctr, intArea)
    Leq2 = core.cal_sqared_equivalent_length(dgrdSdA, dqdA)
    nkeff = core.cal_normalized_Keff(Leq2, Lmin, 2e7)

    Q = core.interp_to_coords(ydef, Yeq, ctr)
    weight = (dA / jnp.nanmax(dA) * grid.dyF.astype(tracer.dtype)
              if metric == "dy" else None)
    lwa = _lwa.local_wave_activity(tracer, Q, dA, ydef, increase=increase,
                                   part="all", weight=weight,
                                   method=lwa_method)
    out = dict(contour=ctr, intArea=intArea, intgrdS=intgrdS, Yeq=Yeq,
               Lmin=Lmin, Leq2=Leq2, nkeff=nkeff, Q=Q, lwa=lwa)
    if with_lwa2:
        out["lwa2"] = _lwa.local_wave_activity2(tracer, Q, dA, ydef,
                                                increase=increase, part="all",
                                                weight=weight,
                                                method=lwa_method)
    if pre_y is not None:
        pre_y = pre_y.astype(tracer.dtype)
        for k in ("Leq2", "nkeff", "Lmin"):
            out[k + "_at"] = core.interp_to_coords(pre_y, Yeq, out[k])
    return out


@partial(jax.jit, static_argnames=("N", "increase", "lt"))
def clength_pipeline(tracer: jax.Array, grid: Grid,
                     mask: Optional[jax.Array] = None, *, N: int = 121,
                     increase: bool = True, lt: bool = True,
                     table: Optional[core.Table] = None) -> dict:
    """Contour-length workload (reference tests/test_clength.py:74-108):
    perimeter lengths L, equivalent length L_eq, minimum length L_min, and
    the Cauchy-Schwarz contour means of |grad q| and 1/|grad q|.

    The nb4 cell-0 inequality chain L_eq >= L >= L_min is the physical
    invariant consumers check.
    """
    ydef = grid.ydef.astype(tracer.dtype)
    dA = grid.dA.astype(tracer.dtype)
    if mask is None:
        mask = grid.fluid_mask(tracer.dtype)
    qy, qx = gradient(tracer, grid)
    grdS = qx * qx + qy * qy
    grdm = jnp.sqrt(grdS)

    if table is None:
        table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                 increase=increase, lt=lt)
    ctr = core.cal_contours(tracer, N, increase=increase)
    intArea = core.cal_integral_within_contours_hist(tracer, ctr, dA, lt=lt)
    intgrdS = core.cal_integral_within_contours_hist(tracer, ctr, dA, grdS,
                                                     lt=lt)
    Yeq = table.lookup_coordinates(intArea)

    lengths = _length.contour_lengths(tracer, ctr, grid.ydef, grid.xdef,
                                      latlon=grid.latlon)
    lat_len = latitude_lengths_at(ydef)
    frac = jnp.sum(mask, axis=-1) / mask.shape[-1]
    Lmin = interp1d(Yeq, ydef, frac * lat_len, increasing=ydef[-1] > ydef[0])

    cmGrd = core.cal_contour_mean_hist(tracer, ctr, dA, grdm, grdm,
                                       intArea, lt=lt)
    cmInvGrd = core.cal_contour_mean_hist(tracer, ctr, dA, 1.0 / grdm, grdm,
                                          intArea, lt=lt)
    dgrdSdA = core.cal_gradient_wrt_area(intgrdS, intArea)
    dqdA = core.cal_gradient_wrt_area(ctr, intArea)
    Leq2 = core.cal_sqared_equivalent_length(dgrdSdA, dqdA)
    nkeff = core.cal_normalized_Keff(Leq2, Lmin, 1e5)
    return dict(contour=ctr, intArea=intArea, Yeq=Yeq, lengths=lengths,
                Lmin=Lmin, Leq2=Leq2, nkeff=nkeff, cmGrd=cmGrd,
                cmInvGrd=cmInvGrd)


def fractal_pipeline(tracer: jax.Array, grid: Grid, *, N: int = 121,
                     strides=(1, 2, 4, 8, 16, 32), increase: bool = True,
                     lt: bool = True, box_counting: bool = True,
                     table: Optional[core.Table] = None) -> dict:
    """Fractal-dimension workload (reference tests/test_fractal.py:52-115):
    contour lengths on a ladder of grid coarsenings (and optionally
    box-counting crossing lengths), log-log slope -> D per contour.

    Rulers follow the reference: stride * cos(latEq) * dlon * R
    (tests/test_fractal.py:105).
    """
    ydef = grid.ydef.astype(tracer.dtype)
    dA = grid.dA.astype(tracer.dtype)
    mask = grid.fluid_mask(tracer.dtype)

    if table is None:
        table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                 increase=increase, lt=lt)
    ctr = core.cal_contours(tracer, N, increase=increase)
    intArea = core.cal_integral_within_contours_hist(tracer, ctr, dA, lt=lt)
    Yeq = table.lookup_coordinates(intArea)

    lengths = []
    for s in strides:
        ts = coarsen(tracer, s)
        ys = coarsen(grid.ydef.astype(tracer.dtype)[None, :], 1)[0] if s == 1 \
            else jnp.mean(grid.ydef.astype(tracer.dtype).reshape(-1, s), axis=1)
        xs = grid.xdef.astype(tracer.dtype) if s == 1 \
            else jnp.mean(grid.xdef.astype(tracer.dtype).reshape(-1, s), axis=1)
        lengths.append(_length.contour_lengths(ts, ctr, ys, xs,
                                               latlon=grid.latlon))
    L = jnp.stack(lengths, axis=-1)                    # (..., N, S)

    reso = grid.xdef[1] - grid.xdef[0]
    rulers = (jnp.asarray(strides, tracer.dtype) *
              jnp.cos(jnp.deg2rad(Yeq))[..., None] *
              jnp.deg2rad(reso).astype(tracer.dtype) * _REARTH)
    D = fractal_dimension(L, rulers)

    out = dict(contour=ctr, Yeq=Yeq, lengths=L, rulers=rulers, D=D)
    if box_counting:
        bc = _length.contour_crossing(tracer, ctr, dA, list(strides))
        out["bclens"] = jnp.stack(bc, axis=-1)
        out["D_bc"] = fractal_dimension(out["bclens"], rulers)
    return out


# ---------------------------------------------------------------------------
# labeled outputs — the reference pipelines return coordinate-labeled
# Datasets (core.py:251-266, interp_to_dataset core.py:1017-1047); this
# converts the raw pipeline dicts into the same shape end-to-end.
# ---------------------------------------------------------------------------
_ATTRS = {
    "levels": dict(long_name="contour level value"),
    "intArea": dict(long_name="area enclosed by contour", units="m2"),
    "intgrdS": dict(long_name="integral of |grad q|^2 within contour"),
    "Yeq": dict(long_name="equivalent coordinate of contour"),
    "Lmin": dict(long_name="minimum possible contour length", units="m"),
    "Leq2": dict(long_name="squared equivalent length", units="m2"),
    "nkeff": dict(long_name="normalized effective diffusivity Keff/Lmin^2"),
    "Q": dict(long_name="sorted tracer profile on the equivalent coordinate"),
    "lwa": dict(long_name="local finite-amplitude wave activity"),
    "lwa2": dict(long_name="local wave activity (impulse-Casimir form)"),
    "lengths": dict(long_name="contour perimeter length", units="m"),
    "cmGrd": dict(long_name="contour mean of |grad q|"),
    "cmInvGrd": dict(long_name="contour mean of 1/|grad q|"),
    "D": dict(long_name="fractal dimension (marching-squares lengths)"),
    "D_bc": dict(long_name="fractal dimension (box counting)"),
    "rulers": dict(long_name="box-counting ruler length", units="m"),
    "bclens": dict(long_name="box-counting crossing length", units="m"),
}


def flatten_output(out: dict) -> dict:
    """Flatten a pipeline output dict to plain name -> array.

    Nested sections use the labeled-output naming convention: ``origin``
    children keep their bare names, ``interp`` children get an ``_at``
    suffix (the reference's interp_to_dataset variables, core.py:1017-1047),
    any other section is prefixed.  Non-array leaves (Table pytrees) are
    dropped.  This is the step-output shape ``runner.run_batched`` and the
    CLI stream, and the input :func:`as_dataset` labels."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                name = k2 if k == "origin" else f"{k2}_at" if k == "interp" \
                    else f"{k}_{k2}"
                flat[name] = v2
        else:
            flat[k] = v
    return {k: v for k, v in flat.items()
            if hasattr(v, "shape") and not hasattr(v, "lookup_coordinates")}


def as_dataset(out: dict, grid: Grid, pre_y=None,
               batch_dims: tuple = ("time",), extra_coords: dict = None,
               dim_hints: dict = None):
    """Label a pipeline output dict with coordinates, returning an
    :class:`xcontour_tpu.utils.ncio.Dataset` ready for ``.to_nc3()`` /
    ``.to_nc4()``.

    Dim inference (documented heuristic): trailing ``grid.shape`` axes are
    the plane (``grid.dim_names``); a trailing axis matching ``len(pre_y)``
    on interp-section / ``*_at`` variables is the predefined equivalent
    coordinate; a trailing axis matching the contour count is ``contour``
    (coordinate = level index, like the reference core.py:241-249); a
    trailing axis matching Ny is the equivalent dim (sorted profiles Q);
    leading axes are ``batch_dims``.  ``dim_hints`` overrides per variable.
    """
    import numpy as np
    from .utils.ncio import Dataset

    ydim, xdim = grid.dim_names
    Ny, Nx = grid.shape
    hints = dict(Q=(ydim,))
    hints.update(dim_hints or {})

    # flatten the keff_pipeline origin/interp sections
    flat = flatten_output(out)

    N = int(flat["contour"].shape[-1]) if "contour" in flat else None
    # the 'contour' DIM is the level index (reference core.py:241-249); the
    # level values themselves are stored as 'levels' so the names don't clash
    if "contour" in flat:
        flat["levels"] = flat.pop("contour")
    if "contour_at" in flat:
        flat["levels_at"] = flat.pop("contour_at")
    P = None if pre_y is None else int(np.asarray(pre_y).shape[0])

    ds = Dataset()
    ds.coords[ydim] = np.asarray(grid.ydef)
    ds.coords[xdim] = np.asarray(grid.xdef)
    if N is not None:
        ds.coords["contour"] = np.arange(N, dtype=np.int32)
    pdim = None
    if P is not None:
        # the interp coordinate gets its own dim unless it IS the grid's
        # equivalent coordinate (never alias two different axes to one name)
        same = P == Ny and np.array_equal(np.asarray(pre_y),
                                          np.asarray(grid.ydef))
        pdim = ydim if same else f"{ydim}_interp"
        ds.coords[pdim] = np.asarray(pre_y)
    for cname, cvals in (extra_coords or {}).items():
        ds.coords[cname] = np.asarray(cvals)

    stride_vars = ("lengths", "bclens", "rulers")
    for name, arr in flat.items():
        a = np.asarray(arr)
        tail = list(hints.get(name, ()))
        if not tail:
            shape = a.shape
            if len(shape) >= 2 and shape[-2:] == (Ny, Nx):
                tail = [ydim, xdim]
            elif len(shape) >= 2 and N is not None and shape[-2] == N and \
                    name in stride_vars:
                # fractal-ladder outputs carry a trailing stride axis
                tail = ["contour", "stride"]
                if "stride" not in ds.coords:
                    ds.coords["stride"] = np.arange(shape[-1])
            elif shape and pdim is not None and shape[-1] == P and \
                    (name.endswith("_at") or P != N):
                tail = [pdim]
            elif shape and N is not None and shape[-1] == N:
                tail = ["contour"]
            elif shape and shape[-1] == Ny:
                tail = [ydim]
        lead_shape = a.shape[:a.ndim - len(tail)]
        lead = [batch_dims[i] if i < len(batch_dims) else f"dim{i}_{s}"
                for i, s in enumerate(lead_shape)]
        ds.variables[name] = a
        ds.dims[name] = tuple(lead + tail)
        base = name[:-3] if name.endswith("_at") else name
        if base in _ATTRS:
            ds.attrs[name] = dict(_ATTRS[base])
    return ds
