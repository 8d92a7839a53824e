"""Contour-space core: the conservative-rearrangement engine (L2/L3).

Functional twin of the reference ``Contour2D`` class
(/root/reference/xcontour/core.py:16-1101) plus the ``Table`` lookup
(core.py:1103-1195), re-designed for an accelerator:

* every function is jit-compatible with static flags (``increase``/``lt`` are
  Python bools, baked into the trace — matching the reference where they are
  constructor constants);
* batch dims are leading axes handled by vmap/broadcasting, replacing the
  reference's ``apply_ufunc(vectorize=True)`` Python loops;
* the histogram path is the digitize/segment-sum/prefix-scan engine in
  ``ops.histogram``; the broadcast path is kept for validation parity, chunked
  so it never materializes the (batch, contour, grid) cliff the reference
  warns about (core.py:82-84);
* ``Table.lookup_values`` works — the reference's is broken by a typo
  (core.py:1190, SURVEY.md §0.2).

Array conventions: plane fields (..., Ny, Nx) with the equivalent dim at axis
-2; contour-space arrays (..., N) with the contour index last.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid
from .ops.histogram import weighted_cdf
from .ops.interp import interp1d
from .ops.gradient import gradient_index
from .diagnostics import lwa as _lwa
from .diagnostics import length as _length


# ---------------------------------------------------------------------------
# contour levels — reference core.py:205-266
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("N", "increase"))
def cal_contours(tracer: jax.Array, N: int, *, increase: bool = True) -> jax.Array:
    """N equally-spaced levels between each batch element's nan-min/max,
    min->max if ``increase`` else max->min (core.py:222-249)."""
    # nan-aware extrema via masked +-inf: one min/max reduction each, no
    # separate NaN pass
    isn = jnp.isnan(tracer)
    big = jnp.asarray(jnp.inf, tracer.dtype)
    mmin = jnp.min(jnp.where(isn, big, tracer), axis=(-2, -1))
    mmax = jnp.max(jnp.where(isn, -big, tracer), axis=(-2, -1))
    nan = jnp.asarray(jnp.nan, tracer.dtype)
    mmin = jnp.where(mmin == big, nan, mmin)    # all-NaN batch elements
    mmax = jnp.where(mmax == -big, nan, mmax)
    start, end = (mmin, mmax) if increase else (mmax, mmin)
    steps = (end - start) / (N - 1.0)
    levels = steps[..., None] * jnp.arange(N, dtype=tracer.dtype) + start[..., None]
    # pin the endpoint to the exact extremum (np.linspace semantics): with the
    # open formula the last level can land 1 ulp short of the tracer max and
    # silently drop the extreme cell from every >=-CDF
    return levels.at[..., -1].set(end)


# ---------------------------------------------------------------------------
# conditional integrals — reference core.py:363-460
# ---------------------------------------------------------------------------
def _chunked_levels(fn, N: int, chunk: int):
    chunk = max(1, min(chunk, N))
    npad = (-N) % chunk
    idx = jnp.arange(N + npad).reshape(-1, chunk)
    out = jax.lax.map(jax.vmap(fn), idx)
    out = out.reshape((-1,) + out.shape[2:])[:N]
    return jnp.moveaxis(out, 0, -1)  # (..., N)


@partial(jax.jit, static_argnames=("lt", "chunk"))
def cal_integral_within_contours(tracer, contours, dA, integrand=None, *,
                                 lt: bool = False, chunk: int = 16):
    """Broadcast path: for each contour C, nan-skipping integral of
    ``integrand`` where tracer </> C (core.py:398-404).  Chunked over contour
    levels so memory stays at chunk x grid."""
    if integrand is None:
        integrand = tracer - tracer + 1.0
    batch = tracer.shape[:-2]
    ctr = jnp.broadcast_to(contours, batch + contours.shape[-1:])
    f_dA = integrand * dA

    def one(k):
        c = ctr[..., k]
        cb = c[..., None, None] if batch else c
        cond = (tracer < cb) if lt else (tracer > cb)
        return jnp.nansum(jnp.where(cond, f_dA, 0.0), axis=(-2, -1))

    return _chunked_levels(one, ctr.shape[-1], chunk)


@partial(jax.jit, static_argnames=("lt",))
def cal_integral_within_contours_hist(tracer, contours, dA, integrand=None, *,
                                      lt: bool = False):
    """Histogram path (core.py:412-460): weights = integrand*dA, NaN->0."""
    wei = dA if integrand is None else integrand * dA
    wei = jnp.broadcast_to(wei, tracer.shape)
    return weighted_cdf(tracer, contours, wei, lt)


@partial(jax.jit, static_argnames=("lt",))
def cal_integral_within_contours_exact(tracer, contours, dA, integrand=None, *,
                                       lt: bool = False):
    """Exact sort-based path (ops/sort.py): the broadcast path's strict
    conditional sums at O(G log G) — no binning quantization, no
    (contour x grid) memory cliff.  A capability beyond the reference."""
    from .ops.sort import exact_conditional_integral
    wei = dA if integrand is None else integrand * dA
    wei = jnp.broadcast_to(wei, tracer.shape)
    return exact_conditional_integral(tracer, contours, wei, lt)


# ---------------------------------------------------------------------------
# monotonic lookup table — reference core.py:1103-1195
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Table:
    """One-to-one map y = F(x) between area (values) and equivalent
    coordinate (coords), direction-aware both ways."""

    values: jax.Array  # (..., Ny) table values (e.g. area A)
    coords: jax.Array  # (Ny,) equivalent coordinates

    def _inc_values(self):
        v = self.values.reshape((-1, self.values.shape[-1]))
        inc = v[:, -1] > v[:, 0]
        # Mixed-direction batches produce wrong lookups; the reference raises
        # "not every time or level is increasing/decreasing"
        # (core.py:1122-1134).  With concrete values the same guard fires
        # eagerly here; under jit, direction is sniffed from element 0 like
        # before (a data-dependent raise cannot live in a trace) — checked
        # pipelines call :meth:`check_direction` for the checkify guard.
        if not isinstance(inc, jax.core.Tracer) and \
                not getattr(self, "_dir_checked", False):
            # np.asarray is a device->host sync — pay it ONCE per Table
            # instance, not per eager lookup
            arr = np.asarray(inc)
            if arr.size > 1 and not (arr == arr[0]).all():
                raise ValueError(
                    "Table: not every batch element (time/level) is "
                    "increasing/decreasing — mixed-direction table values "
                    "(reference core.py:1122-1134)")
            object.__setattr__(self, "_dir_checked", True)
        return inc[0]

    def check_direction(self) -> None:
        """checkify twin of the ctor-time mixed-direction guard, for tables
        built inside jit: add to a checkify.checkify-wrapped pipeline."""
        from .utils.checks import check_uniform_direction
        check_uniform_direction(self.values, axis=-1, name="Table values")

    def lookup_coordinates(self, values: jax.Array) -> jax.Array:
        """Given values (y), return coordinates (x) (core.py:1136-1174)."""
        return interp1d(values, self.values, self.coords,
                        increasing=self._inc_values())

    def lookup_values(self, coords: jax.Array) -> jax.Array:
        """Given coordinates (x), return values (y) — the reference intends
        this but crashes on a typo (core.py:1190); fixed by construction."""
        inc_cd = self.coords[-1] > self.coords[0]
        return interp1d(coords, self.coords, self.values, increasing=inc_cd)


# ---------------------------------------------------------------------------
# area <-> equivalent-coordinate tables — reference core.py:73-203
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("increase", "lt", "chunk"))
def _area_table_broadcast_values(mask, ydef, dA, *, increase: bool, lt: bool,
                                 chunk: int = 16):
    y = ydef
    eq_dim_incre = y[-1] > y[0]
    batch = mask.shape[:-2]

    # 4-way case split (core.py:103-128): which comparison to use is
    # data-dependent on the coordinate direction, resolved with jnp.where.
    use_lt_if_incre = lt  # when (eq_dim_incre == increase)

    def one(j):
        yj = y[j]
        cond_lt = y < yj
        cond_gt = y > yj
        same = eq_dim_incre == increase
        if use_lt_if_incre:
            cond = jnp.where(same, cond_lt, cond_gt)
        else:
            cond = jnp.where(same, cond_gt, cond_lt)
        w = jnp.where(cond[:, None], mask * dA, 0.0)
        return jnp.abs(jnp.nansum(w, axis=(-2, -1)))

    tbl = _chunked_levels(one, y.shape[0], chunk)  # (..., Ny)
    max_area = jnp.abs(jnp.nansum(mask * dA, axis=(-2, -1)))
    incr = tbl[..., -1] > tbl[..., 0]
    last = jnp.where(incr, max_area, tbl[..., -1])
    first = jnp.where(incr, tbl[..., 0], max_area)
    tbl = tbl.at[..., -1].set(last).at[..., 0].set(first)
    return tbl


def cal_area_eqCoord_table(mask, ydef, dA, *, increase: bool, lt: bool) -> Table:
    """Conditional-integration A(y_eq) table (core.py:73-147), endpoint forced
    to the total fluid area (core.py:133-142)."""
    values = _area_table_broadcast_values(mask, ydef, dA, increase=increase, lt=lt)
    return Table(values=values, coords=ydef)


@partial(jax.jit, static_argnames=("increase", "lt"))
def _area_table_hist_values(mask, ydef, dA, *, increase: bool, lt: bool):
    y = ydef
    y_incre = ~(y[-1] < y[0])
    ctr_var = jnp.broadcast_to(y[:, None], mask.shape)
    ctr_var = jnp.where(mask == 1, ctr_var, jnp.nan)  # core.py:178
    # ylt flips with relative direction (core.py:184-188); direction is data-
    # dependent, so compute both branches and select.
    cdf_lt = weighted_cdf(ctr_var, y, jnp.broadcast_to(dA, mask.shape), lt)
    cdf_gt = weighted_cdf(ctr_var, y, jnp.broadcast_to(dA, mask.shape), not lt)
    ylt_is_lt = y_incre == jnp.asarray(increase)
    return jnp.where(ylt_is_lt, cdf_lt, cdf_gt)


def cal_area_eqCoord_table_hist(mask, ydef, dA, *, increase: bool, lt: bool) -> Table:
    """Histogram A(y_eq) table (core.py:150-203): histogram the masked
    y-coordinate field itself with dA weights."""
    values = _area_table_hist_values(mask, ydef, dA, increase=increase, lt=lt)
    return Table(values=values, coords=ydef)


# ---------------------------------------------------------------------------
# contour-space calculus — reference core.py:463-637, 945-966
# ---------------------------------------------------------------------------
@jax.custom_vjp
def _grad_safe_div(num, den):
    """``num / den`` with the raw primal (0/0 -> NaN, x/0 -> inf, exactly as
    the plain division) but a VJP that (a) zeroes degenerate lanes
    (den == 0 or NaN operands), killing the 0-cotangent x NaN-jacobian
    products that poison ``jax.grad`` through the Keff tail, and (b)
    evaluates the live-lane cotangents FACTORED — ``(g/d)`` before the next
    ``/d`` — so no ``den**2`` intermediate under/overflows when the Keff
    quantities span ~35 f32 decades (area ~1e14 m^2, dq/dA ~1e-19)."""
    return num / den


def _grad_safe_div_fwd(num, den):
    return num / den, (num, den)


def _grad_safe_div_bwd(res, g):
    num, den = res
    # non-finite OPERANDS (inf quotients from an upstream safe division are
    # legitimate primal values here) and any residual non-finite cotangent
    # products (f32 overflow at extreme scale ratios) are zeroed: degenerate
    # and overflowing lanes get the zero subgradient, never NaN poison
    bad = (den == 0) | ~jnp.isfinite(den) | ~jnp.isfinite(num)
    d = jnp.where(bad, 1.0, den)
    gd = g / d
    gnum = jnp.where(bad, 0.0, gd)
    gden = jnp.where(bad, 0.0, -gd * (num / d))
    gnum = jnp.where(jnp.isfinite(gnum), gnum, 0.0)
    gden = jnp.where(jnp.isfinite(gden), gden, 0.0)
    return gnum, gden


_grad_safe_div.defvjp(_grad_safe_div_fwd, _grad_safe_div_bwd)


@jax.custom_vjp
def _grad_safe_div_sq(num, den):
    """``num / den**2`` (the Leq^2 form) with the raw primal and a fused,
    factored VJP.  Splitting this into ``den**2`` then a division overflows
    reverse-mode f32 even with :func:`_grad_safe_div`: the cotangent into
    ``den**2`` is ``-g*num/den**4``-scale (~1e39 for ERA-scale units) and
    only the FUSED cotangent ``-2*g*num/den**3`` times the chain's small
    factors stays representable.  Factored as ``-2*(g*(num/d/d))/d`` every
    intermediate is in f32 range."""
    return num / den ** 2


def _grad_safe_div_sq_fwd(num, den):
    return num / den ** 2, (num, den)


def _grad_safe_div_sq_bwd(res, g):
    num, den = res
    # same policy as _grad_safe_div_bwd: non-finite operands, den**2
    # underflow (primal inf with den != 0), and overflowing factored
    # products all take the zero subgradient
    bad = ((den == 0) | (den * den == 0)
           | ~jnp.isfinite(den) | ~jnp.isfinite(num))
    d = jnp.where(bad, 1.0, den)
    gd = g / d
    L = (num / d) / d
    gnum = jnp.where(bad, 0.0, gd / d)
    gden = jnp.where(bad, 0.0, -2.0 * (g * L) / d)
    gnum = jnp.where(jnp.isfinite(gnum), gnum, 0.0)
    gden = jnp.where(jnp.isfinite(gden), gden, 0.0)
    return gnum, gden


_grad_safe_div_sq.defvjp(_grad_safe_div_sq_fwd, _grad_safe_div_sq_bwd)


@jax.jit
def cal_gradient_wrt_area(var, area):
    """dVar/dA via centered differences along the contour index
    (core.py:479-483)."""
    return _grad_safe_div(gradient_index(var, axis=-1),
                          gradient_index(area, axis=-1))


def cal_contour_weigh_mean(tracer, contours, dA, integrand, area=None, *,
                           lt: bool = False):
    """Thickness-weighted line-average d(int f dA)/dA (core.py:491-521)."""
    intA = cal_integral_within_contours(tracer, contours, dA, integrand, lt=lt)
    if area is None:
        area = cal_integral_within_contours(tracer, contours, dA, lt=lt)
    return cal_gradient_wrt_area(intA, area)


def cal_contour_weigh_mean_hist(tracer, contours, dA, integrand, area=None, *,
                                lt: bool = False):
    intA = cal_integral_within_contours_hist(tracer, contours, dA, integrand, lt=lt)
    if area is None:
        area = cal_integral_within_contours_hist(tracer, contours, dA, lt=lt)
    return cal_gradient_wrt_area(intA, area)


def cal_contour_mean(tracer, contours, dA, integrand, grdm, area=None, *,
                     lt: bool = False):
    """Simple along-contour mean <f|grad q|>/<|grad q|> (core.py:555-584)."""
    upper = cal_contour_weigh_mean(tracer, contours, dA, integrand * grdm, area, lt=lt)
    lower = cal_contour_weigh_mean(tracer, contours, dA, grdm, area, lt=lt)
    return _grad_safe_div(upper, lower)


def cal_contour_mean_hist(tracer, contours, dA, integrand, grdm, area=None, *,
                          lt: bool = False):
    upper = cal_contour_weigh_mean_hist(tracer, contours, dA, integrand * grdm, area, lt=lt)
    lower = cal_contour_weigh_mean_hist(tracer, contours, dA, grdm, area, lt=lt)
    return _grad_safe_div(upper, lower)


def cal_sqared_equivalent_length(dgrdSdA, dqdA):
    """Leq^2 = (d int|grad q|^2 dA / dA) / (dq/dA)^2 (core.py:619-637).
    (Name kept verbatim from the reference API, typo included.)"""
    return _grad_safe_div_sq(dgrdSdA, dqdA)


def cal_normalized_Keff(Leq2, Lmin, mask: float = 1e5):
    """nkeff = Leq^2 / Lmin^2, thresholded to NaN above ``mask``
    (core.py:945-966).  Two sequential divisions, NOT /(Lmin*Lmin): the
    float64 oracle (compat.py) and the reference compute Leq2/Lmin/Lmin,
    and the fused form rounds differently by up to 1 ulp — enough to flip
    the `< mask` threshold on boundary values."""
    nkeff = _grad_safe_div(_grad_safe_div(Leq2, Lmin), Lmin)
    return jnp.where(nkeff < mask, nkeff, jnp.nan)


def get_extrema_extend(data, N: int):
    """(min - step, max + step) with step = range/N — the endpoint-extension
    helper (reference core.py:1381-1402; unused in the reference's main paths
    but part of its surface)."""
    vmin = jnp.nanmin(data)
    vmax = jnp.nanmax(data)
    step = (vmax - vmin) / N
    return vmin - step, vmax + step


# ---------------------------------------------------------------------------
# contour-space -> coordinate-space interpolation — core.py:269-360, 1017-1100
# ---------------------------------------------------------------------------
def interp_to_coords(predef, eq_coords, var, increasing=None, axis: int = -1):
    """Remap a contour-indexed variable onto prescribed coordinate values
    (core.py:1050-1100).  Direction is sniffed from the first batch element
    like the reference (core.py:1079-1088) unless given.

    ``axis`` is the interpolation axis in BOTH ``eq_coords`` and ``var`` —
    the functional analogue of the reference's ``interpDim`` name parameter
    (core.py:1050, default ``'contour'`` == the last axis here).  A negative
    axis counts from the end of each array (so it works when their ranks
    differ); a non-negative axis requires equal ranks."""
    if axis != -1:
        if axis >= 0 and eq_coords.ndim != var.ndim:
            raise ValueError(
                "interp_to_coords: a non-negative axis is ambiguous when "
                f"eq_coords (ndim {eq_coords.ndim}) and var (ndim {var.ndim}) "
                "differ in rank; use a negative axis")
        eq_coords = jnp.moveaxis(eq_coords, axis, -1)
        var = jnp.moveaxis(var, axis, -1)
    if increasing is None:
        flat = eq_coords.reshape((-1, eq_coords.shape[-1]))
        increasing = flat[0, 0] < flat[0, -1]
    out = interp1d(predef, eq_coords, var, increasing=increasing)
    if axis != -1:
        out = jnp.moveaxis(out, -1, axis)
    return out


def cal_contours_at(predef, table: Table, tracer, dA, *, increase: bool,
                    lt: bool, method: str = "exact"):
    """Contour levels lying at prescribed equivalent coordinates
    (core.py:269-360): rough contours -> enclosed area -> Y_eq -> interp back.

    method: 'exact' (sort-based, default), 'broadcast', or 'hist'.  Note the
    hist path inherits the reference's assumption that bins span the tracer
    extrema (core.py:1208-1210) — with interior prescribed coordinates it
    systematically under-counts area (everything below the prepended edge is
    excluded), exactly like the reference's ``cal_contours_at_hist``.  The
    exact path has no such window and round-trips cleanly.
    """
    N = predef.shape[-1]
    ctr = cal_contours(tracer, N, increase=increase)
    integral = {"exact": cal_integral_within_contours_exact,
                "broadcast": cal_integral_within_contours,
                "hist": cal_integral_within_contours_hist}[method]
    area = integral(tracer, ctr, dA, lt=lt)
    dim_eq = table.lookup_coordinates(area)
    return interp_to_coords(predef, dim_eq, ctr)


# ---------------------------------------------------------------------------
# reference-compatible object facade
# ---------------------------------------------------------------------------
class Contour2D:
    """Drop-in analogue of the reference ``Contour2D``
    (/root/reference/xcontour/core.py:20-70 and the grid-first test-facing
    variant, tests/test_Keff_atmos.py:37-41).

    ``grid`` carries the metrics; ``tracer`` is (..., Ny, Nx) with the
    equivalent dimension at axis -2.  ``dims``/``dimEq`` are accepted for API
    familiarity and validated against ``grid.dim_names``.
    """

    def __init__(self, grid: Grid, trcr: jax.Array, dims: Optional[dict] = None,
                 dimEq: Optional[dict] = None, arakawa: str = "A",
                 increase: bool = True, lt: bool = False,
                 check_mono: bool = False, dtype=jnp.float32):
        if dimEq is not None and len(dimEq) != 1:
            raise ValueError('dimEq should be one dimension e.g., {"Y": "lat"}')
        if dims is not None:
            if len(dims) != 2:
                raise ValueError("dims should be a 2D plane")
            names = set(dims.values())
            if not names.issuperset(set(grid.dim_names)) and \
                    not set(grid.dim_names).issuperset(names):
                raise ValueError(
                    f"dims {dims} do not match grid dims {grid.dim_names}")
        if arakawa not in ("A", "C"):
            # the reference stores this flag without using it in the math
            # (core.py:60); here unsupported grid letters fail loudly
            raise ValueError(f"unsupported arakawa grid {arakawa!r}; "
                             "expected 'A' or 'C'")
        self.grid = grid
        self.tracer = jnp.asarray(trcr, dtype)
        self.dA = grid.dA.astype(dtype)
        self.increase = bool(increase)
        self.lt = bool(lt)
        self.check_mono = bool(check_mono)
        self.arakawa = arakawa
        self.dtype = dtype

    @classmethod
    def from_arrays(cls, trcr, dA, ydef, xdef=None, *, latlon: bool = False,
                    periodic_x: bool = False, increase: bool = True,
                    lt: bool = False, check_mono: bool = False,
                    dtype=jnp.float32) -> "Contour2D":
        """The vendored-generation constructor (reference core.py:20-21):
        tracer + explicit cell-area array, no grid object.  ``ydef`` supplies
        the equivalent coordinate the xarray version read off the tracer's
        coords; ``xdef`` defaults to an index coordinate."""
        from .grid import from_metrics
        dA = jnp.asarray(dA, dtype)
        if xdef is None:
            xdef = jnp.arange(dA.shape[-1], dtype=dtype)
        grid = from_metrics(ydef, xdef, dA, latlon=latlon,
                            periodic_x=periodic_x, dtype=dtype)
        return cls(grid, trcr, increase=increase, lt=lt,
                   check_mono=check_mono, dtype=dtype)

    # -- contour levels ---------------------------------------------------
    def cal_contours(self, levels: Union[int, Sequence, jax.Array] = 10):
        if isinstance(levels, int):
            return cal_contours(self.tracer, levels, increase=self.increase)
        return jnp.asarray(levels, self.dtype)

    # -- tables -----------------------------------------------------------
    def cal_area_eqCoord_table(self, mask) -> Table:
        tbl = cal_area_eqCoord_table(jnp.asarray(mask, self.dtype),
                                     self.grid.ydef.astype(self.dtype), self.dA,
                                     increase=self.increase, lt=self.lt)
        self._maybe_check_mono(tbl.values)
        return tbl

    def cal_area_eqCoord_table_hist(self, mask) -> Table:
        tbl = cal_area_eqCoord_table_hist(jnp.asarray(mask, self.dtype),
                                          self.grid.ydef.astype(self.dtype),
                                          self.dA,
                                          increase=self.increase, lt=self.lt)
        self._maybe_check_mono(tbl.values)
        return tbl

    # -- conditional integrals -------------------------------------------
    def cal_integral_within_contours(self, contour, tracer=None, integrand=None):
        out = cal_integral_within_contours(
            self.tracer if tracer is None else tracer, contour, self.dA,
            integrand, lt=self.lt)
        self._maybe_check_mono(out)
        return out

    def cal_integral_within_contours_hist(self, contour, tracer=None,
                                          integrand=None):
        out = cal_integral_within_contours_hist(
            self.tracer if tracer is None else tracer, contour, self.dA,
            integrand, lt=self.lt)
        self._maybe_check_mono(out)
        return out

    def cal_integral_within_contours_exact(self, contour, tracer=None,
                                           integrand=None):
        """Sort-based exact conditional integrals (beyond the reference)."""
        out = cal_integral_within_contours_exact(
            self.tracer if tracer is None else tracer, contour, self.dA,
            integrand, lt=self.lt)
        self._maybe_check_mono(out)
        return out

    # -- calculus ---------------------------------------------------------
    def cal_gradient_wrt_area(self, var, area):
        return cal_gradient_wrt_area(var, area)

    def cal_contour_weigh_mean(self, contour, integrand, area=None):
        return cal_contour_weigh_mean(self.tracer, contour, self.dA, integrand,
                                      area, lt=self.lt)

    def cal_contour_weigh_mean_hist(self, contour, integrand, area=None):
        return cal_contour_weigh_mean_hist(self.tracer, contour, self.dA,
                                           integrand, area, lt=self.lt)

    def cal_contour_mean(self, contour, integrand, grdm, area=None):
        return cal_contour_mean(self.tracer, contour, self.dA, integrand, grdm,
                                area, lt=self.lt)

    def cal_contour_mean_hist(self, contour, integrand, grdm, area=None):
        return cal_contour_mean_hist(self.tracer, contour, self.dA, integrand,
                                     grdm, area, lt=self.lt)

    def cal_sqared_equivalent_length(self, dgrdSdA, dqdA):
        return cal_sqared_equivalent_length(dgrdSdA, dqdA)

    def cal_normalized_Keff(self, Leq2, Lmin, mask: float = 1e5):
        return cal_normalized_Keff(Leq2, Lmin, mask)

    # -- LWA family -------------------------------------------------------
    def cal_local_wave_activity(self, q, Q, mask_idx=None, part: str = "all"):
        ydef = self.grid.ydef.astype(self.dtype)
        out = _lwa.local_wave_activity(q, Q, self.dA, ydef,
                                       increase=self.increase, part=part)
        if mask_idx is None:
            return out
        contours, masks = _lwa.lwa_masks_at(q, Q, self.dA, ydef, mask_idx,
                                            increase=self.increase)
        return out, [contours[..., i] for i in range(len(mask_idx))], \
            [masks[i] for i in range(masks.shape[0])]

    def cal_local_wave_activity2(self, q, Q, mask_idx=None, part: str = "all"):
        ydef = self.grid.ydef.astype(self.dtype)
        out = _lwa.local_wave_activity2(q, Q, self.dA, ydef,
                                        increase=self.increase, part=part)
        if mask_idx is None:
            return out
        contours, masks = _lwa.lwa_masks_at(q, Q, self.dA, ydef, mask_idx,
                                            increase=self.increase, variant2=True)
        return out, [contours[..., i] for i in range(len(mask_idx))], \
            [masks[i] for i in range(masks.shape[0])]

    def cal_local_APE(self, q, Q, mask_idx=None, part: str = "all"):
        """Local APE == LWA (core.py:908-942)."""
        return self.cal_local_wave_activity(q, Q, mask_idx, part)

    # -- geometry ---------------------------------------------------------
    def cal_contour_lengths(self, contours, tracer=None, latlon: bool = False):
        if isinstance(contours, (int, list)):
            contours = self.cal_contours(contours)
        data = self.tracer if tracer is None else tracer
        return _length.contour_lengths(
            data, contours, self.grid.ydef.astype(self.dtype),
            self.grid.xdef.astype(self.dtype), latlon=latlon)

    def cal_contour_crossing(self, ctr, stride=1, mode: str = "edge",
                             quirks: bool = False):
        return _length.contour_crossing(self.tracer, ctr, self.dA, stride,
                                        mode=mode, quirks=quirks)

    # -- interpolation ----------------------------------------------------
    def cal_contours_at(self, predef, table: Table):
        return cal_contours_at(jnp.asarray(predef, self.dtype), table,
                               self.tracer, self.dA, increase=self.increase,
                               lt=self.lt, method="broadcast")

    def cal_contours_at_hist(self, predef, table: Table):
        return cal_contours_at(jnp.asarray(predef, self.dtype), table,
                               self.tracer, self.dA, increase=self.increase,
                               lt=self.lt, method="hist")

    def cal_contours_at_exact(self, predef, table: Table):
        """Windowing-free variant (beyond the reference): round-trips
        cleanly for interior prescribed coordinates."""
        return cal_contours_at(jnp.asarray(predef, self.dtype), table,
                               self.tracer, self.dA, increase=self.increase,
                               lt=self.lt, method="exact")

    def interp_to_coords(self, predef, eq_coords, var, axis: int = -1):
        """``axis`` mirrors the reference's ``interpDim=`` (core.py:1050)."""
        return interp_to_coords(jnp.asarray(predef, self.dtype), eq_coords,
                                var, axis=axis)

    def interp_to_dataset(self, predef, eq_coords, vs: dict,
                          batch_dims: tuple = (), batch_coords: dict = None):
        """The reference's Dataset merge (core.py:1017-1047): every variable
        interpolated onto ``predef`` equivalent coordinates, returned as a
        labeled Dataset (dict-style access works; ``.to_nc3``/``.to_nc4``
        write it out).  The new coordinate is named after the grid's
        equivalent dim like the reference's 'new'->dimEq rename.

        ``batch_dims`` names the leading (batch) axes, exactly like the
        reference keeps the caller's dims ('time', 'level', ...) through its
        xarray merge; unnamed leading axes fall back to synthetic
        ``dim{i}_{size}`` labels.  ``batch_coords`` optionally attaches 1-D
        coordinate variables for those dims (written as netCDF coordinate
        variables by ``.to_nc3``)."""
        from .utils.ncio import Dataset
        predef_j = jnp.asarray(predef, self.dtype)
        out = {name: interp_to_coords(predef_j, eq_coords, var)
               for name, var in vs.items()}
        pdim = self.grid.dim_names[0]
        batch_dims = tuple(batch_dims)
        ds = Dataset()
        ds.coords[pdim] = np.asarray(predef)
        for cname, cvals in (batch_coords or {}).items():
            ds.coords[cname] = np.asarray(cvals)
        for name, var in out.items():
            a = np.asarray(var)
            lead = tuple(batch_dims[i] if i < len(batch_dims)
                         else f"dim{i}_{s}"
                         for i, s in enumerate(a.shape[:-1]))
            ds.variables[name] = a
            ds.dims[name] = lead + (pdim,)
        return ds

    # -- checks -----------------------------------------------------------
    def _maybe_check_mono(self, var):
        """Opt-in monotonicity guard (reference core.py:144-145, 1328-1355),
        unified on utils.checks.check_monotonic: eagerly it raises
        immediately (only the boolean predicate syncs, not the array); under
        ``checkify.checkify`` the same check defers to a structured error, so
        checked pipelines stay fully async.  For the offending index, use
        utils.checks.assert_monotonic_host."""
        if not self.check_mono:
            return
        from .utils.checks import check_monotonic
        check_monotonic(var, axis=-1, name="contour-axis values")
