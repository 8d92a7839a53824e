"""Pallas kernel (Triton route) for the linearised LWA c-term on the GPU.

For ``part='all'`` the LWA mask linearises (diagnostics/lwa.py docstring):

    LWA_j(x) = -(R_j(x) + E[j, x]),  R_j(x) = sum_y ext(q(y, x) - Q_j) W(y, x)

with ext = min(., 0) for increasing tracers and max(., 0) otherwise.  E is an
O(Ny*Nx) prefix the caller builds in XLA; R is the O(Ny^2*Nx) pair sum, and it
is what this kernel computes.  XLA evaluates it as a ``lax.map`` over surface
chunks that re-reads the whole field at every step; here each program owns a
(TJ surfaces x BX columns) accumulator in registers and streams the field once
down y in (YB, BX) tiles.  Programs share no state, so Ny is a loop bound, not
a resident block: tall grids need no special path.

The min/max is not bilinear, so the tensor cores cannot help; the kernel is
bound by FP32 issue (sub, min, fma per pair).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Block sizes (powers of two), chosen by a sweep on an H100 at 32x256x512
# and 4x721x1440 (PERF.md).  With BX = 32 * _NUM_WARPS every thread owns one
# column, so the y reduction and its TJ surfaces stay in that thread's
# registers; layouts that split a column across threads ran 3-7x slower.
_TJ = 32      # surfaces per program
_BX = 128     # columns per program
_YB = 8       # rows per loaded tile
_YK = 16      # tiles per partial sum (two-level accumulation, see _kernel)
_NUM_WARPS = 4
_NUM_STAGES = 3


def _kernel(Q_ref, q_ref, W_ref, E_ref, o_ref, *, ny: int, nx: int,
            increase: bool, tj: int, bx: int, yb: int, yk: int):
    b = pl.program_id(0)
    xb = pl.program_id(1)
    t = pl.program_id(2)
    js = t * tj + jnp.arange(tj)
    xs = xb * bx + jnp.arange(bx)
    jm = js < ny
    xm = xs < nx
    Qj = plgpu.load(Q_ref.at[b, pl.ds(t * tj, tj)], mask=jm, other=0.0)

    def tile(i, acc):
        ys = i * yb + jnp.arange(yb)
        m = (ys < ny)[:, None] & xm[None, :]
        # masked cells load W = 0, so they add exactly nothing
        q = plgpu.load(q_ref.at[b, pl.ds(i * yb, yb), pl.ds(xb * bx, bx)],
                       mask=m, other=0.0)
        w = plgpu.load(W_ref.at[pl.ds(i * yb, yb), pl.ds(xb * bx, bx)],
                       mask=m, other=0.0)
        qe = q[None, :, :] - Qj[:, None, None]
        ext = jnp.minimum(qe, 0.0) if increase else jnp.maximum(qe, 0.0)
        return acc + jnp.sum(ext * w[None, :, :], axis=1)

    # two-level accumulation: a fresh partial sum over every yk tiles, added
    # to the total, so float32 rounding grows with yk + Ny/(yb*yk) rather
    # than Ny/yb (one running sum differed from the XLA form by 2e-3 of the
    # max at 4x8192x512).  Tiles past Ny in the last block load only zeros.
    zero = jnp.zeros((tj, bx), o_ref.dtype)

    def block(o, acc):
        return acc + jax.lax.fori_loop(
            0, yk, lambda i, part: tile(o * yk + i, part), zero)

    R = jax.lax.fori_loop(0, pl.cdiv(pl.cdiv(ny, yb), yk), block, zero)
    m2 = jm[:, None] & xm[None, :]
    E = plgpu.load(E_ref.at[b, pl.ds(t * tj, tj), pl.ds(xb * bx, bx)],
                   mask=m2, other=0.0)
    # a NaN profile value makes every qe NaN: the reference row is zero
    row = jnp.where(jnp.isnan(Qj)[:, None], 0.0, -(R + E))
    plgpu.store(o_ref.at[b, pl.ds(t * tj, tj), pl.ds(xb * bx, bx)], row,
                mask=m2)


@partial(jax.jit, static_argnames=("increase", "interpret", "tj", "bx", "yb",
                                   "yk"))
def lwa_lin_pallas(qk, Qc, Wz, E, *, increase: bool, interpret: bool = False,
                   tj: int = _TJ, bx: int = _BX, yb: int = _YB, yk: int = _YK):
    """-(R + E) for the linearised LWA, R as in the module docstring.

    qk : (B, Ny, Nx) centred tracer, invalid cells set to the clamping
         sentinel (+inf for ``increase``, else -inf);
    Qc : (B, Ny) centred profile (NaN rows give zero output rows);
    Wz : (Ny, Nx) weight with non-finite cells zeroed;
    E  : (B, Ny, Nx) t-term prefix.
    Returns (B, Ny, Nx).
    """
    B, Ny, Nx = qk.shape
    grid = (B, pl.cdiv(Nx, bx), pl.cdiv(Ny, tj))
    return pl.pallas_call(
        partial(_kernel, ny=Ny, nx=Nx, increase=increase, tj=tj, bx=bx,
                yb=yb, yk=yk),
        out_shape=jax.ShapeDtypeStruct((B, Ny, Nx), qk.dtype),
        grid=grid,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        interpret=interpret,
        name="lwa_lin_cterm",
    )(Qc, qk, Wz, E)
