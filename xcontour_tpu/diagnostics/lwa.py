"""Local finite-amplitude wave activity (LWA / FAWA / LAPE) kernels.

Reference semantics: /root/reference/xcontour/core.py:696-905.  The reference
loops a Python ``for j in range(Ny)`` over equivalent-dimension surfaces, each
iteration building full-grid temporaries and a full-grid reduction — O(Ny^2*Nx)
with xarray overhead per step.  Here the j-loop becomes a chunked
``lax.map``-of-``vmap``: each chunk of surfaces is evaluated as one fused XLA
elementwise+reduction kernel, so the arithmetic streams from HBM at full
bandwidth and nothing is ever materialized at O(Ny^2*Nx).

For ``part='all'`` (the default and the production configuration) the
O(Ny^2*Nx) pairwise form is bypassed entirely: the reference's 3-valued mask
(core.py:759-766) satisfies the exact identity  mask = t + c - 1  where
t = [row >= j] and c = [qe < 0] (resp. [qe > 0] for decreasing tracers) —
tie cells have qe == 0 and vanish either way — which makes the masked sum
LINEAR in two separable indicators:

    LWA_j = -[ suffix_j(qe*W)  +  CDF(qe*W at Q_j)  -  total(qe*W) ]

i.e. a reverse cumsum along the equivalent dim, a per-column sorted-prefix
lookup, and a total: O(Ny*Nx*log Ny) instead of O(Ny^2*Nx).  The result is
identical to the pairwise form up to float summation order (verified exactly
in float64, see tests/test_lwa_fast.py).  W+/W- part selections multiply the
two indicators and stay on the pairwise paths.  The same identity with the
c-term summed directly (O(Ny^2*Nx) at 4 ops per pair, 'lin') is faster
below a crossover height (see _FAST_NY_CROSSOVER), so 'auto' reserves the
sort path for tall equivalent dims; method='fast' forces it.

Conventions: fields are (..., Ny, Nx) with the equivalent dim at axis -2;
sorted profiles Q are (..., Ny).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _mask3(qe, m, increase: bool):
    """3-valued LWA mask (core.py:759-766): -1 where the tracer deviation
    pokes out equatorward/below of the contour, +1 poleward/above, 0 else."""
    if increase:
        mask1 = jnp.where(qe > 0, -1.0, 0.0)
        mask2 = jnp.where(m, 0.0, mask1)
        return jnp.where((qe < 0) & m, 1.0, mask2)
    mask1 = jnp.where(qe < 0, -1.0, 0.0)
    mask2 = jnp.where(m, 0.0, mask1)
    return jnp.where((qe > 0) & m, 1.0, mask2)


def _part_select(mask3, part: str, increase: bool):
    """W+/W-/all selection (core.py:772-784); NaN marks 'excluded'."""
    if part == "all":
        return mask3
    if part == "upper":
        keep = mask3 > 0 if increase else mask3 < 0
    elif part == "lower":
        keep = mask3 < 0 if increase else mask3 > 0
    else:
        raise ValueError("part must be in ['all', 'upper', 'lower']")
    return jnp.where(keep, mask3, jnp.nan)


def _lwa_dense_xla(q, Q, W, ydef, *, increase: bool, part: str,
                   variant2: bool, chunk: int):
    """The chunked dense (pairwise 3-valued-mask) form: the reference
    summation, core.py:752-793 / 860-890.

    The excluded-cell NaN sentinels (part selection, missing data) are
    substituted by EXACT zeros before the product so the sum equals the
    reference's nansum bit-for-bit while the VJP stays NaN-free: nansum's
    cotangent multiplies by the NaN mask (0*NaN=NaN) and would poison
    every gradient element for part='upper'/'lower'."""
    coord_incre = ydef[-1] > ydef[0]
    Wz = jnp.where(jnp.isnan(W), 0.0, W)

    def masked_term(qe, mask):
        qz = jnp.where(jnp.isnan(qe), 0.0, qe)
        mz = jnp.where(jnp.isnan(mask), 0.0, mask)
        return -jnp.sum(qz * mz * Wz, axis=-2)

    if variant2:
        def one(j):
            qj = jnp.take(q, j, axis=-2)                  # (..., Nx)
            qe = qj[..., None, :] - Q[..., :, None]       # (..., Ny, Nx)
            yj = ydef[j]
            m = jnp.where(coord_incre, ydef >= yj, ydef <= yj)[:, None]
            mask = _part_select(_mask3(qe, m, not increase), part, increase)
            return masked_term(qe, mask)
    else:
        def one(j):
            Qj = jnp.take(Q, j, axis=-1)
            yj = ydef[j]
            qe = q - Qj[..., None, None]
            m = jnp.where(coord_incre, ydef >= yj, ydef <= yj)[:, None]
            mask = _part_select(_mask3(qe, m, increase), part, increase)
            return masked_term(qe, mask)

    lwa = _chunked_over_surfaces(one, ydef.shape[0], chunk)  # (Ny, ..., Nx)
    return jnp.moveaxis(lwa, 0, -2)


def _lin_centred(q, Q, W):
    """Flatten the batch and centre tracer and profile by the profile
    midpoint (exact: the mask depends only on sign(q - Q_j)), which keeps
    the R/E cancellation of the linearised form small in float32."""
    batch = q.shape[:-2]
    Ny, Nx = q.shape[-2:]
    qf = q.reshape((-1, Ny, Nx))
    Qf = jnp.broadcast_to(Q, batch + (Ny,)).reshape((-1, Ny))
    Wb = jnp.broadcast_to(W, (Ny, Nx))
    validQ = jnp.isfinite(Qf)
    c0 = jnp.where(jnp.any(validQ, -1),
                   jnp.nanmean(jnp.where(validQ, Qf, jnp.nan), -1), 0.0)
    c0 = c0.astype(q.dtype)
    qc = qf - c0[:, None, None]
    Qc = Qf - c0[:, None]
    Qt = jnp.where(validQ, Qc, 0.0)
    return qf, Wb, validQ, qc, Qc, Qt


def _lin_v1_terms(q, Q, W, increase: bool):
    """Operands of the variant-1 c-term and its t-term prefix.

    Returns (qk, Qc, Wv, E), all batch-flattened: qk is the centred tracer
    with invalid cells at the clamping sentinel (+inf for ``increase``, so
    min(qk - Q_j, 0) = 0; -inf otherwise), Wv the weight zeroed on invalid
    cells, and E[j] = -sum_{y<j} (q - Q_j) W from the telescoping recurrence

        E[j+1] = E[j] + (Q~[j+1] - q~[j]) W[j] + (Q~[j+1] - Q~[j]) P0[j]

    whose increments are deviation-scaled (no eps*total float32 loss).  The
    telescoping makes E[j] exact for every valid row regardless of how NaN
    entries of Q~/q~ were sanitised.  Like the 'fast' path, the lin family
    treats +/-inf cells as invalid; only the dense path propagates inf like
    the reference's nansum."""
    qf, Wb, _, qc, Qc, Qt = _lin_centred(q, Q, W)
    B, Ny, Nx = qf.shape
    sent = jnp.asarray(jnp.inf if increase else -jnp.inf, q.dtype)
    valid = jnp.isfinite(qf) & jnp.isfinite(Wb)
    qk = jnp.where(valid, qc, sent)
    Wv = jnp.where(valid, Wb, 0.0)
    qt = jnp.where(valid, qc, 0.0)
    P0 = jax.lax.cumsum(Wv, axis=1) - Wv
    inc = ((Qt[:, 1:, None] - qt[:, :-1]) * Wv[:, :-1]
           + (Qt[:, 1:] - Qt[:, :-1])[..., None] * P0[:, :-1])
    E = jnp.concatenate(
        [jnp.zeros((B, 1, Nx), q.dtype), jnp.cumsum(inc, axis=1)], axis=1)
    return qk, Qc, Wv, E


def _lwa_lin_xla(q, Q, W, increase: bool, variant2: bool, chunk: int):
    """Linearised LWA (module docstring) in XLA: the E t-term from the
    telescoping recurrence plus a chunked 4-op c-term reduce per surface.
    The CPU path, the variant-2 path, and the function whose VJP the GPU
    kernel path uses."""
    batch = q.shape[:-2]
    Ny, Nx = q.shape[-2:]

    if variant2:
        qf, Wb, validQ, qc, Qc, Qt = _lin_centred(q, Q, W)
        B = qf.shape[0]
        sent = jnp.asarray(jnp.inf if increase else -jnp.inf, q.dtype)
        Qs = jnp.where(validQ, Qc, sent)[:, :, None]
        Wv = jnp.where(validQ[:, :, None] & jnp.isfinite(Wb), Wb, 0.0)
        P0 = jax.lax.cumsum(Wv, axis=1) - Wv
        qt = jnp.where(jnp.isfinite(qf), qc, 0.0)
        inc = ((Qt[:, :-1, None] - qt[:, 1:]) * Wv[:, :-1]
               - (qt[:, 1:] - qt[:, :-1]) * P0[:, :-1])
        E = jnp.concatenate(
            [jnp.zeros((B, 1, Nx), q.dtype), jnp.cumsum(inc, axis=1)], axis=1)

        def one(j):
            qrow = jnp.take(qc, j, axis=1)                    # (B, Nx)
            qe = qrow[:, None, :] - Qs
            ext = jnp.maximum(qe, 0.0) if increase else jnp.minimum(qe, 0.0)
            R = jnp.sum(ext * Wv, axis=1)
            row = -(R + jnp.take(E, j, axis=1))
            return jnp.where(jnp.isfinite(qrow), row, 0.0)
    else:
        qk, Qc, Wv, E = _lin_v1_terms(q, Q, W, increase)

        def one(j):
            Qj = jnp.take(Qc, j, axis=1)                      # (B,)
            qe = qk - Qj[:, None, None]
            ext = jnp.minimum(qe, 0.0) if increase else jnp.maximum(qe, 0.0)
            R = jnp.sum(ext * Wv, axis=1)
            row = -(R + jnp.take(E, j, axis=1))
            return jnp.where(jnp.isnan(Qj)[:, None], 0.0, row)

    lwa = _chunked_over_surfaces(one, Ny, chunk)              # (Ny, B, Nx)
    return jnp.moveaxis(lwa, 0, 1).reshape(batch + (Ny, Nx))


def _lin_kernel() -> bool:
    """The variant-1 lin path runs the Pallas (Triton) kernel on the GPU
    and :func:`_lwa_lin_xla` on the CPU."""
    return jax.default_backend() == "gpu"


def _lwa_lin_kernel(q, Q, W, increase: bool, chunk: int = 16):
    """Variant-1 lin LWA with the c-term in kernels/lwa_pallas.py.

    The kernel has no AD rule, so the VJP differentiates
    :func:`_lwa_lin_xla` over surface chunks of ``chunk``.  Not the
    full-chunk form (one vmapped sweep over all Ny surfaces): on the H100
    XLA spent over 8 minutes compiling its backward reduce at 4x256x512,
    against 12 s for the chunked one (PERF.md)."""
    from ..kernels import lwa_pallas

    @jax.custom_vjp
    def f(q, Q, W):
        batch = q.shape[:-2]
        qk, Qc, _, E = _lin_v1_terms(q, Q, W, increase)
        Wb = jnp.broadcast_to(W, q.shape[-2:])
        # invalid tracer cells already clamp to zero through the sentinel,
        # so one weight plane serves every batch element
        Wz = jnp.where(jnp.isfinite(Wb), Wb, 0.0)
        out = lwa_pallas.lwa_lin_pallas(qk, Qc, Wz, E, increase=increase)
        return out.reshape(batch + q.shape[-2:])

    def fwd(q, Q, W):
        return f(q, Q, W), (q, Q, W)

    def bwd(res, g):
        _, vjp = jax.vjp(lambda a, b, c: _lwa_lin_xla(
            a, b, c, increase, False, chunk), *res)
        return vjp(g)

    f.defvjp(fwd, bwd)
    return f(q, Q, W)


def _chunked_over_surfaces(fn, Ny: int, chunk: int):
    """Evaluate fn(j_indices_vector) for j = 0..Ny-1 in vmapped chunks via
    lax.map, limiting peak memory to chunk * field size."""
    chunk = max(1, min(chunk, Ny))
    npad = (-Ny) % chunk
    idx = jnp.arange(Ny + npad).reshape(-1, chunk)
    out = jax.lax.map(jax.vmap(fn), idx)          # (nchunk, chunk, ..., Nx)
    out = out.reshape((-1,) + out.shape[2:])[:Ny]  # (Ny, ..., Nx)
    return out


def _cdf_at(values, w0, w1, queries):
    """Per-row weighted CDFs, gather-free: values/w0/w1 (..., n) unsorted,
    queries (..., m) -> (S0, S1) (..., m) with S0[k] ~= sum of w0 where
    value < queries[k] (and S1 with w1).

    Tie cells (value == query) land on either side depending on the sort's
    arbitrary tie order; every caller here evaluates  S1 - query*S0,  in
    which a tied entry contributes  w1 - query*w0 = (value - query)*w  = 0,
    so the ambiguity cancels EXACTLY.

    Built from two co-sorts and static slices only, so positions are never
    materialized.  Merged cumsum trick: queries carry zero weight, so after
    one merged sort the inclusive prefix sum AT each query slot is its CDF;
    a second sort on a position key (queries first, in caller order) brings
    them home, and a static slice extracts them.
    """
    n = values.shape[-1]
    m = queries.shape[-1]
    shape_n = values.shape[:-1] + (n,)
    shape_m = queries.shape[:-1] + (m,)
    i32 = jnp.int32
    key = jnp.concatenate([values, queries], axis=-1)
    # position key: queries get 0..m-1 (sort-2 brings them first, in order),
    # values m..m+n-1
    k2 = jnp.concatenate([
        jnp.broadcast_to(jnp.arange(m, m + n, dtype=i32), shape_n),
        jnp.broadcast_to(jnp.arange(m, dtype=i32), shape_m)], axis=-1)
    z = jnp.zeros(shape_m, values.dtype)
    w0c = jnp.concatenate([w0, z], axis=-1)
    w1c = jnp.concatenate([w1, z], axis=-1)
    _, k2s, w0s, w1s = jax.lax.sort((key, k2, w0c, w1c),
                                    dimension=key.ndim - 1, num_keys=1)
    P0 = jnp.cumsum(w0s, axis=-1)
    P1 = jnp.cumsum(w1s, axis=-1)
    _, S0, S1 = jax.lax.sort((k2s, P0, P1), dimension=key.ndim - 1,
                             num_keys=1)
    return S0[..., :m], S1[..., :m]


def _lwa_fast(q, Q, W, *, increase: bool):
    """part='all' LWA via the mask linearization (module docstring).

    q (B, Ny, Nx); Q (B, Ny); W (Ny, Nx).  Returns (B, Ny, Nx), equal to the
    pairwise form up to float summation order.
    """
    B, Ny, Nx = q.shape
    Wb = jnp.broadcast_to(W, q.shape)
    valid = jnp.isfinite(q) & jnp.isfinite(Wb)
    validQ = jnp.isfinite(Q)
    # center by the profile midpoint: the mask depends only on sign(q - Q_j),
    # so a common shift is exact — and it kills the large-term cancellation
    # between the suffix/CDF/total pieces in float32
    c0 = jnp.nanmean(Q, axis=-1, keepdims=True)
    c0 = jnp.where(jnp.isfinite(c0), c0, 0.0)
    qc = q - c0[..., None]
    Qc = jnp.where(validQ, Q - c0, 0.0)

    wq = jnp.where(valid, Wb, 0.0)
    qwq = jnp.where(valid, qc * Wb, 0.0)
    # t-term: suffix sums along the equivalent dim (in index space the mask
    # row-condition is a suffix for BOTH coordinate directions)
    sfxW = jax.lax.cumsum(wq, axis=1, reverse=True)
    sfxQW = jax.lax.cumsum(qwq, axis=1, reverse=True)
    T0, T1 = sfxW[:, :1], sfxQW[:, :1]

    # c-term: per-column weighted CDF of the tracer at the profile values;
    # invalid cells sort to +inf with zero weight
    vals = jnp.where(valid, qc, jnp.inf).transpose(0, 2, 1)     # (B, Nx, Ny)
    S0, S1 = _cdf_at(vals, wq.transpose(0, 2, 1), qwq.transpose(0, 2, 1),
                     jnp.broadcast_to(Qc[:, None, :], (B, Nx, Ny)))
    S0 = S0.transpose(0, 2, 1)
    S1 = S1.transpose(0, 2, 1)
    # increase: c = [qe < 0] -> mass strictly below Q_j; else c = [qe > 0]
    # -> complement (tie terms cancel in S1 - Q_j*S0 either way)
    if not increase:
        S0 = T0 - S0
        S1 = T1 - S1

    Qj = Qc[..., None]
    out = -((sfxQW - Qj * sfxW) + (S1 - Qj * S0) - (T1 - Qj * T0))
    # NaN profile values: qe is NaN everywhere -> mask 0 -> the reference row
    # integrates to zero
    return jnp.where(validQ[..., None], out, 0.0)


def _lwa2_fast(q, Q, W, *, increase: bool):
    """part='all' variant-2 LWA (impulse-Casimir): qe = q_j(x) - Q(y').

    Here the CDF runs over the PROFILE values (shared across columns), so no
    per-column sort is needed — rows are re-ordered once by Q per batch
    element.  The mask flip (core.py:860-872) maps to: c = [Q < q_j] for
    increase=True (the +1 branch is (qe>0)&m), c = [Q > q_j] for
    increase=False.
    """
    B, Ny, Nx = q.shape
    validQ = jnp.isfinite(Q)                                    # (B, Ny)
    v = validQ[..., None] & jnp.isfinite(W)[None]
    c0 = jnp.nanmean(Q, axis=-1, keepdims=True)
    c0 = jnp.where(jnp.isfinite(c0), c0, 0.0)
    qc = q - c0[..., None]
    Qc = jnp.where(validQ, Q - c0, 0.0)

    wq = jnp.where(v, jnp.broadcast_to(W, q.shape), 0.0)
    qwq = Qc[..., None] * wq
    sfxW = jax.lax.cumsum(wq, axis=1, reverse=True)
    sfxQW = jax.lax.cumsum(qwq, axis=1, reverse=True)
    T0, T1 = sfxW[:, :1], sfxQW[:, :1]

    # c-term: per-column CDF of the PROFILE rows, evaluated at every tracer
    # cell.  Invalid profile rows sort to +inf with zero weight; NaN tracer
    # queries sort last and their rows are zeroed at the end.
    keyQ = jnp.where(validQ, Qc, jnp.inf)                       # (B, Ny)
    vals = jnp.broadcast_to(keyQ[:, None, :], (B, Nx, Ny))
    S0, S1 = _cdf_at(vals, wq.transpose(0, 2, 1), qwq.transpose(0, 2, 1),
                     qc.transpose(0, 2, 1))
    S0 = S0.transpose(0, 2, 1)                                  # (B, Ny, Nx)
    S1 = S1.transpose(0, 2, 1)
    # mask built with (not increase): for increase=True the +1 branch is
    # (qe>0)&m, giving c = [Q < q_j] (mass below the cell value); for
    # increase=False it is (qe<0)&m, giving c = [Q > q_j] (complement) —
    # tie terms cancel in  q_j*S0 - S1  either way
    if not increase:
        S0 = T0 - S0
        S1 = T1 - S1

    out = -((qc * sfxW - sfxQW) + (qc * S0 - S1) - (qc * T0 - T1))
    # NaN tracer at the surface point: qe is NaN for every y' -> zero row
    return jnp.where(jnp.isfinite(q), out, 0.0)


def _lwa_via_fast(q, Q, W, increase: bool, variant2: bool):
    batch = q.shape[:-2]
    Ny, Nx = q.shape[-2:]
    qf = q.reshape((-1, Ny, Nx))
    Qf = jnp.broadcast_to(Q, batch + (Ny,)).reshape((-1, Ny))
    W = jnp.broadcast_to(W, (Ny, Nx))
    fn = _lwa2_fast if variant2 else _lwa_fast
    out = fn(qf, Qf, W, increase=increase)
    return out.reshape(batch + (Ny, Nx))


# 'auto' takes the sort path ('fast') from this height up.  On an H100
# (4xNyx512 float32, 'lin' through the Pallas kernel; PERF.md) the two tie
# at Ny=4096 (5.46 vs 5.42 ms) and 'fast' wins at 8192 (12.7 vs 21.4 ms),
# so the crossover lies between 4096 and 8192.  A finer ladder should place
# it before the threshold moves (ROADMAP S7).
_FAST_NY_CROSSOVER = 6144


def _resolve_method(method: str, part: str, ny: int) -> str:
    """Pick the execution path at CALL time (outside any jit cache key).

    'lin'   — linearized O(Ny^2) c-term at 4 ops/pair (a Pallas kernel on
              the GPU, XLA on the CPU); f32 noise floor ~5e-5 of the max
              (the R and E terms cancel); part='all' only.
    'dense' — pairwise 3-valued-mask kernels, reference summation order
              (f32 ~1e-6); any part.
    'fast'  — sort-merge O(Ny log Ny) XLA path; wins only for tall
              equivalent dims (crossover _FAST_NY_CROSSOVER); part='all'.
    'auto'  — 'dense' for part selections, 'fast' above the crossover,
              'lin' otherwise.  config.set_lwa_fast(False) removes 'fast'
              from auto selection."""
    if method not in ("auto", "lin", "dense", "fast"):
        raise ValueError(f"method={method!r} not in "
                         "['auto', 'lin', 'dense', 'fast']")
    if method == "auto":
        if part != "all":
            return "dense"
        from .. import config
        if config.lwa_fast() and ny >= _FAST_NY_CROSSOVER:
            return "fast"
        return "lin"
    if method in ("fast", "lin") and part != "all":
        raise ValueError(f"method={method!r} only supports part='all' "
                         "(W+/W- selections multiply the two indicators)")
    return method


@partial(jax.jit, static_argnames=("increase", "part", "chunk", "method",
                                   "kernel"))
def _lwa_impl(q, Q, dA, ydef, *, increase: bool, part: str, chunk: int,
              weight, method: str, kernel: bool):
    wei_dA = dA / jnp.nanmax(dA) * dA if weight is None else weight
    if method == "fast":
        return _lwa_via_fast(q, Q, wei_dA, increase, False)
    if method == "lin":
        if kernel:
            return _lwa_lin_kernel(q, Q, wei_dA, increase, chunk)
        return _lwa_lin_xla(q, Q, wei_dA, increase, False, chunk)
    return _lwa_dense_xla(q, Q, wei_dA, ydef, increase=increase, part=part,
                          variant2=False, chunk=chunk)


@partial(jax.jit, static_argnames=("increase", "part", "chunk", "method"))
def _lwa2_impl(q, Q, dA, ydef, *, increase: bool, part: str, chunk: int,
               weight, method: str):
    wei_dA = dA / jnp.nanmax(dA) * dA if weight is None else weight
    if method == "fast":
        return _lwa_via_fast(q, Q, wei_dA, increase, True)
    if method == "lin":
        return _lwa_lin_xla(q, Q, wei_dA, increase, True, chunk)
    return _lwa_dense_xla(q, Q, wei_dA, ydef, increase=increase, part=part,
                          variant2=True, chunk=chunk)


def local_wave_activity(q, Q, dA, ydef, *, increase: bool, part: str = "all",
                        chunk: int = 16, weight=None, method: str = "auto"):
    """LWA (Huang-Nakamura 2016), reference core.py:696-799.

    q : (..., Ny, Nx) tracer;  Q : (..., Ny) sorted profile on ydef;
    dA : (Ny, Nx) cell areas;  ydef : (Ny,).
    Returns LWA (..., Ny, Nx): surface index j along axis -2.

    ``weight`` is the composed integration weight W(y, x); the default
    reproduces the reference's wei*dA with wei = dA/max(dA)
    (core.py:723-724, 789).  Pass wei*dy (the meridional line element) for the
    physically-united m/s form the reference's commented-out metric intends
    (core.py:787-788, SURVEY.md §0.2).

    ``method``: 'auto' (default), 'lin' (linearized 4-op kernels: ~2x the
    dense speed, f32 noise floor ~5e-5 of the max), 'dense' (pairwise
    3-valued mask, the reference's summation order, f32 ~1e-6), or 'fast'
    (sort-merge O(Ny log Ny), for tall equivalent dims).  See
    :func:`_resolve_method` for the auto policy.
    """
    part = part.lower()
    method = _resolve_method(method, part, q.shape[-2])
    return _lwa_impl(q, Q, dA, ydef, increase=increase, part=part,
                     chunk=chunk, weight=weight, method=method,
                     kernel=_lin_kernel())


def local_wave_activity2(q, Q, dA, ydef, *, increase: bool, part: str = "all",
                         chunk: int = 16, weight=None, method: str = "auto"):
    """Impulse-Casimir variant (core.py:802-905): qe = q_j - Q, mask branches
    swapped (core.py:865-872) while part selection keys off the original
    ``increase`` flag (core.py:879-890).  ``weight``/``method`` as in
    :func:`local_wave_activity`."""
    part = part.lower()
    method = _resolve_method(method, part, q.shape[-2])
    return _lwa2_impl(q, Q, dA, ydef, increase=increase, part=part,
                      chunk=chunk, weight=weight, method=method)


def lwa_masks_at(q, Q, dA, ydef, mask_idx, *, increase: bool,
                 variant2: bool = False):
    """Masks and contour values at selected surface indices, for plotting
    parity with the reference's ``mask_idx`` outputs (core.py:768-770).
    Returns (contours (..., K), masks (K, ..., Ny, Nx))."""
    coord_incre = ydef[-1] > ydef[0]
    idx = jnp.asarray(mask_idx)

    def one(j):
        if variant2:
            qj = jnp.take(q, j, axis=-2)
            qe = qj[..., None, :] - Q[..., :, None]
            inc = not increase
        else:
            Qj = jnp.take(Q, j, axis=-1)
            qe = q - Qj[..., None, None]
            inc = increase
        yj = ydef[j]
        m = jnp.where(coord_incre, ydef >= yj, ydef <= yj)[:, None]
        return _mask3(qe, m, inc)

    masks = jax.vmap(one)(idx)
    contours = jnp.take(Q, idx, axis=-1)
    return contours, masks
