"""Example 7 — Adjoint sensitivity of wave activity to the tracer field.

A capability with no counterpart in the reference stack: because the whole
rearrangement engine is functional JAX, ``jax.grad`` differentiates straight
through contours -> weighted CDF -> equivalent-latitude lookup -> sorted
profile -> LWA.  The map d(sum LWA^2)/dq(y, x) answers "where would a small
tracer perturbation change the wave activity the most?" — the starting point
for sensitivity and data-assimilation studies.

The histogram digitize is piecewise constant in q, so the gradient is the
almost-everywhere derivative (bucket-interior); see
tests/test_differentiable.py for the finite-difference validation.

Run:  python examples/ex7_adjoint.py   (writes ex7_adjoint.png)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _pins import _pin  # shared golden-pin helper (examples/_pins.py)

import numpy as np
import jax
import jax.numpy as jnp

from xcontour_tpu import grid as G
from xcontour_tpu import core, pipeline
from xcontour_tpu.diagnostics import lwa as _lwa
from xcontour_tpu.utils import synth


def main():
    ds, _ = synth.synth_barotropic_vorticity()
    lat = np.asarray(ds["latitude"])[::2]
    lon = np.asarray(ds["longitude"])[::2]
    vor = np.asarray(ds["absolute_vorticity"])[::2, ::2]
    grid = G.from_latlon(lat, lon)
    mask = jnp.ones(vor.shape)
    ydef, dA = grid.ydef, grid.dA

    def total_wave_activity_sq(tr):
        table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                 increase=True, lt=True)
        ctr = core.cal_contours(tr[None], 61, increase=True)
        ia = core.cal_integral_within_contours_hist(tr[None], ctr, dA,
                                                    lt=True)
        Q = core.interp_to_coords(ydef, table.lookup_coordinates(ia), ctr)
        lwa = _lwa.local_wave_activity(tr[None], Q, dA, ydef, increase=True)
        return jnp.nansum(lwa * lwa)

    v = jnp.asarray(vor)
    value, sens = jax.value_and_grad(total_wave_activity_sq)(v)
    sens = np.asarray(sens)
    print(f"sum(LWA^2) = {float(value):.4e}; "
          f"|dJ/dq| max {np.abs(sens).max():.3e}, "
          f"finite fraction {np.isfinite(sens).mean():.3f}")

    # The Keff tail is differentiable too (NaN-primal-preserving safe
    # divisions): where would a tracer perturbation change the mixing
    # diagnostic the most?
    def total_nkeff(tr):
        out = pipeline.keff_pipeline(tr[None], grid, N=61, lmin="analytic")
        return jnp.nansum(out["origin"]["nkeff"])

    kval, ksens = jax.value_and_grad(total_nkeff)(v)
    ksens = np.asarray(ksens)
    print(f"sum(nkeff) = {float(kval):.4e}; "
          f"|dJ/dq| max {np.abs(ksens).max():.3e}, "
          f"finite fraction {np.isfinite(ksens).mean():.3f}")
    assert np.isfinite(sens).all() and np.isfinite(ksens).all()
    assert np.abs(sens).max() > 0 and np.abs(ksens).max() > 0
    # golden pins on the seeded snapshot: the two losses' values from the
    # float64 oracle (tools/pin_examples.py); the oracle has no gradient,
    # so the gradients are checked only for being finite and nonzero
    _pin("sum_lwa_sq", float(value), 6.325803e16, rtol=1e-2)
    _pin("sum_nkeff", float(kval), 1166.187, rtol=1e-2)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, figsize=(10, 10), sharex=True)
    axes[0].contourf(lon, lat, vor * 1e5, levels=21, cmap="RdBu_r")
    axes[0].set_title("absolute vorticity (1e-5 s$^{-1}$)")
    lim = np.percentile(np.abs(sens), 99.5)
    cf = axes[1].contourf(lon, lat, sens, levels=np.linspace(-lim, lim, 21),
                          cmap="PiYG", extend="both")
    axes[1].set_title(r"adjoint sensitivity  $\partial\,\Sigma LWA^2 / "
                      r"\partial q(y,x)$")
    fig.colorbar(cf, ax=axes[1], shrink=0.9)
    klim = np.percentile(np.abs(ksens), 99.5)
    cfk = axes[2].contourf(lon, lat, ksens,
                           levels=np.linspace(-klim, klim, 21),
                           cmap="BrBG", extend="both")
    axes[2].set_title(r"adjoint sensitivity  $\partial\,\Sigma nK_{eff} / "
                      r"\partial q(y,x)$")
    fig.colorbar(cfk, ax=axes[2], shrink=0.9)
    out_png = os.path.join(os.path.dirname(__file__), "ex7_adjoint.png")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    print("wrote", out_png)



if __name__ == "__main__":
    main()
