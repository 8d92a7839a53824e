"""Example 4 — Contour perimeter lengths and fractal dimension.

Mirrors reference notebooks/4.ContourLength_ocean.ipynb +
tests/test_fractal.py: actual contour length L vs equivalent length L_eq vs
minimum length L_min (the Cauchy–Schwarz chain L_eq >= L >= L_min), plus the
multi-scale length ladder -> box-counting fractal dimension.

Run:  python examples/ex4_contour_length.py  (writes ex4_contour_length.png)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _pins import _pin  # shared golden-pin helper (examples/_pins.py)

import numpy as np
import jax.numpy as jnp

from xcontour_tpu import grid as G
from xcontour_tpu.utils import synth
from xcontour_tpu.pipeline import clength_pipeline, fractal_pipeline


def main():
    ds, _ = synth.synth_barotropic_vorticity()
    lat = np.asarray(ds["latitude"])
    lon = np.asarray(ds["longitude"])
    vor = np.asarray(ds["absolute_vorticity"])
    grid = G.from_latlon(lat, lon)

    out = clength_pipeline(jnp.asarray(vor), grid, N=121, increase=True,
                           lt=True)
    fr = fractal_pipeline(jnp.asarray(vor), grid, N=121,
                          strides=(1, 2, 4, 8, 16, 32))

    L = np.asarray(out["lengths"])
    Leq = np.sqrt(np.asarray(out["Leq2"]))
    Lmin = np.asarray(out["Lmin"])
    Yeq = np.asarray(out["Yeq"])

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 4.5))
    axes[0].contourf(lon, lat, vor, levels=41)
    axes[0].set_title("vorticity")
    axes[1].plot(L / Lmin, Yeq, label="$L$")
    axes[1].plot(Leq / Lmin, Yeq, label="$L_{eq}$")
    axes[1].axvline(1.0, color="k", lw=0.5)
    axes[1].set_xlim(0, 8)
    axes[1].set_title("contour length / $L_{min}$")
    axes[1].legend()
    axes[2].plot(np.asarray(fr["D"]), np.asarray(fr["Yeq"]), label="marching")
    axes[2].plot(np.asarray(fr["D_bc"]), np.asarray(fr["Yeq"]), "--",
                 label="box counting")
    axes[2].set_xlim(0.9, 1.8)
    axes[2].set_title("fractal dimension")
    axes[2].legend()
    fig.tight_layout()
    fig.savefig(os.path.join(os.path.dirname(__file__),
                             "ex4_contour_length.png"), dpi=110)
    D = float(np.nanmedian(np.asarray(fr["D"])))
    print("median D:", D)
    assert 1.0 <= D < 2.0, "fractal dimension of a plane curve"
    # golden pins on the seeded snapshot, from the float64 oracle
    # (tools/pin_examples.py)
    _pin("D_median", D, 1.069339, rtol=2e-3)
    sl = slice(10, -10)
    ratio = (L / Lmin)[sl]
    _pin("L_over_Lmin_median", float(np.nanmedian(ratio)), 1.186488,
         rtol=2e-3)
    _pin("L_median_km", float(np.nanmedian(L[sl])) / 1e3, 38955.77,
         rtol=2e-3)



if __name__ == "__main__":
    main()
