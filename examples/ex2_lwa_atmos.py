"""Example 2 — Local finite-amplitude wave activity (Huang–Nakamura 2016).

Mirrors reference notebooks/2.LWA_atmos.ipynb on the seeded barotropic
vorticity snapshot (utils.synth): sorted state via the area table, LWA with the physical
wei*dy metric (m/s), and the zonal-mean-LWA == FAWA check.

Run:  python examples/ex2_lwa_atmos.py   (writes ex2_lwa_atmos.png)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _pins import _pin  # shared golden-pin helper (examples/_pins.py)

import numpy as np
import jax.numpy as jnp

from xcontour_tpu import grid as G
from xcontour_tpu.utils import synth
from xcontour_tpu.pipeline import lwa_pipeline


def main():
    ds, _ = synth.synth_barotropic_vorticity()
    lat = np.asarray(ds["latitude"])
    lon = np.asarray(ds["longitude"])
    vor = np.asarray(ds["absolute_vorticity"])
    grid = G.from_latlon(lat, lon)

    out = lwa_pipeline(jnp.asarray(vor), grid, N=121, increase=True, lt=True,
                       metric="dy")
    lwa = np.asarray(out["lwa"])
    lwa2 = np.asarray(out["lwa2"])

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 7))
    axes[0, 0].contourf(lon, lat, vor * 1e5, levels=21, cmap="RdBu_r")
    axes[0, 0].set_title("vorticity x 1e5")
    m = axes[1, 0].contourf(lon, lat, lwa, levels=np.linspace(0, 30, 31),
                            cmap="jet", extend="both")
    axes[1, 0].set_title("local FAWA (LWA), m/s")
    fig.colorbar(m, ax=axes[1, 0])
    m = axes[1, 1].contourf(lon, lat, -lwa2, levels=np.linspace(0, 30, 31),
                            cmap="jet", extend="both")
    axes[1, 1].set_title("impulse-Casimir wave activity, m/s")
    fig.colorbar(m, ax=axes[1, 1])
    axes[0, 1].plot(np.nanmean(lwa, axis=1), lat, label="zonal-mean LWA")
    axes[0, 1].plot(np.nanmean(-lwa2, axis=1), lat, "--", label="-LWA2")
    axes[0, 1].legend()
    axes[0, 1].set_title("FAWA profile")
    fig.tight_layout()
    fig.savefig(os.path.join(os.path.dirname(__file__), "ex2_lwa_atmos.png"),
                dpi=110)
    print("max LWA (m/s):", float(np.nanmax(lwa)))
    # reference notebook 2 scale: tens of m/s
    assert 10.0 < float(np.nanmax(lwa)) < 100.0
    # golden pins on the seeded snapshot, from the float64 oracle
    # (tools/pin_examples.py)
    _pin("lwa_max", float(np.nanmax(lwa)), 73.30085, rtol=2e-3)
    _pin("lwa2_min", float(np.nanmin(lwa2)), -99.36034, rtol=2e-3)
    _pin("lwa_zonal_mean_peak", float(np.nanmax(np.nanmean(lwa, axis=1))),
         17.5198, rtol=2e-3)



if __name__ == "__main__":
    main()
