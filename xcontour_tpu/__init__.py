"""xcontour_tpu — contour-coordinate diagnostics in JAX.

A from-scratch JAX framework (XLA, and a Pallas kernel on the GPU) with the
capabilities of miniufo/xcontour: conservative
rearrangement of quasi-conservative tracers into contour/equivalent-latitude
coordinates, and the diagnostics built on it — effective diffusivity (Nakamura
1996), local finite-amplitude wave activity (Huang-Nakamura 2016), local APE
(Winters-Barkan 2013), and contour perimeter / fractal geometry.

See SURVEY.md for the reference layer map this package re-implements.
"""

__version__ = "0.1.0"

from . import grid  # noqa: F401
from . import compat  # noqa: F401
from .grid import (  # noqa: F401
    Grid, from_latlon, from_cartesian, from_xz, from_metrics,
    equivalent_latitudes, latitude_lengths_at,
)
from .core import (  # noqa: F401
    Contour2D, Table,
    cal_contours, cal_area_eqCoord_table, cal_area_eqCoord_table_hist,
    cal_integral_within_contours, cal_integral_within_contours_hist,
    cal_integral_within_contours_exact,
    cal_gradient_wrt_area, cal_contour_weigh_mean, cal_contour_weigh_mean_hist,
    cal_contour_mean, cal_contour_mean_hist, cal_sqared_equivalent_length,
    cal_normalized_Keff, interp_to_coords, cal_contours_at,
)
from . import pipeline  # noqa: F401
from . import runner  # noqa: F401
from . import config  # noqa: F401
# the reference's top-level metric builders (its __init__.py exports them
# from utils); the full reference namespace lives in .xcontour
from .xcontour import (  # noqa: F401
    add_latlon_metrics, add_latlon_metrics_old, add_MITgcm_missing_metrics,
    contour_area, contour_length,
)
from .diagnostics.lwa import (  # noqa: F401
    local_wave_activity, local_wave_activity2, lwa_masks_at,
)
from .diagnostics.length import contour_lengths, contour_crossing  # noqa: F401
from .ops.stencil import squared_gradient, gradient  # noqa: F401
from .utils.constants import Rearth, g, omega, deg2m  # noqa: F401
