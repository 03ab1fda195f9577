"""Batched primitives and kernels.

Submodules (import them directly; functions keep their module namespaces so
module and function names never shadow each other):

* :mod:`slamrs_tpu.ops.raycast`  — beam x segment closest-hit raycasting
* :mod:`slamrs_tpu.ops.grid`     — occupancy-grid DDA / integrate / likelihood
* :mod:`slamrs_tpu.ops.resample` — systematic particle resampling
* :mod:`slamrs_tpu.ops.icp`      — point-to-normal ICP
"""

from slamrs_tpu.ops import raycast, grid, resample, icp  # noqa: F401
from slamrs_tpu.ops.grid import (  # noqa: F401
    GridSpec2D,
    grid_integrate,
    grid_log_likelihood,
    traverse_ray,
)
from slamrs_tpu.ops.resample import systematic_resample  # noqa: F401
from slamrs_tpu.ops.icp import icp_point_to_normal  # noqa: F401
