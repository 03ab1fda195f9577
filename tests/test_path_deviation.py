"""Quantify the fast paths' deviation from the exact DDA parity path
(VERDICT round-1 #6): run the SAME rollout (same keys, same commands)
through integrate="dda" / "dense" / "fused" and measure pose divergence
and occupancy-grid agreement.

The dense/fused formulations share the DDA's inverse sensor model but
rasterize the beam wedges differently (polar binning vs per-beam integer
walks) and compensate near-robot multiplicity with a density factor, so
cell-level differences are expected WITHIN the tolerance band; the gates
assert the deviation stays at the rasterization-noise level:

* best-particle pose RMSE between paths <= 2 cells
* occupancy classification agreement >= 90% of cells either path touched
  (disagreements concentrate on the 1-cell wedge/ring boundaries)
"""

import jax
import jax.numpy as jnp
import numpy as np

from slamrs_tpu.core.types import OdometryReading
from slamrs_tpu.models import gridslam as gs
from slamrs_tpu.models import simulator as sim_model
from slamrs_tpu.core import motion


def _rollout(integrate: str, T=6, p=6):
    cfg = gs.GridSlamConfig(position_x=-2.0, position_y=-2.0, width=4.0,
                            height=4.0, resolution=0.05, n_particles=p,
                            max_scan_range=1.0, integrate=integrate,
                            resample_neff_frac=1.0)
    scene = sim_model.Scene.build(
        rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1)],
        lines=[(-0.6, -0.4, 0.2, 0.4)])
    state = gs.GridSlamState.init(cfg)
    pose = jnp.zeros(3)
    key = jax.random.key(7)
    best = []
    for t in range(T):
        sl, sr = 0.004, 0.0065
        pose = motion.integrate_exact(pose, jnp.float32(sl), jnp.float32(sr),
                                      0.1)
        scan = sim_model.lidar_scan(pose, scene, 1.0, 360)
        odo = OdometryReading(jnp.float32(sl), jnp.float32(sr),
                              jnp.float32(0.1))
        key, k = jax.random.split(key)
        state, out = gs.update(state, scan, odo, k, cfg)
        best.append(np.asarray(out.pose))
    prob = gs.estimated_probability_grid(state)
    return np.stack(best), np.asarray(prob)


def test_fast_paths_match_dda_statistically():
    poses_dda, grid_dda = _rollout("dda")
    poses_dense, grid_dense = _rollout("dense")
    poses_fused, grid_fused = _rollout("fused")

    res = 0.05
    for name, poses, grid in (("dense", poses_dense, grid_dense),
                              ("fused", poses_fused, grid_fused)):
        rmse = float(np.sqrt(((poses[:, :2] - poses_dda[:, :2]) ** 2).mean()))
        assert rmse <= 2 * res, f"{name} pose RMSE vs dda: {rmse:.4f} m"

        # classify: occupied > 0.6, free < 0.4
        def cls(g):
            return np.where(g > 0.6, 1, np.where(g < 0.4, -1, 0))
        a, b = cls(grid_dda), cls(grid)
        touched = (a != 0) | (b != 0)
        agree = float((a[touched] == b[touched]).mean())
        print(f"{name}: pose RMSE {rmse*1000:.1f} mm, "
              f"cell agreement {agree:.3f} over {int(touched.sum())} cells")
        assert agree >= 0.90, f"{name} occupancy agreement {agree}"
