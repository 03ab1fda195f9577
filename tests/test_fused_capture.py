"""Fused path on REAL Neato captures (VERDICT r3 weak #5 / task #5).

Every other fused-path test feeds simulator scans at
``max_scan_range=1.0`` where each valid endpoint falls inside the kernel
window by construction.  The fused kernel's one documented semantic
deviation — a valid beam whose endpoint lies beyond the window
contributes nothing to the likelihood (ops/fused.py module docstring) —
only triggers on real captures with returns beyond the configured range.

out2.bin (98 frames) has ~3.3k valid beams past 2 m (up to 5.4 m): with
``max_scan_range=2.0`` on an 8x8 m grid those endpoints land INSIDE the
grid but OUTSIDE the fused compute window, exercising the deviation on
the data that actually produces it.  The gate bounds fused-vs-dda pose
deviation and map classification agreement under identical random draws.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamrs_tpu.core.types import OdometryReading, Scan
from slamrs_tpu.models import gridslam as gs

DATA = Path("/root/reference/slamrs/baseui/data")
N_FRAMES = 45  # first leg of the capture (full 98 gated by longrun cost)
MAX_RANGE = 2.0


def _frames():
    from slamrs_tpu.io.neato import load_neato_binary

    return load_neato_binary(DATA / "out2.bin")[:N_FRAMES]


def _config(integrate, grid_dtype="float32"):
    return gs.GridSlamConfig(position_x=-4.0, position_y=-4.0, width=8.0,
                             height=8.0, resolution=0.05, n_particles=4,
                             max_scan_range=MAX_RANGE, integrate=integrate,
                             resample_neff_frac=0.5, grid_dtype=grid_dtype)


def _run(cfg, frames):
    state = gs.GridSlamState.init(cfg)
    upd = jax.jit(lambda st, sc, od, k: gs.update(st, sc, od, k, cfg))
    odo = OdometryReading(jnp.float32(0.0), jnp.float32(0.0),
                          jnp.float32(0.2))
    key = jax.random.key(11)
    track = []
    for f in frames:
        angles, dist, strength, valid, present = f.to_scan_arrays()
        scan = Scan(jnp.asarray(angles), jnp.asarray(dist),
                    jnp.asarray(strength), jnp.asarray(valid),
                    jnp.asarray(present))
        key, k = jax.random.split(key)
        state, out = upd(state, scan, odo, k)
        track.append(np.asarray(out.pose))
    return np.stack(track), np.asarray(
        gs.estimated_probability_grid(state), np.float32)


@pytest.mark.skipif(not DATA.exists(), reason="reference recordings absent")
def test_fused_on_real_capture_exercises_out_of_window_beams():
    frames = _frames()

    # precondition: the capture really does produce valid endpoints
    # beyond the fused window (~2.2 m of half-window at 0.05 m cells) —
    # without this the gate would silently test nothing
    long_beams = 0
    for f in frames:
        _, dist, _, valid, _ = f.to_scan_arrays()
        long_beams += int((np.asarray(dist)[np.asarray(valid)]
                           > MAX_RANGE + 0.3).sum())
    assert long_beams > 300, f"capture lost its long returns? {long_beams}"

    track_d, grid_d = _run(_config("dda"), frames)
    track_f, grid_f = _run(_config("fused", grid_dtype="bfloat16"), frames)

    # pose deviation: identical motion draws, likelihood deviation only
    # through the dropped out-of-window beams + rasterization noise.
    # Recorded on this config/seed: RMSE 16.4 mm, final offset 28.6 mm,
    # map agreement 0.947 (thresholds ~3-6x measured).
    rmse = float(np.sqrt(
        ((track_f[:, :2] - track_d[:, :2]) ** 2).mean()))
    final = float(np.linalg.norm(track_f[-1, :2] - track_d[-1, :2]))
    print(f"fused-vs-dda on out2.bin[{len(frames)}]: RMSE {rmse * 1000:.1f}"
          f" mm, final {final * 1000:.1f} mm")
    assert rmse <= 0.10, f"fused-vs-dda pose RMSE {rmse:.4f} m"
    assert final <= 0.20, f"final pose offset {final:.4f} m"

    # map classification agreement on cells both paths touched
    def cls(g):
        return np.where(g > 0.6, 1, np.where(g < 0.4, -1, 0))

    a = cls(grid_d)
    b = cls(grid_f[:a.shape[0], :a.shape[1]])
    touched = (a != 0) & (b != 0)
    assert touched.sum() > 1000  # both maps actually built structure
    agree = float((a[touched] == b[touched]).mean())
    print(f"map agreement {agree:.3f} over {int(touched.sum())} cells")
    assert agree >= 0.80, f"occupancy agreement {agree:.3f}"
