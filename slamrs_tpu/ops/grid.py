"""Log-odds occupancy grid primitives: DDA ray traversal, measurement
integration (scatter-add), and measurement likelihood (gather).

Parity surface:

* ``GridRayIterator`` (slamrs/slam/src/grid/ray.rs:5-111) — an integer DDA
  / Bresenham-supercover walk emitting every cell a ray crosses plus
  ``additional_steps`` overshoot cells, stopping at the first out-of-bounds
  cell.  Reproduced exactly as a fixed-length ``lax.scan`` with an "alive"
  mask (:func:`traverse_ray`), batched over arbitrary leading axes.
* ``Map::integrate`` / ``inverse_sensor_model`` (slamrs/slam/src/grid/
  map.rs:71-106, 148-172) — per visited cell, add the inverse-sensor-model
  log-odds.  Becomes one big scatter-add over ``[beams × steps]``
  (:func:`grid_integrate`).
* ``Map::probability_of`` (map.rs:113-145) — per-valid-beam endpoint gather
  with the Z_HIT mixture, product in log space
  (:func:`grid_log_likelihood`).

Design: the reference mutates one cell at a time inside nested loops
(beams × ray cells × particles).  Here every (beam, step) lane is
computed in parallel and a single ``.at[rows, cols].add(values)`` performs
the whole update; ``vmap`` lifts it over particles (grids stay resident in
device memory as ``f32[P, H, W]``).  Scatter-add ordering differs from the
reference's sequential order only in float rounding.

Grid layout: arrays are ``[H, W]`` indexed ``grid[row=y, col=x]``.  (The
reference indexes ``row * size.y + column`` — map.rs:200-214 — which is
only consistent for square grids; this implementation uses the standard
row-major ``[H, W]`` layout, identical for every configuration the
reference ships and correct for non-square grids.)
"""

from __future__ import annotations

import dataclasses
import math as pymath

import jax
import jax.numpy as jnp

Array = jnp.ndarray

# Inverse sensor model constants (map.rs:107-109, 148-172).
P_FREE = 0.30
P_OCCUPIED = 0.9
P_PRIOR = 0.5
Z_HIT = 0.9
SENSOR_MAXDIST = 1.0  # meters
TOLERANCE_CELLS = 2.0  # `tolerance` argument at map.rs:104
ADDITIONAL_STEPS = 2  # GridRayIterator overshoot (map.rs:95-97)

L_FREE = pymath.log(P_FREE / (1.0 - P_FREE))
L_OCCUPIED = pymath.log(P_OCCUPIED / (1.0 - P_OCCUPIED))
L_PRIOR = 0.0
# NOTE on log-odds saturation: the reference accumulates unbounded f64
# log-odds (map.rs:102-105), so long-exposed cells become practically
# immutable; in bf16 storage they freeze outright (eps(39000) >> L_OCC).
# A +-50 clamp was tried and REVERTED: keeping mature cells plastic makes
# the map churn with per-scan noise and measurably degrades localization
# (2-4 cm -> 9-15 cm final error over 2,000-scan rollouts, 4 seeds).
# Unbounded growth IS the reference behavior and acts as implicit map
# annealing; revisability after saturation is equally absent in the
# reference.
LOGODDS_CLAMP = None  # kept for documentation; no fast-path clamping


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Static geometry of an occupancy grid.

    Parity: ``Map::new`` (map.rs:26-48): cell counts are ceil(extent /
    resolution); ``position`` is the world coordinate of the lower-left
    corner.  Frozen/hashable so it can be a static jit argument.
    """

    position_x: float
    position_y: float
    width: float  # world meters
    height: float  # world meters
    resolution: float  # meters per cell

    @property
    def cols(self) -> int:  # grid_size.x
        return int(pymath.ceil(self.width / self.resolution))

    @property
    def rows(self) -> int:  # grid_size.y
        return int(pymath.ceil(self.height / self.resolution))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows, self.cols)

    def world_to_grid(self, xy: Array) -> Array:
        """Continuous world -> grid coordinates (map.rs:60-62)."""
        pos = jnp.array([self.position_x, self.position_y], jnp.float32)
        return (xy - pos) / self.resolution

    def new_grid(self, batch_shape=(), dtype=jnp.float32) -> Array:
        """Fresh log-odds grid at the prior (Probability 0.5 -> 0.0)."""
        return jnp.zeros((*batch_shape, self.rows, self.cols), dtype)

    def max_ray_steps(self, max_range_m: float) -> int:
        """Static bound on DDA steps for rays up to ``max_range_m``."""
        cells = max_range_m / self.resolution
        return int(pymath.ceil(cells * pymath.sqrt(2.0))) + ADDITIONAL_STEPS + 3


def traverse_ray(x0: Array, y0: Array, x1: Array, y1: Array,
                 cols: int, rows: int, max_steps: int,
                 additional_steps: int = ADDITIONAL_STEPS):
    """Integer DDA walk from (x0,y0) to (x1,y1) in grid coordinates.

    Exact replication of GridRayIterator (grid/ray.rs:5-111): the step
    count budget, the error-accumulator advance rule (y moves when
    error > 0), the +0.5 cell centers, and stop-at-first-out-of-bounds.

    All coordinate arguments broadcast over leading batch axes.

    Returns:
      cols_idx i32[..., max_steps], rows_idx i32[..., max_steps],
      centers f32[..., max_steps, 2], mask bool[..., max_steps].
    """
    x0, y0, x1, y1 = jnp.broadcast_arrays(
        jnp.asarray(x0, jnp.float32), jnp.asarray(y0, jnp.float32),
        jnp.asarray(x1, jnp.float32), jnp.asarray(y1, jnp.float32))

    dx = jnp.abs(x1 - x0)
    dy = jnp.abs(y1 - y0)

    fx0 = jnp.floor(x0)
    fy0 = jnp.floor(y0)
    fx1 = jnp.floor(x1)
    fy1 = jnp.floor(y1)

    x = fx0.astype(jnp.int32)
    y = fy0.astype(jnp.int32)

    # Step budget n (ray.rs:36-66).
    n = 1 + additional_steps
    n = n + jnp.where(
        dx == 0.0, 0,
        jnp.where(x1 > x0, (fx1 - fx0).astype(jnp.int32),
                  (fx0 - fx1).astype(jnp.int32)))
    n = n + jnp.where(
        dy == 0.0, 0,
        jnp.where(y1 > y0, (fy1 - fy0).astype(jnp.int32),
                  (fy0 - fy1).astype(jnp.int32)))

    x_inc = jnp.where(dx == 0.0, 0, jnp.where(x1 > x0, 1, -1)).astype(jnp.int32)
    y_inc = jnp.where(dy == 0.0, 0, jnp.where(y1 > y0, 1, -1)).astype(jnp.int32)

    err_x = jnp.where(dx == 0.0, jnp.inf,
                      jnp.where(x1 > x0, (fx0 + 1.0 - x0) * dy, (x0 - fx0) * dy))
    err_y = jnp.where(dy == 0.0, jnp.inf,
                      jnp.where(y1 > y0, (fy0 + 1.0 - y0) * dx, (y0 - fy0) * dx))
    error = err_x - err_y  # may be NaN when both deltas are 0, as in the
    # reference (inf - inf); NaN > 0 is false so the walk stays put.

    alive0 = jnp.ones(x.shape, bool)

    def body(carry, _):
        x, y, error, remaining, alive = carry
        in_bounds = (x >= 0) & (x < cols) & (y >= 0) & (y < rows)
        emit = alive & (remaining > 0) & in_bounds  # ray.rs:85-90

        # advance (ray.rs:96-102): move in y when error > 0, else x.
        go_y = error > 0.0
        nx = jnp.where(go_y, x, x + x_inc)
        ny = jnp.where(go_y, y + y_inc, y)
        nerror = jnp.where(go_y, error - dx, error + dy)

        out = (x, y, emit)
        return (nx, ny, nerror, remaining - 1, emit), out

    (_, _, _, _, _), (xs, ys, mask) = jax.lax.scan(
        body, (x, y, error, n, alive0), None, length=max_steps)

    # scan stacks along axis 0; move the step axis last.
    xs = jnp.moveaxis(xs, 0, -1)
    ys = jnp.moveaxis(ys, 0, -1)
    mask = jnp.moveaxis(mask, 0, -1)
    centers = jnp.stack(
        [xs.astype(jnp.float32) + 0.5, ys.astype(jnp.float32) + 0.5], axis=-1)
    return xs, ys, centers, mask


def inverse_sensor_model_log_odds(distance: Array, measured_distance: Array,
                                  was_hit: Array,
                                  tolerance: float = TOLERANCE_CELLS) -> Array:
    """Log-odds increment for a visited cell (map.rs:148-172).

    Distances are in grid-cell units; ``was_hit`` is the beam's valid flag.
    """
    half = tolerance / 2.0
    hit_val = jnp.where(
        distance < measured_distance - half, L_FREE,
        jnp.where(distance > measured_distance + half, L_PRIOR, L_OCCUPIED))
    miss_val = jnp.where(distance < measured_distance, L_FREE, L_PRIOR)
    return jnp.where(was_hit, hit_val, miss_val).astype(jnp.float32)


def scan_endpoints(pose: Array, angles: Array, distances: Array) -> Array:
    """World-frame beam endpoints: pose.xy + R(theta) * polar(angle, dist).

    Parity: the endpoint formula repeated at map.rs:75-78 and map.rs:120-123.
    pose f32[..., 3]; angles/distances f32[..., B] -> f32[..., B, 2].
    """
    a = pose[..., 2:3] + angles
    ex = pose[..., 0:1] + jnp.cos(a) * distances
    ey = pose[..., 1:2] + jnp.sin(a) * distances
    return jnp.stack([ex, ey], axis=-1)


def grid_integrate(grid: Array, spec: GridSpec2D, pose: Array, angles: Array,
                   distances: Array, valid: Array, present: Array,
                   max_steps: int) -> Array:
    """Integrate one scan into a log-odds grid.

    Parity: Map::integrate + apply_measurement (map.rs:71-106): every
    *present* measurement (valid or not) walks the DDA from the robot cell
    to its endpoint cell (+2 overshoot) and adds inverse-sensor-model
    log-odds; invalid beams mark free space up to the sensor range.

    Args:
      grid: f32[H, W] log-odds.
      pose: f32[3]; angles/distances/valid/present: [B] beam lanes.
      max_steps: static DDA bound (use ``spec.max_ray_steps(range)``).

    Returns the updated grid.  Lift over particles/worlds with ``vmap``.
    """
    start = spec.world_to_grid(pose[..., 0:2])  # f32[2]
    ends_w = scan_endpoints(pose, angles, distances)  # [B, 2]
    ends = spec.world_to_grid(ends_w)
    measured_cells = distances / spec.resolution  # [B]

    xs, ys, centers, mask = traverse_ray(
        start[..., 0], start[..., 1], ends[..., 0], ends[..., 1],
        spec.cols, spec.rows, max_steps)  # [B, T]

    mask = mask & present[..., None]

    d = jnp.linalg.norm(centers - start[..., None, None, :], axis=-1)  # [B, T]
    vals = inverse_sensor_model_log_odds(
        d, measured_cells[..., None], valid[..., None])
    vals = jnp.where(mask, vals, 0.0)
    xs = jnp.where(mask, xs, 0)
    ys = jnp.where(mask, ys, 0)

    return grid.at[ys, xs].add(vals, mode="promise_in_bounds")


def grid_integrate_dense(grid: Array, spec: GridSpec2D, pose: Array,
                         angles: Array, distances: Array, valid: Array,
                         present: Array, window: int,
                         multiplicity: bool = True) -> Array:
    """Scatter-free scan integration.

    Same inverse sensor model as :func:`grid_integrate` (map.rs:148-172)
    but formulated *dense*: every cell in a ``window x window`` region
    around the robot computes its own polar coordinates (r, phi) relative
    to the pose, looks up the beam covering phi (the scan is a uniform
    angular table — 1 degree spacing in every reference configuration),
    and applies the inverse-sensor-model log-odds directly.  This replaces
    the reference's per-beam DDA walk + per-cell mutation with pure
    vectorized elementwise math + one table gather — no scatter over the
    beam walk.

    Semantic note vs the DDA path: the DDA increments a cell once per
    *beam visit*, so near the robot (where many beams cross one cell)
    log-odds accumulate multiplicity-fold per scan.  With
    ``multiplicity=True`` the dense update compensates by scaling the
    increment with the local beam density ``max(1, 1/(r * dphi))``,
    matching the DDA's aggregate behavior; beyond ``r = cell/dphi``
    (~16 cells for 360 beams) both formulations visit each cell once.
    Cells farther than ``measured + tolerance/2`` along their beam get a
    zero increment in both formulations, so the support matches the DDA
    walk (which stops ``additional_steps = 2`` cells past the endpoint).

    ``window`` is a static cell count (use
    :func:`dense_window_for` to size it from the scan range).
    """
    b = angles.shape[-1]
    # honor the scan's true angular spacing (the simulator emits
    # 1-degree tables regardless of beam count, simulator.py:155) —
    # assuming 2*pi/b mis-bins every cell for partial-sector tables
    if b > 1:
        dphi = angles[..., 1] - angles[..., 0]
    else:
        dphi = jnp.float32(2.0 * jnp.pi)
    start = spec.world_to_grid(pose[..., 0:2])  # grid coords, continuous

    # full-grid mode when the window covers most of the grid: skips the
    # batched dynamic slice/update (which lowers to gather/scatter under
    # vmap) at the price of a little extra elementwise math.
    full = window * window * 2 >= spec.rows * spec.cols
    wh, ww = (spec.rows, spec.cols) if full else (window, window)

    if full:
        ox = jnp.zeros((), jnp.int32)
        oy = jnp.zeros((), jnp.int32)
    else:
        ox = jnp.clip(jnp.floor(start[..., 0]).astype(jnp.int32) - ww // 2,
                      0, max(spec.cols - ww, 0))
        oy = jnp.clip(jnp.floor(start[..., 1]).astype(jnp.int32) - wh // 2,
                      0, max(spec.rows - wh, 0))

    # cell centers of the window, in grid coords
    wy = jax.lax.broadcasted_iota(jnp.int32, (wh, ww), 0)
    wx = jax.lax.broadcasted_iota(jnp.int32, (wh, ww), 1)
    cx = (ox + wx).astype(jnp.float32) + 0.5
    cy = (oy + wy).astype(jnp.float32) + 0.5

    dx = cx - start[..., 0]
    dy = cy - start[..., 1]
    r = jnp.sqrt(dx * dx + dy * dy)  # cell units (matches map.rs:100)

    # beam lookup: world angle of the cell minus robot heading, wrapped
    # in ANGLE space; cells past the last beam either wrap to beam 0
    # (full-circle tables) or fall outside the swept sector (absent)
    two_pi = 2.0 * jnp.pi
    phi = jnp.arctan2(dy, dx) - pose[..., 2]
    rel = phi - angles[..., 0]  # relative to the scan's first beam angle
    rel = rel - two_pi * jnp.floor(rel / two_pi)
    t = rel / dphi
    beam_f = jnp.round(t)
    wrap = beam_f >= two_pi / dphi - 0.5
    in_sector = wrap | (beam_f <= b - 1)
    beam = jnp.where(wrap | ~in_sector, 0.0, beam_f).astype(jnp.int32)

    # beam-table lookup: one gather per field
    d_meas = jnp.take(distances / spec.resolution, beam)
    was_hit = jnp.take(valid, beam)
    pres = jnp.take(present, beam) & in_sector

    inc = inverse_sensor_model_log_odds(r, d_meas, was_hit)
    if multiplicity:
        inc = inc * jnp.maximum(1.0, 1.0 / (jnp.maximum(r, 0.5) * dphi))
    inc = jnp.where(pres, inc, 0.0)

    if full:
        return grid + inc
    win = jax.lax.dynamic_slice(grid, (oy, ox), (wh, ww))
    return jax.lax.dynamic_update_slice(grid, win + inc, (oy, ox))


def dense_window_for(spec: GridSpec2D, max_range_m: float,
                     align: int = 8) -> int:
    """Static window size covering the scan range (+tolerance) each side."""
    cells = int(pymath.ceil(max_range_m / spec.resolution)) + ADDITIONAL_STEPS + 2
    w = 2 * cells + 1
    w = min(w, min(spec.rows, spec.cols))
    return max((w + align - 1) // align * align, align)


def grid_log_likelihood(grid: Array, spec: GridSpec2D, pose: Array,
                        angles: Array, distances: Array, valid: Array,
                        present: Array) -> Array:
    """log p(z | m, x): per-valid-beam endpoint mixture, product in log space.

    Parity: Map::probability_of (map.rs:113-145): for each valid beam whose
    endpoint lies in the grid, multiply ``Z_HIT * p + (1-Z_HIT)/maxdist``
    (or the uniform ``1/maxdist`` when the cell is untouched, log-odds == 0).

    Returns f32[] (log probability).  Lift with ``vmap`` for particles.
    """
    ends = spec.world_to_grid(scan_endpoints(pose, angles, distances))  # [B,2]
    gx = ends[..., 0]
    gy = ends[..., 1]
    in_bounds = (gx >= 0.0) & (gy >= 0.0) & (gx < spec.cols) & (gy < spec.rows)
    use = valid & present & in_bounds

    xi = jnp.clip(gx.astype(jnp.int32), 0, spec.cols - 1)
    yi = jnp.clip(gy.astype(jnp.int32), 0, spec.rows - 1)
    odds = grid[yi, xi]

    p = 1.0 - 1.0 / (1.0 + jnp.exp(odds))
    mixture = Z_HIT * p + (1.0 - Z_HIT) / SENSOR_MAXDIST
    factor = jnp.where(odds == 0.0, 1.0 / SENSOR_MAXDIST, mixture)
    return jnp.sum(jnp.where(use, jnp.log(factor), 0.0), axis=-1)
