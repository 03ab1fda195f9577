"""ICP scan-to-map odometry frontend with a growing point map.

Parity surface: ``IcpPointMapper`` (slamrs/slam/src/pointmap.rs:20-96):
the first scan initializes the map (projected at the identity pose,
pointmap.rs:38-43); every later scan is matched against the map with
point-to-normal ICP starting from the previous pose estimate, the estimate
is replaced by the ICP result, and the transformed scan points are appended
to the map (pointmap.rs:45-76).

Design:

* The reference's map grows unbounded (subsampling is an acknowledged TODO
  at pointmap.rs:67).  A traced array cannot grow, so the map is a
  fixed-capacity buffer ``f32[C, 2]`` + count; appends past capacity are
  dropped (newest-dropped policy keeps map geometry stable for matching).
* Optional voxel dedup (``voxel_size``): a new point is appended only if
  its voxel is not yet occupied by a map point, tracked in a bitmap carried
  in the state — this bounds the map by world area rather than scan count
  and keeps the NN matmul small.  Disabled by default for reference parity.
* "first scan initializes" (data-dependent control flow) becomes an
  ``initialized`` flag + ``where`` select: ICP against a zero-count map
  yields zero normals, hence a zero Gauss-Newton system and a zero step,
  so running it unconditionally is safe; outputs are select-blended.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

from slamrs_tpu.core.types import Scan
from slamrs_tpu.ops import icp as _icp
from slamrs_tpu.ops.grid import GridSpec2D

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class IcpMapConfig:
    """Static config.  Parity: IcpParameters (icp.rs:14-27) + map policy."""

    capacity: int = 16384
    iterations: int = 10
    step_threshold: float | None = None  # None == Uniform weights
    voxel_size: float | None = None  # None == append-all (reference behavior)
    # voxel bitmap extent (only used when voxel_size is set)
    extent_x: float = -10.0
    extent_y: float = -10.0
    extent_w: float = 20.0
    extent_h: float = 20.0

    @property
    def voxel_spec(self) -> GridSpec2D | None:
        if self.voxel_size is None:
            return None
        return GridSpec2D(self.extent_x, self.extent_y, self.extent_w,
                          self.extent_h, self.voxel_size)


class IcpMapState(NamedTuple):
    points: Array  # f32[..., C, 2] map buffer
    count: Array  # i32[...] valid lanes
    pose: Array  # f32[..., 3] current estimate
    initialized: Array  # bool[...]
    voxel_bitmap: Array  # bool[..., VH, VW] (1x1 dummy when dedup is off)

    @staticmethod
    def init(config: IcpMapConfig, batch_shape=()) -> "IcpMapState":
        vs = config.voxel_spec
        bitmap_shape = vs.shape if vs is not None else (1, 1)
        return IcpMapState(
            points=jnp.zeros((*batch_shape, config.capacity, 2), jnp.float32),
            count=jnp.zeros(batch_shape, jnp.int32),
            pose=jnp.zeros((*batch_shape, 3), jnp.float32),
            initialized=jnp.zeros(batch_shape, bool),
            voxel_bitmap=jnp.zeros((*batch_shape, *bitmap_shape), bool),
        )


class IcpMapOutputs(NamedTuple):
    pose: Array  # f32[..., 3] (topic_pose)
    chi: Array  # f32[..., iterations] per-iteration chi (IcpResult.chi_values)
    appended: Array  # i32[...] points added to the map this update


def update(state: IcpMapState, scan: Scan, config: IcpMapConfig
           ) -> tuple[IcpMapState, IcpMapOutputs]:
    """One scan-matching update for a single world (vmap for fleets)."""
    identity = jnp.zeros(3, jnp.float32)
    p, p_mask = scan.to_points(identity)  # [B, 2], [B] (pointmap.rs:38)

    result = _icp.icp_point_to_normal(
        p, p_mask, state.points, state.count, state.pose,
        iterations=config.iterations, step_threshold=config.step_threshold)

    # first scan: keep pose at default, insert raw points (pointmap.rs:40-43)
    new_pose = jnp.where(state.initialized, result.transformation, state.pose)
    insert_pts = jnp.where(state.initialized, result.transformed_points, p)

    # voxel dedup gate (optional)
    keep = p_mask
    bitmap = state.voxel_bitmap
    vs = config.voxel_spec
    if vs is not None:
        g = vs.world_to_grid(insert_pts)  # [B, 2]
        gx = g[..., 0].astype(jnp.int32)
        gy = g[..., 1].astype(jnp.int32)
        in_b = (g[..., 0] >= 0) & (g[..., 1] >= 0) & \
               (g[..., 0] < vs.cols) & (g[..., 1] < vs.rows)
        gx = jnp.clip(gx, 0, vs.cols - 1)
        gy = jnp.clip(gy, 0, vs.rows - 1)
        keep = keep & in_b & ~bitmap[gy, gx]
        # masked scatter: True where kept; masked lanes max-in False (no-op)
        bitmap = bitmap.at[jnp.where(keep, gy, 0),
                           jnp.where(keep, gx, 0)].max(keep)

    # masked append: lane i goes to slot count + (#kept lanes before i)
    offsets = jnp.cumsum(keep.astype(jnp.int32)) - 1
    slots = state.count + offsets
    ok = keep & (slots < config.capacity)
    slots = jnp.where(ok, slots, config.capacity)  # OOB slot -> dropped
    points = state.points.at[slots].set(
        jnp.where(ok[..., None], insert_pts, 0.0), mode="drop")
    appended = jnp.sum(ok.astype(jnp.int32))
    count = jnp.minimum(state.count + appended, config.capacity)

    new_state = IcpMapState(
        points=points,
        count=count,
        pose=new_pose,
        initialized=jnp.ones_like(state.initialized),
        voxel_bitmap=bitmap,
    )
    chi = jnp.where(state.initialized, result.chi_values,
                    jnp.zeros_like(result.chi_values))
    return new_state, IcpMapOutputs(pose=new_pose, chi=chi, appended=appended)
