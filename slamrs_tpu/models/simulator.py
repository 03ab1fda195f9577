"""Differential-drive robot + 360-beam lidar + landmark sensor simulator.

Parity surface: ``Simulator::tick`` (slamrs/simulator/src/sim.rs:96-220)
and the scene model (simulator/src/scene/ray.rs, landmark.rs):

* diff-drive kinematics ``theta += (sr-sl)/base; x += s̄·cos(theta)``
  (sim.rs:214-220) — see :func:`slamrs_tpu.core.motion.integrate_exact`;
* a scan-update timer with remainder carry (sim.rs:109-112);
* per-scan odometry from a wheel-travel accumulator (sim.rs:106-122);
* the lidar: per-degree raycast; hits beyond ``scanner_range`` are clamped
  to the range and flagged invalid; rays that miss the scene produce no
  measurement (sim.rs:134-159) — encoded in the ``present`` mask;
* the landmark sensor: range gate comparing ``scanner_range`` against the
  *squared* distance (a reference quirk, sim.rs:182-184, kept for parity),
  Gaussian angle/distance noise, known association ids (sim.rs:173-199).

Design: ``tick`` is a pure function over pytrees — one fused XLA
program per tick covering all worlds.  The reference's 30 Hz
accumulator thread (simulator/src/lib.rs:274-299) becomes either host-side
pacing (interactive mode) or a ``lax.scan`` over ticks (rollouts).  The
scan is computed every tick and masked by ``fired``: at 360 beams the
raycast is cheap, and branch-free code is what jit wants.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slamrs_tpu.core import motion
from slamrs_tpu.core.types import Command, LandmarkScan, OdometryReading, Scan
from slamrs_tpu.ops import raycast as _raycast

Array = jnp.ndarray

DEFAULT_DT = 1.0 / 30.0  # simulator/src/lib.rs:278
NUM_BEAMS = 360


class SimParams(NamedTuple):
    """Runtime-tunable simulator parameters (traced scalars, so the UI
    slider semantics of the reference survive without recompiles).

    Parity: ``SimParameters`` defaults (sim.rs:51-61).
    """

    wheel_base: Array  # m
    update_period: Array  # s between scans
    scanner_range: Array  # m
    angle_uncertainty: Array  # rad (landmark sensor)
    distance_uncertainty: Array  # m (landmark sensor)

    @staticmethod
    def make(wheel_base=0.1, update_period=0.2, scanner_range=1.0,
             angle_uncertainty=0.03, distance_uncertainty=0.02) -> "SimParams":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return SimParams(f(wheel_base), f(update_period), f(scanner_range),
                         f(angle_uncertainty), f(distance_uncertainty))


class Scene(NamedTuple):
    """Padded scene geometry (static shapes; built at config time).

    Parity: ``Scene`` (ray.rs:97-150) — line segments (rectangles decompose
    into 4 segments as in add_rect) plus point landmarks.
    """

    segments: Array  # f32[S, 4] (x1, y1, x2, y2)
    segment_mask: Array  # bool[S]
    landmarks: Array  # f32[L, 2]
    landmark_mask: Array  # bool[L]

    @staticmethod
    def build(lines=(), rects=(), landmarks=(), segment_capacity=None,
              landmark_capacity=None) -> "Scene":
        """Host-side builder.

        lines: iterable of (x1, y1, x2, y2); rects: (x, y, w, h) decomposed
        into 4 segments (ray.rs:124-149); landmarks: (x, y).
        """
        segs = [tuple(map(float, l)) for l in lines]
        for (x, y, w, h) in rects:
            segs += [
                (x, y, x + w, y),
                (x + w, y, x + w, y + h),
                (x + w, y + h, x, y + h),
                (x, y + h, x, y),
            ]
        lms = [tuple(map(float, l)) for l in landmarks]

        s_cap = segment_capacity or max(len(segs), 1)
        l_cap = landmark_capacity or max(len(lms), 1)
        if len(segs) > s_cap or len(lms) > l_cap:
            raise ValueError("scene exceeds padded capacity")

        seg_arr = jnp.zeros((s_cap, 4), jnp.float32)
        if segs:
            seg_arr = seg_arr.at[: len(segs)].set(jnp.array(segs, jnp.float32))
        lm_arr = jnp.zeros((l_cap, 2), jnp.float32)
        if lms:
            lm_arr = lm_arr.at[: len(lms)].set(jnp.array(lms, jnp.float32))
        return Scene(
            segments=seg_arr,
            segment_mask=jnp.arange(s_cap) < len(segs),
            landmarks=lm_arr,
            landmark_mask=jnp.arange(l_cap) < len(lms),
        )


class SimState(NamedTuple):
    pose: Array  # f32[..., 3]
    scan_timer: Array  # f32[...]
    scan_counter: Array  # i32[...]
    wheel_accum_left: Array  # f32[...]
    wheel_accum_right: Array  # f32[...]

    @staticmethod
    def init(batch_shape=()) -> "SimState":
        z = jnp.zeros(batch_shape, jnp.float32)
        return SimState(
            pose=jnp.zeros((*batch_shape, 3), jnp.float32),
            scan_timer=z,
            scan_counter=jnp.zeros(batch_shape, jnp.int32),
            wheel_accum_left=z,
            wheel_accum_right=z,
        )


class SimOutputs(NamedTuple):
    """Everything the reference publishes on its topics, each tick.

    ``fired`` gates the scan/odometry/landmark outputs (they are computed
    every tick for branch-free jit; consumers must respect ``fired``).
    """

    fired: Array  # bool[...]
    pose: Array  # f32[..., 3] ground-truth pose (topic_pose)
    scan: Scan  # beam lanes [..., B]
    odometry: OdometryReading
    landmarks: LandmarkScan  # lanes [..., L]
    scan_id: Array  # i32[...]


def lidar_scan(pose: Array, scene: Scene, scanner_range: Array,
               num_beams: int = NUM_BEAMS) -> Scan:
    """One full revolution from ``pose`` (sim.rs:129-159).

    Beams at whole degrees; ``present`` = ray hit something; ``valid`` =
    hit closer than the scanner range (in-range returns are exact — the
    reference's lidar is noise-free; its uncertainty parameters only apply
    to the landmark sensor).
    """
    rel_angles = jnp.deg2rad(jnp.arange(num_beams, dtype=jnp.float32))
    batch = pose.shape[:-1]
    rel = jnp.broadcast_to(rel_angles, (*batch, num_beams))
    world_angles = pose[..., 2:3] + rel
    dist, hit = _raycast.raycast(pose[..., 0:2], world_angles, scene.segments,
                                 scene.segment_mask)
    rng = jnp.asarray(scanner_range)[..., None]
    valid = hit & (dist < rng)
    distances = jnp.where(valid, dist, jnp.broadcast_to(rng, dist.shape))
    distances = jnp.where(hit, distances, 0.0)
    return Scan(
        angles=rel,
        distances=distances,
        strengths=jnp.where(hit, 1.0, 0.0),
        valid=valid,
        present=hit,
    )


def landmark_scan(key: Array, pose: Array, scene: Scene, params: SimParams
                  ) -> LandmarkScan:
    """Noisy range/bearing landmark observations (sim.rs:173-199).

    Range gate: ``dist_sq <= scanner_range`` — the reference compares the
    squared distance against the (non-squared) range; kept verbatim.
    """
    lx = scene.landmarks[..., 0]
    ly = scene.landmarks[..., 1]
    dx = lx - pose[..., 0:1]
    dy = ly - pose[..., 1:2]
    dist_sq = dx * dx + dy * dy
    in_range = dist_sq <= jnp.asarray(params.scanner_range)[..., None]
    angle = jnp.arctan2(dy, dx)

    n_lanes = scene.landmarks.shape[-2]
    batch = pose.shape[:-1]
    k1, k2 = jax.random.split(key)
    noise_a = jax.random.normal(k1, (*batch, n_lanes))
    noise_d = jax.random.normal(k2, (*batch, n_lanes))

    return LandmarkScan(
        angles=angle - pose[..., 2:3]
        + noise_a * jnp.asarray(params.angle_uncertainty)[..., None],
        distances=jnp.sqrt(dist_sq)
        + noise_d * jnp.asarray(params.distance_uncertainty)[..., None],
        association=jnp.broadcast_to(jnp.arange(n_lanes, dtype=jnp.int32),
                                     (*batch, n_lanes)),
        valid=in_range & scene.landmark_mask,
    )


def tick(state: SimState, cmd: Command, key: Array, params: SimParams,
         scene: Scene, dt: float | Array = DEFAULT_DT,
         num_beams: int = NUM_BEAMS) -> tuple[SimState, SimOutputs]:
    """One fixed-timestep simulator tick (sim.rs:96-212).

    All state/command leaves may carry leading batch axes (worlds); the
    scene is shared (or batched itself for per-world scenes via vmap).
    """
    dt = jnp.asarray(dt, jnp.float32)
    sl = cmd.speed_left * dt
    sr = cmd.speed_right * dt

    pose = motion.integrate_exact(state.pose, sl, sr, params.wheel_base)
    accum_l = state.wheel_accum_left + sl
    accum_r = state.wheel_accum_right + sr

    timer = state.scan_timer + dt
    fired = timer > params.update_period
    timer = jnp.where(fired, timer - params.update_period, timer)

    odometry = OdometryReading(
        distance_left=accum_l,
        distance_right=accum_r,
        wheel_base=jnp.broadcast_to(params.wheel_base, accum_l.shape),
    )
    accum_l = jnp.where(fired, 0.0, accum_l)
    accum_r = jnp.where(fired, 0.0, accum_r)

    scan = lidar_scan(pose, scene, params.scanner_range, num_beams)
    landmarks = landmark_scan(key, pose, scene, params)

    new_state = SimState(
        pose=pose,
        scan_timer=timer,
        scan_counter=state.scan_counter + fired.astype(jnp.int32),
        wheel_accum_left=accum_l,
        wheel_accum_right=accum_r,
    )
    outputs = SimOutputs(
        fired=fired,
        pose=pose,
        scan=scan,
        odometry=odometry,
        landmarks=landmarks,
        scan_id=state.scan_counter,
    )
    return new_state, outputs
