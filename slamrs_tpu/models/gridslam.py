"""Rao-Blackwellized particle-filter occupancy-grid SLAM.

Parity surface: ``GridMapSlam`` (slamrs/slam/src/grid/slam.rs:27-97) +
``ParticleFilter`` (grid/particle.rs):

per update: for every particle, (1) sample a successor pose from the
odometry motion model, (2) weight by ``p(z | x, m) * p(x | x0, u)``,
(3) integrate the scan into the particle's own map, then normalize weights
and systematically resample (slam.rs:45-75; resample every update, as the
reference does).

Design (not a port):

* The reference iterates particles serially and resampling deep-clones
  ``(Pose, Map)`` — whole log-odds vectors — per surviving particle
  (particle.rs:78-105).  Here the particle set is a leading array axis:
  poses ``f32[P, 3]``, grids ``[P, H, W]`` resident in device memory;
  motion sampling / weighting / integration are ``vmap`` over P, and
  resampling is one gather (``jnp.take``) by ancestor index.
* Weights are accumulated in log space (the reference multiplies f64
  pdf values; log-f32 is the numerically-equivalent stable form).
* Deliberate deviations from reference quirks (SURVEY §7):
  - ``map.likelihood()`` computed-and-dropped per particle (slam.rs:58)
    is omitted (pure dead work).
  - The reference reads the best-particle index computed *before*
    resampling out of the *resampled* array (slam.rs:77-81 after
    particle.rs:39-47) — an off-by-reshuffle; here the estimated pose is
    the pre-resample argmax particle's pose (the intended semantics).
* ``resample_neff_frac`` optionally gates resampling on N_eff (standard
  RBPF practice; default 1.0 resamples every update like the reference —
  the gate skips the whole-set grid gather, the largest memory move of
  an update, when weights are still uniform enough).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slamrs_tpu.core import motion
from slamrs_tpu.core.types import OdometryReading, Scan
from slamrs_tpu.ops import resample as _resample
from slamrs_tpu.ops.grid import (GridSpec2D, dense_window_for, grid_integrate,
                                 grid_integrate_dense, grid_log_likelihood)

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class GridSlamConfig:
    """Parity: GridMapSlamConfig (slam.rs:18-25).  Static (hashable)."""

    position_x: float = -2.0
    position_y: float = -2.0
    width: float = 4.0
    height: float = 4.0
    resolution: float = 0.02
    n_particles: int = 10
    max_scan_range: float = 1.0  # bounds the DDA step count (static)
    resample_neff_frac: float = 1.0  # 1.0 == always resample (reference)
    # "dda":   exact reference-parity scatter walk (grid/ray.rs semantics).
    # "dense": scatter-free windowed polar update (see
    #          ops.grid.grid_integrate_dense) — equivalent sensor model.
    # "fused": likelihood + integrate in one pass over a window around
    #          each particle (ops.fused) — the throughput path; grids
    #          optionally bf16.
    integrate: str = "dda"
    grid_dtype: str = "float32"  # "bfloat16" halves the fused map set
    # STATIC beam spacing (radians) of the scan's uniform angle table,
    # or None to derive it from scan.angles at trace time.  Both scan
    # producers emit 1-degree tables (simulator.py:155, io/neato.py:51),
    # so the graph compiler sets math.radians(1.0) on fused configs —
    # the cell pass then runs the static bin-units pipeline
    # (ops/fused._cell_pass).  Leave None for nonstandard tables fed
    # directly into update().
    beam_spacing: float | None = None
    # mesh-sharded fleet resampling mode: "local" relabels slots
    # local-first so only spilled unique maps cross devices
    # (parallel/resample.py — no full-grid all-gather); "gather" keeps
    # the exact slot-ordered take (bitwise-reproducible vs the
    # unsharded fleet, at all-gather cost).
    fleet_resample: str = "local"

    @property
    def grid_spec(self) -> GridSpec2D:
        return GridSpec2D(self.position_x, self.position_y, self.width,
                          self.height, self.resolution)

    @property
    def max_ray_steps(self) -> int:
        return self.grid_spec.max_ray_steps(self.max_scan_range)


class GridSlamState(NamedTuple):
    poses: Array  # f32[..., P, 3]
    grids: Array  # [..., P, H, W] log-odds (f32, or bf16 on "fused")
    weights: Array  # f32[..., P] normalized
    best_pose: Array  # f32[..., 3] argmax-weight particle pose
    best_idx: Array  # i32[...]
    # resample lineage of the last update: every update applies it, so
    # particle i's map is grids[i] and this is the identity
    ancestors: Array  # i32[..., P]

    @staticmethod
    def init(config: GridSlamConfig, batch_shape=()) -> "GridSlamState":
        p = config.n_particles
        spec = config.grid_spec
        if config.integrate == "fused":
            dtype = jnp.bfloat16 if config.grid_dtype == "bfloat16" \
                else jnp.float32
            grids = spec.new_grid((*batch_shape, p), dtype)
        else:
            grids = spec.new_grid((*batch_shape, p))
        return GridSlamState(
            poses=jnp.zeros((*batch_shape, p, 3), jnp.float32),
            grids=grids,
            weights=jnp.full((*batch_shape, p), 1.0 / p, jnp.float32),
            best_pose=jnp.zeros((*batch_shape, 3), jnp.float32),
            best_idx=jnp.zeros(batch_shape, jnp.int32),
            ancestors=jnp.broadcast_to(jnp.arange(p, dtype=jnp.int32),
                                       (*batch_shape, p)),
        )


class GridSlamOutputs(NamedTuple):
    pose: Array  # f32[..., 3] estimated pose (topic_pose)
    n_eff: Array  # f32[...] effective particle count diagnostic
    resampled: Array  # bool[...]


class UpdateNoise(NamedTuple):
    """Pre-drawn randomness for one :func:`update` call (RNG hoist).

    Rollouts derive these in BULK outside the ``lax.scan`` (one batched
    threefry over all frames) instead of chaining ~4 small threefry
    calls through every step's critical path.  The drawn VALUES are
    bitwise identical to the in-step draws (see :func:`derive_noise`);
    downstream floats may differ by FMA-fusion rounding across the two
    jitted graphs (~1e-9, tested in test_models.py).
    """

    eps_c: Array  # f32[P] motion center draws (standard normal)
    eps_t: Array  # f32[P] motion theta draws
    u01: Array    # f32[1] systematic-resample offset (uniform [0,1))


def derive_noise(key: Array, p: int) -> UpdateNoise:
    """Reproduce :func:`update`'s exact RNG chain for one step key.

    MUST mirror update()'s splits bit-for-bit: ``(k_motion, k_resample)
    = split(key)``; ``motion.sample`` splits ``k_motion`` into the two
    normal draws; ``systematic_resample`` draws ``uniform(k_resample,
    (1,))``.  ``vmap(derive_noise)`` over a rollout's step keys gives
    each step the identical values it would have drawn itself (jax
    random functions are deterministic per (key, shape), batched or
    not), so hoisting is output-neutral up to FMA-fusion rounding of
    the surrounding arithmetic.
    """
    k_motion, k_resample = jax.random.split(key)
    k1, k2 = jax.random.split(k_motion)
    eps_c = jax.random.normal(k1, (p,), jnp.float32)
    eps_t = jax.random.normal(k2, (p,), jnp.float32)
    u01 = jax.random.uniform(k_resample, (1,), jnp.float32)
    return UpdateNoise(eps_c, eps_t, u01)


def _weigh_and_select(log_lik: Array, log_motion: Array,
                      prev_weights: Array, k_resample: Array,
                      frac: float, p: int, u01: Array | None = None):
    """The filter's weighting + selection policy for ONE world (vmap for
    fleets) — the single definition both update() and update_fleet()
    use: SIS weight carry (constant-shift-equivalent to the reference's
    always-resample when the gate fires every step, persistent when the
    N_eff gate skips), normalization, argmax, N_eff, and the gated
    systematic resample with identity ancestors on skip
    (slam.rs:62-75 + particle.rs:37-105)."""
    log_w = jnp.log(prev_weights) + log_lik + log_motion
    weights = _resample.normalize_log_weights(log_w)
    best_idx = jnp.argmax(weights, axis=-1).astype(jnp.int32)
    n_eff = _resample.effective_particles(weights)
    do_resample = n_eff <= frac * p
    ancestors = _resample.systematic_resample(k_resample, weights, u01=u01)
    identity = jnp.arange(p, dtype=jnp.int32)
    ancestors = jnp.where(do_resample, ancestors, identity)
    weights = jnp.where(do_resample, jnp.full((p,), 1.0 / p), weights)
    return weights, ancestors, best_idx, n_eff, do_resample


def update(state: GridSlamState, scan: Scan, odometry: OdometryReading,
           key: Array, config: GridSlamConfig,
           noise: UpdateNoise | None = None
           ) -> tuple[GridSlamState, GridSlamOutputs]:
    """One SLAM update for a single world (vmap over worlds for fleets).

    scan/odometry: unbatched (shared across the world's particles).
    ``noise`` optionally supplies this step's pre-drawn randomness
    (:func:`derive_noise` of the same ``key`` — the identical draws);
    when given, ``key`` is not consumed, letting rollouts hoist all RNG
    out of the sequential scan body.
    """
    p = config.n_particles
    spec = config.grid_spec
    max_steps = config.max_ray_steps

    if noise is None:
        k_motion, k_resample = jax.random.split(key)
        eps = None
        u01 = None
    else:
        k_motion = k_resample = key  # unused (eps/u01 provided)
        eps = (noise.eps_c, noise.eps_t)
        u01 = noise.u01

    # 1) motion sampling (slam.rs:55) — one batched draw covers all
    # particles (motion.sample broadcasts the noise over the pose batch)
    new_poses = motion.sample(k_motion, state.poses,
                              odometry.distance_left,
                              odometry.distance_right, odometry.wheel_base,
                              eps=eps)

    # 2+3) weights log p(z|x,m) + integrate (slam.rs:62, 67).  The fused
    # path does both in one call; the others are separate ops.
    if config.integrate == "fused":
        from slamrs_tpu.ops.fused import fused_update

        nb = scan.angles.shape[-1]
        dphi = (config.beam_spacing if config.beam_spacing is not None
                else scan.angles[..., 1] - scan.angles[..., 0]
                if nb > 1 else jnp.float32(2.0 * jnp.pi))
        grids, log_lik = fused_update(
            state.grids, new_poses, scan.angles[..., 0], scan.distances,
            scan.valid, scan.present, spec, nb, config.max_scan_range,
            dphi=dphi)
    else:
        log_lik = jax.vmap(
            lambda g, q: grid_log_likelihood(g, spec, q, scan.angles,
                                             scan.distances, scan.valid,
                                             scan.present)
        )(state.grids, new_poses)
        if config.integrate == "dense":
            window = dense_window_for(spec, config.max_scan_range)
            integrate_one = lambda g, q: grid_integrate_dense(
                g, spec, q, scan.angles, scan.distances, scan.valid,
                scan.present, window)
        else:
            integrate_one = lambda g, q: grid_integrate(
                g, spec, q, scan.angles, scan.distances, scan.valid,
                scan.present, max_steps)
        grids = jax.vmap(integrate_one)(state.grids, new_poses)
    log_motion = motion.log_prob(state.poses, new_poses,
                                 odometry.distance_left,
                                 odometry.distance_right, odometry.wheel_base)

    # 4-5) weighting + gated systematic resample (_weigh_and_select);
    # the whole-set grid gather runs only when the N_eff gate fires
    weights, ancestors, best_idx, n_eff, do_resample = _weigh_and_select(
        log_lik, log_motion, state.weights, k_resample,
        config.resample_neff_frac, p, u01=u01)
    best_pose = new_poses[best_idx]
    new_poses = jnp.take(new_poses, ancestors, axis=0)
    grids = jax.lax.cond(
        do_resample,
        lambda ga: jnp.take(ga[0], ga[1], axis=0),
        lambda ga: ga[0],
        (grids, ancestors))

    new_state = GridSlamState(
        poses=new_poses,
        grids=grids,
        weights=weights,
        best_pose=best_pose,
        best_idx=best_idx,
        ancestors=jnp.arange(p, dtype=jnp.int32),
    )
    return new_state, GridSlamOutputs(pose=best_pose, n_eff=n_eff,
                                      resampled=do_resample)


def update_fleet(state: GridSlamState, scan: Scan,
                 odometry: OdometryReading, keys: Array,
                 config: GridSlamConfig, mesh=None
                 ) -> tuple[GridSlamState, GridSlamOutputs]:
    """Batched-worlds update ([W, ...] state, per-world scan/odo/keys).

    Semantically ``vmap(update)`` — and without a mesh (or off the fused
    path) that is literally what runs.  With a mesh the fused update
    runs under ``shard_map`` on each device's local (world, particle)
    block (:func:`slamrs_tpu.parallel.shard.fused_update_batched`);
    everything around it stays in pjit-land where the SPMD partitioner
    owns the collectives (weight normalization/N_eff reduce over the
    sharded particle axis, the resample gather).  Matches the reference
    update loop slam.rs:45-75 run over W independent worlds.

    Fleet resampling is applied every update; with a particle-sharded
    mesh the default ``fleet_resample="local"`` relabels slots
    local-first so only spilled unique maps cross devices
    (parallel/resample.py) — ``"gather"`` keeps the exact slot-ordered
    take for bitwise reproducibility vs the unsharded fleet.
    """
    if config.integrate != "fused" or mesh is None:
        upd = lambda st, sc, od, k: update(st, sc, od, k, config)
        return jax.vmap(upd)(state, scan, odometry, keys)

    p = config.n_particles
    spec = config.grid_spec

    ks = jax.vmap(jax.random.split)(keys)  # [W, 2, ...]
    k_motion, k_resample = ks[:, 0], ks[:, 1]

    new_poses = jax.vmap(motion.sample)(
        k_motion, state.poses, odometry.distance_left,
        odometry.distance_right, odometry.wheel_base)

    from slamrs_tpu.parallel.shard import fused_update_batched

    nb = scan.angles.shape[-1]
    dphi = (scan.angles[:, 1] - scan.angles[:, 0] if nb > 1
            else jnp.full(scan.angles.shape[:1], 2.0 * jnp.pi, jnp.float32))
    grids, log_lik = fused_update_batched(
        state.grids, new_poses, scan.angles[:, 0], scan.distances,
        scan.valid, scan.present, spec, nb, config.max_scan_range,
        dphi, mesh=mesh, dphi_static=config.beam_spacing)

    log_motion = jax.vmap(motion.log_prob)(
        state.poses, new_poses, odometry.distance_left,
        odometry.distance_right, odometry.wheel_base)

    weights, ancestors, best_idx, n_eff, do_resample = jax.vmap(
        _weigh_and_select, in_axes=(0, 0, 0, 0, None, None))(
            log_lik, log_motion, state.weights, k_resample,
            config.resample_neff_frac, p)
    best_pose = jnp.take_along_axis(
        new_poses, best_idx[:, None, None], axis=1)[:, 0]

    if (config.fleet_resample == "local"
            and dict(zip(mesh.axis_names, mesh.devices.shape)).get(
                "particle", 1) > 1):
        # local-first multiset relabeling: only spilled unique maps move
        # between devices (parallel/resample.py) instead of the SPMD
        # partitioner's full-grid all-gather for a sharded-axis take
        from slamrs_tpu.parallel.resample import resample_fleet

        grids, new_poses = resample_fleet(grids, new_poses, ancestors,
                                          mesh)
    else:
        new_poses = jnp.take_along_axis(new_poses, ancestors[:, :, None],
                                        axis=1)
        grids = jnp.take_along_axis(grids, ancestors[:, :, None, None],
                                    axis=1)
    identity = jnp.broadcast_to(jnp.arange(p, dtype=jnp.int32),
                                ancestors.shape)

    new_state = GridSlamState(
        poses=new_poses, grids=grids, weights=weights,
        best_pose=best_pose, best_idx=best_idx, ancestors=identity)
    return new_state, GridSlamOutputs(pose=best_pose, n_eff=n_eff,
                                      resampled=do_resample)


def estimated_probability_grid(state: GridSlamState) -> Array:
    """Occupancy probabilities of the best particle's map.

    Parity: GridMapSlam::estimated_likelihood (slam.rs:83-88) — the argmax
    particle's log-odds grid converted cell-wise to probability.
    """
    if state.grids.ndim > 3:  # [..., P, H, W] batched worlds
        idx = state.best_idx[..., None, None, None]
        grid = jnp.take_along_axis(
            state.grids, idx, axis=-3).squeeze(-3)
    else:
        grid = state.grids[state.best_idx]
    grid = grid.astype(jnp.float32)
    return 1.0 - 1.0 / (1.0 + jnp.exp(grid))
