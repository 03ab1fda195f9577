"""EKF landmark SLAM with known association.

Parity surface: ``EKFLandmarkSlam`` (slamrs/slam/src/landmark/ekf.rs:17-244):

* state = [x, y, theta, l1x, l1y, ..., lNx, lNy], N = 10 landmarks by
  default (ekf.rs:19-26); initial covariance 1000·I with a zeroed pose
  block (ekf.rs:25-31);
* velocity motion model with the ``omega == 0`` straight-line branch
  (ekf.rs:52-89) — here a ``where``-select with a safe denominator;
* motion noise sigma = (0.02 m, 0.02 m, 5°) added to the pose block
  (ekf.rs:106-113);
* per-observation sequential Kalman update: first-sighting initialization
  at the expected position (ekf.rs:128-136), 2x5 measurement Jacobian
  lifted by the F matrix (ekf.rs:148-173), observation noise (0.03 m, 3°)
  (ekf.rs:176-177), angle wrapping of the innovation and of theta
  (ekf.rs:186-199).

Deliberate deviation: the reference's ``h_jacobian_low`` omits the textbook
1/q normalization (ekf.rs:149-160, i.e. H_ref = q * H_textbook, cf. Thrun
et al. / the cited lecture's formulation).  For landmarks closer than 1 m
(q < 1) that inflates the Kalman gain by 1/q and makes the filter
marginally unstable — empirically it diverges within a few updates on the
``landmarks.yaml`` scene (which the reference ships with ``running:
false``, so the defect is latent there).  The default here is the correct
1/q-normalized Jacobian; set ``reference_jacobian=True`` to replicate the
reference verbatim.

Design: the dynamic landmark loop becomes a ``lax.scan`` over
fixed observation lanes with validity masking; the 5xN F-matrix lift
becomes direct block indexing with ``dynamic_slice``-style gathers; the
whole update jits and ``vmap``s over worlds (state dim 23 is tiny — the
win is batching thousands of worlds, not the single-filter flops).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slamrs_tpu.core import math as m
from slamrs_tpu.core.types import LandmarkScan, OdometryReading

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class EkfConfig:
    num_landmarks: int = 10  # ekf.rs:19
    initial_landmark_variance: float = 1000.0  # ekf.rs:25-26
    motion_std_x: float = 0.02  # ekf.rs:107
    motion_std_y: float = 0.02
    motion_std_theta_deg: float = 5.0
    obs_std_distance: float = 0.03  # ekf.rs:176
    obs_std_angle_deg: float = 3.0
    # replicate the reference's unnormalized Jacobian (see module docstring)
    reference_jacobian: bool = False

    @property
    def dim(self) -> int:
        return 3 + 2 * self.num_landmarks


class EkfState(NamedTuple):
    mean: Array  # f32[..., D]
    cov: Array  # f32[..., D, D]
    seen: Array  # bool[..., N]

    @staticmethod
    def init(config: EkfConfig, batch_shape=()) -> "EkfState":
        d = config.dim
        cov = jnp.eye(d, dtype=jnp.float32) * config.initial_landmark_variance
        cov = cov.at[jnp.arange(3), jnp.arange(3)].set(0.0)
        return EkfState(
            mean=jnp.zeros((*batch_shape, d), jnp.float32),
            cov=jnp.broadcast_to(cov, (*batch_shape, d, d)),
            seen=jnp.zeros((*batch_shape, config.num_landmarks), bool),
        )


class EkfOutputs(NamedTuple):
    pose: Array  # f32[..., 3]
    landmark_means: Array  # f32[..., N, 2]
    landmark_covs: Array  # f32[..., N, 2, 2]
    seen: Array  # bool[..., N]


def _motion_prediction(mean: Array, odometry: OdometryReading):
    """(delta_mean[3], gx_jacobian[3,3]) per ekf.rs:47-89."""
    omega_dt = (odometry.distance_right - odometry.distance_left) \
        / odometry.wheel_base
    v_dt = (odometry.distance_left + odometry.distance_right) * 0.5
    theta = mean[..., 2]

    nonzero = omega_dt != 0.0
    safe_omega = jnp.where(nonzero, omega_dt, 1.0)
    v_over_omega = v_dt / safe_omega

    s, c = jnp.sin(theta), jnp.cos(theta)
    s2, c2 = jnp.sin(theta + omega_dt), jnp.cos(theta + omega_dt)

    g_rot = jnp.stack([-v_over_omega * s + v_over_omega * s2,
                       v_over_omega * c - v_over_omega * c2,
                       omega_dt], axis=-1)
    g_lin = jnp.stack([v_dt * c, v_dt * s, jnp.zeros_like(v_dt)], axis=-1)
    g = jnp.where(nonzero[..., None], g_rot, g_lin)

    j_rot = jnp.stack([-v_over_omega * c + v_over_omega * c2,
                       -v_over_omega * s + v_over_omega * s2], axis=-1)
    j_lin = jnp.stack([-v_dt * s, v_dt * c], axis=-1)
    j = jnp.where(nonzero[..., None], j_rot, j_lin)

    gx = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                          (*j.shape[:-1], 3, 3))
    gx = gx.at[..., 0, 2].set(j[..., 0]).at[..., 1, 2].set(j[..., 1])
    return g, gx


def update(state: EkfState, observation: LandmarkScan,
           odometry: OdometryReading, config: EkfConfig
           ) -> tuple[EkfState, EkfOutputs]:
    """One EKF update for a single world (vmap over worlds for fleets)."""
    d = config.dim
    n = config.num_landmarks

    # ---- prediction (ekf.rs:47-113)
    g, gx = _motion_prediction(state.mean, odometry)
    mu = state.mean
    mu = mu.at[0].add(g[0]).at[1].add(g[1])
    mu = mu.at[2].set(m.wrap_angle(mu[2] + g[2]))

    big_g = jnp.eye(d, dtype=jnp.float32).at[0:3, 0:3].set(gx)
    sigma = big_g @ state.cov @ big_g.T
    motion_var = jnp.array(
        [config.motion_std_x ** 2, config.motion_std_y ** 2,
         jnp.deg2rad(config.motion_std_theta_deg) ** 2], jnp.float32)
    sigma = sigma.at[0:3, 0:3].add(jnp.diag(motion_var))

    obs_var = jnp.array(
        [config.obs_std_distance ** 2,
         jnp.deg2rad(config.obs_std_angle_deg) ** 2], jnp.float32)
    q_noise = jnp.diag(obs_var)

    # ---- correction: sequential scan over observation lanes (ekf.rs:117-200)
    def correct(carry, lane):
        mu, sigma, seen = carry
        angle, dist, assoc, valid = lane
        idx = jnp.clip(assoc, 0, n - 1)
        li = 3 + 2 * idx

        # first-sighting init at the expected position (ekf.rs:128-136)
        first = valid & ~seen[idx]
        init_x = mu[0] + dist * jnp.cos(mu[2] + angle)
        init_y = mu[1] + dist * jnp.sin(mu[2] + angle)
        mu = mu.at[li].set(jnp.where(first, init_x, mu[li]))
        mu = mu.at[li + 1].set(jnp.where(first, init_y, mu[li + 1]))
        seen = seen.at[idx].set(seen[idx] | valid)

        dx = mu[li] - mu[0]
        dy = mu[li + 1] - mu[1]
        q = dx * dx + dy * dy
        sqrt_q = jnp.sqrt(q)

        z_bar = jnp.stack([sqrt_q, jnp.arctan2(dy, dx) - mu[2]])
        z = jnp.stack([dist, angle])

        # H = h_low @ F lift, assembled directly into [2, D] (ekf.rs:149-173)
        # scale = 1/q (textbook, default) or 1 (reference verbatim)
        scale = 1.0 if config.reference_jacobian else 1.0 / q
        h = jnp.zeros((2, d), jnp.float32)
        h = h.at[0, 0].set(scale * -sqrt_q * dx).at[0, 1].set(
            scale * -sqrt_q * dy)
        h = h.at[1, 0].set(scale * dy).at[1, 1].set(scale * -dx)
        h = h.at[1, 2].set(scale * -q)
        h = h.at[0, li].set(scale * sqrt_q * dx).at[0, li + 1].set(
            scale * sqrt_q * dy)
        h = h.at[1, li].set(scale * -dy).at[1, li + 1].set(scale * dx)

        s_mat = h @ sigma @ h.T + q_noise  # [2, 2]
        # closed-form 2x2 inverse (ekf.rs:180-184 try_inverse)
        det = s_mat[0, 0] * s_mat[1, 1] - s_mat[0, 1] * s_mat[1, 0]
        inv = jnp.array([[s_mat[1, 1], -s_mat[0, 1]],
                         [-s_mat[1, 0], s_mat[0, 0]]]) / det
        k = sigma @ h.T @ inv  # [D, 2]

        diff = z - z_bar
        diff = diff.at[1].set(m.wrap_angle(diff[1]))

        mu_new = mu + k @ diff
        mu_new = mu_new.at[2].set(m.wrap_angle(mu_new[2]))
        sigma_new = (jnp.eye(d, dtype=jnp.float32) - k @ h) @ sigma

        mu = jnp.where(valid, mu_new, mu)
        sigma = jnp.where(valid, sigma_new, sigma)
        return (mu, sigma, seen), None

    lanes = (observation.angles, observation.distances,
             observation.association, observation.valid)
    (mu, sigma, seen), _ = jax.lax.scan(correct, (mu, sigma, state.seen),
                                        lanes)

    new_state = EkfState(mean=mu, cov=sigma, seen=seen)
    lm_means = mu[3:].reshape(n, 2)
    rows = 3 + 2 * jnp.arange(n)
    lm_covs = jnp.stack(
        [jnp.stack([sigma[rows, rows], sigma[rows, rows + 1]], -1),
         jnp.stack([sigma[rows + 1, rows], sigma[rows + 1, rows + 1]], -1)],
        -2)
    return new_state, EkfOutputs(pose=mu[0:3], landmark_means=lm_means,
                                 landmark_covs=lm_covs, seen=seen)
