"""Point-to-normal ICP scan matching, fixed iteration count.

Parity surface: ``slamrs/slam/src/icp.rs`` — ``icp_point_to_normal``
(icp.rs:82-128): per iteration, transform the source points by the
accumulated pose, find nearest-neighbor correspondences in the reference
cloud, accumulate the 3-DoF Gauss-Newton normal equations with
point-to-normal errors (prepare_system_normals, icp.rs:256-288), solve,
and renormalize the angle.  Normals come from central differences of
neighboring reference points (compute_normals, icp.rs:226-254); weights are
Uniform or a Step function on the squared error (icp.rs:29-51).

Design:

* Correspondences: the reference builds a kd-tree per call (icp.rs:61-68).
  kd-trees do not vmap; at scan sizes (<=360 source points, a few
  thousand reference points) a dense pairwise distance matrix is one
  small matmul (``-2 p qᵀ``) plus an argmin — batchable over worlds.
* Point clouds are fixed-capacity padded buffers.  Padded reference lanes
  are excluded from the argmin with +inf; padded source lanes get weight 0.
  Reference endpoint lanes have zero normals (as in the reference), which
  already nullifies their H/g contribution.
* The iteration loop is a ``lax.scan`` (static trip count, exactly the
  reference's fixed ``iterations``).
* The 3x3 solve replicates ``lstsq`` (icp.rs:211-215) via an eigh-based
  pseudo-inverse (H is symmetric PSD), so an under-determined system
  degrades to the minimum-norm step instead of NaNs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray

_BIG = 1e30


class IcpResult(NamedTuple):
    transformation: Array  # f32[..., 3] (x, y, theta)
    transformed_points: Array  # f32[..., Np, 2] source points under the final pose
    chi_values: Array  # f32[..., iterations]


def rot2(theta: Array) -> Array:
    """R(theta) (icp.rs:152-154)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack([jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2)


def drot2(theta: Array) -> Array:
    """dR/dtheta (icp.rs:148-150)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack([jnp.stack([-s, -c], -1), jnp.stack([c, -s], -1)], -2)


def transform_points(points: Array, x: Array) -> Array:
    """R(x2) p + (x0, x1) (icp.rs:70-79).  points [..., N, 2], x [..., 3]."""
    return points @ rot2(x[..., 2]).swapaxes(-1, -2) + x[..., None, 0:2]


def compute_normals(q: Array, q_count: Array) -> Array:
    """Central-difference normals of an ordered point sequence.

    Parity: compute_normals (icp.rs:226-254): normal_i = normalize(perp(
    q_{i+1} - q_{i-1})) for interior i, zero at the endpoints, all zero for
    sequences shorter than 3.  ``q_count`` is the number of real (leading)
    lanes in the padded buffer ``q [..., Nq, 2]``.
    """
    nq = q.shape[-2]
    prev = jnp.roll(q, 1, axis=-2)
    nxt = jnp.roll(q, -1, axis=-2)
    diff = nxt - prev
    perp = jnp.stack([-diff[..., 1], diff[..., 0]], axis=-1)
    norm = jnp.linalg.norm(perp, axis=-1, keepdims=True)
    normal = jnp.where(norm > 0.0, perp / jnp.where(norm > 0.0, norm, 1.0), 0.0)
    idx = jnp.arange(nq)
    qc = jnp.asarray(q_count)[..., None]  # [..., 1] broadcasts against [Nq]
    interior = (idx >= 1) & (idx < qc - 1) & (qc > 2)
    return jnp.where(interior[..., None], normal, 0.0)


def nearest_neighbors(p: Array, q: Array, q_count: Array) -> Array:
    """Index into q of the closest point for every p lane.

    Parity: find_correspondences (icp.rs:131-146) — kd-tree NN replaced by
    a dense distance matrix ``|q|² - 2 p qᵀ``; padded q lanes are pushed
    to +inf before the argmin.  The product runs at full f32 precision:
    a reduced-precision (TF32) product would flip near-tie argmins.
    p [..., Np, 2], q [..., Nq, 2] -> i32[..., Np].
    """
    # the p-squared term is constant along the argmin axis — dropping it
    # saves one full pass over the [Np, Nq] matrix
    d2 = (
        jnp.sum(q * q, axis=-1)[..., None, :]
        - 2.0 * jnp.einsum("...nd,...md->...nm", p, q,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
    )
    lane = jnp.arange(q.shape[-2])
    q_valid = lane < jnp.asarray(q_count)[..., None]
    d2 = jnp.where(q_valid[..., None, :], d2, _BIG)
    return jnp.argmin(d2, axis=-1).astype(jnp.int32)


def icp_point_to_normal(
    p: Array,
    p_mask: Array,
    q: Array,
    q_count: Array,
    initial_pose: Array,
    iterations: int = 10,
    step_threshold: float | None = None,
) -> IcpResult:
    """Fixed-iteration point-to-normal ICP (icp.rs:82-128).

    Args:
      p: f32[Np, 2] source points (padded), p_mask: bool[Np].
      q: f32[Nq, 2] reference points (padded, ordered), q_count: i32[] real
        lane count.
      initial_pose: f32[3].
      iterations: static iteration count (IcpParameters.iterations).
      step_threshold: None -> Uniform weights; float -> Step{threshold}
        (CorrespondenceWeight, icp.rs:29-51).

    Batch over worlds with ``vmap``.
    """
    q_normals = compute_normals(q, q_count)

    def iteration(x, _):
        p_t = transform_points(p, x)
        corr = nearest_neighbors(p_t, q, q_count)  # [Np]
        qc = jnp.take_along_axis(q, corr[..., None], axis=-2)  # [Np, 2]
        nc = jnp.take_along_axis(q_normals, corr[..., None], axis=-2)

        # error e_i = n_iᵀ (R p_i + t - q_i)  (icp.rs:273)
        resid = transform_points(p, x) - qc  # [Np, 2]
        e = jnp.sum(nc * resid, axis=-1)  # [Np]

        # J_i = n_iᵀ [I | dR p_i]  (icp.rs:275, jacobian at icp.rs:156-161)
        dRp = p @ drot2(x[..., 2]).swapaxes(-1, -2)  # [Np, 2]
        J = jnp.concatenate([nc, jnp.sum(nc * dRp, axis=-1)[..., None]],
                            axis=-1)  # [Np, 3]

        if step_threshold is None:
            w = jnp.ones_like(e)
        else:
            w = (e * e < step_threshold * step_threshold).astype(e.dtype)
        w = w * p_mask.astype(e.dtype)

        H = jnp.einsum("...ni,...nj->...ij", J * w[..., None], J,
                       preferred_element_type=jnp.float32)
        g = jnp.einsum("...ni,...n->...i", J, w * e)
        chi = jnp.sum(jnp.where(p_mask, e * e, 0.0), axis=-1)

        dx = _pinv_solve(H, -g)
        x = x + dx
        theta = jnp.arctan2(jnp.sin(x[..., 2]), jnp.cos(x[..., 2]))
        x = x.at[..., 2].set(theta)
        return x, chi

    x, chis = jax.lax.scan(iteration, initial_pose, None, length=iterations)
    return IcpResult(
        transformation=x,
        transformed_points=transform_points(p, x),
        chi_values=jnp.moveaxis(chis, 0, -1),
    )


def _pinv_solve(H: Array, b: Array, rcond: float = 1e-8) -> Array:
    """Solve the symmetric PSD 3x3 system H dx = b.

    Behavior target: lstsq(H, b, eps=1e-8) (icp.rs:211-215).  A batched
    ``eigh`` is a large share of a batched ICP solve; this closed-form
    adjugate/Cramer solve with a tiny relative Tikhonov floor is a few
    elementwise ops and matches lstsq to f32
    precision for the PD systems ICP produces (the ridge only acts when H
    is numerically singular, where lstsq's min-norm answer is equally
    arbitrary for the pose update).
    """
    # relative damping keeps det > 0 for degenerate geometry
    tr = H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]
    lam = (rcond * jnp.maximum(tr, 1e-30))[..., None, None]
    A = H + lam * jnp.eye(3, dtype=H.dtype)

    a, bb, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    # cofactors of the symmetric matrix [[a,b,c],[b,d,e],[c,e,f]]
    c00 = d * f - e * e
    c01 = c * e - bb * f
    c02 = bb * e - c * d
    c11 = a * f - c * c
    c12 = bb * c - a * e
    c22 = a * d - bb * bb
    det = a * c00 + bb * c01 + c * c02
    inv_det = jnp.where(jnp.abs(det) > 1e-30, 1.0 / det, 0.0)
    x0 = c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]
    x1 = c01 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]
    x2 = c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]
    return jnp.stack([x0, x1, x2], axis=-1) * inv_det[..., None]
