"""Particle-filter resampling primitives.

Parity surface: ``ParticleFilter`` (slamrs/slam/src/grid/particle.rs):
systematic (low-variance) resampling with a single uniform offset
r in [0, 1/N) (particle.rs:78-105), weight normalization (49-56), and the
effective-particle-count diagnostic (59-65).

Design: the reference's ``while u > c`` pointer walk becomes a
``cumsum`` + ``searchsorted``; the reference's deep per-particle clone of
(Pose, full Map grid) becomes a gather by ancestor indices done by the
caller (``jnp.take`` — no host copies, one pass over device memory).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def normalize_log_weights(log_w: Array, axis: int = -1) -> Array:
    """Normalize weights given in log space; returns linear-space weights
    summing to 1 along ``axis`` (particle.rs:49-56, done stably in log)."""
    log_w = log_w - jnp.max(log_w, axis=axis, keepdims=True)
    w = jnp.exp(log_w)
    return w / jnp.sum(w, axis=axis, keepdims=True)


def effective_particles(weights: Array, axis: int = -1) -> Array:
    """N_eff = 1 / sum(w^2) (particle.rs:59-65); expects normalized w."""
    return 1.0 / jnp.sum(weights * weights, axis=axis)


def systematic_resample(key: Array, weights: Array,
                        u01: Array | None = None) -> Array:
    """Systematic resampling: ancestor indices, shape/batch = weights.

    Parity: ParticleFilter::resample (particle.rs:78-105): u_m = r +
    (m-1)/N with one shared r ~ U[0, 1/N); ancestor is the smallest i with
    cumsum(w)_i >= u_m (the reference walks ``while u > c``, i.e. stops at
    the first c >= u, which is ``searchsorted(..., side='left')``).

    weights: f32[..., N] normalized.  Returns i32[..., N].
    ``u01`` optionally supplies the pre-drawn U[0,1) offset (shape
    batch + (1,), exactly ``jax.random.uniform(key, batch + (1,))``) so
    rollouts can hoist the draw out of the sequential step chain; the
    offset value is identical to drawing from ``key`` here.
    """
    n = weights.shape[-1]
    batch = weights.shape[:-1]
    if u01 is None:
        u01 = jax.random.uniform(key, batch + (1,), weights.dtype)
    r = u01 / n
    u = r + jnp.arange(n, dtype=weights.dtype) / n  # [..., N]
    cum = jnp.cumsum(weights, axis=-1)
    # comparison-matrix formulation: ancestor_m = #(cum_i < u_m); identical
    # to searchsorted(side='left') but batches/vectorizes trivially on the
    # device for the particle counts involved (cum[-1] roundoff covered by clip)
    idx = jnp.sum(cum[..., None, :] < u[..., :, None], axis=-1)
    return jnp.clip(idx, 0, n - 1).astype(jnp.int32)
