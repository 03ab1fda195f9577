"""Probability algebra and angle math as pure array functions.

Parity surface: ``slamrs/common/src/math.rs`` (Probability, LogProbability,
LogOdds, angle_diff).  The reference wraps f64 scalars in newtypes with
operator overloads; here these become vectorized f32 transforms (the PF
weight accumulation that motivated f64 in the reference is done in log space
here, which is the numerically stable representation anyway).
"""

from __future__ import annotations

import math as _pymath

import jax.numpy as jnp

Array = jnp.ndarray


def prob_to_log_odds(p: Array) -> Array:
    """log(p / (1-p)).  Parity: Probability::log_odds (math.rs:30-32)."""
    p = jnp.asarray(p)
    return jnp.log(p) - jnp.log1p(-p)


def log_odds_to_prob(lo: Array) -> Array:
    """Inverse of :func:`prob_to_log_odds`.

    Parity: LogOdds::probability = 1 - 1/(1+exp(l)) (math.rs:134-138),
    i.e. the logistic sigmoid, computed in the numerically-stable form.
    """
    lo = jnp.asarray(lo)
    # sigmoid(lo); jnp has a stable implementation via jax.nn
    return 1.0 - 1.0 / (1.0 + jnp.exp(lo))


def log_prob_mul(a: Array, b: Array) -> Array:
    """Product of probabilities in log space (math.rs:54-60)."""
    return a + b


def log_prob_add(a: Array, b: Array) -> Array:
    """Sum of probabilities in log space (math.rs:62-76): logaddexp."""
    return jnp.logaddexp(a, b)


def angle_diff(alpha: Array, beta: Array) -> Array:
    """Shortest signed angular distance beta-alpha, in [-pi, pi).

    Parity: ``angle_diff`` (math.rs:150-157).  The reference uses Rust's
    ``%`` (truncated remainder, sign follows dividend) then fixes up values
    below -pi; jnp.mod is a floored remainder so the fixup is subsumed, but
    we reproduce the exact branch structure with remainder semantics to stay
    bit-compatible at the boundaries.
    """
    alpha = jnp.asarray(alpha)
    beta = jnp.asarray(beta)
    two_pi = 2.0 * jnp.pi
    diff = jnp.mod(beta - alpha + jnp.pi, two_pi) - jnp.pi
    # jnp.mod returns result with the sign of the divisor (>=0), so diff is
    # already in [-pi, pi); the reference's `if diff < -pi` fixup only fires
    # for truncated remainders and is kept for exactness with -pi inputs.
    return jnp.where(diff < -jnp.pi, diff + two_pi, diff)


def wrap_angle(theta: Array) -> Array:
    """Wrap an angle to [-pi, pi).  Parity: na::wrap usage in ekf.rs:95-99."""
    return angle_diff(0.0, theta)


# Python float, NOT jnp: a module-level jnp op would initialize the JAX
# backend at import time, which breaks clean-env subprocess bootstraps
# (the driver's multi-chip dryrun re-execs with JAX_PLATFORMS=cpu).
_LOG_SQRT_2PI = 0.5 * _pymath.log(2.0 * _pymath.pi)


def normal_logpdf(x: Array, mean: Array, std: Array) -> Array:
    """Gaussian log-density.

    The reference evaluates ``statrs`` Normal::pdf and multiplies the
    resulting "probabilities" (robot.rs:162-166); we keep everything in log
    space for stability and only exponentiate where a linear-space weight is
    required.
    """
    z = (x - mean) / std
    return -0.5 * z * z - jnp.log(std) - _LOG_SQRT_2PI
