"""Core domain types, batched-first.

Parity surface: ``slamrs/common/src/robot.rs`` (Pose, Observation,
Measurement, Odometry, Command, LandmarkObservation(s)).

Design notes (not a port):

* The reference stores an observation as a ``Vec<Measurement>`` whose length
  varies with how many rays hit the scene (beams that miss are simply not
  pushed, see simulator/src/sim.rs:134-159).  Variable lengths do not jit, so
  a :class:`Scan` always carries a fixed number of beam lanes plus two masks:

  - ``present`` — this lane corresponds to a measurement the sensor emitted
    at all (reference: the Measurement exists in the Vec);
  - ``valid``   — the sensor marked the return as a real hit (reference:
    ``Measurement.valid``).  ``valid`` implies ``present``.

* Every type is a NamedTuple of arrays, so it is a pytree and can carry
  arbitrary leading batch axes ``[worlds, ...]`` / ``[particles, ...]``.

* A pose is a plain ``f32[..., 3]`` array ``(x, y, theta)`` — keeping it a
  raw array (rather than a wrapper) lets poses flow through ``lax.scan``
  carries, gathers and shard_map without ceremony.  :class:`Pose2` provides
  constructors/accessors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

Array = jnp.ndarray


class Pose2:
    """Helpers for ``f32[..., 3]`` pose arrays ``(x, y, theta)``.

    Reference: ``Pose`` in slamrs/common/src/robot.rs:8-46.  theta is radians
    counter-clockwise from +x.
    """

    DIM = 3

    @staticmethod
    def make(x=0.0, y=0.0, theta=0.0, dtype=jnp.float32) -> Array:
        return jnp.stack(
            [
                jnp.asarray(x, dtype),
                jnp.asarray(y, dtype),
                jnp.asarray(theta, dtype),
            ],
            axis=-1,
        )

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> Array:
        return jnp.zeros((*batch_shape, 3), dtype)

    @staticmethod
    def x(p: Array) -> Array:
        return p[..., 0]

    @staticmethod
    def y(p: Array) -> Array:
        return p[..., 1]

    @staticmethod
    def theta(p: Array) -> Array:
        return p[..., 2]

    @staticmethod
    def xy(p: Array) -> Array:
        return p[..., 0:2]


class Scan(NamedTuple):
    """A full lidar revolution with fixed beam lanes.

    Parity: ``Observation { id, measurements: Vec<Measurement> }`` +
    ``Measurement { angle, distance, strength, valid }``
    (slamrs/common/src/robot.rs:50-94), with the absent-beam case encoded in
    ``present`` instead of a shorter Vec.
    """

    angles: Array  # f32[..., B] radians, sensor-relative
    distances: Array  # f32[..., B] meters
    strengths: Array  # f32[..., B]
    valid: Array  # bool[..., B] sensor says the return is a true hit
    present: Array  # bool[..., B] lane carries a measurement at all

    @property
    def num_beams(self) -> int:
        return self.angles.shape[-1]

    def to_points(self, origin: Array) -> tuple[Array, Array]:
        """Project valid beams to world-frame points.

        Parity: ``Observation::to_points`` (robot.rs:57-68) — reference
        filters to valid beams; here all lanes are projected and the
        valid mask is returned alongside (fixed shapes).

        origin: f32[..., 3]; returns (points f32[..., B, 2], mask bool[..., B]).
        """
        a = origin[..., 2:3] + self.angles
        px = origin[..., 0:1] + jnp.cos(a) * self.distances
        py = origin[..., 1:2] + jnp.sin(a) * self.distances
        return jnp.stack([px, py], axis=-1), self.valid & self.present

    @staticmethod
    def empty(num_beams: int = 360, batch_shape=()) -> "Scan":
        sh = (*batch_shape, num_beams)
        angles = jnp.broadcast_to(
            jnp.deg2rad(jnp.arange(num_beams, dtype=jnp.float32)), sh
        )
        z = jnp.zeros(sh, jnp.float32)
        f = jnp.zeros(sh, bool)
        return Scan(angles=angles, distances=z, strengths=z, valid=f, present=f)


class OdometryReading(NamedTuple):
    """Measured wheel travel since the previous reading.

    Parity: ``Odometry { distance_left, distance_right, wheel_distance }``
    (robot.rs:114-129).  The derived Gaussian motion model lives in
    :mod:`slamrs_tpu.core.motion` as pure functions of these fields.
    """

    distance_left: Array  # f32[...]
    distance_right: Array  # f32[...]
    wheel_base: Array  # f32[...]

    @staticmethod
    def make(left=0.0, right=0.0, wheel_base=0.1) -> "OdometryReading":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return OdometryReading(f(left), f(right), f(wheel_base))


class Command(NamedTuple):
    """Target wheel speeds, m/s.  Parity: ``Command`` (robot.rs:186-194)."""

    speed_left: Array
    speed_right: Array

    @staticmethod
    def make(left=0.0, right=0.0) -> "Command":
        return Command(jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32))


class LandmarkScan(NamedTuple):
    """Batched landmark observations with fixed lanes.

    Parity: ``LandmarkObservations`` / ``LandmarkObservation { angle,
    distance, association }`` (robot.rs:96-111).  ``association`` is the
    landmark id (simulator-known association); ``valid`` masks unused lanes
    (reference uses a variable-length Vec).
    """

    angles: Array  # f32[..., L] radians, robot-relative
    distances: Array  # f32[..., L] meters
    association: Array  # i32[..., L]
    valid: Array  # bool[..., L]

    @property
    def num_lanes(self) -> int:
        return self.angles.shape[-1]

    @staticmethod
    def empty(num_lanes: int, batch_shape=()) -> "LandmarkScan":
        sh = (*batch_shape, num_lanes)
        return LandmarkScan(
            angles=jnp.zeros(sh, jnp.float32),
            distances=jnp.zeros(sh, jnp.float32),
            association=jnp.zeros(sh, jnp.int32),
            valid=jnp.zeros(sh, bool),
        )


@dataclasses.dataclass
class Gaussian2D:
    """2D Gaussian domain type.

    Parity: ``Gaussian2D { mean, covariance }``
    (slamrs/common/src/gaussian.rs:3-16).  Host-side numpy payload (used
    by the Gaussian debug node and covariance-ellipse rendering).
    """

    mean: "object" = None  # np [2]
    covariance: "object" = None  # np [2, 2]

    def __post_init__(self):
        import numpy as np
        if self.mean is None:
            self.mean = np.zeros(2, np.float32)
        if self.covariance is None:
            self.covariance = np.eye(2, dtype=np.float32)
