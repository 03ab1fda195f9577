"""slamrs_tpu — a 2D SLAM simulation framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of antbern/slamrs
(differential-drive + lidar simulator, point-to-normal ICP scan matching,
RBPF occupancy-grid SLAM, EKF landmark SLAM, declarative node/topic config,
Neato robot protocol), re-designed for accelerators:

* the per-beam raycast, grid-ray DDA walk, log-odds scatter, and particle
  resampling are batched kernels over ``[worlds, particles, beams, ...]``
  axes instead of the reference's serial loops;
* every algorithm is a pure function ``step(state, inputs, key) -> (state,
  outputs)`` over pytrees of fixed-shape arrays so the whole sim+SLAM
  pipeline jits/scans/shards;
* multi-chip scaling uses ``jax.sharding.Mesh`` + ``shard_map`` over the
  world (data-parallel) axis rather than any message-passing runtime.

The host-side node/topic graph (``slamrs_tpu.graph``) keeps the reference's
declarative YAML vocabulary (``!Simulator``, ``!GridMapSlam``, ...) as the
orchestration API; inside a compiled rollout the topics become pytree
plumbing.
"""

__version__ = "0.1.0"

from slamrs_tpu.core.types import (  # noqa: F401
    Command,
    LandmarkScan,
    OdometryReading,
    Pose2,
    Scan,
)
