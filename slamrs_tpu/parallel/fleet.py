"""Multi-chip fleet scaling: mesh construction and world-state sharding.

The reference is strictly single-process (SURVEY §2.3/§5.8: its only
"transports" are in-process mpsc channels and the robot serial/TCP link);
scale-out is a new capability: BASELINE config 5 asks for 256 parallel
worlds across the devices of one host.

Design (the scaling-book recipe — pick a mesh, annotate shardings, let the
XLA SPMD partitioner insert the collectives):

* mesh axes ``(world, particle)``: the world axis is pure data parallelism
  (worlds never communicate); the particle axis shards the RBPF particle
  set *within* each world — weight normalization and the systematic
  resample's cumulative sum become cross-shard reductions, and the
  ancestor gather of per-particle grids becomes an all-to-all, all
  partitioner-inserted (NCCL over NVLink between the cards of a host).
  Every card reaches every other at the same rate, so the mesh follows
  the algorithm, in ``jax.devices()`` order.
* ``shard_world_state`` annotates the :class:`WorldState` pytree: leaves
  with a leading worlds axis get ``P('world', ...)``; per-particle leaves
  (poses/grids/weights of the PF) additionally shard their particle axis;
  shared scalars (scan timer/counter) replicate.

No hand-written communication runtime is needed: a jitted step with
these shardings IS the distributed program.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, particle_axis: int = 1,
              devices=None) -> Mesh:
    """Build a ``(world, particle)`` mesh over the first ``n_devices``.

    ``particle_axis`` devices are dedicated to particle-sharding; the rest
    to worlds (data parallel).  ``particle_axis=1`` gives a pure-DP mesh.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % particle_axis != 0:
        raise ValueError(f"{n} devices not divisible by particle_axis="
                         f"{particle_axis}")
    arr = np.array(devices).reshape(n // particle_axis, particle_axis)
    return Mesh(arr, ("world", "particle"))


def fleet_shardings(state, mesh: Mesh, worlds: int):
    """Sharding pytree for a batched :class:`WorldState` (explicit per
    field: worlds axis -> 'world'; the PF's per-particle axis ->
    'particle'; shared scalars replicated)."""
    del worlds  # structure, not shapes, determines the specs
    ws = lambda *rest: NamedSharding(mesh, P("world", *rest))
    rep = NamedSharding(mesh, P())

    grid_sh = None
    if state.grid is not None:
        from slamrs_tpu.models.gridslam import GridSlamState

        grid_sh = GridSlamState(
            poses=ws("particle"),  # [W, P, 3]
            grids=ws("particle"),  # [W, P, H, W']
            weights=ws("particle"),  # [W, P]
            best_pose=ws(),  # [W, 3]
            best_idx=ws(),  # [W]
            ancestors=ws("particle"),  # [W, P]
        )
    icp_sh = (jax.tree.map(lambda _: ws(), state.icp)
              if state.icp is not None else None)
    ekf_sh = (jax.tree.map(lambda _: ws(), state.ekf)
              if state.ekf is not None else None)

    return type(state)(
        pose=ws(),
        accum_left=ws(),
        accum_right=ws(),
        scan_timer=rep,
        scan_counter=rep,
        grid=grid_sh,
        icp=icp_sh,
        ekf=ekf_sh,
    )


def shard_world_state(state, mesh: Mesh, worlds: int):
    """Place a host-built WorldState onto the mesh with fleet shardings."""
    shardings = fleet_shardings(state, mesh, worlds)
    return jax.tree.map(
        lambda leaf, s: jax.device_put(leaf, s), state, shardings)
