"""Mesh-sharded execution of the fused RBPF update.

The SPMD partitioner auto-inserts collectives for every jnp op in the
SLAM update (weight normalization, N_eff, the resample gather — all
tiny or partitionable), but it cannot partition a hand-written kernel
(``pl.pallas_call``): left alone it would all-gather the full
particle-map set onto every device and run the kernel replicated.  This
module wraps ONLY the fused update in :func:`jax.shard_map` over the
fleet's ``(world, particle)`` mesh — manual-shard the one custom kernel,
let the partitioner own everything around it.

The update is embarrassingly parallel over (world, particle): each
device runs the identical program on its local ``[W_loc, P_loc, H, W]``
block with the (per-world) scan replicated along the particle axis — no
collectives inside, so results match the unsharded ``vmap``
formulation.

Reference capability being scaled: the per-particle weight+integrate
core ``GridMapSlam::update`` (slamrs/slam/src/grid/slam.rs:45-75) at
BASELINE config-5 fleet scale.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from slamrs_tpu.ops.grid import GridSpec2D

Array = jnp.ndarray


def fused_update_batched(grids: Array, poses: Array, angles0: Array,
                         distances: Array, valid: Array, present: Array,
                         spec: GridSpec2D, num_beams: int,
                         max_range_m: float, dphi: Array,
                         mesh: Mesh | None = None,
                         dphi_static: float | None = None):
    """Batched-worlds fused update: grids [W, P, H, W'], poses [W, P, 3],
    per-world scan arrays ([W] / [W, B]).

    ``mesh=None`` vmaps the update over worlds (single-device fleets).
    With a mesh, the same vmapped call runs under ``shard_map`` on each
    device's local (world, particle) block.  Returns (grids', log_lik
    [W, P]).
    """
    from slamrs_tpu.ops.fused import fused_update

    def run_block(g, q, a0, d, v, pr, dp):
        f = functools.partial(fused_update, spec=spec, num_beams=num_beams,
                              max_range_m=max_range_m)
        return jax.vmap(lambda gg, qq, aa, dd, vv, pp, ddp:
                        f(gg, qq, aa, dd, vv, pp,
                          dphi=dphi_static if dphi_static is not None
                          else ddp))(g, q, a0, d, v, pr, dp)

    if mesh is None:
        return run_block(grids, poses, angles0, distances, valid, present,
                         dphi)

    wp = P("world", "particle")
    w = P("world")
    sharded = jax.shard_map(
        run_block, mesh=mesh,
        in_specs=(P("world", "particle", None, None),  # grids
                  P("world", "particle", None),        # poses
                  w,                                   # angles0 [W]
                  P("world", None),                    # distances [W, B]
                  P("world", None),                    # valid
                  P("world", None),                    # present
                  w),                                  # dphi [W]
        out_specs=(P("world", "particle", None, None), wp),
        check_vma=False,
    )
    return sharded(grids, poses, angles0, distances, valid, present, dphi)
