"""Sharded-fleet particle resampling WITHOUT the full-grid all-gather.

Reference semantics being scaled: ``ParticleFilter::resample``
(slamrs/slam/src/grid/particle.rs:78-105) — the resampled particle set
is a MULTISET of survivors (slot order is free: slots only pair
particles with independent noise draws), so each device may relabel
slots to keep data local.

The naive sharded formulation (``jnp.take_along_axis`` over a
particle-sharded grid axis) makes the SPMD partitioner all-gather the
entire per-world map set onto every device — at BASELINE config-5 scale
that is the whole multi-GB state over the interconnect per resample.  This module
replaces it with a LOCAL-FIRST plan under ``shard_map``:

* Each particle shard keeps copies of its OWN surviving ancestors in its
  own slots (an intra-device gather, no communication).
* Shards whose ancestors have more children than local slots SPILL the
  excess copies.  Because systematic-resample ancestors are sorted, the
  spilled ancestors form a contiguous SUFFIX of the shard's range — and
  duplicates of one ancestor need that map shipped once: the shard
  publishes at most ``spill_cap`` UNIQUE maps into a small all-gathered
  pool ([shards, spill_cap] maps vs [P] for the full gather).
* Deficit shards fill their remaining slots from the pool; the
  deterministic global spill order makes every device compute the same
  assignment from the (tiny, replicated) ancestor counts — no extra
  communication beyond the pool itself.
* Degenerate weights (every particle descending from one ancestor) are
  the BEST case: the pool carries a single map that every shard
  replicates locally — a broadcast, not a gather.
* If a shard would need to publish more than ``spill_cap`` unique maps
  (only under exotic weight patterns), the call falls back to the exact
  full gather under a scalar ``lax.cond`` — correctness never depends
  on the cap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

Array = jnp.ndarray


def _plan(ancestors: Array, n_shards: int, p_loc: int, spill_cap: int):
    """Replicated (per-world) plan math on tiny [P] int arrays.

    ancestors: i32[P] sorted systematic-resample output (identity on an
    N_eff skip).  Returns per-shard plan arrays, all statically shaped:
      local_src  i32[S, p_loc]  in-shard ancestor LOCAL index per slot
      use_pool   bool[S, p_loc] slot filled from the pool instead
      pool_sel   i32[S, p_loc]  flat pool index (shard * cap + k)
      pool_base  i32[S]         first spilled LOCAL ancestor per shard
      overflow   bool[]         some shard spills > spill_cap uniques
    """
    p = ancestors.shape[0]
    s = n_shards
    counts = jnp.zeros((p,), jnp.int32).at[ancestors].add(1)
    counts_sh = counts.reshape(s, p_loc)          # per-shard child counts
    cum_sh = jnp.cumsum(counts_sh, axis=1)        # inclusive, per shard
    total = cum_sh[:, -1]                         # children per shard

    # ---- local fill: slot j of shard t copies the t-local ancestor
    # whose cumulative-children range covers j (sorted fill order)
    slot = jnp.arange(p_loc, dtype=jnp.int32)
    local_src = jax.vmap(
        lambda c: jnp.searchsorted(c, slot, side="right"))(cum_sh)
    local_src = jnp.clip(local_src, 0, p_loc - 1).astype(jnp.int32)
    fill_n = jnp.minimum(total, p_loc)            # [S]

    # ---- spill: copies beyond p_loc, i.e. fill positions [p_loc, total)
    # of each surplus shard.  Sorted fill => spilled ancestors are the
    # suffix [base, last]; the shard publishes maps [base, base+cap) of
    # its local block into the pool.
    spill_copies = jnp.maximum(total - p_loc, 0)  # [S]
    base = jax.vmap(
        lambda c: jnp.searchsorted(c, jnp.int32(p_loc), side="right"))(
            cum_sh).astype(jnp.int32)
    last = jax.vmap(
        lambda c, t: jnp.searchsorted(c, jnp.maximum(t - 1, 0),
                                      side="right"))(
            cum_sh, total).astype(jnp.int32)
    uniq = jnp.where(spill_copies > 0, last - base + 1, 0)
    overflow = jnp.any(uniq > spill_cap)
    # publish window start, clamped so the static-size slice stays in
    # bounds; k = anc - base stays < cap because anc <= p_loc - 1
    pool_base = jnp.clip(base, 0, max(p_loc - min(spill_cap, p_loc), 0))

    # ---- deficit fill: global spill order = (shard asc, fill pos asc).
    # Shard t's deficit slots take global spill positions
    # [deficit_start[t], ...); spill position g belongs to source shard
    # src_t = searchsorted(spill_cum, g) at in-shard spill offset
    # g - spill_cum[src_t - 1], whose ancestor is found in src_t's cum
    # table at fill position p_loc + offset.
    deficit = p_loc - fill_n                       # [S]
    deficit_start = jnp.cumsum(deficit) - deficit  # exclusive
    spill_cum = jnp.cumsum(spill_copies)

    def shard_deficit(t):
        g = deficit_start[t] + slot - fill_n[t]    # [p_loc] global pos
        use = slot >= fill_n[t]
        g = jnp.where(use, g, 0)
        src_t = jnp.searchsorted(spill_cum, g, side="right").astype(
            jnp.int32)
        src_t = jnp.clip(src_t, 0, s - 1)
        off = g - jnp.where(src_t > 0, spill_cum[src_t - 1], 0)
        # ancestor local index within src_t covering fill pos p_loc+off
        anc = jax.vmap(
            lambda st, o: jnp.searchsorted(cum_sh[st], p_loc + o,
                                           side="right"))(src_t, off)
        anc = jnp.clip(anc, 0, p_loc - 1).astype(jnp.int32)
        k = jnp.clip(anc - pool_base[src_t], 0, spill_cap - 1)
        return use, src_t * spill_cap + k

    use_pool, pool_sel = jax.vmap(shard_deficit)(
        jnp.arange(s, dtype=jnp.int32))
    return local_src, use_pool, pool_sel.astype(jnp.int32), pool_base, \
        overflow


def _resample_block(grids, poses, ancestors, *, axis_name, n_shards,
                    p_loc, spill_cap):
    """Per-device block body: grids [W_loc, p_loc, H, W] local block,
    ancestors [W_loc, P] global indices (replicated along particle).

    The overflow fallback is ONE scalar ``lax.cond`` over the whole
    world block — a per-world cond under vmap would lower to a select
    that executes the full gather unconditionally, defeating the point.
    """
    t = jax.lax.axis_index(axis_name)
    cap = min(spill_cap, p_loc)
    local_src, use_pool, pool_sel, pool_base, overflow = jax.vmap(
        lambda a: _plan(a, n_shards, p_loc, spill_cap))(ancestors)

    def local_first(_):
        # publish my (per-world) spill windows, gather every shard's pool
        def window(g, p_b):
            return jax.lax.dynamic_slice(g, (p_b, 0, 0),
                                         (cap, *g.shape[1:]))
        mine = jax.vmap(window)(grids, pool_base[:, t])
        pool = jax.lax.all_gather(mine, axis_name, axis=1, tiled=False)
        # [W_loc, S, cap, H, W] -> flat pool per world
        pool = pool.reshape(pool.shape[0], n_shards * spill_cap,
                            *grids.shape[2:])

        def pick(g, pl_, ls, up, ps):
            local = jnp.take(g, ls, axis=0)
            pooled = jnp.take(pl_, ps, axis=0)
            return jnp.where(up[:, None, None], pooled, local)
        new_grids = jax.vmap(pick)(grids, pool, local_src[:, t],
                                   use_pool[:, t], pool_sel[:, t])

        mine_p = jax.vmap(lambda q, p_b: jax.lax.dynamic_slice(
            q, (p_b, 0), (cap, 3)))(poses, pool_base[:, t])
        pool_p = jax.lax.all_gather(mine_p, axis_name, axis=1,
                                    tiled=False)
        pool_p = pool_p.reshape(pool_p.shape[0], n_shards * spill_cap, 3)
        new_poses = jax.vmap(
            lambda q, pl_, ls, up, ps: jnp.where(
                up[:, None], jnp.take(pl_, ps, axis=0),
                jnp.take(q, ls, axis=0)))(
                    poses, pool_p, local_src[:, t], use_pool[:, t],
                    pool_sel[:, t])
        return new_grids, new_poses

    def full_gather(_):
        # exact fallback: the slot-ordered reference semantics
        all_g = jax.lax.all_gather(grids, axis_name, axis=1, tiled=True)
        all_p = jax.lax.all_gather(poses, axis_name, axis=1, tiled=True)
        sl = jax.lax.dynamic_slice(
            ancestors, (0, t * p_loc), (ancestors.shape[0], p_loc))
        g = jax.vmap(lambda a, s_: jnp.take(a, s_, axis=0))(all_g, sl)
        q = jax.vmap(lambda a, s_: jnp.take(a, s_, axis=0))(all_p, sl)
        return g, q

    return jax.lax.cond(jnp.any(overflow), full_gather, local_first, 0)


def resample_fleet(grids: Array, poses: Array, ancestors: Array,
                   mesh: Mesh, spill_cap: int | None = None
                   ) -> tuple[Array, Array]:
    """Mesh-sharded fleet resample: grids [W, P, H, C], poses [W, P, 3],
    ancestors [W, P] (sorted per world; identity when resampling was
    skipped).  Returns the resampled (grids, poses) with the particle
    axis still sharded — the same per-world particle MULTISET as
    ``take(ancestors)``, relabeled local-first so only spilled unique
    maps cross devices (an [S, spill_cap] pool all-gather instead of the
    whole set).
    """
    n_shards = mesh.shape["particle"]
    p = grids.shape[1]
    assert p % n_shards == 0
    p_loc = p // n_shards
    if spill_cap is None:
        spill_cap = max(1, min(p_loc, 8))
    spill_cap = min(spill_cap, p_loc)
    if n_shards == 1:
        g = jax.vmap(lambda g, a: jnp.take(g, a, axis=0))(grids, ancestors)
        q = jax.vmap(lambda q, a: jnp.take(q, a, axis=0))(poses, ancestors)
        return g, q

    body = functools.partial(_resample_block, axis_name="particle",
                             n_shards=n_shards, p_loc=p_loc,
                             spill_cap=spill_cap)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("world", "particle", None, None),
                  P("world", "particle", None),
                  P("world", None)),
        out_specs=(P("world", "particle", None, None),
                   P("world", "particle", None)),
        check_vma=False,
    )
    return fn(grids, poses, ancestors)
