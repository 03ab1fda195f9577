"""Fleet updates on the fused path: unsharded fleets are per-world
``vmap(update)`` (the whole-set gather resample behind the N_eff gate),
world-only meshes run the fused update per device under ``shard_map``.

Reference semantics per world: ParticleFilter::resample
(slamrs/slam/src/grid/particle.rs:78-105) over independent worlds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamrs_tpu.core.types import OdometryReading, Scan
from slamrs_tpu.models import gridslam as gs

B = 64


def _fleet_inputs(seed, worlds, step=0):
    rng = np.random.default_rng(seed + 131 * step)
    angles = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.float32) * (2 * np.pi / B), (worlds, B))
    dist = jnp.asarray(rng.uniform(0.15, 0.95, size=(worlds, B)),
                       jnp.float32)
    valid = jnp.asarray(rng.random((worlds, B)) > 0.1)
    present = jnp.asarray(rng.random((worlds, B)) > 0.05)
    scan = Scan(angles, dist, jnp.ones((worlds, B), jnp.float32), valid,
                present)
    odo = OdometryReading(jnp.full((worlds,), 0.02, jnp.float32),
                          jnp.full((worlds,), 0.03, jnp.float32),
                          jnp.full((worlds,), 0.2, jnp.float32))
    keys = jax.random.split(jax.random.key(700 + step), worlds)
    return scan, odo, keys


def _base_cfg(**over):
    kw = dict(position_x=-2.0, position_y=-2.0, width=4.0, height=4.0,
              resolution=0.05, n_particles=16, max_scan_range=1.0,
              integrate="fused", grid_dtype="bfloat16",
              resample_neff_frac=1.0)  # force resampling every update
    kw.update(over)
    return gs.GridSlamConfig(**kw)


def _multiset_equal(poses_a, grids_a, poses_b, grids_b, world):
    """Per-world particle-multiset equality (slot order is free)."""
    ka = np.argsort([p.tobytes() + g.tobytes()
                     for p, g in zip(poses_a, grids_a)])
    kb = np.argsort([p.tobytes() + g.tobytes()
                     for p, g in zip(poses_b, grids_b)])
    np.testing.assert_array_equal(poses_a[ka], poses_b[kb],
                                  err_msg=f"world {world} poses")
    np.testing.assert_array_equal(grids_a[ka], grids_b[kb],
                                  err_msg=f"world {world} grids")


def test_fleet_cow_multiset_matches_gather():
    """The default unsharded-fleet resample ("local") must produce the
    same per-world particle MULTISET as the slot-exact gather mode after
    one resampling update (slot order is free, and the NEXT step's
    per-slot noise pairing makes trajectories order-dependent — so the
    comparison is one step from a common state, like the sharded
    local/gather gate).  A second local-mode update then checks
    consecutive updates compose (lineage fully applied each call)."""
    worlds = 3
    res = {}
    st_local = None
    for mode in ("local", "gather"):
        cfg = _base_cfg(fleet_resample=mode)
        st = gs.GridSlamState.init(cfg, (worlds,))
        scan, odo, keys = _fleet_inputs(11, worlds)
        st, outs = gs.update_fleet(st, scan, odo, keys, cfg, mesh=None)
        assert bool(np.asarray(outs.resampled).all())
        # every update applies its lineage: identity ancestors
        np.testing.assert_array_equal(
            np.asarray(st.ancestors),
            np.broadcast_to(np.arange(cfg.n_particles, dtype=np.int32),
                            (worlds, cfg.n_particles)))
        res[mode] = (np.asarray(st.poses), np.asarray(st.grids, np.float32))
        if mode == "local":
            st_local = st
    for w in range(worlds):
        _multiset_equal(res["local"][0][w], res["local"][1][w],
                        res["gather"][0][w], res["gather"][1][w], w)
    # consecutive updates from the resampled state stay sound
    cfg = _base_cfg(fleet_resample="local")
    scan, odo, keys = _fleet_inputs(11, worlds, step=1)
    st2, outs2 = gs.update_fleet(st_local, scan, odo, keys, cfg, mesh=None)
    assert np.isfinite(np.asarray(st2.poses)).all()
    assert np.isfinite(np.asarray(outs2.n_eff)).all()


def test_fleet_cow_world_only_mesh_matches_unsharded():
    """A pure-DP (world-only) mesh runs the fused update per device
    under shard_map and the resample gather locally; outputs agree with
    the unsharded fleet up to cross-compilation fma contraction."""
    from slamrs_tpu.parallel.fleet import make_mesh

    worlds = 8
    mesh = make_mesh(8, particle_axis=1)
    cfg = _base_cfg()
    st_m = gs.GridSlamState.init(cfg, (worlds,))
    st_p = st_m
    # one resampling step suffices: consecutive-application composition
    # is covered unsharded above, and the mesh body IS that same path
    scan, odo, keys = _fleet_inputs(23, worlds)
    st_m, outs_m = gs.update_fleet(st_m, scan, odo, keys, cfg, mesh=mesh)
    st_p, outs_p = gs.update_fleet(st_p, scan, odo, keys, cfg, mesh=None)
    assert bool(np.asarray(outs_m.resampled).all())
    np.testing.assert_allclose(np.asarray(st_m.poses),
                               np.asarray(st_p.poses), atol=1e-5)
    d_m = np.asarray(st_m.grids, np.float32)
    d_p = np.asarray(st_p.grids, np.float32)
    eq = float((d_m == d_p).mean())
    assert eq > 0.9999, f"mesh/unsharded grid agreement {eq}"
    assert float(np.abs(d_m - d_p).max()) <= 0.25


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["one_device", "world_mesh"])
def test_update_fleet_matches_per_world_update(sharded):
    """update_fleet against gs.update run world by world: the plain fleet
    path on one device, and the shard_map'd fused update on a world-only
    mesh (the resample gather then stays on each device)."""
    from slamrs_tpu.parallel.fleet import make_mesh

    worlds = 8 if sharded else 3
    mesh = make_mesh(8, particle_axis=1) if sharded else None
    cfg = _base_cfg(n_particles=8, resample_neff_frac=0.5)
    st = gs.GridSlamState.init(cfg, (worlds,))
    per_world = [gs.GridSlamState.init(cfg) for _ in range(worlds)]
    upd = jax.jit(lambda s, sc, od, k: gs.update(s, sc, od, k, cfg))
    fleet = jax.jit(lambda s, sc, od, k: gs.update_fleet(s, sc, od, k, cfg,
                                                          mesh=mesh))
    for step in range(2):
        scan, odo, keys = _fleet_inputs(53, worlds, step)
        st, outs = fleet(st, scan, odo, keys)
        for i in range(worlds):
            per_world[i], out_i = upd(
                per_world[i], jax.tree.map(lambda x: x[i], scan),
                jax.tree.map(lambda x: x[i], odo), keys[i])
            np.testing.assert_allclose(np.asarray(st.poses[i]),
                                       np.asarray(per_world[i].poses),
                                       atol=1e-5)
            np.testing.assert_allclose(float(outs.n_eff[i]),
                                       float(out_i.n_eff), rtol=1e-5)
            assert bool(outs.resampled[i]) == bool(out_i.resampled)
            d_f = np.asarray(st.grids[i], np.float32)
            d_w = np.asarray(per_world[i].grids, np.float32)
            assert float((d_f == d_w).mean()) > 0.9999
            assert float(np.abs(d_f - d_w).max()) <= 0.25
