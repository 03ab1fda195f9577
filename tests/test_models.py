"""End-to-end model tests: grid SLAM / ICP mapper / EKF track a simulated
robot (the integration-fixture strategy of SURVEY §4: the simulator IS the
fixture, here with assertive gates instead of visual inspection)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamrs_tpu.core.types import Command
from slamrs_tpu.models import ekf as E
from slamrs_tpu.models import gridslam as GS
from slamrs_tpu.models import icp_mapper as IM
from slamrs_tpu.models import simulator as S


def make_scene():
    return S.Scene.build(
        rects=[(-1, -1, 2, 2), (-0.1, -0.4, 0.5, 0.1), (-0.6, 0.4, 0.2, 0.5)],
        lines=[(-0.6, -0.4, 0.2, 0.4)],
        landmarks=[(-0.1, -0.4), (-0.6, 0.4), (-0.6, -0.4), (0.6, 0.4),
                   (0.6, -0.4)])


def rollout(n_ticks, slam_update, init_ops, seed=0, update_period=0.2):
    scene = make_scene()
    params = S.SimParams.make(update_period=update_period)
    sim = S.SimState.init()

    @jax.jit
    def step(carry, key):
        sim, ops = carry
        k1, k2 = jax.random.split(key)
        sim, out = S.tick(sim, Command.make(0.05, 0.08), k1, params, scene)
        ops, est = jax.lax.cond(
            out.fired,
            lambda o: slam_update(o, out, k2),
            lambda o: (o, jnp.zeros(3)),
            ops)
        return (sim, ops), (out.fired, out.pose, est)

    keys = jax.random.split(jax.random.key(seed), n_ticks)
    (_, _), (fired, poses, ests) = jax.lax.scan(step, (sim, init_ops), keys)
    f = np.asarray(fired)
    return np.asarray(poses)[f], np.asarray(ests)[f]


@pytest.mark.parametrize("integrate", ["dda", "fused"])
def test_update_noise_hoist_equivalent(integrate):
    """update(key, noise=derive_noise(key)) must draw the SAME random
    values as update(key): the RNG-hoisted rollout path
    (compile.FusedWorld._grid_noise) relies on derive_noise mirroring
    update()'s chain.  Unjitted the results are bitwise equal; under jit
    the two graphs may fuse FMAs differently, so floats get a 1e-6
    tolerance while the resample decision (integers) must match exactly.
    """
    cfg = GS.GridSlamConfig(resolution=0.1, n_particles=8,
                            integrate=integrate)
    st0 = GS.GridSlamState.init(cfg)
    scene = make_scene()
    params = S.SimParams.make(update_period=0.0)
    sim = S.SimState.init()
    _, out = jax.jit(lambda s, k: S.tick(s, Command.make(0.05, 0.08), k,
                                         params, scene))(
        sim, jax.random.key(0))
    key = jax.random.key(42)
    noise = GS.derive_noise(key, cfg.n_particles)
    # unjitted: identical computation graph -> bitwise equal
    a_st, a_out = GS.update(st0, out.scan, out.odometry, key, cfg)
    b_st, b_out = GS.update(st0, out.scan, out.odometry, key, cfg,
                            noise=noise)
    for a, b in zip(jax.tree.leaves(a_st), jax.tree.leaves(b_st)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # jitted: same values, fusion-tolerant comparison
    upd = jax.jit(lambda s, noise: GS.update(s, out.scan, out.odometry, key,
                                             cfg, noise=noise))
    a_st, a_out = upd(st0, None)
    b_st, b_out = upd(st0, noise)
    np.testing.assert_array_equal(np.asarray(a_st.ancestors),
                                  np.asarray(b_st.ancestors))
    np.testing.assert_array_equal(np.asarray(a_st.best_idx),
                                  np.asarray(b_st.best_idx))
    np.testing.assert_allclose(np.asarray(a_st.poses),
                               np.asarray(b_st.poses), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a_st.weights),
                               np.asarray(b_st.weights), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a_out.pose),
                               np.asarray(b_out.pose), atol=1e-6)


@pytest.mark.parametrize("integrate", ["dda", "dense"])
def test_gridslam_tracks(integrate):
    cfg = GS.GridSlamConfig(resolution=0.05, n_particles=8,
                            integrate=integrate)
    state = GS.GridSlamState.init(cfg)

    def upd(ops, out, key):
        st, o = GS.update(ops, out.scan, out.odometry, key, cfg)
        return st, o.pose

    true, est = rollout(180, upd, state)
    rmse = np.sqrt(np.mean((true[:, :2] - est[:, :2]) ** 2))
    assert rmse < 0.05, rmse
    # heading tracks too
    assert np.abs(true[-1, 2] - est[-1, 2]) < 0.3


def test_icp_mapper_tracks():
    cfg = IM.IcpMapConfig(capacity=8192, step_threshold=0.05)
    state = IM.IcpMapState.init(cfg)

    def upd(ops, out, key):
        st, o = IM.update(ops, out.scan, cfg)
        return st, o.pose

    true, est = rollout(180, upd, state)
    rmse = np.sqrt(np.mean((true[:, :2] - est[:, :2]) ** 2))
    assert rmse < 0.05, rmse


def test_icp_mapper_first_scan_initializes():
    cfg = IM.IcpMapConfig(capacity=1024)
    state = IM.IcpMapState.init(cfg)
    scene = make_scene()
    scan = S.lidar_scan(jnp.zeros(3), scene, jnp.float32(1.0))
    state, out = IM.update(state, scan, cfg)
    assert bool(state.initialized)
    assert int(state.count) == int(np.asarray(scan.valid).sum())
    np.testing.assert_allclose(np.asarray(out.pose), 0.0)  # pose unchanged


def test_icp_mapper_voxel_dedup_bounds_growth():
    cfg = IM.IcpMapConfig(capacity=8192, voxel_size=0.05,
                          extent_x=-2, extent_y=-2, extent_w=4, extent_h=4)
    state = IM.IcpMapState.init(cfg)
    scene = make_scene()
    scan = S.lidar_scan(jnp.zeros(3), scene, jnp.float32(1.0))
    state, _ = IM.update(state, scan, cfg)
    c1 = int(state.count)
    state, _ = IM.update(state, scan, cfg)  # identical scan again
    c2 = int(state.count)
    assert c2 - c1 < c1 * 0.2  # nearly everything deduped


def test_ekf_tracks_and_maps():
    cfg = E.EkfConfig()
    state = E.EkfState.init(cfg)

    def upd(ops, out, key):
        st, o = E.update(ops, out.landmarks, out.odometry, cfg)
        return st, o.pose

    true, est = rollout(240, upd, state)
    rmse = np.sqrt(np.mean((true[:, :2] - est[:, :2]) ** 2))
    assert rmse < 0.06, rmse


def test_ekf_reference_jacobian_mode_exists():
    cfg = E.EkfConfig(reference_jacobian=True)
    state = E.EkfState.init(cfg)
    scene = make_scene()
    params = S.SimParams.make()
    scan = S.landmark_scan(jax.random.key(0), jnp.zeros(3), scene, params)
    from slamrs_tpu.core.types import OdometryReading
    state, out = E.update(state, scan, OdometryReading.make(0.01, 0.012),
                          cfg)
    assert np.isfinite(np.asarray(out.pose)).all()


def test_gridslam_neff_gate_skips_resampling():
    cfg = GS.GridSlamConfig(resolution=0.1, n_particles=8,
                            resample_neff_frac=0.0)  # never resample
    state = GS.GridSlamState.init(cfg)
    scene = make_scene()
    scan = S.lidar_scan(jnp.zeros(3), scene, jnp.float32(1.0), 90)
    from slamrs_tpu.core.types import OdometryReading
    state, out = GS.update(state, scan, OdometryReading.make(0.01, 0.012),
                           jax.random.key(0), cfg)
    assert not bool(out.resampled)
    # weights stay non-uniform
    w = np.asarray(state.weights)
    assert w.std() > 0.0


def test_checkpoint_roundtrip_and_resume():
    """SURVEY §5.4: checkpoint/resume (absent in the reference; framework
    capability here) — rollout state round-trips through .npz and a
    resumed rollout continues bit-exactly."""
    import jax
    import numpy as np

    from slamrs_tpu.graph.compile import make_fused
    from slamrs_tpu.models.gridslam import GridSlamConfig
    from slamrs_tpu.models.simulator import SimParams
    from slamrs_tpu.utils import checkpoint as ckpt

    cfg = GridSlamConfig(resolution=0.1, n_particles=4, max_scan_range=1.0,
                         integrate="dense")
    fw = make_fused(params=SimParams.make(update_period=0.2),
                    grid_config=cfg, num_beams=60)
    s0 = fw.init()
    mid, _ = fw.rollout(s0, 10, seed=1)

    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        ckpt.save(path, mid)
        restored = ckpt.load(path, fw.init())
        same = jax.tree.map(
            lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
            mid, restored)
        assert all(jax.tree.leaves(same))

        # continuing from the restored state == continuing from mid
        f1, _ = fw.rollout(mid, 5, seed=2)
        f2, _ = fw.rollout(restored, 5, seed=2)
        np.testing.assert_array_equal(np.asarray(f1.pose),
                                      np.asarray(f2.pose))
        np.testing.assert_array_equal(np.asarray(f1.grid.grids),
                                      np.asarray(f2.grid.grids))

        # config mismatch: the treedef difference warns loudly, the leaf
        # count check rejects
        import pytest
        other = make_fused(params=SimParams.make(update_period=0.2),
                           grid_config=None, num_beams=60)
        with pytest.warns(UserWarning, match="pytree structure"), \
                pytest.raises(ValueError):
            ckpt.load(path, other.init())


def test_checkpoint_roundtrip_bfloat16():
    """Review regression: npz cannot store bf16 — save widens to f32
    (exact), load casts back; the flagship fused/bf16 state must
    round-trip."""
    import tempfile, os
    import jax.numpy as jnp
    import numpy as np

    from slamrs_tpu.utils import checkpoint as ckpt

    cfg = GS.GridSlamConfig(resolution=0.1, n_particles=4,
                            integrate="fused", grid_dtype="bfloat16")
    state = GS.GridSlamState.init(cfg)
    state = state._replace(grids=state.grids + jnp.bfloat16(0.5))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.npz")
        ckpt.save(path, state)
        restored = ckpt.load(path, GS.GridSlamState.init(cfg))
    assert restored.grids.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(restored.grids, np.float32),
                                  np.asarray(state.grids, np.float32))


def test_long_run_stability_fused_bf16():
    """Stability contract (CPU-sized): finite grids, sane N_eff, bounded
    pose tracking (unbounded log-odds growth is reference behavior — see
    ops/grid.py LOGODDS_CLAMP note).  chip_smoke.py checks the
    full-scale (1,024-particle) rollout's tracking on the GPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamrs_tpu.core.types import Command
    from slamrs_tpu.graph.compile import make_fused
    from slamrs_tpu.models.simulator import SimParams

    cfg = GS.GridSlamConfig(resolution=0.1, n_particles=8,
                            max_scan_range=1.0, resample_neff_frac=0.5,
                            integrate="fused", grid_dtype="bfloat16")
    fw = make_fused(params=SimParams.make(update_period=0.0),
                    grid_config=cfg, num_beams=90)
    state = fw.init()
    n = 300
    cmds = Command(jnp.full((n,), 0.05, jnp.float32),
                   jnp.full((n,), 0.08, jnp.float32))
    final, outs = fw.rollout(state, n, seed=5, commands=cmds)
    g = np.asarray(final.grid.grids, np.float32)
    assert np.isfinite(g).all()
    err = np.linalg.norm(
        (np.asarray(outs.pose) - np.asarray(outs.grid_pose))[:, :2], axis=1)
    assert err[-1] < 0.5, f"tracking lost: {err[-1]:.3f} m"
    assert np.isfinite(np.asarray(outs.n_eff)).all()
