"""Graph compiler: fuse a YAML node graph into one jitted world step.

This is the compiled execution path.  The host pub/sub graph
(:mod:`slamrs_tpu.graph.app`) mirrors the reference's per-frame node loop;
for throughput (rollouts, fleet datagen, benchmarking) the same declarative
config compiles down to a single pure function

    step : (WorldState, Command, key) -> (WorldState, WorldOutputs)

in which the topics have become pytree plumbing (SURVEY §5.8): the
simulator's observation topic feeds the SLAM nodes directly, splitters
dissolve, and the whole step jits, ``lax.scan``s over time, ``vmap``s over
worlds, and shards over a device mesh.

Topic wiring is resolved from the config exactly as the pub/sub graph
would: a SLAM node is fed by the simulator iff its input topic is the
simulator's output topic or a Splitter-derived alias of it.

Scan cadence: the reference's per-world accumulator timer
(sim.rs:109-112) is hoisted into a *scalar* (shared) timer so the
fired-branch is uniform across worlds — ``lax.cond`` then skips the
expensive SLAM update entirely on non-scan ticks even in batched rollouts
(a per-world timer would degrade to ``select`` under vmap and always pay
for the SLAM update).  The cadence (e.g. 7,6,6,7,... ticks at
period=0.2s, dt=1/30s) is identical to the reference's accumulator.
"""

from __future__ import annotations

import dataclasses
import math as pymath
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from slamrs_tpu.core.types import Command
from slamrs_tpu.graph.config import Config
from slamrs_tpu.graph.nodes.sim import SimulatorNodeConfig
from slamrs_tpu.graph.nodes.slam import (EKFLandmarkSlamNodeConfig,
                                         GridMapSlamNodeConfig,
                                         IcpPointMapperNodeConfig)
from slamrs_tpu.graph.nodes.util import ControlsNodeConfig, SplitterNodeConfig
from slamrs_tpu.models import ekf as ekf_model
from slamrs_tpu.models import gridslam as gs_model
from slamrs_tpu.models import icp_mapper as icp_model
from slamrs_tpu.models import simulator as sim_model

Array = jnp.ndarray


class WorldState(NamedTuple):
    pose: Array  # f32[..., 3] ground-truth robot pose
    accum_left: Array  # f32[...] wheel travel since last scan
    accum_right: Array  # f32[...]
    scan_timer: Array  # f32[] SHARED scalar timer (see module docstring)
    scan_counter: Array  # i32[]
    grid: Optional[gs_model.GridSlamState]
    icp: Optional[icp_model.IcpMapState]
    ekf: Optional[ekf_model.EkfState]


class WorldOutputs(NamedTuple):
    fired: Array  # bool[] scalar
    pose: Array  # f32[..., 3] ground truth
    grid_pose: Optional[Array]  # f32[..., 3]
    icp_pose: Optional[Array]
    ekf_pose: Optional[Array]
    n_eff: Optional[Array]  # f32[...]


@dataclasses.dataclass
class FusedWorld:
    """A compiled sim(+SLAM) pipeline.  Build with :func:`compile_world`."""

    sim_config: SimulatorNodeConfig
    scene: sim_model.Scene
    params: sim_model.SimParams
    dt: float
    grid_config: Optional[gs_model.GridSlamConfig]
    icp_config: Optional[icp_model.IcpMapConfig]
    ekf_config: Optional[ekf_model.EkfConfig]
    control_script: list  # [[until_t, left, right], ...]
    num_beams: int = 360
    # optional (world, particle) device mesh: batched fused-path SLAM
    # updates then run under shard_map on each device's local block
    # (parallel/shard.py); everything else stays auto-partitioned.
    # None = single-device (plain vmap).
    mesh: Any = None

    # ---- state ------------------------------------------------------------

    def init(self, worlds: tuple[int, ...] = ()) -> WorldState:
        return WorldState(
            pose=jnp.zeros((*worlds, 3), jnp.float32),
            accum_left=jnp.zeros(worlds, jnp.float32),
            accum_right=jnp.zeros(worlds, jnp.float32),
            scan_timer=jnp.zeros((), jnp.float32),
            scan_counter=jnp.zeros((), jnp.int32),
            grid=(gs_model.GridSlamState.init(self.grid_config, worlds)
                  if self.grid_config else None),
            icp=(icp_model.IcpMapState.init(self.icp_config, worlds)
                 if self.icp_config else None),
            ekf=(ekf_model.EkfState.init(self.ekf_config, worlds)
                 if self.ekf_config else None),
        )

    # ---- one tick ---------------------------------------------------------

    def step(self, state: WorldState, cmd: Command, key: Array,
             force_fire: bool = False,
             noise=None) -> tuple[WorldState, WorldOutputs]:
        """One dt tick: motion always; scan + SLAM under the fired cond.

        ``force_fire`` statically removes the cond (the caller knows the
        scan fires this tick — rollout_cadence / update_period == 0).
        The cond is not free: XLA copies the large SLAM state through the
        untaken branch (~18 us per 42 MB of grids).
        ``noise`` optionally carries this tick's pre-drawn grid-SLAM
        randomness (gridslam.UpdateNoise, single-world only) so rollouts
        hoist the RNG chain out of the scan body — the identical draws.
        """
        from slamrs_tpu.core import motion

        batch = state.pose.shape[:-1]
        if noise is not None and batch:
            raise ValueError("pre-drawn noise is single-world only (the "
                             "batched paths draw per-world keys in-step)")
        dt = jnp.float32(self.dt)
        sl = jnp.broadcast_to(cmd.speed_left * dt, batch)
        sr = jnp.broadcast_to(cmd.speed_right * dt, batch)

        pose = motion.integrate_exact(state.pose, sl, sr,
                                      self.params.wheel_base)
        accum_l = state.accum_left + sl
        accum_r = state.accum_right + sr

        timer = state.scan_timer + dt
        fired = timer > self.params.update_period
        timer = jnp.where(fired, timer - self.params.update_period, timer)

        odo_args = (accum_l, accum_r,
                    jnp.broadcast_to(self.params.wheel_base, batch))

        def do_scan(operand):
            pose, accum_l, accum_r, grid, icp, ekf, key = operand
            from slamrs_tpu.core.types import OdometryReading

            odometry = OdometryReading(*odo_args)
            scan = sim_model.lidar_scan(pose, self.scene,
                                        self.params.scanner_range,
                                        self.num_beams)
            k_lm, k_grid = jax.random.split(key)
            outs = {}

            if self.grid_config is not None:
                gcfg = self.grid_config
                upd = lambda st, sc, od, k: gs_model.update(
                    st, sc, od, k, gcfg)
                if batch:
                    keys = jax.random.split(k_grid, batch[0])
                    if gcfg.integrate == "fused":
                        # update_fleet owns the batched fused policy:
                        # per-world updates, and — with a mesh —
                        # shard_map'd updates + the local-first sharded
                        # resample (parallel/{shard,resample}.py)
                        grid, gout = gs_model.update_fleet(
                            grid, scan, odometry, keys, gcfg,
                            mesh=self.mesh)
                    else:
                        grid, gout = jax.vmap(upd)(grid, scan, odometry,
                                                   keys)
                else:
                    grid, gout = gs_model.update(grid, scan, odometry,
                                                 k_grid, gcfg, noise=noise)
                outs["grid_pose"] = gout.pose
                outs["n_eff"] = gout.n_eff

            if self.icp_config is not None:
                upd = lambda st, sc: icp_model.update(st, sc, self.icp_config)
                if batch:
                    icp, iout = jax.vmap(upd)(icp, scan)
                else:
                    icp, iout = upd(icp, scan)
                outs["icp_pose"] = iout.pose

            if self.ekf_config is not None:
                landmarks = sim_model.landmark_scan(k_lm, pose, self.scene,
                                                    self.params)
                upd = lambda st, lm, od: ekf_model.update(
                    st, lm, od, self.ekf_config)
                if batch:
                    ekf, eout = jax.vmap(upd)(ekf, landmarks, odometry)
                else:
                    ekf, eout = upd(ekf, landmarks, odometry)
                outs["ekf_pose"] = eout.pose

            zero = jnp.zeros(batch, jnp.float32)
            return (jnp.zeros_like(accum_l), jnp.zeros_like(accum_r),
                    grid, icp, ekf,
                    outs.get("grid_pose", jnp.zeros((*batch, 3))),
                    outs.get("icp_pose", jnp.zeros((*batch, 3))),
                    outs.get("ekf_pose", jnp.zeros((*batch, 3))),
                    outs.get("n_eff", zero))

        def no_scan(operand):
            pose, accum_l, accum_r, grid, icp, ekf, key = operand
            batchz = jnp.zeros(batch, jnp.float32)
            prev_g = (grid.best_pose if grid is not None
                      else jnp.zeros((*batch, 3)))
            prev_i = icp.pose if icp is not None else jnp.zeros((*batch, 3))
            prev_e = (ekf.mean[..., 0:3] if ekf is not None
                      else jnp.zeros((*batch, 3)))
            return (accum_l, accum_r, grid, icp, ekf,
                    prev_g, prev_i, prev_e, batchz)

        operand = (pose, accum_l, accum_r, state.grid, state.icp, state.ekf,
                   key)
        if force_fire or float(self.params.update_period) == 0.0:
            fired = jnp.bool_(True)
            (accum_l, accum_r, grid, icp, ekf, grid_pose, icp_pose,
             ekf_pose, n_eff) = do_scan(operand)
        else:
            (accum_l, accum_r, grid, icp, ekf, grid_pose, icp_pose,
             ekf_pose, n_eff) = jax.lax.cond(fired, do_scan, no_scan,
                                             operand)

        new_state = WorldState(
            pose=pose,
            accum_left=accum_l,
            accum_right=accum_r,
            scan_timer=timer,
            scan_counter=state.scan_counter + fired.astype(jnp.int32),
            grid=grid,
            icp=icp,
            ekf=ekf,
        )
        outputs = WorldOutputs(
            fired=fired,
            pose=pose,
            grid_pose=grid_pose if self.grid_config else None,
            icp_pose=icp_pose if self.icp_config else None,
            ekf_pose=ekf_pose if self.ekf_config else None,
            n_eff=n_eff if self.grid_config else None,
        )
        return new_state, outputs

    # ---- rollout ----------------------------------------------------------

    def commands_for(self, n_steps: int) -> Command:
        """Materialize the Controls drive plan as per-tick command arrays.

        Each row is ``[until_t, left, right]``: the command active while
        sim time <= until_t.  Rows are sorted here so an out-of-order
        YAML script selects the earliest matching row, not the first
        listed one."""
        import numpy as np

        left = np.zeros(n_steps, np.float32)
        right = np.zeros(n_steps, np.float32)
        t = (np.arange(n_steps) + 1) * self.dt
        script = sorted(self.control_script, key=lambda row: float(row[0]))
        cur_l = cur_r = 0.0
        for i in range(n_steps):
            for until, l, r in script:
                if t[i] <= until:
                    cur_l, cur_r = float(l), float(r)
                    break
            left[i], right[i] = cur_l, cur_r
        return Command(jnp.asarray(left), jnp.asarray(right))

    def _grid_noise(self, keys: Array, state: WorldState):
        """Bulk pre-draw of per-tick grid-SLAM randomness (RNG hoist).

        One batched threefry over all ticks, outside the sequential scan
        body, replaces the ~4 chained splits/draws each step would put
        on its own critical path.  Bitwise identical to the in-step
        draws (gridslam.derive_noise mirrors update()'s exact chain).
        Single-world only — fleets draw per-world keys in-step.
        """
        if self.grid_config is None or state.pose.ndim != 1:
            return None

        p = self.grid_config.n_particles

        def one(key):
            # step() does `k_lm, k_grid = split(key)` and hands k_grid
            # to gridslam.update
            k_grid = jax.random.split(key)[1]
            return gs_model.derive_noise(k_grid, p)

        return jax.vmap(one)(keys)

    def rollout(self, state: WorldState, n_steps: int, seed: int = 0,
                commands: Optional[Command] = None
                ) -> tuple[WorldState, WorldOutputs]:
        """``lax.scan`` over ticks; outputs stacked along the time axis."""
        if commands is None:
            commands = self.commands_for(n_steps)
        keys = jax.random.split(jax.random.key(seed), n_steps)
        noises = self._grid_noise(keys, state)

        def body(carry, inp):
            cmd_l, cmd_r, key, noise = inp
            return self.step(carry, Command(cmd_l, cmd_r), key, noise=noise)

        return jax.lax.scan(body, state,
                            (commands.speed_left, commands.speed_right, keys,
                             noises))

    def rollout_cadence(self, state: WorldState, n_steps: int, seed: int = 0,
                        commands: Optional[Command] = None,
                        initial_timer: Optional[float] = None
                        ) -> tuple[WorldState, WorldOutputs]:
        """Cadence-structured rollout: identical semantics to
        :meth:`rollout`, restructured for throughput.

        ``step``'s per-tick ``lax.cond`` must route the (large) SLAM state
        through both branches, and XLA copies it on the skip path — at
        1,024 particle grids that is ~14 us per idle tick.  Here the
        deterministic scalar scan timer is unrolled on the host into
        frames of ``k`` idle ticks + 1 scan tick; idle ticks advance only
        the small sim state (pose/accumulators), so the SLAM state flows
        straight through the outer scan carry with no conditional at all.

        Outputs are per-frame (the scan ticks) rather than per-tick.
        """
        import numpy as np

        if commands is None:
            commands = self.commands_for(n_steps)
        dt = np.float32(self.dt)
        # concrete host values for the unroll (params are stored as jnp
        # scalars; they are concrete here — only `state` may be traced)
        period = np.float32(self.params.update_period)

        # host-side unroll of the accumulator timer (sim.rs:109-112) in
        # FLOAT32, bit-matching step()'s on-device f32 accumulation so
        # both resolve boundary ticks identically
        if initial_timer is not None:
            timer = np.float32(initial_timer)
        else:
            try:
                timer = np.float32(state.scan_timer)
            except Exception as e:
                raise ValueError(
                    "rollout_cadence under jit needs the concrete start "
                    "timer: pass initial_timer= (0.0 for a fresh state)"
                ) from e
        fired = np.zeros(n_steps, bool)
        for i in range(n_steps):
            timer = np.float32(timer + dt)
            if timer > period:
                fired[i] = True
                timer = np.float32(timer - period)
        fire_idx = np.flatnonzero(fired)
        if fire_idx.size == 0:
            return self.rollout(state, n_steps, seed, commands)
        n_frames = fire_idx.size
        starts = np.concatenate([[0], fire_idx[:-1] + 1])
        idle = fire_idx - starts  # idle ticks before each scan tick
        kmax = int(idle.max())

        # per-frame command slabs [n_frames, kmax + 1] (idle ticks padded
        # by repeating the scan tick's command under the mask)
        cl = np.asarray(commands.speed_left)
        cr = np.asarray(commands.speed_right)
        slab_l = np.zeros((n_frames, kmax + 1), np.float32)
        slab_r = np.zeros((n_frames, kmax + 1), np.float32)
        for f, (s, e) in enumerate(zip(starts, fire_idx)):
            k = e - s
            slab_l[f, :k] = cl[s:e]
            slab_r[f, :k] = cr[s:e]
            slab_l[f, kmax] = cl[e]
            slab_r[f, kmax] = cr[e]

        # key discipline matches rollout(): one key per TICK, of which
        # only the scan ticks consume theirs — so a fixed seed produces
        # identical SLAM randomness through either entry point
        keys = jax.random.split(jax.random.key(seed), n_steps)[fire_idx]
        noises = self._grid_noise(keys, state)
        wb = self.params.wheel_base
        dtf = jnp.float32(dt)

        def frame(carry, inp):
            st: WorldState = carry
            sl_slab, sr_slab, k_idle, key, noise = inp

            def idle_tick(i, small):
                pose, al, ar = small
                live = i < k_idle
                sl = jnp.where(live, sl_slab[i] * dtf, 0.0)
                sr = jnp.where(live, sr_slab[i] * dtf, 0.0)
                pose = motion_integrate(pose, sl, sr, wb)
                return pose, al + sl, ar + sr

            from slamrs_tpu.core import motion as motion_mod
            motion_integrate = motion_mod.integrate_exact
            small = jax.lax.fori_loop(
                0, kmax, idle_tick,
                (st.pose, st.accum_left, st.accum_right))
            # force step()'s timer to fire on this tick (the fire pattern
            # was already resolved on the host; the device timer is only
            # a mechanism here)
            st = st._replace(pose=small[0], accum_left=small[1],
                             accum_right=small[2],
                             scan_timer=jnp.float32(period))
            new_st, outs = self.step(
                st, Command(sl_slab[kmax], sr_slab[kmax]), key,
                force_fire=True, noise=noise)
            return new_st, outs

        final, outs = jax.lax.scan(
            frame, state,
            (jnp.asarray(slab_l), jnp.asarray(slab_r),
             jnp.asarray(idle, jnp.int32), keys, noises))

        # trailing idle ticks after the last scan tick
        tail = n_steps - (int(fire_idx[-1]) + 1)
        pose, al, ar = final.pose, final.accum_left, final.accum_right
        for i in range(int(fire_idx[-1]) + 1, n_steps):
            sl = jnp.float32(cl[i] * dt)
            sr = jnp.float32(cr[i] * dt)
            from slamrs_tpu.core import motion as motion_mod
            pose = motion_mod.integrate_exact(pose, sl, sr, wb)
            al, ar = al + sl, ar + sr
        del tail
        final = final._replace(pose=pose, accum_left=al, accum_right=ar,
                               scan_timer=jnp.float32(timer))
        return final, outs


def make_fused(scene: Optional[sim_model.Scene] = None,
               params: Optional[sim_model.SimParams] = None,
               grid_config: Optional[gs_model.GridSlamConfig] = None,
               icp_config: Optional[icp_model.IcpMapConfig] = None,
               ekf_config: Optional[ekf_model.EkfConfig] = None,
               control_script: Optional[list] = None,
               num_beams: int = 360,
               dt: float = sim_model.DEFAULT_DT,
               mesh: Any = None) -> "FusedWorld":
    """Programmatic FusedWorld builder (benchmarks / entry points)."""
    if scene is None:
        scene = sim_model.Scene.build(
            rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1),
                   (-0.6, 0.4, 0.2, 0.5)],
            lines=[(-0.6, -0.4, 0.2, 0.4)],
            landmarks=[(-1.0, -1.0), (1.0, 1.0), (-0.1, -0.4), (-0.6, 0.4),
                       (-0.6, -0.4), (0.6, 0.4), (0.6, -0.4)])
    if params is None:
        params = sim_model.SimParams.make()
    if (grid_config is not None and grid_config.integrate == "fused"
            and grid_config.beam_spacing is None):
        # the simulator ALWAYS emits uniform 1-degree tables
        # (models/simulator.py:155 deg2rad(arange)), regardless of
        # num_beams (fewer beams = a partial sector, not wider spacing):
        # give the fused cell pass the spacing statically so it runs the
        # leaner bin-units pipeline (ops/fused._cell_pass)
        grid_config = dataclasses.replace(
            grid_config, beam_spacing=pymath.radians(1.0))
    sim_cfg = SimulatorNodeConfig(topic_command="robot/command")
    return FusedWorld(
        sim_config=sim_cfg, scene=scene, params=params, dt=dt,
        grid_config=grid_config, icp_config=icp_config,
        ekf_config=ekf_config,
        control_script=control_script or [[1e9, 0.05, 0.08]],
        num_beams=num_beams, mesh=mesh)


def _scan_topic_aliases(config: Config, source_topic: Optional[str],
                        field: str) -> set[str]:
    """Topics carrying the scan/landmark stream: the source tuple topic plus
    any Splitter outputs derived from it."""
    aliases = set()
    if source_topic is None:
        return aliases
    aliases.add(source_topic)
    for _, node in config.nodes:
        if isinstance(node, SplitterNodeConfig):
            for s in node.splits:
                tag, fields = s if isinstance(s, tuple) else (s.get("_tag"), s)
                if fields.get("input") in aliases and fields.get(field):
                    aliases.add(fields[field])
    return aliases


def compile_world(config: Config) -> FusedWorld:
    """Resolve the node graph into a FusedWorld."""
    sim_cfg = None
    grid_cfg = icp_cfg = ekf_cfg = None
    script: list = []

    for _, node in config.nodes:
        if isinstance(node, SimulatorNodeConfig):
            sim_cfg = node
        elif isinstance(node, ControlsNodeConfig):
            script = node.script or []

    if sim_cfg is None:
        raise ValueError("fused compilation requires a !Simulator node")

    scan_aliases = _scan_topic_aliases(
        config, sim_cfg.topic_observation_scanner, "scanner")
    lm_aliases = _scan_topic_aliases(
        config, sim_cfg.topic_observation_landmarks, "landmark")

    for _, node in config.nodes:
        if isinstance(node, GridMapSlamNodeConfig):
            if node.topic_observation_odometry in scan_aliases:
                grid_cfg = node.slam_config()
        elif isinstance(node, IcpPointMapperNodeConfig):
            if node.topic_observation in scan_aliases:
                icp_cfg = node.mapper_config()
        elif isinstance(node, EKFLandmarkSlamNodeConfig):
            if node.topic_observation_landmark in lm_aliases:
                ekf_cfg = ekf_model.EkfConfig(**(node.config or {}))

    return FusedWorld(
        sim_config=sim_cfg,
        scene=sim_cfg.build_scene(),
        params=sim_model.SimParams.make(**sim_cfg.parameters),
        dt=sim_model.DEFAULT_DT,
        grid_config=grid_cfg,
        icp_config=icp_cfg,
        ekf_config=ekf_cfg,
        control_script=script,
    )
