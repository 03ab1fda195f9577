#!/usr/bin/env python3
"""Smoke run of the RBPF grid-SLAM main path on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded fleet only

Phases on one card, in order; each raises on failure:

  (a) parity: the fused update against fused_update_reference at the
      headline, 0.02 m and config-2 geometries in bf16 and f32; ICP
      nearest neighbours against a numpy brute-force argmin; a DDA
      (fidelity path) rollout against the CPU oracle of the reference
      (tests/parity_oracle.py);
  (b) the headline rollout (configs/grid_slam_fused.yaml, through
      compile_world and through make_fused): compile seconds, steady
      time per tick, memory_analysis(), finite N_eff, pose RMSE;
  (c) the same YAML through the host graph (App), which must publish
      poses;
  (d) 0.02 m cells, config 2 and config 3 (2 GB of maps), a few frames;
  (e) when the GPU runs the Triton kernel: its end-to-end time against
      the plain XLA version, one line per geometry.

The last line of standard output is one JSON object naming the device;
it is printed only when every phase passed.  Without a GPU the script
exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FUSED_YAML = REPO / "configs" / "grid_slam_fused.yaml"
B = 360
# grid_pose vs simulated pose over a rollout: a 1 m scanner in a 2x2 m
# room; the YAML drive script's turns measured 0.082 m on the CPU
RMSE_BOUND_M = 0.15
FLIP_FRAC = 1e-4     # bin flips allowed per window cell
LIK_ATOL = 1e-4      # per-particle log-likelihood
PHASE_LIMIT_S = 400  # a phase past this dumps its stacks and exits


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        sys.exit(f"chip_smoke.py needs {n} GPU(s), JAX found {devs}")
    return devs


def _grid_config(resolution=0.05, particles=1024, width=4.0, **over):
    from slamrs_tpu.models.gridslam import GridSlamConfig

    kw = dict(position_x=-width / 2, position_y=-width / 2, width=width,
              height=width, resolution=resolution, n_particles=particles,
              max_scan_range=1.0, resample_neff_frac=0.5,
              integrate="fused", grid_dtype="bfloat16")
    kw.update(over)
    return GridSlamConfig(**kw)


def _fw(cfg, mesh=None):
    from slamrs_tpu.graph.compile import make_fused
    from slamrs_tpu.models.simulator import SimParams

    return make_fused(params=SimParams.make(update_period=0.2),
                      grid_config=cfg, num_beams=B, mesh=mesh)


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    gib = lambda b: f"{b / 2**30:.3f}"
    return (f"args={gib(m.argument_size_in_bytes)} "
            f"out={gib(m.output_size_in_bytes)} "
            f"alias={gib(m.alias_size_in_bytes)} "
            f"temp={gib(m.temp_size_in_bytes)} GiB")


def compile_rollout(fw, n_ticks: int):
    """Trace, lower and compile a jitted rollout_cadence of ``n_ticks``
    ticks.  Returns (compiled, initial state, (trace+lower s, compile
    s)).  A persistent-cache hit shows in the compile seconds; tracing,
    lowering and the Triton kernel's own build are not cached."""
    import jax

    state = fw.init()
    cmds = fw.commands_for(n_ticks)  # concrete: the cadence unrolls on host

    def run(s):
        return fw.rollout_cadence(s, n_ticks, seed=0, commands=cmds,
                                  initial_timer=0.0)

    t0 = time.perf_counter()
    lowered = jax.jit(run).lower(state)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    return compiled, state, (t1 - t0, time.perf_counter() - t1)


def time_rollout(fw, n_ticks: int, reps: int = 3):
    """:func:`compile_rollout`, one warm-up run, then ``reps`` timed
    runs.  Returns (compiled, outputs, (trace+lower s, compile s),
    median us per tick)."""
    import jax

    compiled, state, compile_s = compile_rollout(fw, n_ticks)
    out = jax.block_until_ready(compiled(state))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(state))
        times.append(time.perf_counter() - t0)
    us = float(np.median(times)) / n_ticks * 1e6
    return compiled, out, compile_s, us


def _check_rollout(name, outs, bound=RMSE_BOUND_M) -> float:
    neff = np.asarray(outs.n_eff)
    assert np.isfinite(neff).all(), f"{name}: non-finite N_eff"
    err = np.asarray(outs.grid_pose - outs.pose)[..., :2]
    rmse = float(np.sqrt((err ** 2).sum(-1).mean()))
    assert rmse < bound, f"{name}: grid_pose RMSE {rmse:.4f} m >= {bound}"
    return rmse


# ---- (a) parity ---------------------------------------------------------

def window_cells(spec, max_range_m: float, p: int) -> int:
    """Cells an update covers: P disc-box windows."""
    from slamrs_tpu.ops.fused import crop_window

    wr, wc = crop_window(spec, max_range_m)
    return p * wr * wc


def grid_mismatch(a, b, rel: float = 1e-6) -> tuple[int, int]:
    """(flips, cells that differ at all) between two grid sets, compared
    at f32.  A flip differs by more than f32 rounding: more than ``rel``
    times the larger magnitude, floored at 1.  Increments are O(1)
    log-odds times a density >= 1, so a flipped bin or ISM band moves a
    cell by >= 0.8, while the few-ulp noise of two separately compiled
    graphs stays far below."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    neq = a != b
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    far = neq & (np.abs(a - b) > rel * scale)
    return int(far.sum()), int(neq.sum())


def _random_case(spec, p, dtype, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    g = rng.normal(size=(p, spec.rows, spec.cols)).astype(np.float32) * 0.5
    g[:, ::3, ::2] = 0.0
    lo = np.array([spec.position_x, spec.position_y])
    hi = lo + np.array([spec.width, spec.height])
    xy = rng.uniform(lo + 0.1, hi - 0.1, (p, 2))
    th = rng.uniform(-3.0, 3.0, (p, 1))
    q = np.concatenate([xy, th], -1).astype(np.float32)
    d = rng.uniform(0.05, 1.0, B).astype(np.float32)
    return (jnp.asarray(g).astype(dtype), jnp.asarray(q), jnp.float32(0.1),
            jnp.asarray(d), jnp.asarray(rng.random(B) < 0.85),
            jnp.asarray(rng.random(B) < 0.97))


PARITY_GEOMETRIES = (("headline", 0.05, 4.0, 1024),
                     ("0.02m", 0.02, 4.0, 1024),
                     ("config2", 0.05, 20.0, 100))


def phase_parity() -> None:
    import jax
    import jax.numpy as jnp

    from slamrs_tpu.ops import fused
    from slamrs_tpu.ops.grid import GridSpec2D

    dphi = float(np.radians(1.0))
    for name, res, width, p in PARITY_GEOMETRIES:
        spec = GridSpec2D(-width / 2, -width / 2, width, width, res)
        for dtype in (jnp.bfloat16, jnp.float32):
            args = _random_case(spec, p, dtype)
            gpu = jax.jit(lambda *a: fused.fused_update(
                *a, spec, B, 1.0, dphi=dphi))
            ref = jax.jit(lambda *a: fused.fused_update_reference(
                *a, spec, B, 1.0, dphi=dphi))
            g1, l1 = gpu(*args)
            g2, l2 = ref(*args)
            flips, n_diff = grid_mismatch(g1, g2)
            cells = window_cells(spec, 1.0, p)
            lik = float(jnp.abs(l1 - l2).max())
            log(f"parity {name} {jnp.dtype(dtype).name} "
                f"[{fused.update_impl(jax.default_backend())} vs reference]:"
                f" flips {flips}"
                f" / {cells} window cells (bound {FLIP_FRAC:g}), cells "
                f"differing at all {n_diff}, max |dlik| {lik:.2e} "
                f"(bound {LIK_ATOL:g})")
            assert flips <= FLIP_FRAC * cells, (name, flips)
            assert lik <= LIK_ATOL, (name, lik)
    _parity_icp()
    _parity_dda()


def _parity_icp() -> None:
    import jax
    import jax.numpy as jnp

    from slamrs_tpu.ops.icp import nearest_neighbors

    rng = np.random.default_rng(1)
    p = rng.normal(size=(64, 360, 2)).astype(np.float32)
    q = rng.normal(size=(64, 360, 2)).astype(np.float32)
    got = np.asarray(jax.jit(nearest_neighbors)(
        jnp.asarray(p), jnp.asarray(q), jnp.int32(360)))
    d2 = ((p[:, :, None, :].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    want = d2.argmin(-1)
    differ = got != want
    # a differing index is a tie only if its distance equals the minimum
    # to f32 precision
    gap = (np.take_along_axis(d2, got[..., None], -1)[..., 0]
           - d2.min(-1))
    wrong = int((differ & (gap > 1e-6 * (1.0 + d2.min(-1)))).sum())
    log(f"parity icp nearest_neighbors vs numpy argmin: "
        f"{int(differ.sum())} of {want.size} correspondences differ, "
        f"{wrong} by more than an f32 tie")
    assert wrong == 0


def _parity_dda() -> None:
    """Six DDA updates (the tests/test_parity.py sim trace) on the card
    against tests/parity_oracle.py, the line-by-line CPU port of the
    reference, fed the same random draws; test_parity.py's bounds."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(REPO / "tests"))
    import parity_oracle as oracle

    from slamrs_tpu.core import motion
    from slamrs_tpu.core.types import OdometryReading
    from slamrs_tpu.models import gridslam as gs
    from slamrs_tpu.models import simulator as sim_model

    cfg = gs.GridSlamConfig(position_x=-2.0, position_y=-2.0, width=4.0,
                            height=4.0, resolution=0.05, n_particles=8,
                            max_scan_range=1.0, integrate="dda",
                            resample_neff_frac=1.0)
    p = cfg.n_particles
    scene = sim_model.Scene.build(
        rects=[(-1.0, -1.0, 2.0, 2.0), (-0.1, -0.4, 0.5, 0.1)],
        lines=[(-0.6, -0.4, 0.2, 0.4)])
    upd = jax.jit(lambda s_, sc, od, k: gs.update(s_, sc, od, k, cfg))
    state = gs.GridSlamState.init(cfg)
    orc = oracle.GridMapSlam(cfg.position_x, cfg.position_y, cfg.width,
                             cfg.height, cfg.resolution, p)
    pose = jnp.zeros(3)
    key = jax.random.key(0)
    best_g, best_o, lineage = [], [], 0.0
    for t in range(6):
        sl, sr = 0.004 + 0.001 * t, 0.006
        pose = motion.integrate_exact(pose, jnp.float32(sl),
                                      jnp.float32(sr), 0.1)
        scan = sim_model.lidar_scan(pose, scene, 1.0, 360)
        odo = OdometryReading(jnp.float32(sl), jnp.float32(sr),
                              jnp.float32(0.1))
        key, k_step = jax.random.split(key)
        k_motion, k_resample = jax.random.split(k_step)
        sampled = motion.sample(k_motion, state.poses, odo.distance_left,
                                odo.distance_right, odo.wheel_base)
        r = float(jax.random.uniform(k_resample, (1,), jnp.float32)[0]) / p
        state, out = upd(state, scan, odo, k_step)
        orc.update({"angles": np.asarray(scan.angles, np.float64),
                    "distances": np.asarray(scan.distances, np.float64),
                    "valid": np.asarray(scan.valid),
                    "present": np.asarray(scan.present)},
                   sl, sr, 0.1, np.asarray(sampled, np.float64), r)
        best_g.append(np.asarray(out.pose, np.float64))
        best_o.append(orc.best_pose)
        lineage = max(lineage, float(np.abs(
            np.asarray(state.poses, np.float64)
            - np.stack(orc.poses)).max()))
    best_g, best_o = np.stack(best_g), np.stack(best_o)
    rmse = float(np.sqrt(((best_g[:, :2] - best_o[:, :2]) ** 2).mean()))
    grids_g = np.asarray(state.grids, np.float64)
    grids_o = np.stack([m.odds for m in orc.maps])
    agree = float((np.abs(grids_g - grids_o) <= 5e-3).mean())
    touched = np.abs(grids_o) > 1e-6
    cls = float((np.sign(grids_g[touched])
                 == np.sign(grids_o[touched])).mean())
    log(f"parity dda rollout on the card vs the CPU oracle: pose RMSE "
        f"{rmse:.2e} m (bound 1e-3), lineage max |d| {lineage:.2e} "
        f"(bound 1e-5), cell agreement {agree:.5f}, classification "
        f"{cls:.5f} (bounds 0.999)")
    assert rmse <= 1e-3 and lineage <= 1e-5
    assert agree >= 0.999 and cls >= 0.999


# ---- (b) the headline rollout --------------------------------------------

def phase_headline() -> None:
    from slamrs_tpu.graph.compile import compile_world
    from slamrs_tpu.graph.config import load_config

    yaml_fw = compile_world(load_config(FUSED_YAML))
    cfg = yaml_fw.grid_config
    assert (cfg.integrate, cfg.n_particles, cfg.resolution, cfg.grid_dtype,
            cfg.resample_neff_frac) == ("fused", 1024, 0.05, "bfloat16",
                                        0.5), cfg
    for name, fw in (("compile_world(grid_slam_fused.yaml)", yaml_fw),
                     ("make_fused(headline)", _fw(_grid_config()))):
        n = 600
        compiled, (_, outs), compile_s, us = time_rollout(fw, n)
        rmse = _check_rollout(name, outs)
        log(f"headline {name}: {n} ticks, {outs.n_eff.shape[0]} scan "
            f"frames, trace+lower {compile_s[0]:.2f} s, compile "
            f"{compile_s[1]:.2f} s, steady "
            f"{us / 1e3:.4f} ms/tick, grid_pose RMSE {rmse:.4f} m, "
            f"min N_eff {float(outs.n_eff.min()):.1f}, memory "
            f"{_mem(compiled)}")


# ---- (c) the host graph --------------------------------------------------

def phase_app() -> None:
    from slamrs_tpu.graph.app import App
    from slamrs_tpu.graph.nodes.sim import SimulatorNode
    from slamrs_tpu.graph.nodes.slam import GridMapSlamNode
    from slamrs_tpu.graph.nodes.viz import VisualizerNode

    app = App.from_file(str(FUSED_YAML))
    t0 = time.perf_counter()
    app.run(duration_s=3.0)
    wall = time.perf_counter() - t0
    slam = app.node(GridMapSlamNode)
    pose = app.node(VisualizerNode).latest("robot/pose")
    true = app.node(SimulatorNode).get_pose()
    app.terminate()
    assert slam._updates >= 10 and pose is not None, slam._updates
    err = float(np.linalg.norm(np.asarray(true[:2]) - pose.pose[:2]))
    log(f"app grid_slam_fused.yaml: 3.0 s simulated in {wall:.2f} s wall, "
        f"{slam._updates} GridMapSlam updates published poses, last pose "
        f"error {err:.4f} m")
    assert np.isfinite(pose.pose).all() and err < 0.3


# ---- (d) larger states ---------------------------------------------------

def phase_sizes() -> None:
    """Each state completes a few scan frames.  No time is reported: a
    35-tick window run once is not a steady state (bench.py times these
    states over hundreds of ticks)."""
    import jax

    for name, cfg in (
            ("0.02m 1024p 4x4m", _grid_config(resolution=0.02)),
            ("config2 100p 20x20m", _grid_config(particles=100,
                                                 width=20.0)),
            ("config3 1024p 50x50m", _grid_config(width=50.0))):
        n = 35  # five scan frames at the 0.2 s cadence
        compiled, state, compile_s = compile_rollout(_fw(cfg), n)
        final, outs = jax.block_until_ready(compiled(state))
        rmse = _check_rollout(name, outs)
        gb = final.grid.grids.size * final.grid.grids.dtype.itemsize / 1e9
        log(f"size {name}: maps {gb:.3f} GB, {outs.n_eff.shape[0]} frames "
            f"completed, trace+lower {compile_s[0]:.2f} s, compile "
            f"{compile_s[1]:.2f} s, grid_pose RMSE {rmse:.4f} m, memory "
            f"{_mem(compiled)}")


# ---- (e) the kernel against the plain version ------------------------------

def _update_loop_us(update, spec, p: int, n: int = 200) -> float:
    """µs per fused update alone: ``n`` updates of one map set in one
    jitted loop (no per-call dispatch), likelihoods kept live."""
    import jax
    import jax.numpy as jnp

    g0, *rest = _random_case(spec, p, jnp.bfloat16)
    dphi = float(np.radians(1.0))

    def run(g):
        def body(_, carry):
            g_, acc = carry
            g_, lik = update(g_, *rest, spec, B, 1.0, dphi=dphi)
            return g_, acc + jnp.sum(lik)
        return jax.lax.fori_loop(0, n, body, (g, jnp.float32(0.0)))

    f = jax.jit(run)
    jax.block_until_ready(f(g0))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(f(g0))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / n * 1e6


def phase_kernel_timing() -> None:
    """The kept kernel against the plain version: the update alone, and
    the whole rollout with gridslam's ``fused_update`` patched to one
    formulation for the measurement (order xla, triton, triton, xla)."""
    from unittest import mock

    from slamrs_tpu.ops import fused
    from slamrs_tpu.ops.grid import GridSpec2D

    if fused.update_impl("gpu") != "triton":
        return
    for name, res, n in (("headline", 0.05, 600), ("0.02m", 0.02, 300)):
        fw = _fw(_grid_config(resolution=res))
        us = {"xla": [], "triton": []}
        alone = {}
        for impl in ("xla", "triton", "triton", "xla"):
            update = getattr(fused, f"fused_update_{impl}")
            with mock.patch.object(fused, "fused_update", update):
                _, _, _, t = time_rollout(fw, n, reps=5)
            if impl not in alone:
                alone[impl] = _update_loop_us(
                    update, GridSpec2D(-2.0, -2.0, 4.0, 4.0, res), 1024)
            us[impl].append(t)
        tri, xla = np.mean(us["triton"]), np.mean(us["xla"])
        log(f"kernel-vs-plain {name}: update alone (200 in one jit, bf16, "
            f"1024 particles) triton {alone['triton']:.2f} us, xla "
            f"{alone['xla']:.2f} us; rollout end to end (order xla, "
            f"triton, triton, xla) triton {tri:.2f} us/tick "
            f"{[round(x, 2) for x in us['triton']]}, xla {xla:.2f} us/tick "
            f"{[round(x, 2) for x in us['xla']]}, triton/xla "
            f"{tri / xla:.3f}")


# ---- four cards -------------------------------------------------------------

def phase_four() -> None:
    """The fused fleet on a (world=2, particle=2) mesh over four cards —
    local-first and gather resampling — and one world-only (4, 1) step,
    each against the unsharded fleet on one card."""
    import jax

    from slamrs_tpu.parallel.fleet import (fleet_shardings, make_mesh,
                                           shard_world_state)

    worlds = 8
    n = 8  # one scan tick at the 0.2 s cadence
    base = _grid_config(particles=64, resample_neff_frac=1.0)

    def run(cfg, mesh):
        fw = _fw(cfg, mesh=mesh)
        state = fw.init((worlds,))
        if mesh is None:
            f = jax.jit(lambda s: fw.rollout(s, n, seed=5))
            return f(jax.device_put(state, jax.devices()[0]))
        state = shard_world_state(state, mesh, worlds)
        sh = fleet_shardings(state, mesh, worlds)

        def body(s):
            final, outs = fw.rollout(s, n, seed=5)
            return jax.lax.with_sharding_constraint(final, sh), outs
        return jax.jit(body)(state)

    def compare(label, mode, mesh):
        import dataclasses

        cfg = dataclasses.replace(base, fleet_resample=mode)
        log(f"four {label} {mode}: unsharded fleet on one card")
        ref_final, ref_outs = jax.block_until_ready(run(cfg, None))
        log(f"four {label} {mode}: sharded fleet")
        t0 = time.perf_counter()
        final, outs = jax.block_until_ready(run(cfg, mesh))
        wall = time.perf_counter() - t0
        assert bool(np.asarray(outs.fired).any())
        n_devs = len(final.grid.grids.sharding.device_set)
        neff_d = float(np.abs(np.asarray(outs.n_eff)
                              - np.asarray(ref_outs.n_eff)).max())
        pose_d = 0.0
        for w in range(worlds):
            a = np.asarray(final.grid.poses[w])
            b = np.asarray(ref_final.grid.poses[w])
            a = a[np.lexsort(a.T[::-1])]
            b = b[np.lexsort(b.T[::-1])]
            pose_d = max(pose_d, float(np.abs(a - b).max()))
        log(f"four {label} fleet_resample={mode}: {worlds} worlds x "
            f"{base.n_particles} particles on {n_devs} devices, run "
            f"{wall:.2f} s (compile included); vs the unsharded fleet on "
            f"one card: max |dN_eff| {neff_d:.2e}, particle pose multiset "
            f"max |d| {pose_d:.2e}")
        assert n_devs == 4
        assert neff_d <= 1e-3 * base.n_particles and pose_d <= 1e-4

    mesh = make_mesh(4, particle_axis=2)
    compare("(world=2, particle=2)", "local", mesh)
    compare("(world=2, particle=2)", "gather", mesh)
    compare("(world=4, particle=1)", "local", make_mesh(4, particle_axis=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded fleet phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1
    devs = require_gpus(n_cards)

    sys.path.insert(0, str(REPO))
    from slamrs_tpu.utils import compile_cache

    log(f"card: {card_line()}")
    log(f"jax devices: {devs}")
    log(f"compile cache: {compile_cache.enable()}")
    phases = ([phase_four] if args.four else
              [phase_parity, phase_headline, phase_app, phase_sizes,
               phase_kernel_timing])
    for phase in phases:
        t0 = time.perf_counter()
        # a hung phase (a collective that never completes) must not hold
        # the card: dump every thread's stack and exit non-zero
        faulthandler.dump_traceback_later(PHASE_LIMIT_S, exit=True)
        phase()
        faulthandler.cancel_dump_traceback_later()
        log(f"{phase.__name__} ok in {time.perf_counter() - t0:.1f} s")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
