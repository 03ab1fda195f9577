"""Benchmarks: sim+SLAM throughput on one GPU, across the BASELINE matrix.

Prints ONE JSON line (the headline metric) to stdout; the device (JAX's
name for it, and the card's name and power limit from nvidia-smi) and
the full config matrix go to stderr.  A leg that fails fails the run.
Refuses to run without a GPU: a CPU number is not a device number.

Headline: full sim+RBPF-SLAM pipeline ticks/s at the reference's own
operating point — 30 Hz ticks with the lidar firing every
``update_period = 0.2 s`` (the simulator default, sim.rs:56), 360 beams,
1,024 particles, 4x4 m world at the 0.05 m cell size of BASELINE configs
2-3, N_eff-gated systematic resampling.  Every tick runs the diff-drive
integrator, accumulators and timers; each scan tick additionally runs
the full RBPF update (motion sampling, fused likelihood+integrate,
resampling policy) for all 1,024 particles.  The matrix also reports the
harder every-tick-scan variant and the other BASELINE configs.

Timing is the marginal cost between two scan lengths, so per-call
dispatch and transfer overhead cancel in the difference.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp


def ticks_per_frame(update_period: float, n: int = 1050) -> float:
    """Average ticks per scan frame at a cadence: replicates
    rollout_cadence's f32 accumulator unroll (the true value is NOT
    period/dt — f32 rounding + remainder carry make 0.2 s ~6.7, not 6)."""
    if update_period <= 0:
        return 1.0
    import numpy as np

    timer, fired = np.float32(0.0), 0
    for _ in range(n):
        timer = np.float32(timer + np.float32(1.0 / 30.0))
        if timer > np.float32(update_period):
            fired += 1
            timer = np.float32(timer - np.float32(update_period))
    return n / max(fired, 1)


def _marginal(make_run, state, n1, n2, reps=3):
    """Marginal seconds/step between two jitted scan lengths.

    MEDIAN of the per-rep differences, not min: a single anomalously
    slow short run makes (tb - ta) too small, and min-of-reps AMPLIFIES
    that into a too-fast reading; the median is robust to one outlier
    on either side.  Each run ends by fetching a value derived from the
    whole computation, so it cannot return before the device is done."""
    r1, r2 = make_run(n1), make_run(n2)
    float(r1(state, jax.random.key(1)))
    float(r2(state, jax.random.key(1)))
    diffs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(r1(state, jax.random.key(2)))
        ta = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(r2(state, jax.random.key(2)))
        tb = time.perf_counter() - t0
        diffs.append((tb - ta) / (n2 - n1))
    diffs.sort()
    return max(diffs[len(diffs) // 2], 1e-9)


def bench_grid_slam(particles=1024, width=4.0, resolution=0.05,
                    num_beams=360, update_period=0.2, neff=0.5,
                    integrate="fused", grid_dtype="bfloat16",
                    n1=50, n2=2050, reps=3):
    from slamrs_tpu.core.types import Command
    from slamrs_tpu.graph.compile import make_fused
    from slamrs_tpu.models.gridslam import GridSlamConfig
    from slamrs_tpu.models.simulator import SimParams

    grid_cfg = GridSlamConfig(
        position_x=-width / 2, position_y=-width / 2, width=width,
        height=width, resolution=resolution, n_particles=particles,
        max_scan_range=1.0, resample_neff_frac=neff, integrate=integrate,
        grid_dtype=grid_dtype)
    fw = make_fused(params=SimParams.make(update_period=update_period),
                    grid_config=grid_cfg, num_beams=num_beams)
    state = fw.init()

    def make_run(n):
        cmds = Command(jnp.full((n,), 0.05, jnp.float32),
                       jnp.full((n,), 0.08, jnp.float32))

        @jax.jit
        def run(state, key):
            if update_period > 0:
                c, outs = fw.rollout_cadence(state, n, seed=0, commands=cmds,
                                             initial_timer=0.0)
            else:
                c, outs = fw.rollout(state, n, seed=0, commands=cmds)
            return (jnp.sum(outs.n_eff) + jnp.float32(c.grid.grids[0, 0, 0])
                    + c.pose[0])
        return run

    dt = _marginal(make_run, state, n1, n2, reps=reps)
    return 1.0 / dt


def bench_icp(batch=2048, beams=360, iterations=10, n1=5, n2=55):
    """ICP iterations/sec per chip (BASELINE config 1 half-metric):
    batched point-to-normal scan matching, 10 iterations per solve."""
    import numpy as np

    from slamrs_tpu.ops.icp import icp_point_to_normal

    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, beams, endpoint=False)
    q = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    q = q * rng.uniform(0.5, 1.0, (beams, 1)).astype(np.float32)
    qb = jnp.asarray(np.tile(q[None], (batch, 1, 1)))
    # p = q rotated/translated a little, per problem
    dx = rng.uniform(-0.05, 0.05, (batch, 1, 2)).astype(np.float32)
    pb = jnp.asarray(q[None] + dx)
    mask = jnp.ones((batch, beams), bool)
    count = jnp.full((batch,), beams, jnp.int32)
    x0 = jnp.zeros((batch, 3), jnp.float32)

    def make_run(n):
        @jax.jit
        def run(_, key):
            def body(c, k):
                res = jax.vmap(lambda p, m, q, qc, x: icp_point_to_normal(
                    p, m, q, qc, x, iterations=iterations))(
                        pb + c * 1e-6, mask, qb, count, x0)
                return c + 1e-7, jnp.sum(res.transformation)
            c, outs = jax.lax.scan(body, jnp.float32(key[0] if False else 0.0),
                                   jax.random.split(key, n))
            return jnp.sum(outs) + c
        return run

    dt = _marginal(make_run, jnp.float32(0.0), n1, n2)
    return batch * iterations / dt


def bench_fleet(worlds=256, particles=10, width=4.0, resolution=0.02,
                update_period=0.2, integrate="fused", n1=20, n2=220):
    """BASELINE config 5: vmapped raycast+SLAM rollouts over 256 worlds
    (the fused update batches over worlds x particles)."""
    from slamrs_tpu.core.types import Command
    from slamrs_tpu.graph.compile import make_fused
    from slamrs_tpu.models.gridslam import GridSlamConfig
    from slamrs_tpu.models.simulator import SimParams

    grid_cfg = GridSlamConfig(
        position_x=-width / 2, position_y=-width / 2, width=width,
        height=width, resolution=resolution, n_particles=particles,
        max_scan_range=1.0, resample_neff_frac=0.5, integrate=integrate)
    fw = make_fused(params=SimParams.make(update_period=update_period),
                    grid_config=grid_cfg)
    state = fw.init((worlds,))

    def make_run(n):
        @jax.jit
        def run(state, key):
            def body(c, k):
                s, outs = fw.step(
                    c, Command(jnp.float32(0.05), jnp.float32(0.08)), k)
                return s, jnp.sum(outs.n_eff)
            keys = jax.random.split(key, n)
            c, neffs = jax.lax.scan(body, state, keys)
            return (jnp.sum(neffs) + jnp.float32(c.grid.grids[0, 0, 0, 0])
                    + c.pose[0, 0])
        return run

    dt = _marginal(make_run, state, n1, n2)
    return worlds / dt  # world-ticks per second


def device_line() -> str:
    """The device as JAX reports it, plus the card's name and power
    limit as nvidia-smi gives them."""
    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return (f"device: {d.platform} {d.device_kind} x{len(jax.devices())}"
            f" | nvidia-smi: {smi}")


def main() -> None:
    from slamrs_tpu.utils import compile_cache

    headline_only = "--headline-only" in sys.argv
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU, found {jax.devices()}")
    print(f"compile cache: {compile_cache.enable()}", file=sys.stderr)
    print(device_line(), file=sys.stderr, flush=True)

    def note(name, value, unit):
        print(f"  {name}: {value:,.1f} {unit}", file=sys.stderr, flush=True)

    # ---- headline (bf16 log-odds grids: identical map quality to f32
    # vs the DDA oracle — see tests/test_path_deviation.py) -------------
    headline = bench_grid_slam(reps=5)
    note("grid_slam_ticks_per_s_ref_cadence_1024p_0.05m", headline,
         "ticks/s")

    if not headline_only:
        # strict reference semantics: resample EVERY update (slam.rs:74
        # has no N_eff gate) — next to the gated headline
        note("grid_slam_ticks_per_s_ref_cadence_1024p_0.05m_always_resample",
             bench_grid_slam(neff=1.0), "ticks/s")
        note("grid_slam_ticks_per_s_ref_cadence_1024p_0.05m_f32",
             bench_grid_slam(grid_dtype="float32"), "ticks/s")
        note("grid_slam_steps_per_s_scan_every_tick_1024p_0.05m",
             bench_grid_slam(update_period=0.0, n2=1050, reps=5), "steps/s")
        note("grid_slam_ticks_per_s_ref_cadence_1024p_0.02m_bf16",
             bench_grid_slam(resolution=0.02, n2=1050, reps=5), "ticks/s")
        note("grid_slam_ticks_per_s_config2_100p_20m_0.05m",
             bench_grid_slam(particles=100, width=20.0, n2=1050),
             "ticks/s")
        note("grid_slam_ticks_per_s_config3_1024p_50m_0.05m_2GB",
             bench_grid_slam(width=50.0, n1=10, n2=110), "ticks/s")
        # the exact reference-parity scatter path (fidelity gates run on
        # this formulation; see tests/test_parity.py)
        note("grid_slam_ticks_per_s_dda_parity_path_1024p_0.05m",
             bench_grid_slam(integrate="dda", n1=5, n2=35), "ticks/s")
        note("icp_iterations_per_s_batch2048", bench_icp(), "iters/s")
        note("fleet_world_ticks_per_s_256worlds_10p_0.02m", bench_fleet(),
             "world-ticks/s")

    d = jax.devices()[0]
    print(json.dumps({
        "metric": "sim+SLAM pipeline ticks/sec (360-beam lidar, 1024 "
                  "particles, RBPF grid SLAM, reference scan cadence "
                  "update_period=0.2s, 4x4m @ 0.05m, one GPU)",
        "value": headline,
        "unit": "ticks/s",
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
