"""CLI entrypoint: ``python -m slamrs_tpu <command>``.

Parity surface: baseui/src/main.rs (the binary takes one optional config
path, main.rs:28-33) — extended with headless subcommands:

    run      <config.yaml> [--duration S] [--png out.png] [--npz out.npz]
    rollout  <config.yaml> [--steps N] [--worlds W] — fused jitted rollout
    replay   <file.bin>    — parse a recorded Neato log, print stats
    bench    — run the benchmark (same as python bench.py)
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_run(args):
    from slamrs_tpu.graph.app import App
    from slamrs_tpu.graph.nodes.viz import VisualizerNode

    app = App.from_file(args.config, realtime=args.realtime,
                        with_renderer=bool(args.png))
    teleop = None
    if getattr(args, "teleop", False):
        from slamrs_tpu.graph.nodes.util import ControlsNode
        from slamrs_tpu.io.teleop import StdinTeleop

        controls = app.node(ControlsNode)
        if controls is None:
            print("--teleop: config has no !Controls node", file=sys.stderr)
        else:
            teleop = StdinTeleop(controls.set_command,
                                 target_speed=controls.config.max_speed)
            print("teleop: WASD/arrows drive, space stops, Q quits",
                  file=sys.stderr)
    try:
        app.run(duration_s=args.duration)
    finally:
        # always restore the terminal (cbreak mode) even when run()
        # raises — a crash must not leave the user's shell without echo
        if teleop is not None:
            teleop.stop()
    print(f"ran {args.duration}s of sim time; frame {app.frame_stats}")
    viz = app.node(VisualizerNode)
    if args.png and app.renderer is not None:
        # rasterize the composed frame: every node's draw hook (scene +
        # ground-truth pose from the simulator, debug shapes) plus the
        # Visualizer topics, exactly what the reference's GL window shows
        from slamrs_tpu.viz.shapes import render_draw_calls

        calls = app.renderer.flush()
        render_draw_calls(calls, args.png)
        print("wrote", args.png)
    if viz is not None and args.npz:
        viz.save_npz(args.npz)
        print("wrote", args.npz)
    app.terminate()


def cmd_rollout(args):
    import jax
    import numpy as np

    from slamrs_tpu.graph.compile import compile_world
    from slamrs_tpu.graph.config import load_config

    fw = compile_world(load_config(args.config))
    shape = (args.worlds,) if args.worlds > 1 else ()
    state = fw.init(shape)
    if args.resume:
        from slamrs_tpu.utils.checkpoint import load as load_state
        state = load_state(args.resume, state)
        print(f"resumed from {args.resume}", file=sys.stderr)
    state, outs = jax.jit(lambda s: fw.rollout(s, args.steps,
                                               seed=args.seed))(state)
    if args.save_state:
        from slamrs_tpu.utils.checkpoint import save as save_state
        save_state(args.save_state, state)
        print(f"saved state to {args.save_state}", file=sys.stderr)
    fired = np.asarray(outs.fired)
    report = {
        "steps": args.steps,
        "worlds": max(args.worlds, 1),
        "scans": int(fired.sum()),
        "final_pose": np.asarray(outs.pose)[-1].tolist(),
    }
    for name in ("grid_pose", "icp_pose", "ekf_pose"):
        est = getattr(outs, name)
        if est is not None:
            err = np.asarray(est)[fired] - np.asarray(outs.pose)[fired]
            report[f"{name}_rmse_xy"] = float(
                np.sqrt((err[..., :2] ** 2).mean()))
    print(json.dumps(report))


def cmd_robot(args):
    """Serve a virtual robot (firmware-behavior model) over TCP so any
    host config with a !RobotConnection node can drive it like hardware.

    Note: the first lidar revolution jit-compiles the scene raycast
    (seconds on a cold compile cache); frames stream at the firmware
    cadence once warm."""
    import socket

    from slamrs_tpu.io.virtual_robot import VirtualRobot, VirtualRobotServer
    from slamrs_tpu.models import simulator as sim_model

    scene = sim_model.Scene.build(
        rects=[(-2.0, -2.0, 4.0, 4.0), (-0.1, -0.4, 0.5, 0.1)],
        lines=[(-0.6, -0.4, 0.2, 0.4)])
    if args.cdc:
        # USB-CDC bridge (tasks/usb.rs): serve over a pty; the host
        # opens the printed path as `serial:` in a !RobotConnection
        from slamrs_tpu.io.virtual_robot import UsbCdcServer

        server = UsbCdcServer(VirtualRobot(scene=scene, scanner_range=5.0),
                              realtime=True)
        print(f"virtual robot (USB-CDC) at {server.path}", file=sys.stderr)
        try:
            server._thread.join()
        except KeyboardInterrupt:
            pass
        finally:
            server.close()
        return
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(1)
    print(f"virtual robot listening on {args.host}:{args.port}",
          file=sys.stderr)
    try:
        while True:
            conn, addr = srv.accept()
            print(f"host connected: {addr}", file=sys.stderr)
            from slamrs_tpu.io.connection import ConnectionMedium

            class _M(ConnectionMedium):
                def __init__(self, sock):
                    self.sock = sock
                    sock.settimeout(0.05)

                def read(self, n):
                    try:
                        data = self.sock.recv(n)
                    except socket.timeout:
                        return b""
                    return data if data else None  # b'' == EOF

                def write(self, data):
                    # frames must not be cut mid-message when the host
                    # reader lags: allow a longer send window than the
                    # 50 ms recv poll
                    self.sock.settimeout(5.0)
                    try:
                        self.sock.sendall(data)
                    finally:
                        self.sock.settimeout(0.05)

                def close(self):
                    self.sock.close()

            server = VirtualRobotServer(
                VirtualRobot(scene=scene, scanner_range=5.0), _M(conn),
                realtime=True)
            try:
                server._thread.join()
            finally:
                server.close()
            print("host disconnected", file=sys.stderr)
    except KeyboardInterrupt:
        pass


def cmd_replay(args):
    import numpy as np

    from slamrs_tpu.io.neato import load_neato_binary

    frames = load_neato_binary(args.file)
    valid = np.array([(f.valid != 0).sum() for f in frames])
    print(json.dumps({
        "frames": len(frames),
        "valid_beams_median": int(np.median(valid)) if len(frames) else 0,
    }))


def cmd_bench(args):
    del args
    import bench

    bench.main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="slamrs_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a node-graph config headlessly")
    r.add_argument("config")
    r.add_argument("--duration", type=float, default=10.0)
    r.add_argument("--realtime", action="store_true")
    r.add_argument("--teleop", action="store_true",
                   help="drive the !Controls node from the keyboard "
                        "(WASD/arrows; implies an interactive terminal)")
    r.add_argument("--png")
    r.add_argument("--npz")
    r.set_defaults(fn=cmd_run)

    ro = sub.add_parser("rollout", help="fused jitted rollout")
    ro.add_argument("config")
    ro.add_argument("--steps", type=int, default=900)
    ro.add_argument("--worlds", type=int, default=1)
    ro.add_argument("--seed", type=int, default=0)
    ro.add_argument("--save-state", dest="save_state",
                    help="checkpoint final state to .npz")
    ro.add_argument("--resume", help="resume from a .npz checkpoint")
    ro.set_defaults(fn=cmd_rollout)

    vr = sub.add_parser("robot", help="serve a virtual robot over TCP "
                                      "(or a pty with --cdc)")
    vr.add_argument("--host", default="0.0.0.0")
    vr.add_argument("--port", type=int, default=8080)
    vr.add_argument("--cdc", action="store_true",
                    help="serve over a pty (the USB-CDC bridge analog, "
                         "tasks/usb.rs); prints the tty path")
    vr.set_defaults(fn=cmd_robot)

    rp = sub.add_parser("replay", help="parse a recorded Neato .bin log")
    rp.add_argument("file")
    rp.set_defaults(fn=cmd_replay)

    b = sub.add_parser("bench", help="run the benchmark")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from slamrs_tpu.utils import compile_cache

    compile_cache.enable()
    args.fn(args)


if __name__ == "__main__":
    main()
