"""Node lifecycle contract and message types carried on topics.

Parity surface: ``Node``/``NodeConfig`` (slamrs/common/src/node.rs:9-27)
and the topic payload types (GridMapMessage at grid/node.rs:64-72,
PointMap at pointmap.rs:18, LandmarkMapMessage at landmark/node.rs).

Headless-first: ``draw`` takes no GL context — nodes that visualize export
data through the :class:`slamrs_tpu.graph.nodes.viz.VisualizerNode`
instead (the reference's egui/OpenGL UI is host tooling, out of the
framework core; see SURVEY §7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


class Node:
    """Parity: Node trait (node.rs:9-21)."""

    def update(self) -> None:  # called once per app frame
        pass

    def draw(self, viz: Optional[Any] = None) -> None:  # optional viz hook
        pass

    def terminate(self) -> None:  # cleanup (threads, sockets)
        pass


class NodeConfig:
    """Parity: NodeConfig trait (node.rs:23-27)."""

    def instantiate(self, pubsub) -> Node:
        raise NotImplementedError


# ---- topic payload types -------------------------------------------------

@dataclasses.dataclass
class ScanOdometry:
    """(Observation, Odometry) tuple topic payload."""

    scan: Any  # slamrs_tpu.core.types.Scan (host-side: numpy-backed ok)
    odometry: Any  # OdometryReading


@dataclasses.dataclass
class LandmarkOdometry:
    landmarks: Any  # LandmarkScan
    odometry: Any


@dataclasses.dataclass
class PoseMsg:
    """Pose topic payload (x, y, theta)."""

    pose: np.ndarray  # f32[3]


@dataclasses.dataclass
class GridMapMessage:
    """Parity: GridMapMessage (grid/node.rs:64-72)."""

    position: np.ndarray  # f32[2] world coords of lower-left corner
    resolution: float
    data: np.ndarray  # f32[H, W] occupancy probability


@dataclasses.dataclass
class PointMapMessage:
    """Parity: PointMap (pointmap.rs:18)."""

    points: np.ndarray  # f32[N, 2]


@dataclasses.dataclass
class LandmarkMapMessage:
    """Parity: LandmarkMapMessage (landmark/node.rs)."""

    means: np.ndarray  # f32[N, 2]
    covariances: np.ndarray  # f32[N, 2, 2]
    seen: np.ndarray  # bool[N]
