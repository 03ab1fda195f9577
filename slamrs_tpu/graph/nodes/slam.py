"""SLAM algorithm nodes for the host graph.

Parity surface: ``GridMapSlamNode`` (slam/src/grid/node.rs),
``IcpPointMapNode`` (slam/src/pointmap.rs:98-154), ``EKFLandmarkSlamNode``
(slam/src/landmark/node.rs) — YAML field names match the reference.

Each node owns device-resident state plus one jitted update function and
processes at most one observation per app frame (the reference's explicit
backpressure policy, pointmap.rs:127).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from slamrs_tpu.graph.node import (GridMapMessage, LandmarkMapMessage,
                                   LandmarkOdometry, Node, NodeConfig,
                                   PointMapMessage, PoseMsg, ScanOdometry)
from slamrs_tpu.models import ekf as ekf_model
from slamrs_tpu.models import gridslam as gs_model
from slamrs_tpu.models import icp_mapper as icp_model
from slamrs_tpu.utils import PerfStats


@dataclasses.dataclass
class GridMapSlamNodeConfig(NodeConfig):
    topic_pose: str
    topic_observation_odometry: str
    topic_map: str
    config: dict = dataclasses.field(default_factory=dict)
    seed: int = 1
    publish_map_every: int = 1

    def slam_config(self) -> gs_model.GridSlamConfig:
        c = dict(self.config)
        pos = c.pop("position", (-2.0, -2.0))
        return gs_model.GridSlamConfig(
            position_x=float(pos[0]), position_y=float(pos[1]),
            width=float(c.pop("width", 4.0)),
            height=float(c.pop("height", 4.0)),
            resolution=float(c.pop("resolution", 0.02)),
            n_particles=int(c.pop("n_particles", 10)),
            **c)

    def instantiate(self, pubsub) -> "GridMapSlamNode":
        return GridMapSlamNode(self, pubsub)


class GridMapSlamNode(Node):
    def __init__(self, config: GridMapSlamNodeConfig, pubsub):
        self.cfg = config
        self.slam_cfg = config.slam_config()
        self.state = gs_model.GridSlamState.init(self.slam_cfg)
        self.key = jax.random.key(config.seed)
        self.sub = pubsub.subscribe(config.topic_observation_odometry,
                                    ScanOdometry)
        self.pub_pose = pubsub.publish(config.topic_pose, PoseMsg)
        self.pub_map = pubsub.publish(config.topic_map, GridMapMessage)
        self.stats = PerfStats()
        self._updates = 0
        self._update = jax.jit(
            lambda state, scan, odo, key: gs_model.update(
                state, scan, odo, key, self.slam_cfg))
        self._prob_grid = jax.jit(gs_model.estimated_probability_grid)

    def update(self) -> None:
        msg = self.sub.try_recv()  # one observation per frame (node.rs:47)
        if msg is None:
            return
        from slamrs_tpu.utils.trace import span

        # the reference's only instrumented span is GridMapSlam::update
        # (#[tracing::instrument], slam.rs:45) — mirror it
        with span("GridMapSlam::update"), self.stats.timeit():
            self.key, sub = jax.random.split(self.key)
            self.state, out = self._update(self.state, msg.scan,
                                           msg.odometry, sub)
            self.pub_pose.publish(PoseMsg(np.asarray(out.pose)))
            self._updates += 1
            if self._updates % self.cfg.publish_map_every == 0:
                self.pub_map.publish(GridMapMessage(
                    position=np.array([self.slam_cfg.position_x,
                                       self.slam_cfg.position_y], np.float32),
                    resolution=self.slam_cfg.resolution,
                    data=np.asarray(self._prob_grid(self.state)),
                ))


@dataclasses.dataclass
class IcpPointMapperNodeConfig(NodeConfig):
    topic_pose: str
    topic_observation: str
    topic_pointmap: str
    icp: dict = dataclasses.field(default_factory=dict)
    capacity: int = 16384
    voxel_size: Optional[float] = None

    def mapper_config(self) -> icp_model.IcpMapConfig:
        icp = dict(self.icp)
        weights = icp.pop("correspondence_weights", "Uniform")
        threshold = None
        if isinstance(weights, tuple):  # ("Step", {"threshold": ...})
            tag, fields = weights
            if tag == "Step":
                threshold = float(fields["threshold"])
        elif isinstance(weights, dict) and "threshold" in weights:
            threshold = float(weights["threshold"])
        return icp_model.IcpMapConfig(
            capacity=self.capacity,
            iterations=int(icp.pop("iterations", 10)),
            step_threshold=threshold,
            voxel_size=self.voxel_size,
        )

    def instantiate(self, pubsub) -> "IcpPointMapperNode":
        return IcpPointMapperNode(self, pubsub)


class IcpPointMapperNode(Node):
    def __init__(self, config: IcpPointMapperNodeConfig, pubsub):
        self.cfg = config
        self.map_cfg = config.mapper_config()
        self.state = icp_model.IcpMapState.init(self.map_cfg)
        self.sub = pubsub.subscribe(config.topic_observation)
        self.pub_pose = pubsub.publish(config.topic_pose, PoseMsg)
        self.pub_map = pubsub.publish(config.topic_pointmap, PointMapMessage)
        self.stats = PerfStats()
        self._update = jax.jit(
            lambda state, scan: icp_model.update(state, scan, self.map_cfg))

    def update(self) -> None:
        msg = self.sub.try_recv()  # one per frame (pointmap.rs:125-136)
        if msg is None:
            return
        scan = msg.scan if isinstance(msg, ScanOdometry) else msg
        with self.stats.timeit():
            self.state, out = self._update(self.state, scan)
            self.pub_pose.publish(PoseMsg(np.asarray(out.pose)))
            count = int(self.state.count)
            self.pub_map.publish(PointMapMessage(
                points=np.asarray(self.state.points[:count])))


@dataclasses.dataclass
class EKFLandmarkSlamNodeConfig(NodeConfig):
    topic_pose: str
    topic_observation_landmark: str
    topic_map: str
    config: Optional[dict] = None

    def instantiate(self, pubsub) -> "EKFLandmarkSlamNode":
        return EKFLandmarkSlamNode(self, pubsub)


class EKFLandmarkSlamNode(Node):
    def __init__(self, config: EKFLandmarkSlamNodeConfig, pubsub):
        self.cfg = config
        self.ekf_cfg = ekf_model.EkfConfig(**(config.config or {}))
        self.state = ekf_model.EkfState.init(self.ekf_cfg)
        self.sub = pubsub.subscribe(config.topic_observation_landmark,
                                    LandmarkOdometry)
        self.pub_pose = pubsub.publish(config.topic_pose, PoseMsg)
        self.pub_map = pubsub.publish(config.topic_map, LandmarkMapMessage)
        self._update = jax.jit(
            lambda state, obs, odo: ekf_model.update(state, obs, odo,
                                                     self.ekf_cfg))

    def update(self) -> None:
        msg = self.sub.try_recv()
        if msg is None:
            return
        self.state, out = self._update(self.state, msg.landmarks,
                                       msg.odometry)
        self.pub_pose.publish(PoseMsg(np.asarray(out.pose)))
        self.pub_map.publish(LandmarkMapMessage(
            means=np.asarray(out.landmark_means),
            covariances=np.asarray(out.landmark_covs),
            seen=np.asarray(out.seen)))

    def correlation_matrix(self) -> np.ndarray:
        """Correlation matrix of the full EKF state covariance
        (the debug view at landmark/node.rs:62-68): corr = D^-1 Sigma D^-1
        with D = diag(sqrt(Sigma_ii))."""
        cov = np.asarray(self.state.cov, np.float64)
        d = np.sqrt(np.clip(np.diag(cov), 1e-30, None))
        return cov / np.outer(d, d)

    def draw(self, viz=None) -> None:
        """Correlation heat-map as filled rects (landmark/node.rs:69-94):
        green = positive, red = negative, white = zero, with the pose/
        landmark block separator gaps."""
        if viz is None:
            return
        from slamrs_tpu.viz.shapes import Color, PrimitiveType

        corr = self.correlation_matrix()
        viz.begin(PrimitiveType.FILLED)
        x_offset, y_offset, size = 2.0, 0.0, 0.08
        for i in range(corr.shape[0]):
            for j in range(corr.shape[1]):
                c = float(corr[i, j])
                if c > 0.0:
                    color = Color(0.0, min(c, 1.0), 0.0)
                elif c == 0.0:
                    color = Color.WHITE
                else:
                    color = Color(min(-c, 1.0), 0.0, 0.0)
                x = x_offset + i * size + (size / 3.0 if i > 2 else 0.0)
                y = y_offset + j * size + (size / 3.0 if j > 2 else 0.0)
                viz.rect(x, y, size, size, color)
        viz.end()
