"""The reference's front end: one frame is a registration (`register`),
then the map and the graph take the frame at its fused pose (`commit`),
then, on a check frame, the back end looks for loops (`check`), and a
correction rewrites the map (`correct`).

The judge calls these steps itself so that it can hand the map and the
graph the program's outputs between them; the control
(`reference/control.py`) chains them into a front end of its own.
`hold` rounds what the front end stores (scans, map points) to the
precision it runs at: float32, as the configuration states, unless a
control lowers it."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from slambench.reference.cloud import Map, voxel_centroids
from slambench.reference.geometry import resample
from slambench.reference.graph import Graph
from slambench.reference.ndt import Registered, register


def config(slam: dict) -> SimpleNamespace:
    """The configuration file's `slam` settings as attributes."""
    return SimpleNamespace(**slam)


class RefFrontEnd:
    def __init__(self, cfg, device, hold=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.hold = hold or (lambda xy: xy)
        self.map = Map(cfg, self.device, self.hold)
        self.graph = (Graph(cfg, self.device) if cfg.loop_enable
                      else None)
        self.prev_odo = None
        self.last_cov = np.zeros((3, 3))
        self.cnt = 0

    def scan(self, raw: np.ndarray) -> torch.Tensor:
        """A logged scan (sensor frame) as the front end takes it."""
        cfg = self.cfg
        xy = resample(raw, cfg.resample_space, cfg.resample_space_thre,
                      cfg.max_scan_points)
        return self.hold(torch.from_numpy(xy).to(self.device))

    def register(self, scan: torch.Tensor, odo) -> Registered:
        return register(self.cfg, scan, odo, self.prev_odo,
                        self.map.last_pose(), self.last_cov,
                        self.map.target())

    def counts(self, scan: torch.Tensor) -> tuple:
        """(live source points, live target points) of a registration."""
        src = voxel_centroids(scan, self.cfg.source_leaf_size)
        return len(src), len(self.map.target())

    def commit(self, sid: int, scan: torch.Tensor, odo, fused, cov):
        """The frame enters the map and the graph at `fused`."""
        self.map.add(fused, scan)
        self.prev_odo = np.asarray(odo, np.float64)
        self.last_cov = np.asarray(cov, np.float64)
        self.cnt += 1
        if self.graph is not None:
            self.graph.add(sid, fused, cov, scan)

    def check_due(self) -> bool:
        """Whether the frame just committed is a loop check."""
        return (self.graph is not None and self.cnt > 1 and
                (self.cnt - 1) % max(1, self.cfg.loop_check_skip) == 0)

    def correct(self, poses_deg):
        """Corrected poses for every node: the map and graph follow."""
        poses = np.asarray(poses_deg, np.float32)
        self.map.rewrite(poses)
        self.graph.take(poses)
