"""Keyframe store for loop-closure detection (port of
`ndt_slam_tpu.graph.keyframes`).

Scans are kept as fixed-shape padded buffers, as the device tensors
they arrive as (references, no copy), so a candidate subset becomes one
batched verifier input by a stack on the device. Poses and metadata
stay on the host for the candidate search.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PointBuffer


class KeyframeStore:
    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.sids: List[int] = []
        self.poses_deg: List[np.ndarray] = []   # fused pose at store time
        self.scan_xy: List = []                 # [S,2] local frame, padded
        self.scan_mask: List = []               # [S]
        self.pos_var: List[float] = []  # cumulative chain position var [m^2]

    def __len__(self) -> int:
        return len(self.sids)

    def add(self, sid: int, pose_deg: np.ndarray, scan: PointBuffer,
            pos_var: float = 0.0):
        """Store a keyframe; `pos_var` is the back end's cumulative
        per-frame position variance (chain model) at store time, which
        feeds the drift-aware candidate radius. The scan's tensors are
        kept as references."""
        if len(self.sids) >= self.cfg.max_keyframes:
            self._decimate()
        if self.scan_xy and scan.xy.shape != self.scan_xy[0].shape:
            # the batched verifier stacks the scans: one capacity
            raise ValueError(
                f"keyframe scan of shape {tuple(scan.xy.shape)}, the store "
                f"holds {tuple(self.scan_xy[0].shape)}")
        self.sids.append(int(sid))
        self.poses_deg.append(np.asarray(pose_deg, np.float32).copy())
        self.scan_xy.append(scan.xy)
        self.scan_mask.append(scan.mask)
        self.pos_var.append(float(pos_var))

    def _decimate(self):
        """At capacity, drop every other stored keyframe: the temporal
        density halves uniformly, so a long run keeps its spatial
        coverage (the candidates loop closure needs are the old frames)."""
        self.sids = self.sids[::2]
        self.poses_deg = self.poses_deg[::2]
        self.scan_xy = self.scan_xy[::2]
        self.scan_mask = self.scan_mask[::2]
        self.pos_var = self.pos_var[::2]

    def update_poses(self, poses_deg: np.ndarray, sid_to_row):
        """Refresh stored poses after a pose-graph correction.
        `sid_to_row` maps a keyframe sid to its row in poses_deg."""
        for k, sid in enumerate(self.sids):
            row = sid_to_row(sid)
            if row is not None:
                self.poses_deg[k] = np.asarray(
                    poses_deg[row], np.float32
                ).copy()

    def candidates(
        self, cur_pose_deg: np.ndarray, cur_sid: int,
        radius: float | None = None, min_gap: int | None = None,
        max_candidates: int | None = None,
        cur_pos_var: float = 0.0,
    ) -> List[int]:
        """Keyframe indices within the effective radius of the current
        pose and at least `min_gap` frames old, nearest first.

        Drift-aware radius: under the odometry-chain model the variance
        of the current pose relative to keyframe k is about
        var_cur - var_k, so keyframe k's gate widens to
        radius + loop_drift_gain * sqrt(max(0, var_cur - var_k))."""
        if not self.sids:
            return []
        radius = self.cfg.loop_radius if radius is None else radius
        min_gap = (
            self.cfg.loop_min_frame_gap if min_gap is None else min_gap
        )
        poses = np.stack(self.poses_deg)
        d = np.hypot(
            poses[:, 0] - cur_pose_deg[0], poses[:, 1] - cur_pose_deg[1]
        )
        gain = self.cfg.loop_drift_gain
        if gain > 0.0 and cur_pos_var > 0.0:
            var_k = np.asarray(self.pos_var, np.float64)
            sigma_rel = np.sqrt(np.maximum(0.0, cur_pos_var - var_k))
            eff_radius = radius + gain * sigma_rel
        else:
            eff_radius = np.full(d.shape, radius)
        sids = np.asarray(self.sids)
        ok = (d <= eff_radius) & (cur_sid - sids >= min_gap)
        idx = np.nonzero(ok)[0]
        # rank by distance in units of each candidate's gate, so that a
        # close but uncertain candidate does not crowd out a confident one
        idx = idx[np.argsort(d[idx] / np.maximum(eff_radius[idx], 1e-9))]
        if max_candidates is not None:
            idx = idx[:max_candidates]
        return idx.tolist()
