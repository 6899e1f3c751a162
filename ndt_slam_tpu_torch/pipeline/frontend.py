"""Per-frame SLAM step (port of `ndt_slam_tpu.pipeline.frontend`, the
synchronous path).

A registration step does everything numerical for a frame on the device
of its inputs:

    odometry motion -> predicted pose -> NDT grid -> compact table ->
    source voxel downsample -> Newton align -> fitness -> NDT
    covariance from the Hessian -> accept/reject -> Kalman fuse (or
    odometry-only propagation) -> map-frame points.

`_registration_step` builds the grid by rescattering the whole local
map; `_registration_step_inc` cuts it out of the map's running moment
lattice and adds the newest raw scan's moments. Both share the tail
`_register_with_grid`.

`FrontEnd` owns the first-scan bootstrap, the map bookkeeping, the
metrics trail and, with `loop_enable`, the loop-closure back end
(`graph/backend.GraphBackend`): every frame becomes a graph node, every
`loop_check_skip` frames candidates are verified, and a correction
rewrites the pose history and the map (`_apply_correction`). The pose,
covariance and odometry carries stay on the device between frames; the
per-frame small outputs come back to the host in one device-to-host
copy (a second one only for a frame whose window escaped the lattice
and is redone through the full rebuild).

Parity notes: cost is forced to failed_cost when the solve is unusable;
accept iff cost <= score_thre (and the innovation gates hold); on
reject the pose is the odometry prediction and the covariance grows by
the motion model only; the first frame enters the map at its raw
odometry pose with zero covariance.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core import pose2
from ndt_slam_tpu_torch.core.points import PAD_COORD, PointBuffer, pad_points
from ndt_slam_tpu_torch.fuse.ekf import gate_and_fuse
from ndt_slam_tpu_torch.graph.backend import GraphBackend
from ndt_slam_tpu_torch.io import native
from ndt_slam_tpu_torch.mapping.pointcloud_map import PointCloudMap
from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
from ndt_slam_tpu_torch.ndt.compact import compact_grid
from ndt_slam_tpu_torch.ndt.fitness import fitness_score
from ndt_slam_tpu_torch.ndt.grid import (
    build_grid, lattice_anchor, moments_abs, window_grid_from_lattice,
)
from ndt_slam_tpu_torch.ndt.score import gauss_constants
from ndt_slam_tpu_torch.ndt.solve import align
from ndt_slam_tpu_torch.pre.resample import resample_points_np


class FrameResult(NamedTuple):
    est_pose: torch.Tensor     # [3] NDT pose (deg)
    fused_pose: torch.Tensor   # [3] fused pose (deg)
    cov: torch.Tensor          # [3,3]
    cost: torch.Tensor         # fitness (or failed_cost)
    successful: torch.Tensor   # bool
    iterations: torch.Tensor   # int32
    matched: torch.Tensor      # float32
    global_xy: torch.Tensor    # [N,2] scan in map frame at fused pose
    error_pose: torch.Tensor   # [3] map->odom offset (deg)
    trans_probability: torch.Tensor  # score per source point
    grid_ok: torch.Tensor      # float32: 0.0 iff the window escaped the lattice

    def small(self) -> torch.Tensor:
        """[24] float32: fused(3) cov(9) cost successful iterations
        matched trans_probability est(3) error(3) grid_ok, so the host
        fetches a frame's small outputs in one copy."""
        return torch.cat([
            self.fused_pose, self.cov.reshape(-1),
            torch.stack([
                self.cost, self.successful.to(torch.float32),
                self.iterations.to(torch.float32), self.matched,
                self.trans_probability,
            ]),
            self.est_pose, self.error_pose, self.grid_ok[None],
        ])


class StageTimer:
    """Milliseconds per stage of the frame loop, summed over frames.

    `mark(name)` closes the interval since the previous mark under
    `name`. On a CUDA device a mark records an event on the current
    stream (no sync), so the split is taken on the card's timeline;
    intervals are folded in once their events have completed."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self.ms: dict[str, float] = {}
        self._open: list = []
        self._last = None

    def mark(self, name: str):
        if self._cuda:
            now = torch.cuda.Event(enable_timing=True)
            now.record()
        else:
            now = time.perf_counter()
        if self._last is not None:
            if self._cuda:
                self._open.append((name, self._last, now))
            else:
                self._add(name, (now - self._last) * 1e3)
        self._last = now

    def _add(self, name: str, ms: float):
        self.ms[name] = self.ms.get(name, 0.0) + ms

    def resolve(self, wait: bool = False):
        """Fold in completed intervals (all of them after a sync with
        `wait=True`)."""
        if wait and self._cuda:
            torch.cuda.synchronize()
        still = []
        for name, a, b in self._open:
            if b.query():
                self._add(name, a.elapsed_time(b))
            else:
                still.append((name, a, b))
        self._open = still


def _registration_step(cfg: SlamConfig, scan_xy, scan_mask, odo_pose,
                       prev_odo, last_pose, last_cov, local_xy, local_mask,
                       timer: Optional[StageTimer] = None) -> FrameResult:
    """Registration against a grid rebuilt from the whole target."""
    # --- odometry prediction
    odo_motion = pose2.cal_motion(odo_pose, prev_odo)
    pred_pose = pose2.cal_pred_pose(odo_motion, last_pose)

    # --- NDT grid over the local map, window centered on the prediction
    grid = build_grid(
        local_xy, local_mask, pred_pose[:2],
        cfg.grid_cells_x, cfg.grid_cells_y, cfg.ndt_resolution,
        min_pts=cfg.ndt_min_points_per_cell,
    )
    return _register_with_grid(
        cfg, grid, scan_xy, scan_mask, odo_pose, odo_motion, pred_pose,
        last_pose, last_cov, local_xy, local_mask,
        grid_ok=torch.ones((), dtype=torch.float32, device=scan_xy.device),
        timer=timer,
    )


def _registration_step_inc(cfg: SlamConfig, scan_xy, scan_mask, odo_pose,
                           prev_odo, last_pose, last_cov, local_xy,
                           local_mask, mom, mom_anchor, newest_xy,
                           newest_mask, proc_count, include_newest: bool,
                           timer: Optional[StageTimer] = None) -> FrameResult:
    """Registration against the incremental moment lattice: the grid is
    the frame's window of `mom` [B*B, 6] (anchored at `mom_anchor`)
    plus, with `include_newest`, the fresh moments of the newest raw
    scan (`newest_xy`, map frame), which under remove_moving rides along
    in the target but is not in the lattice. The target buffer still
    feeds the fitness pass.

    `proc_count` (int32, on the device) mirrors the target's overflow
    rule: the newest scan is concatenated after proc in the submap
    buffer, so once proc has filled it the scan's tail is dropped from
    the target. The fresh moments drop the same points: those whose
    rank among the valid ones is not below the remaining capacity."""
    odo_motion = pose2.cal_motion(odo_pose, prev_odo)
    pred_pose = pose2.cal_pred_pose(odo_motion, last_pose)

    B = cfg.resolved_grid_mom_cells
    nx, ny = cfg.grid_cells_x, cfg.grid_cells_y
    res = cfg.ndt_resolution
    frame_anchor = lattice_anchor(pred_pose[:2], nx, res)
    extra = None
    if include_newest:
        rank = torch.cumsum(newest_mask.to(torch.int32), dim=0) - 1
        budget = cfg.max_submap_points - proc_count
        keep = newest_mask & (rank < budget)
        extra = moments_abs(newest_xy, keep, frame_anchor, nx, ny, res)
    grid, in_range = window_grid_from_lattice(
        mom, mom_anchor, B, B, frame_anchor, nx, ny, res,
        extra=extra, min_pts=cfg.ndt_min_points_per_cell,
    )
    return _register_with_grid(
        cfg, grid, scan_xy, scan_mask, odo_pose, odo_motion, pred_pose,
        last_pose, last_cov, local_xy, local_mask,
        grid_ok=in_range.to(torch.float32), timer=timer,
    )


def _register_with_grid(cfg: SlamConfig, grid, scan_xy, scan_mask, odo_pose,
                        odo_motion, pred_pose, last_pose, last_cov,
                        local_xy, local_mask, grid_ok,
                        timer: Optional[StageTimer] = None) -> FrameResult:
    """The tail both registration steps share: source downsample,
    compact table, align, fitness, gate + fuse, map-frame points."""
    mark = timer.mark if timer is not None else (lambda name: None)
    mark("grid")

    # --- source downsample, compact table
    src = voxel_filter(PointBuffer(scan_xy, scan_mask), cfg.source_leaf_size)
    mark("source_filter")
    cgrid = compact_grid(grid, cfg.ndt_max_active_cells)
    mark("compact")
    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)

    res = align(
        pose2.pose_deg_to_rad(pred_pose), src.xy, src.mask, cgrid, d1, d2,
        max_iterations=cfg.ndt_max_iterations,
        step_size=cfg.ndt_step_size,
        trans_eps=cfg.ndt_trans_eps,
        radius=cfg.ndt_neighborhood,
    )
    est_pose = pose2.pose_rad_to_deg(res.pose_rad)
    mark("align")

    # --- fitness at the converged pose, on the downsampled source
    src_map = pose2.global_points(est_pose, src.xy)
    src_map = torch.where(src.mask[:, None], src_map, PAD_COORD)
    fit = fitness_score(src_map, src.mask, local_xy, local_mask)
    cost = torch.where(res.converged, fit, cfg.failed_cost)
    mark("fitness")

    # --- covariance repair + gates + Kalman fuse or dead-reckon
    fused, cov, accept = gate_and_fuse(
        cfg, pred_pose, est_pose, res.hessian, cost,
        odo_motion, last_pose, last_cov,
    )
    # scan into the map frame at the fused pose (growMap input)
    g = pose2.global_points(fused, scan_xy)
    g = torch.where(scan_mask[:, None], g, PAD_COORD)
    error_pose = pose2.cal_global_motion(fused, odo_pose)
    n_src = src.mask.sum(dtype=torch.float32)
    trans_prob = -res.objective / torch.clamp(n_src, min=1.0)
    mark("fuse")
    return FrameResult(
        est_pose=est_pose, fused_pose=fused, cov=cov, cost=cost,
        successful=accept, iterations=res.iterations, matched=res.matched,
        global_xy=g, error_pose=error_pose, trans_probability=trans_prob,
        grid_ok=grid_ok,
    )


class FrontEnd:
    """Host orchestration: the reference's FrontEnd::process +
    ScanMatcher, on the device `device`."""

    def __init__(self, cfg: SlamConfig, device):
        if cfg.pipeline_depth > 0:
            raise NotImplementedError(
                "the pipelined front end is not ported yet")
        cfg.resolved_ndt_engine  # raises for an engine the port lacks
        self.cfg = cfg
        self.device = torch.device(device)
        self.pcmap = PointCloudMap(cfg, self.device)
        self.cnt = 0
        self.prev_odo: Optional[np.ndarray] = None
        self.last_cov = torch.zeros((3, 3), dtype=torch.float32,
                                    device=self.device)
        # device-resident carries (None: take the host copy)
        self._last_pose_dev: Optional[torch.Tensor] = None
        self._prev_odo_dev: Optional[torch.Tensor] = None
        self.init_pose: Optional[np.ndarray] = None
        # the native resampler gives the numpy one's points bit for bit
        # (tests/test_torch_io.py) and is taken where the library loads
        self.resampler = "native" if native.available() else "numpy"
        self._resample = (native.resample_points if native.available()
                          else resample_points_np)
        self.incremental_grid = self.pcmap.incremental_grid
        # escape hatch of the incremental grid: route the next
        # dispatched frame through the full rebuild (set when a frame's
        # window escaped the lattice; n_grid_fallbacks counts them)
        self._force_full_grid = False
        self.n_grid_fallbacks = 0
        self.pose_history: list[np.ndarray] = []
        self.cov_history: list[np.ndarray] = []
        self.metrics: list[dict] = []
        self.timer = StageTimer(self.device)
        # loop closure: wall time of the back end's checks (verify and
        # optimise) and of the map rewrites after corrections
        self.t_backend = 0.0
        self.t_remake = 0.0
        self.n_corrections = 0
        self.backend = None
        if cfg.loop_enable:
            self.backend = GraphBackend(cfg, self.device)
            self.backend.mark = self.timer.mark

    def process(self, scan_xy_local: np.ndarray, odo_pose_deg: np.ndarray,
                sid: Optional[int] = None) -> dict:
        """One frame. scan_xy_local: [n,2] raw sensor-frame points;
        odo_pose_deg: [3] raw odometry. Returns the per-frame record."""
        cfg = self.cfg
        if sid is None:
            sid = self.cnt
        if sid < cfg.start_frame:
            return {"sid": sid, "skipped": True}

        rs = self._resample(
            scan_xy_local, cfg.resample_space, cfg.resample_space_thre
        )
        odo = np.asarray(odo_pose_deg, dtype=np.float32)
        scan = pad_points(rs, cfg.max_scan_points, self.device)
        odo_dev = torch.from_numpy(odo).to(self.device)
        self.timer.mark("host")

        if self.cnt == 0:
            # bootstrap: the first scan enters the map at its odometry
            self.init_pose = odo.copy()
            cov = np.zeros((3, 3), dtype=np.float32)
            g = pose2.global_points(odo_dev, scan.xy)
            g = torch.where(scan.mask[:, None], g, PAD_COORD)
            self._grow_map(PointBuffer(g, scan.mask), odo, rs, scan)
            self.last_cov = torch.zeros((3, 3), dtype=torch.float32,
                                        device=self.device)
            self.prev_odo = odo
            self._last_pose_dev = odo_dev
            self._prev_odo_dev = odo_dev
            self.cnt += 1
            self.timer.mark("map")
            rec = {
                "sid": sid, "cost": 0.0, "successful": True,
                "fused_pose": odo.tolist(), "iterations": 0,
                "bootstrap": True,
            }
            self._record(odo, cov, rec)
            if self.backend is not None:
                self.backend.add_frame(sid, odo, cov, scan)
            return rec

        local = self.pcmap.registration_target()
        prev_odo_dev = (self._prev_odo_dev if self._prev_odo_dev is not None
                        else torch.from_numpy(self.prev_odo).to(self.device))
        last_pose_dev = (
            self._last_pose_dev if self._last_pose_dev is not None
            else torch.from_numpy(self.pcmap.get_last_pose()).to(self.device)
        )
        out = self._run_step(scan, odo_dev, prev_odo_dev, last_pose_dev,
                             local)
        small = out.small().cpu().numpy()   # the frame's one fetch
        self.timer.mark("fetch")
        if not small[23] > 0.0:
            # the window escaped the lattice: redo this frame through
            # the full rebuild (a second fetch)
            self.n_grid_fallbacks += 1
            self._force_full_grid = True
            out = self._run_step(scan, odo_dev, prev_odo_dev, last_pose_dev,
                                 local)
            small = out.small().cpu().numpy()
            self.timer.mark("fetch")
        self.timer.resolve()
        return self._finish_frame(out, small, scan, rs, odo, odo_dev, sid)

    def _run_step(self, scan: PointBuffer, odo_dev, prev_odo_dev,
                  last_pose_dev, local: PointBuffer) -> FrameResult:
        """The frame's registration: against the moment lattice when the
        incremental grid is on, else (and for the one frame after an
        escape, which re-arms the lattice path) against a full
        rebuild."""
        cfg = self.cfg
        if self.incremental_grid and not self._force_full_grid:
            mom, anchor = self.pcmap.mom_state()
            newest = self.pcmap.newest_raw()
            include_newest = bool(cfg.remove_moving and newest is not None)
            if newest is None:
                newest = scan  # unused (include_newest False)
            return _registration_step_inc(
                cfg, scan.xy, scan.mask, odo_dev, prev_odo_dev,
                last_pose_dev, self.last_cov, local.xy, local.mask,
                mom, anchor, newest.xy, newest.mask,
                self.pcmap.submaps[-1].proc_count, include_newest,
                timer=self.timer,
            )
        self._force_full_grid = False
        return _registration_step(
            cfg, scan.xy, scan.mask, odo_dev, prev_odo_dev, last_pose_dev,
            self.last_cov, local.xy, local.mask, timer=self.timer,
        )

    def _finish_frame(self, out: FrameResult, small: np.ndarray,
                      scan: PointBuffer, rs_local: np.ndarray,
                      odo: np.ndarray, odo_dev, sid: int) -> dict:
        fused = small[0:3].copy()
        cov = small[3:12].reshape(3, 3).copy()
        self.last_cov = out.cov
        self._last_pose_dev = out.fused_pose
        self._prev_odo_dev = odo_dev
        self._grow_map(PointBuffer(out.global_xy, scan.mask), fused,
                       rs_local, scan)
        self.prev_odo = odo
        self.cnt += 1
        self.timer.mark("map")
        rec = {
            "sid": sid,
            "cost": float(small[12]),
            "successful": bool(small[13] > 0.5),
            "est_pose": small[17:20].tolist(),
            "fused_pose": fused.tolist(),
            "iterations": int(small[14]),
            "matched": float(small[15]),
            "error_pose": small[20:23].tolist(),
            "trans_probability": float(small[16]),
        }
        self._record(fused, cov, rec)
        self._backend_hook(sid, fused, cov, scan, rec)
        return rec

    def _backend_hook(self, sid: int, fused, cov, scan: PointBuffer,
                      rec: dict):
        """The back end's step for one frame: add_frame, the check every
        loop_check_skip frames, and the correction it returns."""
        if self.backend is None:
            return
        self.backend.add_frame(sid, fused, cov, scan)
        if (self.cnt - 1) % max(1, self.cfg.loop_check_skip) == 0:
            t0 = time.perf_counter()
            corrected = self.backend.try_close(sid, fused, scan)
            self.t_backend += time.perf_counter() - t0
            if corrected is not None:
                self._correct(corrected)
                rec["loop_closed"] = True
                return
        self.timer.mark("backend")

    def _correct(self, corrected_deg: np.ndarray):
        """Apply a correction, timed and counted."""
        t0 = time.perf_counter()
        self._apply_correction(corrected_deg)
        self.t_remake += time.perf_counter() - t0
        self.n_corrections += 1
        self.timer.mark("backend")

    def _apply_correction(self, corrected_deg: np.ndarray):
        """Rewrite the trajectory and the map through the corrected
        poses; the device-resident pose carry is stale after it."""
        n = len(self.pose_history)
        if corrected_deg.shape[0] != n:
            raise ValueError(f"{corrected_deg.shape[0]} corrected poses for "
                             f"a trajectory of {n}")
        self.pose_history = [p.astype(np.float32) for p in corrected_deg]
        self.pcmap.remake_maps(corrected_deg)
        self._last_pose_dev = None

    def _grow_map(self, scan_map_frame: PointBuffer, fused_pose: np.ndarray,
                  rs_local: np.ndarray, scan_local: PointBuffer):
        self.pcmap.add_pose(fused_pose)
        self.pcmap.add_points(scan_map_frame)
        self.pcmap.set_last_pose(fused_pose)
        self.pcmap.set_last_scan(scan_map_frame)
        self.pcmap.record_local_scan(rs_local, padded=scan_local)

    def _record(self, fused, cov, rec):
        self.pose_history.append(np.asarray(fused, dtype=np.float32))
        self.cov_history.append(np.asarray(cov, dtype=np.float32))
        self.metrics.append(rec)

    def finalize(self):
        """End of run: apply a correction the back end still holds (a
        verification in flight, edges deferred by loop_opt_min_frames),
        then fold in the remaining stage intervals."""
        if self.backend is not None:
            t0 = time.perf_counter()
            corrected = self.backend.flush()
            self.t_backend += time.perf_counter() - t0
            if corrected is not None:
                self._correct(corrected)
        self.timer.resolve(wait=True)

    def get_poses(self) -> np.ndarray:
        return np.asarray(self.pose_history, dtype=np.float32)
