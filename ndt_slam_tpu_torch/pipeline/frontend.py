"""Per-frame SLAM step (port of `ndt_slam_tpu.pipeline.frontend`, the
synchronous path).

A registration step does everything numerical for a frame on the device
of its inputs:

    odometry motion -> predicted pose -> NDT grid -> compact table ->
    source voxel downsample -> Newton align -> fitness -> NDT
    covariance from the Hessian -> accept/reject -> Kalman fuse (or
    odometry-only propagation) -> map-frame points.

On CUDA tensors the stage from the cost to the map-frame points is one
launch of the fuse kernel (`fuse.ekf.fuse_stage`, `kernels.ndt_fuse`).

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
and is redone through the full rebuild). The pipelined front end
(`pipeline/async_frontend.py`) fetches them a chunk of frames at a
time and shares the record (`_build_rec`) and the back-end step
(`_backend_hook`) with this path.

`_registration_step` also takes a leading batch dimension: the lockstep
batch runner (`pipeline/batch_runner.py`) registers B sequences a tick
in one call and runs each sequence's FrontEnd in batch mode
(`_defer_map`), where the carries stay on the host and the map update
is left to the runner's batched map step.

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
from ndt_slam_tpu_torch.fuse.ekf import fuse_stage
from ndt_slam_tpu_torch.graph.backend import GraphBackend
from ndt_slam_tpu_torch.io import native
from ndt_slam_tpu_torch.mapping.pointcloud_map import PointCloudMap
from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
from ndt_slam_tpu_torch.ndt.compact import compact_grid, compact_grids
from ndt_slam_tpu_torch.ndt.fitness import fitness_score
from ndt_slam_tpu_torch.ndt.kernels import fitness_score_batched
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
        fetches a frame's small outputs in one copy; [B,24] for the B
        rows of a lockstep tick."""
        return torch.cat([
            self.fused_pose, self.cov.flatten(-2),
            torch.stack([
                self.cost, self.successful.to(torch.float32),
                self.iterations.to(torch.float32), self.matched,
                self.trans_probability,
            ], dim=-1),
            self.est_pose, self.error_pose, self.grid_ok[..., None],
        ], dim=-1)


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
    """Registration against a grid rebuilt from the whole target.

    With a leading batch dimension on every input ([B,S,2] scans, [B,3]
    poses, [B,3,3] covariances, [B,L,2] targets) it registers B
    independent sequences at once, the JAX package's `vmap` of this
    step (the lockstep batch runner): one grid build keyed by (row,
    cell), one `GridStack` of B tables, the row axis of `align` with
    row b against grid b (the stacked window itself under the gather
    engine), one fitness call for all rows, the fusion over rows. Every
    field of the result then leads with [B]. A row whose
    masks are all False (an idle sequence) matches nothing, so its solve
    ends at the first iteration and holds no other row back."""
    # --- odometry prediction
    odo_motion = pose2.cal_motion(odo_pose, prev_odo)
    pred_pose = pose2.cal_pred_pose(odo_motion, last_pose)

    # --- NDT grid over the local map, window centered on the prediction
    grid = build_grid(
        local_xy, local_mask, pred_pose[..., :2],
        cfg.grid_cells_x, cfg.grid_cells_y, cfg.ndt_resolution,
        min_pts=cfg.ndt_min_points_per_cell,
    )
    return _register_with_grid(
        cfg, grid, scan_xy, scan_mask, odo_pose, odo_motion, pred_pose,
        last_pose, last_cov, local_xy, local_mask,
        grid_ok=torch.ones(scan_xy.shape[:-2], dtype=torch.float32,
                           device=scan_xy.device),
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
    compact table, align, fitness, gate + fuse, map-frame points (over
    rows when the inputs lead with a batch dimension)."""
    mark = timer.mark if timer is not None else (lambda name: None)
    mark("grid")
    rows = scan_xy.dim() == 3

    # --- source downsample, compact table (the gather engine registers
    # against the window grid itself)
    src = voxel_filter(PointBuffer(scan_xy, scan_mask), cfg.source_leaf_size)
    mark("source_filter")
    gather = cfg.resolved_ndt_engine == "gather"
    grid_index = None
    if rows:
        # row b against window b: the stacked grid itself, or its tables
        cgrid = (grid if gather
                 else compact_grids(grid, cfg.ndt_max_active_cells))
        grid_index = torch.arange(scan_xy.shape[0], dtype=torch.int32,
                                  device=scan_xy.device)
    elif gather:
        cgrid = grid
    else:
        cgrid = compact_grid(grid, cfg.ndt_max_active_cells)
    mark("compact")
    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)

    res = align(
        pose2.pose_deg_to_rad(pred_pose), src.xy, src.mask, cgrid, d1, d2,
        max_iterations=cfg.ndt_max_iterations,
        step_size=cfg.ndt_step_size,
        trans_eps=cfg.ndt_trans_eps,
        radius=cfg.ndt_neighborhood,
        grid_index=grid_index,
    )
    est_pose = pose2.pose_rad_to_deg(res.pose_rad)
    mark("align")

    # --- fitness at the converged pose, on the downsampled source
    src_map = pose2.global_points(est_pose, src.xy)
    src_map = torch.where(src.mask[..., None], src_map, PAD_COORD)
    fitness = fitness_score_batched if rows else fitness_score
    fit = fitness(src_map, src.mask, local_xy, local_mask)
    mark("fitness")

    # --- cost, covariance repair + gates + Kalman fuse or dead-reckon,
    # the scan in the map frame (one launch of the fuse kernel on CUDA)
    cost, fused, cov, accept, g, error_pose, trans_prob = fuse_stage(
        cfg, pred_pose, est_pose, res.hessian, res.objective, res.converged,
        fit, odo_pose, odo_motion, last_pose, last_cov, src.mask, scan_xy,
        scan_mask,
    )
    mark("fuse")
    return FrameResult(
        est_pose=est_pose, fused_pose=fused, cov=cov, cost=cost,
        successful=accept, iterations=res.iterations, matched=res.matched,
        global_xy=g, error_pose=error_pose, trans_probability=trans_prob,
        grid_ok=grid_ok,
    )


class FrontEnd:
    """Host orchestration: the reference's FrontEnd::process +
    ScanMatcher, on the device `device`; `mesh` shards the loop-closure
    verification over its "dp" ranks (`graph/backend.GraphBackend`)."""

    def __init__(self, cfg: SlamConfig, device, mesh=None):
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
        # lockstep batch mode (pipeline/batch_runner.py): the runner
        # registers every sequence of a tick in one batched step and
        # runs their map updates as one batched map step, so a frame's
        # map update is left in _pending_scan (the runner's ("slot", i)
        # sentinel or a map-frame PointBuffer) and the carries stay on
        # the host; _map_rewritten tells the runner that a correction
        # rebuilt this map, so its stacked copy is stale
        self._defer_map = False
        self._pending_scan = None
        self._map_rewritten = False
        self.backend = None
        if cfg.loop_enable:
            self.backend = GraphBackend(cfg, self.device, mesh=mesh)
            self.backend.mark = self.timer.mark

    def warmup(self):
        """Build the kernel library (on a CUDA device) and run every
        map-step variant the run will meet once on empty buffers: each
        flag set of `_add_scan_target_mom` with and without a lattice,
        the from-scratch lattice, the close path's `_concat` and voxel
        filter, and the standalone `_append` and interior pass of a new
        submap's seeding; so that a timed run pays no first-launch
        cost. The map is left as it was; the kernels' launches count."""
        from ndt_slam_tpu_torch.mapping.dynamic import process_interior_scan
        from ndt_slam_tpu_torch.mapping.pointcloud_map import (
            _add_scan_target_mom, _append, _concat, _rebuild_mom,
        )
        from ndt_slam_tpu_torch.ndt import kernels

        cfg, dev = self.cfg, self.device
        if dev.type == "cuda":
            kernels._load()
        scan = PointBuffer.empty(cfg.max_scan_points, dev)
        proc = PointBuffer.empty(cfg.max_submap_points, dev)
        none = PointBuffer.empty(1, dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        B = cfg.resolved_grid_mom_cells
        mom = torch.zeros((B * B, 6), dtype=torch.float32, device=dev)
        anchor = torch.zeros((2,), dtype=torch.int32, device=dev)
        common = dict(
            filtered=cfg.ndt_target_filtered, cap_sub=cfg.max_submap_points,
            cap_local=cfg.max_local_map_points, resol=cfg.diff_resol,
            thre=cfg.thre_neighbor, leaf=cfg.submap_leaf_size,
            mom_cells=B, grid_res=cfg.ndt_resolution,
        )
        variants = ([(True, False, True), (False, False, True),
                     (False, True, True)] if cfg.remove_moving
                    else [(True, False, False)])
        for has_prev in (False, True):
            prev = proc if has_prev else none
            for ap, di, inc in variants:
                for m, a in ((None, None), (mom, anchor)):
                    _add_scan_target_mom(
                        proc, zero, scan, scan, scan, prev, m, a,
                        append_scan=ap, do_interior=di, include_newest=inc,
                        has_prev=has_prev, **common)
            _rebuild_mom(prev, proc, anchor, mom_cells=B,
                         grid_res=cfg.ndt_resolution, has_prev=has_prev)
        c = _concat(proc, scan, cfg.max_submap_points)
        voxel_filter(c, cfg.submap_leaf_size)
        _concat(proc, c, cfg.max_local_map_points)
        _concat(c, none, cfg.max_local_map_points)
        _append(proc, zero, scan)
        if cfg.remove_moving:
            process_interior_scan(scan, scan, scan, cfg.diff_resol,
                                  cfg.thre_neighbor)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

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
            self.last_cov = (cov if self._defer_map else torch.zeros(
                (3, 3), dtype=torch.float32, device=self.device))
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

        prev_odo_dev, last_pose_dev, local = self._frame_inputs()
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

    def _frame_inputs(self):
        """The registration step's device inputs besides the scan and
        the odometry: (prev_odo, last_pose, target). The carries come
        from the device when the last frame left them there, else from
        the host. (The lockstep runner stacks its rows' carries from the
        host and their targets itself.)"""
        local = self.pcmap.registration_target()
        prev_odo_dev = (self._prev_odo_dev if self._prev_odo_dev is not None
                        else torch.from_numpy(self.prev_odo).to(self.device))
        last_pose_dev = (
            self._last_pose_dev if self._last_pose_dev is not None
            else torch.from_numpy(self.pcmap.get_last_pose()).to(self.device)
        )
        return prev_odo_dev, last_pose_dev, local

    def _run_step(self, scan: PointBuffer, odo_dev, prev_odo_dev,
                  last_pose_dev, local: PointBuffer) -> FrameResult:
        """The frame's registration: against the moment lattice when the
        incremental grid is on, else (and for the one frame after an
        escape, which re-arms the lattice path) against a full
        rebuild."""
        cfg = self.cfg
        if (self.incremental_grid and not self._defer_map
                and not self._force_full_grid):
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

    def _finish_frame(self, out: Optional[FrameResult], small: np.ndarray,
                      scan: PointBuffer, rs_local: np.ndarray,
                      odo: np.ndarray, odo_dev, sid: int,
                      pending=None) -> dict:
        """The frame's bookkeeping after its fetch `small` ([24]): the
        carries, the map, the record, the back end. In batch mode
        (`_defer_map`; `out` and `odo_dev` may be None) the carries stay
        on the host, where the runner stacks them for the next tick, and
        the map update is the runner's `pending` (see `_grow_map`)."""
        fused = small[0:3].copy()
        cov = small[3:12].reshape(3, 3).copy()
        if self._defer_map:
            self.last_cov = cov
            self._last_pose_dev = None
            self._prev_odo_dev = None
            scan_map = pending
        else:
            self.last_cov = out.cov
            self._last_pose_dev = out.fused_pose
            self._prev_odo_dev = odo_dev
            scan_map = PointBuffer(out.global_xy, scan.mask)
        self._grow_map(scan_map, fused, rs_local, scan)
        self.prev_odo = odo
        self.cnt += 1
        self.timer.mark("map")
        rec = self._build_rec(sid, small)
        self._record(fused, cov, rec)
        self._backend_hook(sid, fused, cov, scan, rec)
        return rec

    @staticmethod
    def _build_rec(sid: int, small: np.ndarray) -> dict:
        """A frame's record from its fetched row `small` ([24], the
        layout of `FrameResult.small`); the synchronous and the
        pipelined paths share it."""
        return {
            "sid": sid,
            "cost": float(small[12]),
            "successful": bool(small[13] > 0.5),
            "est_pose": small[17:20].tolist(),
            "fused_pose": small[0:3].tolist(),
            "iterations": int(small[14]),
            "matched": float(small[15]),
            "error_pose": small[20:23].tolist(),
            "trans_probability": float(small[16]),
        }

    def _backend_hook(self, sid: int, fused, cov, scan: PointBuffer,
                      rec: dict) -> bool:
        """The back end's step for one frame: add_frame, the check every
        loop_check_skip frames, and the correction it returns. True when
        a correction rewrote the map (the pipelined path then replays the
        frames it has in flight)."""
        if self.backend is None:
            return False
        self.backend.add_frame(sid, fused, cov, scan)
        if (self.cnt - 1) % max(1, self.cfg.loop_check_skip) == 0:
            t0 = time.perf_counter()
            corrected = self.backend.try_close(sid, fused, scan)
            self.t_backend += time.perf_counter() - t0
            if corrected is not None:
                self._correct(corrected)
                rec["loop_closed"] = True
                return True
        self.timer.mark("backend")
        return False

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
        # the rewrite replayed every recorded scan, this frame's too: a
        # deferred map update is superseded, a stacked copy stale
        self._pending_scan = None
        self._map_rewritten = True

    def _grow_map(self, scan_map_frame, fused_pose: np.ndarray,
                  rs_local: np.ndarray, scan_local: PointBuffer):
        """Pose, map update, last pose and scan, the scan kept for a
        rewrite. In batch mode the map update is left to the runner:
        `scan_map_frame` may then be its ("slot", i) sentinel, and the
        runner restores `last_scan` when it hands the map back."""
        self.pcmap.add_pose(fused_pose)
        if self._defer_map:
            self._pending_scan = scan_map_frame
        else:
            self.pcmap.add_points(scan_map_frame)
        self.pcmap.set_last_pose(fused_pose)
        if isinstance(scan_map_frame, PointBuffer):
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
