"""Sharded NDT registration: the multi-rank compute path (port of
`ndt_slam_tpu.parallel.register`).

The per-frame math of the single-device step, run by every rank of a
mesh on its shards:

- the point buffers (registration target and source) are sharded over
  the "pt" dimension: each rank scatters its target shard into partial
  cell moments, one collective sums them, and every rank finalizes the
  same grid (`ndt/grid.py`, `axis=`);
- the Newton solve runs in lockstep: the partial score, gradient,
  Hessian, matched count and line-search scores are summed over "pt"
  (`ndt/solve.align`, `axis=`), so every rank takes the same step;
- fitness gathers the target shards once and sums the partial sums
  (`ndt/fitness.fitness_score`, `sharded="both"`);
- independent pairs or frames are further sharded over "dp".

Each `make_*` is a function of (mesh, cfg) that returns a callable on
this rank's shards (`parallel.dist.shard` cuts them): a [B, N, 2]
buffer sharded ("dp", "pt") is the rank's [B/dp, N/pt, 2] block. Every
output is the same on the ranks of a "pt" group, bit for bit; a batched
output holds this rank's "dp" rows. Buffer capacities must divide the
axis sizes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core import pose2
from ndt_slam_tpu_torch.core.points import PAD_COORD
from ndt_slam_tpu_torch.fuse.ekf import gate_and_fuse
from ndt_slam_tpu_torch.ndt.compact import compact_grid
from ndt_slam_tpu_torch.ndt.fitness import fitness_score
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.score import gauss_constants
from ndt_slam_tpu_torch.ndt.solve import NDTResult, align
from ndt_slam_tpu_torch.parallel.dist import Axis, axis


class RegisterOut(NamedTuple):
    pose_rad: torch.Tensor    # [3] (or [B,3]) converged pose
    cost: torch.Tensor        # fitness (failed_cost when unusable)
    converged: torch.Tensor   # bool
    iterations: torch.Tensor  # int32
    matched: torch.Tensor     # float32
    hessian: torch.Tensor     # [3,3] objective Hessian at the optimum


def _solve(cfg: SlamConfig, ax: Axis, src_xy, src_mask, tgt_xy, tgt_mask,
           init_pose_rad, center) -> NDTResult:
    """Grid over the target shards, then the Newton solve of the source
    shard, both summed over `ax`."""
    grid = build_grid(tgt_xy, tgt_mask, center, cfg.grid_cells_x,
                      cfg.grid_cells_y, cfg.ndt_resolution,
                      min_pts=cfg.ndt_min_points_per_cell, axis=ax)
    if cfg.resolved_ndt_engine != "gather":
        # the same (summed) grid on every rank -> the same table
        grid = compact_grid(grid, cfg.ndt_max_active_cells)
    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)
    return align(init_pose_rad, src_xy, src_mask, grid, d1, d2,
                 max_iterations=cfg.ndt_max_iterations,
                 step_size=cfg.ndt_step_size, trans_eps=cfg.ndt_trans_eps,
                 radius=cfg.ndt_neighborhood, axis=ax)


def _fitness(cfg: SlamConfig, ax: Axis, r: NDTResult, src_xy, src_mask,
             tgt_xy, tgt_mask):
    """(pose in degrees, cost): fitness of the source shard at the
    solved pose against the gathered target, failed_cost when the solve
    is unusable."""
    pose_deg = pose2.pose_rad_to_deg(r.pose_rad)
    src_map = pose2.global_points(pose_deg, src_xy)
    src_map = torch.where(src_mask[:, None], src_map, PAD_COORD)
    fit = fitness_score(src_map, src_mask, tgt_xy, tgt_mask, axis=ax,
                        sharded="both")
    return pose_deg, torch.where(r.converged, fit, cfg.failed_cost)


def _register_core(cfg: SlamConfig, ax: Axis, src_xy, src_mask, tgt_xy,
                   tgt_mask, init_pose_rad, center) -> RegisterOut:
    """One NDT registration, sharded over `ax` (the registration slice
    of `pipeline/frontend._registration_step`)."""
    r = _solve(cfg, ax, src_xy, src_mask, tgt_xy, tgt_mask, init_pose_rad,
               center)
    _, cost = _fitness(cfg, ax, r, src_xy, src_mask, tgt_xy, tgt_mask)
    return RegisterOut(pose_rad=r.pose_rad, cost=cost, converged=r.converged,
                       iterations=r.iterations, matched=r.matched,
                       hessian=r.hessian)


def _stack_rows(outs):
    return type(outs[0])(*(torch.stack(f) for f in zip(*outs)))


def make_sharded_register(mesh, cfg: SlamConfig, axis_points: str = "pt"):
    """Single-pair registration with the point buffers sharded over
    `axis_points`. Returns fn(src_xy, src_mask, tgt_xy, tgt_mask,
    init_pose_rad [3], center [2]) -> RegisterOut, the same on every
    rank; the buffers are this rank's shards."""
    ax = axis(mesh, axis_points)

    def fn(src_xy, src_mask, tgt_xy, tgt_mask, init_pose_rad, center):
        return _register_core(cfg, ax, src_xy, src_mask, tgt_xy, tgt_mask,
                              init_pose_rad, center)
    return fn


def make_batch_register(mesh, cfg: SlamConfig, axis_batch: str = "dp",
                        axis_points: str = "pt"):
    """Batched pair registration: pairs sharded over `axis_batch`, each
    pair's points over `axis_points` (the loop-closure verification
    workload: independent across pairs). Returns fn(src_xy [b,n,2],
    src_mask [b,n], tgt_xy [b,m,2], tgt_mask [b,m], init_pose_rad [b,3],
    center [b,2]) -> RegisterOut of this rank's b = B/dp rows, each
    computed on its own."""
    ax = axis(mesh, axis_points)

    def fn(src_xy, src_mask, tgt_xy, tgt_mask, init_pose_rad, center):
        return _stack_rows([
            _register_core(cfg, ax, src_xy[i], src_mask[i], tgt_xy[i],
                           tgt_mask[i], init_pose_rad[i], center[i])
            for i in range(src_xy.shape[0])])
    return fn


class SeqStepOut(NamedTuple):
    """Outputs of the sharded sequential frame step, the same on every
    rank; the fields of `pipeline/frontend.FrameResult` (global_xy is
    the raw scan in the map frame at the fused pose) and the packed
    [24] row of `FrameResult.small`."""
    est_pose: torch.Tensor
    fused_pose: torch.Tensor
    cov: torch.Tensor
    cost: torch.Tensor
    successful: torch.Tensor
    iterations: torch.Tensor
    matched: torch.Tensor
    error_pose: torch.Tensor
    trans_probability: torch.Tensor
    global_xy: torch.Tensor
    packed: torch.Tensor


def make_sharded_sequential_step(mesh, cfg: SlamConfig,
                                 axis_points: str = "pt"):
    """One frame of the sequential loop with the point buffers (the
    voxel-filtered source and the registration target) sharded over
    `axis_points`: `_registration_step` without the source voxel filter,
    which the caller runs replicated first. The accept / fuse tail is
    `fuse/ekf.gate_and_fuse`, shared with the single-device step; the
    map-frame scan and the packed row are computed on every rank.

    Returns fn(src_xy, src_mask, odo, prev_odo, last_pose, last_cov,
    tgt_xy, tgt_mask, scan_xy, scan_mask) -> SeqStepOut: src and tgt
    are this rank's shards, the rest replicated (scan_xy / scan_mask the
    raw padded scan)."""
    from ndt_slam_tpu_torch.pipeline.frontend import FrameResult

    ax = axis(mesh, axis_points)

    def fn(src_xy, src_mask, odo, prev_odo, last_pose, last_cov, tgt_xy,
           tgt_mask, scan_xy, scan_mask):
        odo_motion = pose2.cal_motion(odo, prev_odo)
        pred_pose = pose2.cal_pred_pose(odo_motion, last_pose)
        r = _solve(cfg, ax, src_xy, src_mask, tgt_xy, tgt_mask,
                   pose2.pose_deg_to_rad(pred_pose), pred_pose[:2])
        est_pose, cost = _fitness(cfg, ax, r, src_xy, src_mask, tgt_xy,
                                  tgt_mask)
        fused, cov, accept = gate_and_fuse(
            cfg, pred_pose, est_pose, r.hessian, cost, odo_motion,
            last_pose, last_cov)
        error_pose = pose2.cal_global_motion(fused, odo)
        # trans_probability needs the whole source count
        n_src = ax.sum(src_mask.sum(dtype=torch.float32))
        tprob = -r.objective / torch.clamp(n_src, min=1.0)
        g = pose2.global_points(fused, scan_xy)
        g = torch.where(scan_mask[:, None], g, PAD_COORD)
        res = FrameResult(
            est_pose=est_pose, fused_pose=fused, cov=cov, cost=cost,
            successful=accept, iterations=r.iterations, matched=r.matched,
            global_xy=g, error_pose=error_pose, trans_probability=tprob,
            grid_ok=torch.ones((), dtype=torch.float32,
                               device=src_xy.device))
        return SeqStepOut(
            est_pose=est_pose, fused_pose=fused, cov=cov, cost=cost,
            successful=accept, iterations=r.iterations, matched=r.matched,
            error_pose=error_pose, trans_probability=tprob, global_xy=g,
            packed=res.small())
    return fn


class FrameStepOut(NamedTuple):
    est_pose: torch.Tensor    # [B,3] NDT pose (deg)
    fused_pose: torch.Tensor  # [B,3] Kalman-fused pose (deg)
    cov: torch.Tensor         # [B,3,3]
    cost: torch.Tensor        # [B]
    successful: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B]


def make_sharded_frame_step(mesh, cfg: SlamConfig, axis_batch: str = "dp",
                            axis_points: str = "pt"):
    """The whole per-frame step, batched and sharded: odometry
    prediction, sharded registration, fitness accept / reject, the NDT
    covariance from the Hessian and the Kalman fusion, for independent
    frames. "dp" shards the frames, "pt" every point buffer.

    Returns fn(src_xy [b,n,2], src_mask, tgt_xy [b,m,2], tgt_mask,
    odo_pose [b,3], prev_odo, last_pose, last_cov [b,3,3]) ->
    FrameStepOut of this rank's b = B/dp rows (src: the voxel-filtered
    source)."""
    ax = axis(mesh, axis_points)

    def one(src_xy, src_mask, tgt_xy, tgt_mask, odo_pose, prev_odo,
            last_pose, last_cov):
        odo_motion = pose2.cal_motion(odo_pose, prev_odo)
        pred_pose = pose2.cal_pred_pose(odo_motion, last_pose)
        r = _register_core(cfg, ax, src_xy, src_mask, tgt_xy, tgt_mask,
                           pose2.pose_deg_to_rad(pred_pose), pred_pose[:2])
        est_pose = pose2.pose_rad_to_deg(r.pose_rad)
        fused, cov, successful = gate_and_fuse(
            cfg, pred_pose, est_pose, r.hessian, r.cost, odo_motion,
            last_pose, last_cov)
        return FrameStepOut(est_pose=est_pose, fused_pose=fused, cov=cov,
                            cost=r.cost, successful=successful,
                            iterations=r.iterations)

    def fn(*rows):
        return _stack_rows([one(*(t[i] for t in rows))
                            for i in range(rows[0].shape[0])])
    return fn
