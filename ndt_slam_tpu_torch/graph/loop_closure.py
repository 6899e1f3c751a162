"""Loop-closure candidate verification: batched coarse-to-fine NDT
(port of `ndt_slam_tpu.graph.loop_closure`).

A candidate is an old keyframe scan, the current scan and an initial
relative pose (old -> current) from the trajectory estimate.
Verification registers the current scan against the old one and
accepts when the overlaps and the trimmed cost pass their gates:

- a resolution ladder (`loop_stage_mults`, 4x -> 2x -> 1x): each stage
  builds its own grid around the initial guess at `mult` times the
  resolution with max(16, cells // mult) cells, and runs the Newton
  solve with `ndt_step_size * mult` and `ndt_trans_eps * min(mult, 2)`;
- at the coarse stage a plus pattern of `loop_coarse_starts` starts
  half a coarse cell apart; the best converged one (lowest objective,
  the first on a tie) goes on;
- trimmed ICP (`ndt/icp.py`) as the precision finisher, then the
  symmetric overlap (the target's points explained by the moved
  source), then the gates and `failed_cost`.

The JAX package runs one candidate's program under `vmap` over the
candidates and, at the coarse stage, over the starts. Here those are
rows: `ndt/solve.align` takes all B x starts rows of a stage at once,
each row against its own candidate's grid through the grid axis of the
window kernels (`compact.GridStack`), and ICP and the overlap take all
B candidates in one batched call of the nearest-neighbour kernel. The
B grids of a stage are built by a loop over the candidates
(`build_grid` and `compact_grid`, about 200 device operations each:
the largest share of a verify's operations, `PERF.md` §5). The gather
engine (`ndt_engine = "gather"`) registers against the B dense windows
themselves: one `build_grid` over the [B,T,2] candidate scans gives a
stacked `NDTGrid`, and no table is compacted, as JAX's `_verify_one`
skips `compact_grid` there.
Nothing waits for the host but the solver's done-flag polls; the
caller fetches a verification as one [B,16] array (`pack_verify_out`).

`make_sharded_verify` shards the candidates over the ranks of a mesh
dimension: each rank verifies its contiguous slice and the packed rows
are gathered in rank order, so every rank holds all B.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core import pose2
from ndt_slam_tpu_torch.core.points import PAD_COORD
from ndt_slam_tpu_torch.ndt.compact import compact_grid, stack_grids
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.icp import icp_refine
from ndt_slam_tpu_torch.ndt.kernels import nn_sq_dists_batched
from ndt_slam_tpu_torch.ndt.score import gauss_constants
from ndt_slam_tpu_torch.ndt.solve import NDTResult, align
from ndt_slam_tpu_torch.parallel.dist import axis


class LoopVerifyOut(NamedTuple):
    rel_pose_rad: torch.Tensor  # [B,3] measured relative pose (old -> cur)
    cost: torch.Tensor          # [B] trimmed mean NN d^2 over matched pts
    overlap: torch.Tensor       # [B] matched-source fraction
    overlap_tgt: torch.Tensor   # [B] matched-TARGET fraction
    accepted: torch.Tensor      # [B] overlap & cost gates & converged
    hessian: torch.Tensor       # [B,3,3] information of the fine stage


@functools.lru_cache(maxsize=None)
def _start_offsets(device: torch.device, half_cell: float,
                   starts: int) -> torch.Tensor:
    """[starts, 3] coarse-stage start offsets on `device`, copied once
    (a host-to-device copy waits for the stream)."""
    h = half_cell
    offs = np.array(
        [[0.0, 0.0, 0.0], [h, 0.0, 0.0], [-h, 0.0, 0.0],
         [0.0, h, 0.0], [0.0, -h, 0.0],
         [h, h, 0.0], [-h, -h, 0.0], [h, -h, 0.0],
         [-h, h, 0.0]][:starts],
        np.float32,
    )
    return torch.from_numpy(offs).to(device)


def verify_candidates(cfg: SlamConfig, src_xy, src_mask, tgt_xy, tgt_mask,
                      init_rel_rad) -> LoopVerifyOut:
    """Batched coarse-to-fine verification of B candidates: the current
    scan `src_xy` [S,2] / `src_mask` [S] (its own frame) against the
    keyframe scans `tgt_xy` [B,T,2] / `tgt_mask` [B,T] (each in its own
    frame) from `init_rel_rad` [B,3]. Runs on the device of the
    tensors: the CUDA kernels on the card, their twins on the CPU."""
    gather = cfg.resolved_ndt_engine == "gather"
    dev = src_xy.device
    b = tgt_xy.shape[0]
    rows = torch.arange(b, dtype=torch.int32, device=dev)
    res = cfg.ndt_resolution
    pose = init_rel_rad.to(torch.float32)
    center = pose[:, :2]
    rf = None
    for si, mult in enumerate(cfg.loop_stage_mults):
        nxs = max(16, cfg.grid_cells_x // mult)
        nys = max(16, cfg.grid_cells_y // mult)
        if gather:
            gs = build_grid(tgt_xy, tgt_mask, center, nxs, nys, res * mult,
                            min_pts=cfg.ndt_min_points_per_cell)
        else:
            gs = stack_grids([
                compact_grid(build_grid(tgt_xy[k], tgt_mask[k], center[k],
                                        nxs, nys, res * mult,
                                        min_pts=cfg.ndt_min_points_per_cell),
                             cfg.ndt_max_active_cells)
                for k in range(b)])
        d1s, d2s = gauss_constants(res * mult, cfg.ndt_outlier_ratio)
        kw = dict(max_iterations=(cfg.loop_stage_max_iterations
                                  or cfg.ndt_max_iterations),
                  step_size=cfg.ndt_step_size * mult,
                  trans_eps=cfg.ndt_trans_eps * min(mult, 2),
                  radius=cfg.ndt_neighborhood)
        if si == 0 and cfg.loop_coarse_starts > 1:
            # multi-start: the coarse grid's quantized landscape has local
            # minima about half a cell from the optimum
            offs = _start_offsets(dev, res * mult * 0.5,
                                  cfg.loop_coarse_starts)
            n_starts = offs.shape[0]
            starts = (pose[:, None, :] + offs[None, :, :]).reshape(-1, 3)
            rs = align(starts, src_xy, src_mask, gs, d1s, d2s,
                       grid_index=rows.repeat_interleave(n_starts), **kw)
            # lower objective = better match; unusable starts ranked last
            score = torch.where(rs.converged, rs.objective, float("inf"))
            pick = (rows.to(torch.int64) * n_starts
                    + torch.argmin(score.reshape(b, n_starts), dim=1))
            rf = NDTResult(*(f.index_select(0, pick) for f in rs))
        else:
            rf = align(pose, src_xy, src_mask, gs, d1s, d2s,
                       grid_index=rows, **kw)
        pose = rf.pose_rad

    icp = icp_refine(pose, src_xy, src_mask, tgt_xy, tgt_mask,
                     match_dist=cfg.loop_match_dist, iterations=10)
    overlap = icp.matched_frac

    # symmetric consistency: the target's points must be explained by
    # the moved source too
    pose_deg = pose2.pose_rad_to_deg(icp.pose_rad)
    src_map = pose2.global_points(pose_deg, src_xy)              # [B,S,2]
    src_map = torch.where(src_mask[:, None], src_map, PAD_COORD)
    smask = src_mask[None, :].expand(b, -1).contiguous()
    d2_t = nn_sq_dists_batched(tgt_xy, tgt_mask, src_map, smask)
    n_t = torch.clamp(tgt_mask.sum(dim=-1, dtype=torch.float32), min=1.0)
    hit_t = tgt_mask & (d2_t <= cfg.loop_match_dist ** 2)
    overlap_tgt = hit_t.sum(dim=-1, dtype=torch.float32) / n_t

    cost = torch.where(rf.converged, icp.mean_sq_err, cfg.failed_cost)
    accepted = (
        rf.converged
        & (overlap >= cfg.loop_min_overlap)
        & (overlap_tgt >= cfg.loop_min_overlap)
        & (cost <= cfg.loop_score_thre)
    )
    return LoopVerifyOut(
        rel_pose_rad=icp.pose_rad, cost=cost, overlap=overlap,
        overlap_tgt=overlap_tgt, accepted=accepted, hessian=rf.hessian,
    )


def pack_verify_out(out: LoopVerifyOut) -> torch.Tensor:
    """LoopVerifyOut -> one [B,16] float32 array, so that a
    verification's results come to the host in one copy. Layout
    (`unpack_verify_row`): rel(3) cost overlap overlap_tgt accepted
    hessian(9)."""
    return torch.cat([
        out.rel_pose_rad,
        out.cost[:, None],
        out.overlap[:, None],
        out.overlap_tgt[:, None],
        out.accepted.to(torch.float32)[:, None],
        out.hessian.reshape(-1, 9),
    ], dim=1)


def unpack_verify_rows(packed: torch.Tensor) -> LoopVerifyOut:
    """[B,16] packed rows -> LoopVerifyOut (views, `accepted` bool)."""
    return LoopVerifyOut(
        rel_pose_rad=packed[:, 0:3], cost=packed[:, 3],
        overlap=packed[:, 4], overlap_tgt=packed[:, 5],
        accepted=packed[:, 6] == 1.0,
        hessian=packed[:, 7:16].unflatten(-1, (3, 3)))


def make_sharded_verify(mesh, cfg: SlamConfig, axis_batch: str = "dp"):
    """Candidate verification with the batch sharded over `axis_batch`
    of `mesh`: the multi-rank loop-closure fan-out. The current scan is
    replicated; each rank verifies its contiguous slice of the
    candidates (no collective inside: the candidates are independent)
    and the packed rows are gathered in rank order.

    Returns fn(src_xy [S,2], src_mask [S], tgt_xy [B,T,2], tgt_mask
    [B,T], init_rel_rad [B,3]) -> LoopVerifyOut of all B candidates, the
    same on every rank; every rank passes the whole batch, and B must
    divide by the axis size (pad with masked candidates)."""
    ax = axis(mesh, axis_batch)

    def fn(src_xy, src_mask, tgt_xy, tgt_mask, init_rel_rad):
        out = verify_candidates(cfg, src_xy, src_mask, ax.shard(tgt_xy),
                                ax.shard(tgt_mask), ax.shard(init_rel_rad))
        return unpack_verify_rows(ax.gather(pack_verify_out(out)))
    return fn


def unpack_verify_row(row: np.ndarray):
    """[16] packed row -> (rel_pose_rad[3], cost, overlap, overlap_tgt,
    accepted, hessian[3,3]) host values."""
    return (
        row[0:3].astype(np.float32),
        float(row[3]),
        float(row[4]),
        float(row[5]),
        bool(row[6] == 1.0),
        row[7:16].reshape(3, 3).astype(np.float64),
    )


def relative_pose_deg(pose_a_deg, pose_b_deg):
    """b expressed in a's frame, degrees (init guess for verification)."""
    return pose2.cal_motion(pose_b_deg, pose_a_deg)
