"""Trimmed point-to-point ICP refinement (port of `ndt_slam_tpu.ndt.icp`).

The precision finisher of loop-closure verification
(`graph/loop_closure.py`): the NDT ladder gives the wide basin, ICP the
unbiased metric alignment and the overlap and error the gates read.
Each iteration takes the nearest valid target of every source point,
keeps the pairs closer than `match_dist`, and applies the closed-form
weighted Procrustes update; 10 fixed iterations, then the matched
fraction and the trimmed mean squared distance.

Here it runs over a batch axis: B candidate poses and B target scans
against one source scan, all rows in every operation. The nearest
neighbours come from `kernels.nn_argmin` (the argmin form of the CUDA
nearest-neighbour kernel on the card, its plain twin on the CPU), in
the difference form; the JAX package takes them as a matmul at
`Precision.HIGHEST`, so the two agree by result, not index by index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndt_slam_tpu_torch.ndt.fitness import BIG
from ndt_slam_tpu_torch.ndt.kernels import nn_argmin, nn_sq_dists_batched


class ICPResult(NamedTuple):
    pose_rad: torch.Tensor      # [B,3]
    matched_frac: torch.Tensor  # [B]
    mean_sq_err: torch.Tensor   # [B] over the matched pairs


def _transform(pose, xy):
    """Points xy [N,2] under poses [...,3] -> [..., N, 2]."""
    c, s = torch.cos(pose[..., 2:3]), torch.sin(pose[..., 2:3])
    x = c * xy[:, 0] - s * xy[:, 1] + pose[..., 0:1]
    y = s * xy[:, 0] + c * xy[:, 1] + pose[..., 1:2]
    return torch.stack([x, y], dim=-1)


def icp_refine(init_pose_rad, src_xy, src_mask, tgt_xy, tgt_mask,
               match_dist: float = 0.4, iterations: int = 10) -> ICPResult:
    """Trimmed ICP of the source scan (`src_xy` [N,2], `src_mask` [N])
    against B targets (`tgt_xy` [B,M,2], `tgt_mask` [B,M]) from
    `init_pose_rad` [B,3]."""
    md2 = match_dist * match_dist
    b, n = tgt_xy.shape[0], src_xy.shape[0]
    smask = src_mask[None, :].expand(b, n).contiguous()
    pose = init_pose_rad.to(torch.float32)
    for _ in range(iterations):
        src_w = _transform(pose, src_xy)                        # [B,N,2]
        d2, idx = nn_argmin(src_w, smask, tgt_xy, tgt_mask)
        w = (smask & (d2 < md2)).to(torch.float32)
        tw = tgt_xy.gather(1, idx.to(torch.int64)[..., None].expand(b, n, 2))
        wsum = torch.clamp(w.sum(dim=-1), min=1.0)
        # weighted Procrustes in the CURRENT source frame
        mu_s = (src_w * w[..., None]).sum(dim=1) / wsum[:, None]
        mu_t = (tw * w[..., None]).sum(dim=1) / wsum[:, None]
        ds = src_w - mu_s[:, None, :]
        dt = tw - mu_t[:, None, :]
        sxx = (w * ds[..., 0] * dt[..., 0]).sum(dim=-1)
        sxy = (w * ds[..., 0] * dt[..., 1]).sum(dim=-1)
        syx = (w * ds[..., 1] * dt[..., 0]).sum(dim=-1)
        syy = (w * ds[..., 1] * dt[..., 1]).sum(dim=-1)
        dth = torch.atan2(sxy - syx, sxx + syy)
        c, s = torch.cos(dth), torch.sin(dth)
        # delta transform: rotate about mu_s by dth, translate to mu_t
        dx = mu_t[:, 0] - (c * mu_s[:, 0] - s * mu_s[:, 1])
        dy = mu_t[:, 1] - (s * mu_s[:, 0] + c * mu_s[:, 1])
        # compose onto pose: new = delta o pose
        new_pose = torch.stack([
            c * pose[:, 0] - s * pose[:, 1] + dx,
            s * pose[:, 0] + c * pose[:, 1] + dy,
            pose[:, 2] + dth,
        ], dim=-1)
        ok = w.sum(dim=-1) >= 3.0
        pose = torch.where(ok[:, None], new_pose, pose)

    d2 = nn_sq_dists_batched(_transform(pose, src_xy), smask, tgt_xy,
                             tgt_mask)
    matched = smask & (d2 < md2)
    n_valid = torch.clamp(src_mask.sum(dtype=torch.float32), min=1.0)
    n_match = matched.sum(dim=-1, dtype=torch.float32)
    mse = (torch.where(matched, d2, 0.0).sum(dim=-1)
           / torch.clamp(n_match, min=1.0))
    mse = torch.where(n_match > 0, mse, BIG)
    return ICPResult(pose_rad=pose, matched_frac=n_match / n_valid,
                     mean_sq_err=mse)
