"""Fitness score: mean squared nearest-neighbour distance.

Port of `ndt_slam_tpu.ndt.fitness` (PCL getFitnessScore semantics: no
max-range cutoff, mean over the valid source points). The distances are
taken in the difference form, dx*dx + dy*dy, as the TPU kernel does
(pallas_kernels.py:310-313): the |s|^2+|t|^2-2s.t matmul form would
cancel at map-scale coordinates and, on the card, could meet TF32.

`nn_sq_dists` and `fitness_score_plain` here are the plain twins of
the CUDA NN kernel's two entry points; `fitness_score` goes through
`kernels.fitness_score`, which picks the kernel or the twin by device.
"""

from __future__ import annotations

import torch

BIG = 1.0e12


def nn_sq_dists(src_xy, src_mask, tgt_xy, tgt_mask, chunk: int = 4096):
    """Per-source-point squared distance to the nearest valid target.
    [N], BIG for masked sources or when no target is valid."""
    best = torch.full((src_xy.shape[0],), BIG, dtype=torch.float32,
                      device=src_xy.device)
    sx, sy = src_xy[:, 0:1], src_xy[:, 1:2]
    for lo in range(0, tgt_xy.shape[0], chunk):
        t = tgt_xy[lo:lo + chunk]
        dx = sx - t[None, :, 0]
        dy = sy - t[None, :, 1]
        d2 = dx * dx + dy * dy
        d2 = torch.where(tgt_mask[None, lo:lo + chunk], d2, BIG)
        best = torch.minimum(best, d2.amin(dim=1))
    best = torch.clamp(best, min=0.0)
    return torch.where(src_mask, best, BIG)


def fitness_score_plain(src_xy, src_mask, tgt_xy, tgt_mask):
    """`fitness_score` in plain tensor operations, on any device."""
    d2 = nn_sq_dists(src_xy, src_mask, tgt_xy, tgt_mask)
    n = src_mask.sum(dtype=torch.float32)
    have_tgt = tgt_mask.any()
    total = torch.sum(torch.where(src_mask, d2, 0.0))
    mean = total / torch.clamp(n, min=1.0)
    return torch.where((n > 0) & have_tgt, mean, BIG)


def fitness_score(src_xy, src_mask, tgt_xy, tgt_mask):
    """Mean squared NN distance over valid sources; BIG when there are
    no sources or no valid targets. A CUDA tensor goes to the kernel, a
    CPU tensor to `fitness_score_plain`."""
    from ndt_slam_tpu_torch.ndt.kernels import fitness_score as routed

    return routed(src_xy, src_mask, tgt_xy, tgt_mask)
