"""Fitness score: mean squared nearest-neighbour distance.

Port of `ndt_slam_tpu.ndt.fitness` (PCL getFitnessScore semantics: no
max-range cutoff, mean over the valid source points). The distances are
taken in the difference form, dx*dx + dy*dy, as the TPU kernel does
(pallas_kernels.py:310-313): the |s|^2+|t|^2-2s.t matmul form would
cancel at map-scale coordinates and, on the card, could meet TF32.

`nn_sq_dists` and `fitness_score_plain` here are the plain twins of
the CUDA NN kernel's two entry points; `fitness_score` goes through
`kernels.fitness_score`, which picks the kernel or the twin by device.
`nn_sq_dists` and `fitness_score_plain` also take a leading batch
dimension (the twins of the kernel's batch axis), and `nn_argmin` adds
the index of the nearest target (the twin of its argmin form, for
`ndt/icp`).
"""

from __future__ import annotations

import torch

BIG = 1.0e12


def _chunk_d2(sx, sy, tgt_xy, lo: int, chunk: int):
    """[..., N, c] squared distances of the sources to targets lo..lo+c,
    in the difference form."""
    t = tgt_xy[..., lo:lo + chunk, :]
    dx = sx - t[..., None, :, 0]
    dy = sy - t[..., None, :, 1]
    return dx * dx + dy * dy


def nn_sq_dists(src_xy, src_mask, tgt_xy, tgt_mask, chunk: int = 4096):
    """Per-source-point squared distance to the nearest valid target.
    [..., N], BIG for masked sources or when no target is valid;
    [B,N,2] sources against [B,M,2] targets give B problems."""
    best = torch.full(src_xy.shape[:-1], BIG, dtype=torch.float32,
                      device=src_xy.device)
    sx, sy = src_xy[..., 0:1], src_xy[..., 1:2]
    for lo in range(0, tgt_xy.shape[-2], chunk):
        d2 = _chunk_d2(sx, sy, tgt_xy, lo, chunk)
        d2 = torch.where(tgt_mask[..., None, lo:lo + chunk], d2, BIG)
        best = torch.minimum(best, d2.amin(dim=-1))
    best = torch.clamp(best, min=0.0)
    return torch.where(src_mask, best, BIG)


def nn_argmin(src_xy, src_mask, tgt_xy, tgt_mask, chunk: int = 4096):
    """(`nn_sq_dists`, the index of the nearest valid target, int32) of
    [B,N,2] sources against [B,M,2] targets.

    The index is the lowest among the valid targets at the least
    distance (JAX's argmin inside a chunk and its strict < across
    chunks, `ndt_slam_tpu/ndt/icp.py:70-73`); a NaN distance is the
    least and the lowest index giving one wins; 0 for a masked source
    and for a source without a valid target. Plain tensor code, the
    twin of the argmin form of the CUDA kernel."""
    best = torch.full(src_xy.shape[:-1], BIG, dtype=torch.float32,
                      device=src_xy.device)
    key_best = torch.full_like(best, float("inf"))
    idx = torch.zeros(best.shape, dtype=torch.int64, device=best.device)
    found = torch.zeros(best.shape, dtype=torch.bool, device=best.device)
    sx, sy = src_xy[..., 0:1], src_xy[..., 1:2]
    for lo in range(0, tgt_xy.shape[-2], chunk):
        d2 = _chunk_d2(sx, sy, tgt_xy, lo, chunk)
        live = tgt_mask[..., None, lo:lo + chunk]
        best = torch.minimum(best, torch.where(live, d2, BIG).amin(dim=-1))
        key = torch.where(live, d2, float("inf"))
        kmin = key.amin(dim=-1)
        hit = live & ((key == kmin[..., None])
                      | (torch.isnan(key) & torch.isnan(kmin)[..., None]))
        any_hit = hit.any(dim=-1)
        take = any_hit & (~found | (kmin < key_best)
                          | (torch.isnan(kmin) & ~torch.isnan(key_best)))
        key_best = torch.where(take, kmin, key_best)
        idx = torch.where(take, lo + hit.to(torch.uint8).argmax(dim=-1), idx)
        found = found | any_hit
    d2 = torch.where(src_mask, torch.clamp(best, min=0.0), BIG)
    idx = torch.where(src_mask & found, idx, 0).to(torch.int32)
    return d2, idx


def fitness_score_plain(src_xy, src_mask, tgt_xy, tgt_mask):
    """`fitness_score` in plain tensor operations, on any device; [B,N,2]
    sources against [B,M,2] targets give B means, each row's the mean of
    that row alone."""
    d2 = nn_sq_dists(src_xy, src_mask, tgt_xy, tgt_mask)
    n = src_mask.sum(dim=-1, dtype=torch.float32)
    have_tgt = tgt_mask.any(dim=-1)
    total = torch.sum(torch.where(src_mask, d2, 0.0), dim=-1)
    mean = total / torch.clamp(n, min=1.0)
    return torch.where((n > 0) & have_tgt, mean, BIG)


def fitness_score(src_xy, src_mask, tgt_xy, tgt_mask, axis=None,
                  sharded: str = "sources"):
    """Mean squared NN distance over valid sources; BIG when there are
    no sources or no valid targets. A CUDA tensor goes to the kernel, a
    CPU tensor to `fitness_score_plain`.

    With `axis` (`parallel.dist.Axis`), `sharded` says which buffers are
    this rank's shards:
    - "sources": the sources; each rank scores its shard
      (`kernels.nn_sq_dists`), (total, n) are summed over the axis;
    - "targets": the targets; the per-source minimum is taken over the
      axis;
    - "both": both; the target shards are gathered in rank order first,
      then as "sources".
    Whether any target is valid is the maximum over the axis."""
    from ndt_slam_tpu_torch.ndt import kernels

    if axis is None:
        return kernels.fitness_score(src_xy, src_mask, tgt_xy, tgt_mask)
    if sharded == "both":
        tgt_xy, tgt_mask = axis.gather(tgt_xy), axis.gather(tgt_mask)
        sharded = "sources"
    if sharded not in ("sources", "targets"):
        raise ValueError(f"sharded={sharded!r}: sources, targets or both")
    d2 = kernels.nn_sq_dists(src_xy, src_mask, tgt_xy, tgt_mask)
    if sharded == "targets":
        d2 = axis.min(d2)
    tn = torch.stack([torch.sum(torch.where(src_mask, d2, 0.0)),
                      src_mask.sum(dtype=torch.float32)])
    if sharded == "sources":
        tn = axis.sum(tn)
    have_tgt = axis.max(tgt_mask.any().to(torch.float32)) > 0.0
    total, n = tn[0], tn[1]
    mean = total / torch.clamp(n, min=1.0)
    return torch.where((n > 0) & have_tgt, mean, BIG)
