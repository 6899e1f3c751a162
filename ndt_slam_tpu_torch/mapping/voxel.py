"""Voxel-grid downsampling as a stable sort + fixed-order segment means.

Port of `ndt_slam_tpu.mapping.voxel` (an exact replacement for
pcl::ApproximateVoxelGrid). Points are keyed by their voxel, sorted
stably, and reduced to per-voxel centroids; centroid k lands in slot k.

B buffers [B,N] filter in one program (the lockstep batch runner's
source filter and map step), each row as its own call.

Voxel key: cell coords offset by 2^15 into [0, 2^16) each, packed as
(cx << 16) | cy, so |coord| < 32768 cells. The JAX package packs into
uint32 with sentinel 0xFFFFFFFF; here the same values are int64 (torch
supports uint32 only partially), so the sort order is unchanged.
"""

from __future__ import annotations

import torch

from ndt_slam_tpu_torch.core.points import PAD_COORD, PointBuffer
from ndt_slam_tpu_torch.core.segment import segment_sum_sorted

SENTINEL = 0xFFFFFFFF


def voxel_keys(xy, mask, leaf: float):
    """int64 voxel key per point ([..., N]); masked/out-of-range ->
    SENTINEL."""
    c = torch.floor(xy / leaf).to(torch.int32) + 32768
    in_range = ((c >= 0) & (c < 65536)).all(dim=-1)
    key = (c[..., 0].to(torch.int64) << 16) | c[..., 1].to(torch.int64)
    return torch.where(mask & in_range, key, SENTINEL)


def voxel_filter(buf: PointBuffer, leaf: float) -> PointBuffer:
    """One centroid per occupied voxel; output capacity == input's.
    [B,N,2] / [B,N] buffers filter B rows at once, each as its own call.

    One stable sort along the rows and one fixed-order segment sum over
    all of them: row r's voxels are the segments r*(N+1) ..
    r*(N+1) + N - 1 and its invalid points fall in segment r*(N+1) + N,
    which is dropped, so the ids stay nondecreasing."""
    if buf.mask.dim() == 1:
        out = voxel_filter(PointBuffer(buf.xy[None], buf.mask[None]), leaf)
        return PointBuffer(out.xy[0], out.mask[0])
    b, n = buf.mask.shape
    keys = voxel_keys(buf.xy, buf.mask, leaf)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    sxy = buf.xy.gather(1, order[..., None].expand(-1, -1, 2))
    svalid = skeys != SENTINEL

    first = svalid & torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=keys.device),
         skeys[:, 1:] != skeys[:, :-1]], dim=1)
    seg = torch.cumsum(first.to(torch.int64), 1) - 1      # [-1 .. nseg-1]
    seg = torch.where(svalid, torch.clamp(seg, 0, n - 1), n)
    seg = seg + (torch.arange(b, device=keys.device) * (n + 1))[:, None]

    ones = svalid.to(buf.xy.dtype)
    rows = torch.stack(
        [ones,
         torch.where(svalid, sxy[..., 0], 0.0),
         torch.where(svalid, sxy[..., 1], 0.0)],
        dim=-1,
    )
    acc = segment_sum_sorted(rows.reshape(-1, 3), seg.reshape(-1),
                             b * (n + 1)).reshape(b, n + 1, 3)[:, :n]
    cnt, sx, sy = acc[..., 0], acc[..., 1], acc[..., 2]

    valid = cnt > 0
    d = torch.clamp(cnt, min=1.0)
    xy = torch.stack([sx / d, sy / d], dim=-1)
    xy = torch.where(valid[..., None], xy, PAD_COORD)
    return PointBuffer(xy, valid)
