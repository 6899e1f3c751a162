"""Voxel-grid downsampling as a stable sort + fixed-order segment means.

Port of `ndt_slam_tpu.mapping.voxel` (an exact replacement for
pcl::ApproximateVoxelGrid). Points are keyed by their voxel, sorted
stably, and reduced to per-voxel centroids; centroid k lands in slot k.

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
    """One centroid per occupied voxel; output capacity == input's."""
    n = buf.capacity
    keys = voxel_keys(buf.xy, buf.mask, leaf)
    skeys, order = torch.sort(keys, stable=True)
    sxy = buf.xy.index_select(0, order)
    svalid = skeys != SENTINEL

    first = svalid & torch.cat(
        [torch.ones(1, dtype=torch.bool, device=keys.device),
         skeys[1:] != skeys[:-1]]
    )
    seg = torch.cumsum(first.to(torch.int64), 0) - 1      # [-1 .. nseg-1]
    seg = torch.where(svalid, torch.clamp(seg, 0, n - 1), n)  # drop invalid

    ones = svalid.to(buf.xy.dtype)
    rows = torch.stack(
        [ones,
         torch.where(svalid, sxy[:, 0], 0.0),
         torch.where(svalid, sxy[:, 1], 0.0)],
        dim=-1,
    )
    acc = segment_sum_sorted(rows, seg, n)
    cnt, sx, sy = acc[:, 0], acc[:, 1], acc[:, 2]

    valid = cnt > 0
    d = torch.clamp(cnt, min=1.0)
    xy = torch.stack([sx / d, sy / d], dim=-1)
    xy = torch.where(valid[:, None], xy, PAD_COORD)
    return PointBuffer(xy, valid)
