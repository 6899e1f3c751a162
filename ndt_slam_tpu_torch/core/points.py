"""Fixed-capacity masked point buffers.

Every point set is an (xy [N,2] float32, mask [N] bool) pair of fixed
capacity, as in `ndt_slam_tpu.core.points`. Invalid slots hold a
far-away sentinel coordinate so they can never win a nearest-neighbour
search or fall in a valid NDT cell.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Sentinel for padded slots: far outside any realistic map.
PAD_COORD = 1.0e8


class PointBuffer(NamedTuple):
    """One buffer, or [B] leading both fields for B buffers of one
    capacity."""
    xy: torch.Tensor    # [N, 2] float32
    mask: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @staticmethod
    def empty(capacity: int, device) -> "PointBuffer":
        return PointBuffer(
            xy=torch.full((capacity, 2), PAD_COORD, dtype=torch.float32,
                          device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


def pad_points(xy: np.ndarray, capacity: int, device) -> PointBuffer:
    """Pad a host [n,2] array to `capacity` (truncating if over) and
    move it to `device` in one host-to-device copy."""
    xy = np.asarray(xy, dtype=np.float32).reshape(-1, 2)
    n = min(xy.shape[0], capacity)
    out = np.full((capacity, 2), PAD_COORD, dtype=np.float32)
    out[:n] = xy[:n]
    dev_xy = torch.from_numpy(out).to(device)
    mask = torch.arange(capacity, device=device) < n
    return PointBuffer(dev_xy, mask)


def sanitize(buf: PointBuffer) -> PointBuffer:
    """Force padded slots to the sentinel coordinate."""
    xy = torch.where(buf.mask[..., None], buf.xy, PAD_COORD)
    return PointBuffer(xy, buf.mask)


def compact(buf: PointBuffer) -> PointBuffer:
    """Move valid points to the front (stable), padding the tail; row by
    row for [B,N] buffers."""
    order = torch.sort((~buf.mask).to(torch.int8), dim=-1,
                       stable=True).indices
    if buf.mask.dim() == 1:
        xy = buf.xy.index_select(0, order)
        mask = buf.mask.index_select(0, order)
    else:
        xy = buf.xy.gather(-2, order[..., None].expand(*order.shape, 2))
        mask = buf.mask.gather(-1, order)
    xy = torch.where(mask[..., None], xy, PAD_COORD)
    return PointBuffer(xy, mask)


def concat_buffers(a: PointBuffer, b: PointBuffer,
                   capacity: int) -> PointBuffer:
    """Valid points of `a` first, then of `b`, in a `capacity` buffer;
    overflow is dropped."""
    xy = torch.cat([a.xy, b.xy], dim=0)
    mask = torch.cat([a.mask, b.mask], dim=0)
    c = compact(PointBuffer(xy, mask))
    return PointBuffer(c.xy[:capacity], c.mask[:capacity])


def from_host_list(points, capacity: int, device) -> PointBuffer:
    """`pad_points` of a host list (or array) of [x, y] points."""
    return pad_points(np.asarray(points, dtype=np.float32), capacity, device)
