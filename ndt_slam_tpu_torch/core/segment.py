"""Segment sums that reduce in a fixed order.

Float `index_add_`/`scatter_add_` on CUDA accumulate with atomics, in
an order that changes from run to run, so the NDT moments and the
voxel centroids would not repeat bit for bit. Here rows are grouped by
a stable sort on the segment id and each segment is summed front to
back (`torch.segment_reduce`), which is the order a sequential
scatter-add over the rows takes. Rows with id == num_segments are
dropped: they sort to the tail, past the last offset.
"""

from __future__ import annotations

import torch


def segment_sum_sorted(rows: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """[num_segments, C] sums of `rows` [N, C] whose ids `seg` [N]
    (in [0, num_segments]) are already nondecreasing."""
    bounds = torch.arange(num_segments + 1, device=seg.device,
                          dtype=seg.dtype)
    offsets = torch.searchsorted(seg, bounds)
    return torch.segment_reduce(
        rows, "sum", offsets=offsets, axis=0, unsafe=True
    )


class SortedSegments:
    """Segment ids `seg` [N] in [0, num_segments], sorted once (stable):
    `sum(rows)` then gives the [num_segments, C] sums of rows [N, C] by
    id, each segment summing its rows in row order, in two operations
    (a gather and the segment reduce). For scatters whose ids stay
    fixed over many calls, such as a pose graph's edge endpoints."""

    def __init__(self, seg: torch.Tensor, num_segments: int):
        sseg, self.order = torch.sort(seg.to(torch.int64), stable=True)
        bounds = torch.arange(num_segments + 1, device=seg.device,
                              dtype=sseg.dtype)
        self.offsets = torch.searchsorted(sseg, bounds)

    def sum(self, rows: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(
            rows.index_select(0, self.order), "sum", offsets=self.offsets,
            axis=0, unsafe=True
        )


def segment_sum(rows: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """[num_segments, C] sums of `rows` [N, C] by id `seg` [N] in
    [0, num_segments]; each segment sums its rows in row order."""
    return SortedSegments(seg, num_segments).sum(rows)
