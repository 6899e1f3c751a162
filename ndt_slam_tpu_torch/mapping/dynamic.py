"""Dynamic-object removal primitives (port of
`ndt_slam_tpu.mapping.dynamic`).

- `occupancy_diff_mask`: points of `test` whose `resol`-voxel no `base`
  point occupies, by a binary search over sorted base voxel keys.
- `keep_far_from_mask`: points at least `thre` away from every
  candidate, through the nearest-neighbour pass
  (`kernels.nn_sq_dists_batched`: the CUDA NN kernel on the card, its
  difference-form twin on the CPU).
- `process_interior_scan`: candidates = diff(prev ∪ next -> cur); keep
  the cur points at least `thre_neighbor` away from every candidate.

Each takes leading batch dimensions ([B,N,2] points, [B,N] masks: B
independent problems, the JAX package's `vmap` of the pass over a
rebuilt submap's windows); a batch goes through the batch axis of the
nearest-neighbour kernel in one call, and "no candidate" is decided
row by row. A single scan is a batch of one.
"""

from __future__ import annotations

import torch

from ndt_slam_tpu_torch.core.points import PAD_COORD, PointBuffer
from ndt_slam_tpu_torch.mapping.voxel import SENTINEL, voxel_keys
from ndt_slam_tpu_torch.ndt.kernels import nn_sq_dists_batched


def occupancy_diff_mask(base_xy, base_mask, test_xy, test_mask,
                        resol: float):
    """Mask over `test`: True where the point's voxel is NOT occupied in
    `base` (the point "appeared": a moving-object candidate)."""
    bkeys = torch.sort(voxel_keys(base_xy, base_mask, resol)).values
    tkeys = voxel_keys(test_xy, test_mask, resol)
    pos = torch.searchsorted(bkeys, tkeys)
    pos = torch.clamp(pos, 0, bkeys.shape[-1] - 1)
    in_base = (bkeys.gather(-1, pos) == tkeys) & (tkeys != SENTINEL)
    return test_mask & ~in_base


def keep_far_from_mask(pts_xy, pts_mask, cand_xy, cand_mask, thre: float):
    """Mask over `pts`: True where the distance to every valid candidate
    is >= thre (all kept when there is no candidate)."""
    if pts_xy.dim() == 2:
        return keep_far_from_mask(pts_xy[None], pts_mask[None],
                                  cand_xy[None], cand_mask[None], thre)[0]
    d2 = nn_sq_dists_batched(pts_xy, pts_mask, cand_xy, cand_mask)
    no_cand = ~cand_mask.any(dim=-1, keepdim=True)
    return pts_mask & (no_cand | (d2 >= thre * thre))


def process_interior_scan(prev: PointBuffer, cur: PointBuffer,
                          nxt: PointBuffer, resol: float,
                          thre_neighbor: float) -> PointBuffer:
    """Dynamic-removal pass for one interior scan of a submap."""
    base_xy = torch.cat([prev.xy, nxt.xy], dim=-2)
    base_mask = torch.cat([prev.mask, nxt.mask], dim=-1)
    cand = occupancy_diff_mask(base_xy, base_mask, cur.xy, cur.mask, resol)
    cand_xy = torch.where(cand[..., None], cur.xy, PAD_COORD)
    keep = keep_far_from_mask(cur.xy, cur.mask, cand_xy, cand, thre_neighbor)
    xy = torch.where(keep[..., None], cur.xy, PAD_COORD)
    return PointBuffer(xy, keep)
