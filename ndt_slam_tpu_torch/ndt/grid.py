"""NDT grid construction: per-cell mean/covariance over a dense 2D window.

Port of `ndt_slam_tpu.ndt.grid`. The window is a fixed nx*ny block of
cells recentered every frame on the predicted pose. Moments are summed
in cell-relative coordinates (each point minus its own cell's lower
corner), so the covariance's sum-of-squares cancellation stays exact to
f32 roundoff at map-scale coordinates. The moment scatter reduces in a
fixed order (core/segment.py), so a run on the card repeats bit for
bit. Near-singular covariances are inflated like PCL's
VoxelGridCovariance (lambda_min floored at 0.01 lambda_max); cells with
fewer than `min_pts` points are invalid.

Two ways to the same grid. `build_grid` rescatters the whole target
buffer into the frame's window; it also takes B target buffers
[B,L,2] and B window centers [B,2] (the lockstep batch runner, one
sequence a row): one stable sort keyed by (row, cell) and the same
front-to-back segment sums, so a row gets the bits of its own call. The incremental lattice keeps running
moments instead: `moments_abs` keys cells by the absolute index
floor(x / resolution), independent of any window origin, so moments of
successive scans add up in a lattice wider than the window, and
`window_grid_from_lattice` cuts the frame's window out of it. A point
lands in the same cell with the same cell-relative coordinates either
way; the two grids differ only in f32 summation order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ndt_slam_tpu_torch.core.segment import segment_sum


class NDTGrid(NamedTuple):
    """One window, or [B] leading every tensor for B windows (a stacked
    grid: `origin` [B,2], one nx, ny and resolution for all)."""
    origin: torch.Tensor    # [2] lower-left corner of the window (world)
    mean: torch.Tensor      # [C, 2] per-cell mean
    inv_cov: torch.Tensor   # [C, 2, 2] per-cell inverse covariance
    valid: torch.Tensor     # [C] bool
    nx: int
    ny: int
    resolution: float


def _inflate_and_invert(cov: torch.Tensor, eig_mult: float = 0.01):
    """Per-cell 2x2: floor lambda_min at eig_mult*lambda_max, invert.
    cov: [...,C,2,2] symmetric. Returns ([...,C,2,2] inverse, [...,C] ok
    flag)."""
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    c = cov[..., 1, 1]
    tr_half = 0.5 * (a + c)
    det_root = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    lam1 = tr_half + det_root  # lambda_max
    lam2 = tr_half - det_root  # lambda_min

    # eigenvector for lam1 (b ~ 0: axis-aligned)
    use_b = torch.abs(b) > 1e-12
    v1x = torch.where(use_b, lam1 - c, torch.where(a >= c, 1.0, 0.0))
    v1y = torch.where(use_b, b, torch.where(a >= c, 0.0, 1.0))
    nrm = torch.sqrt(v1x * v1x + v1y * v1y)
    v1x = v1x / torch.clamp(nrm, min=1e-20)
    v1y = v1y / torch.clamp(nrm, min=1e-20)
    v2x, v2y = -v1y, v1x

    lam1_f = torch.clamp(lam1, min=1e-12)
    lam2_f = torch.maximum(lam2, eig_mult * lam1_f)

    ia = lam1_f * v1x * v1x + lam2_f * v2x * v2x
    ib = lam1_f * v1x * v1y + lam2_f * v2x * v2y
    ic = lam1_f * v1y * v1y + lam2_f * v2y * v2y
    det = ia * ic - ib * ib
    ok = det > 1e-20
    inv_det = torch.where(ok, 1.0 / torch.clamp(det, min=1e-20), 0.0)
    inv = torch.stack(
        [
            torch.stack([ic * inv_det, -ib * inv_det], dim=-1),
            torch.stack([-ib * inv_det, ia * inv_det], dim=-1),
        ],
        dim=-2,
    )
    return inv, ok


def grid_origin(center: torch.Tensor, nx: int, ny: int, resolution: float):
    """Window origin centered on `center` ([2], or [B,2]), snapped to the
    cell lattice."""
    # the half extents as f32 products, like the JAX package's
    # f32 [nx, ny] * (resolution / 2) (no host-to-device copy)
    hx = float(np.float32(nx) * np.float32(resolution / 2.0))
    hy = float(np.float32(ny) * np.float32(resolution / 2.0))
    corner = torch.stack([center[..., 0] - hx, center[..., 1] - hy], dim=-1)
    return torch.floor(corner / resolution) * resolution


def grid_moments(xy, mask, origin, nx: int, ny: int, resolution: float,
                 axis=None):
    """Per-cell (count, sx, sy, sxx, sxy, syy), each [nx*ny]; B rows
    ([B,L,2] points, [B,L] masks, [B,2] origins) give [B, nx*ny] each,
    from one segment sum keyed by (row, cell).

    The moments are additive: with `axis` (`parallel.dist.Axis`) `xy` is
    this rank's shard of the target and the partial moments are summed
    over the axis in one collective before `grid_finalize`. The cell
    corners they are relative to depend on the cell and the origin only,
    so the partials add up on every rank."""
    num_cells = nx * ny
    org = origin[..., None, :]
    rel = (xy - org) / resolution
    ci = torch.floor(rel).to(torch.int32)
    in_bounds = (
        (ci[..., 0] >= 0) & (ci[..., 0] < nx) & (ci[..., 1] >= 0)
        & (ci[..., 1] < ny)
    )
    ok = mask & in_bounds
    cid = ci[..., 0] * ny + ci[..., 1]
    rows_b = xy.shape[0] if xy.dim() == 3 else 1
    if xy.dim() == 3:
        # row r's cells are segments r*num_cells .. (r+1)*num_cells - 1
        cid = cid + (torch.arange(rows_b, dtype=torch.int32,
                                  device=xy.device) * num_cells)[:, None]
    # invalid points go to the dropped segment (id == rows * num_cells)
    cid = torch.where(ok, cid, rows_b * num_cells)
    cx = ci[..., 0].to(xy.dtype) * resolution + org[..., 0]
    cy = ci[..., 1].to(xy.dtype) * resolution + org[..., 1]
    xr = torch.where(ok, xy[..., 0] - cx, 0.0)
    yr = torch.where(ok, xy[..., 1] - cy, 0.0)
    ones = ok.to(xy.dtype)
    rows = torch.stack([ones, xr, yr, xr * xr, xr * yr, yr * yr], dim=-1)
    acc = segment_sum(rows.reshape(-1, 6), cid.reshape(-1),
                      rows_b * num_cells)
    if axis is not None:
        acc = axis.sum(acc)
    acc = acc.reshape(*xy.shape[:-2], num_cells, 6)
    return tuple(acc[..., i] for i in range(6))


def _finalize(moments, corner_x, corner_y, origin, nx: int, ny: int,
              resolution: float, min_pts: int, eig_mult: float) -> NDTGrid:
    """Per-cell mean / inverse covariance from cell-relative moments and
    the cells' lower corners."""
    count, sx, sy, sxx, sxy, syy = moments
    n = torch.clamp(count, min=1.0)
    mx, my = sx / n, sy / n
    # unbiased covariance (PCL divides by n-1)
    nm1 = torch.clamp(count - 1.0, min=1.0)
    cxx = (sxx - count * mx * mx) / nm1
    cxy = (sxy - count * mx * my) / nm1
    cyy = (syy - count * my * my) / nm1
    cov = torch.stack(
        [torch.stack([cxx, cxy], dim=-1), torch.stack([cxy, cyy], dim=-1)],
        dim=-2,
    )
    inv_cov, inv_ok = _inflate_and_invert(cov, eig_mult)
    valid = (count >= min_pts) & inv_ok

    # moments were cell-relative; restore absolute means
    mean = torch.stack([mx + corner_x, my + corner_y], dim=-1)
    # park invalid cells far away so a stray unmasked lookup scores ~0
    mean = torch.where(valid[..., None], mean, 1.0e8)
    inv_cov = torch.where(valid[..., None, None], inv_cov, 0.0)
    return NDTGrid(origin=origin, mean=mean, inv_cov=inv_cov, valid=valid,
                   nx=nx, ny=ny, resolution=resolution)


def grid_finalize(moments, origin, nx: int, ny: int, resolution: float,
                  min_pts: int = 6, eig_mult: float = 0.01) -> NDTGrid:
    """Turn moments into per-cell mean / inverse covariance."""
    cell = torch.arange(nx * ny, dtype=torch.int32, device=origin.device)
    corner_x = ((cell // ny).to(origin.dtype) * resolution
                + origin[..., 0:1])
    corner_y = (cell % ny).to(origin.dtype) * resolution + origin[..., 1:2]
    return _finalize(moments, corner_x, corner_y, origin, nx, ny,
                     resolution, min_pts, eig_mult)


def lattice_anchor(center: torch.Tensor, cells: int, resolution: float):
    """[2] int32 absolute index of the lower-left cell of a `cells`-wide
    window centered on `center` [2]."""
    return torch.floor(center / resolution - cells / 2.0).to(torch.int32)


def moments_abs(xy, mask, anchor, nx: int, ny: int, resolution: float):
    """[nx*ny, 6] moment rows (count, sx, sy, sxx, sxy, syy) of the
    masked points, cells keyed by absolute index minus `anchor` ([2]
    int32). Additive: lattices accumulate by `+` across scans. The
    cell's corner is the cell index times the resolution, the very
    float `_finalize_abs` adds back."""
    num_cells = nx * ny
    ci_abs = torch.floor(xy / resolution).to(torch.int32)
    ci = ci_abs - anchor[None, :]
    ok = (
        mask
        & (ci[:, 0] >= 0) & (ci[:, 0] < nx)
        & (ci[:, 1] >= 0) & (ci[:, 1] < ny)
    )
    cid = torch.where(ok, ci[:, 0] * ny + ci[:, 1], num_cells)
    corner = ci_abs.to(xy.dtype) * resolution
    xr = torch.where(ok, xy[:, 0] - corner[:, 0], 0.0)
    yr = torch.where(ok, xy[:, 1] - corner[:, 1], 0.0)
    ones = ok.to(xy.dtype)
    rows = torch.stack([ones, xr, yr, xr * xr, xr * yr, yr * yr], dim=-1)
    return segment_sum(rows, cid, num_cells)


def window_grid_from_lattice(mom, mom_anchor, bx: int, by: int,
                             frame_anchor, nx: int, ny: int,
                             resolution: float, extra=None,
                             min_pts: int = 6, eig_mult: float = 0.01):
    """Cut the [nx, ny] frame window at `frame_anchor` out of the
    running lattice `mom` [bx*by, 6] anchored at `mom_anchor`, add the
    optional fresh moments `extra` [nx*ny, 6], finalize to an NDTGrid.

    Returns (grid, in_range). `in_range` (a bool on the device) is False
    when the window does not fit inside the lattice; the caller must
    then fall back to a full rebuild for that frame. What such a call
    returns is the window `jax.lax.dynamic_slice` cuts: a negative
    offset counts from the far edge, and the result is clamped into the
    lattice. The window is gathered by index arithmetic on the device:
    nothing here waits for the host."""
    off = frame_anchor - mom_anchor
    in_range = (
        (off[0] >= 0) & (off[0] <= bx - nx)
        & (off[1] >= 0) & (off[1] <= by - ny)
    )
    ox = torch.where(off[0] < 0, off[0] + bx, off[0])
    oy = torch.where(off[1] < 0, off[1] + by, off[1])
    ox = torch.clamp(ox, 0, bx - nx).to(torch.int64)
    oy = torch.clamp(oy, 0, by - ny).to(torch.int64)
    ix = ox + torch.arange(nx, device=mom.device)
    iy = oy + torch.arange(ny, device=mom.device)
    win = mom.index_select(0, (ix[:, None] * by + iy[None, :]).reshape(-1))
    if extra is not None:
        win = win + extra
    origin = frame_anchor.to(torch.float32) * resolution
    moments = tuple(win[:, i] for i in range(6))
    grid = _finalize_abs(moments, origin, frame_anchor, nx, ny, resolution,
                         min_pts, eig_mult)
    return grid, in_range


def _finalize_abs(moments, origin, anchor, nx: int, ny: int,
                  resolution: float, min_pts: int, eig_mult: float) -> NDTGrid:
    """grid_finalize with the corners restored from absolute cell
    indices, (local + anchor) * resolution: the exact floats
    `moments_abs` subtracted."""
    cell = torch.arange(nx * ny, dtype=torch.int32, device=origin.device)
    corner_x = ((cell // ny) + anchor[0]).to(origin.dtype) * resolution
    corner_y = ((cell % ny) + anchor[1]).to(origin.dtype) * resolution
    return _finalize(moments, corner_x, corner_y, origin, nx, ny,
                     resolution, min_pts, eig_mult)


def build_grid(xy, mask, center, nx: int, ny: int, resolution: float,
               min_pts: int = 6, eig_mult: float = 0.01,
               axis=None) -> NDTGrid:
    """Moments + finalize over an nx*ny window centered on `center`;
    [B,L,2] / [B,L] targets and [B,2] centers give B windows (a stacked
    `NDTGrid`). With `axis`, `xy` is this rank's target shard (see
    `grid_moments`)."""
    origin = grid_origin(center, nx, ny, resolution)
    m = grid_moments(xy, mask, origin, nx, ny, resolution, axis=axis)
    return grid_finalize(m, origin, nx, ny, resolution, min_pts, eig_mult)
