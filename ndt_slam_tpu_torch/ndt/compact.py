"""Compact-cell NDT engine: the plain [N,K] score/grad/Hessian.

Port of `ndt_slam_tpu.ndt.compact`. The valid cells of the dense window
are compacted into a fixed-capacity table [K] once per frame
(`compact_grid`); the objective then evaluates every (point, cell) pair
as [N,K] broadcasts, with q = T(x) - mu as a direct difference (no
quadratic expansion, so no cancellation at map-scale coordinates),
weighted by the (2r+1)^2 cell-index window test.

This module is the plain PyTorch twin of the first two CUDA kernels
(ndt/kernels.py): it runs for CPU tensors and is the oracle the kernels
are held against on the card. The kernels do not scan the table: they
look the (2r+1)^2 window cells up through `CompactGrid.cell_slot` and
read them from `CompactGrid.table`, both built here once per frame, and
compute the point features themselves in `point_features`' operation
order, so the window test passes the same pairs on both sides.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ndt_slam_tpu_torch.ndt.grid import NDTGrid


class CompactGrid(NamedTuple):
    """Fixed-capacity table of the valid NDT cells.

    kx, ky: [K] float32 cell indices (integral values); mx, my: [K]
    cell means (map frame); b00, b01, b11: [K] inverse covariance
    entries; valid: [K] bool; origin [2], resolution, nx, ny as in
    NDTGrid.

    The window index, read by the CUDA kernels only: `table` is the
    same table cell-major, float32 [K, 8] = (kx, ky, mx, my, b00, b01,
    b11, valid), one cell in two aligned 16-byte loads; `cell_slot` is
    int32 [nx*ny], the table slot of cell id kx*ny + ky, -1 for a cell
    that is empty or was dropped at capacity.
    """
    kx: torch.Tensor
    ky: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    b00: torch.Tensor
    b01: torch.Tensor
    b11: torch.Tensor
    valid: torch.Tensor
    origin: torch.Tensor
    nx: int
    ny: int
    resolution: float
    table: Optional[torch.Tensor] = None
    cell_slot: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.kx.shape[0]


def compact_grid(grid: NDTGrid, capacity: int) -> CompactGrid:
    """Compact `grid`'s valid cells, in cell-id order, into a
    [capacity] table; cells beyond `capacity` are dropped.

    The fixed-size nonzero is a cumsum and a scatter on the device (no
    host sync, no data-dependent shape): valid cell c goes to slot
    rank(c) when that is < capacity, everything else to a dump slot
    that is sliced off; empty slots keep the fill id nx*ny."""
    num_cells = grid.nx * grid.ny
    dev = grid.valid.device
    rank = torch.cumsum(grid.valid.to(torch.int64), 0) - 1
    slot = torch.where(grid.valid & (rank < capacity), rank, capacity)
    idx = torch.full((capacity + 1,), num_cells, dtype=torch.int64,
                     device=dev)
    idx.scatter_(0, slot, torch.arange(num_cells, device=dev))
    idx = idx[:capacity]
    ok = idx < num_cells
    safe = torch.where(ok, idx, 0)
    kx = (safe // grid.ny).to(torch.float32)
    ky = (safe % grid.ny).to(torch.float32)
    mean = grid.mean.index_select(0, safe)
    icov = grid.inv_cov.index_select(0, safe)
    cg = CompactGrid(
        kx=torch.where(ok, kx, -1e9),
        ky=torch.where(ok, ky, -1e9),
        mx=torch.where(ok, mean[:, 0], 0.0),
        my=torch.where(ok, mean[:, 1], 0.0),
        b00=torch.where(ok, icov[:, 0, 0], 0.0),
        b01=torch.where(ok, icov[:, 0, 1], 0.0),
        b11=torch.where(ok, icov[:, 1, 1], 0.0),
        valid=ok & grid.valid.index_select(0, safe),
        origin=grid.origin,
        nx=grid.nx,
        ny=grid.ny,
        resolution=grid.resolution,
    )
    cell_slot = torch.where(slot < capacity, rank, -1).to(torch.int32)
    return cg._replace(table=table_rows(cg), cell_slot=cell_slot)


def table_rows(cg: CompactGrid) -> torch.Tensor:
    """`cg`'s table cell-major, [K, 8] (the `CompactGrid.table` field)."""
    return torch.stack([
        cg.kx, cg.ky, cg.mx, cg.my, cg.b00, cg.b01, cg.b11,
        cg.valid.to(torch.float32),
    ], dim=1)


def cell_slot_of_table(cg: CompactGrid) -> torch.Tensor:
    """The `CompactGrid.cell_slot` map of a table that came without one:
    slot k is scattered to its cell id kx*ny + ky, the invalid slots to
    a dump entry that is sliced off (no nonzero, no host sync)."""
    num_cells = cg.nx * cg.ny
    dev = cg.kx.device
    cell = torch.where(
        cg.valid, cg.kx.to(torch.int64) * cg.ny + cg.ky.to(torch.int64),
        num_cells)
    out = torch.full((num_cells + 1,), -1, dtype=torch.int32, device=dev)
    out.scatter_(0, cell, torch.arange(cg.capacity, dtype=torch.int32,
                                       device=dev))
    return out[:num_cells]


def point_features(pose_rad, xy, cg: CompactGrid):
    """Transformed points and their integral cell indices.

    pose_rad [..., 3] batches over leading dims: [3] gives [N] arrays,
    [C,3] gives [C,N]. Returns (px, py, fx, fy, c, s) with c, s the
    cos/sin of the heading (shape [...,1])."""
    c = torch.cos(pose_rad[..., 2:3])
    s = torch.sin(pose_rad[..., 2:3])
    px = c * xy[:, 0] - s * xy[:, 1] + pose_rad[..., 0:1]
    py = s * xy[:, 0] + c * xy[:, 1] + pose_rad[..., 1:2]
    fx = torch.floor((px - cg.origin[0]) / cg.resolution)
    fy = torch.floor((py - cg.origin[1]) / cg.resolution)
    return px, py, fx, fy, c, s


def _pair_terms(pose_rad, xy, mask, cg: CompactGrid, d2: float,
                radius: int):
    """Shared [N,K] pair quantities (weights and exp terms)."""
    px, py, fx, fy, c, s = point_features(pose_rad, xy, cg)
    r = float(radius)
    in_win = (
        (torch.abs(fx[:, None] - cg.kx[None, :]) <= r)
        & (torch.abs(fy[:, None] - cg.ky[None, :]) <= r)
    )
    w = (in_win & mask[:, None] & cg.valid[None, :]).to(xy.dtype)

    qx = px[:, None] - cg.mx[None, :]          # [N,K] exact differences
    qy = py[:, None] - cg.my[None, :]
    bqx = cg.b00[None, :] * qx + cg.b01[None, :] * qy
    bqy = cg.b01[None, :] * qx + cg.b11[None, :] * qy
    md = qx * bqx + qy * bqy
    e = torch.exp(-0.5 * d2 * torch.clamp(md, max=50.0 / d2))
    return px, py, c, s, w, e, bqx, bqy


def ndt_negative_score_compact(pose_rad, xy, mask, cg: CompactGrid,
                               d1: float, d2: float, radius: int = 1):
    """E(p) = sum over pairs of d1 * exp(-d2/2 * q'Bq) (minimized)."""
    _, _, _, _, w, e, _, _ = _pair_terms(pose_rad, xy, mask, cg, d2, radius)
    return torch.sum(w * (d1 * e))


def ndt_score_grad_hess_compact(pose_rad, xy, mask, cg: CompactGrid,
                                d1: float, d2: float, radius: int = 1):
    """Fused (E, grad[3], hess[3,3], matched) over the [N,K] pairs."""
    px, py, c, s, w, e, bqx, bqy = _pair_terms(
        pose_rad, xy, mask, cg, d2, radius
    )
    E = torch.sum(w * (d1 * e))
    matched = torch.sum(w)

    coef = (-d1 * d2) * w * e                  # [N,K]
    gqx_s = torch.sum(coef * bqx, dim=1)       # [N]
    gqy_s = torch.sum(coef * bqy, dim=1)
    hq00_s = torch.sum(coef * (cg.b00[None, :] - d2 * bqx * bqx), dim=1)
    hq01_s = torch.sum(coef * (cg.b01[None, :] - d2 * bqx * bqy), dim=1)
    hq11_s = torch.sum(coef * (cg.b11[None, :] - d2 * bqy * bqy), dim=1)
    grad, hess = pose_terms(pose_rad, xy, px, py, c, s,
                            gqx_s, gqy_s, hq00_s, hq01_s, hq11_s)
    return E, grad, hess, matched


def pose_terms(pose_rad, xy, px, py, c, s, gqx, gqy, hq00, hq01, hq11):
    """O(N) epilogue: per-point partial sums over cells -> grad[3] and
    the symmetric Hessian [3,3] of E. The CUDA kernel applies the same
    terms per point before it sums over points."""
    a = -s * xy[:, 0] - c * xy[:, 1]
    b = c * xy[:, 0] - s * xy[:, 1]
    g0 = torch.sum(gqx)
    g1 = torch.sum(gqy)
    g2 = torch.sum(a * gqx + b * gqy)
    grad = torch.stack([g0, g1, g2])

    h00 = torch.sum(hq00)
    h01 = torch.sum(hq01)
    h11 = torch.sum(hq11)
    h02 = torch.sum(a * hq00 + b * hq01)
    h12 = torch.sum(a * hq01 + b * hq11)
    h22_rot = torch.sum(a * a * hq00 + 2.0 * a * b * hq01 + b * b * hq11)
    d2x = -(px - pose_rad[0])
    d2y = -(py - pose_rad[1])
    h22 = h22_rot + torch.sum(gqx * d2x + gqy * d2y)
    hess = torch.stack([
        torch.stack([h00, h01, h02]),
        torch.stack([h01, h11, h12]),
        torch.stack([h02, h12, h22]),
    ])
    return grad, hess
