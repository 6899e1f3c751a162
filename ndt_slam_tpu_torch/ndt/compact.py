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

The grid axis of those kernels (loop-closure verification: every pose
against its own candidate's grid) takes G tables of one grid shape
stacked by `stack_grids`. Its twin, `window_rows`, is the kernels' own
route in plain tensor code over all poses at once: the (2r+1)^2 window
cells looked up through the stacked `cell_slot`, the per-point values
formed in the kernel's order and summed over points in the kernel's
fixed tree (a butterfly inside each warp of 32 points, the warps of a
128-point block in order, the blocks in order). So a pose's result does
not depend on the other poses of the call, and the kernel agrees with
it to the rounding of the transcendental functions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ndt_slam_tpu_torch.ndt.grid import NDTGrid

# Threads of a block of the window kernels (kWinThreads in
# csrc/ndt_kernels.cu): the unit of their fixed-order point sums.
WINDOW_THREADS = 128


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
    [capacity] table; cells beyond `capacity` are dropped. The table of
    `compact_grids` for a batch of one window."""
    gs = compact_grids(grid._replace(
        origin=grid.origin[None], mean=grid.mean[None],
        inv_cov=grid.inv_cov[None], valid=grid.valid[None]), capacity)
    t = gs.table[0]
    return CompactGrid(
        kx=t[:, 0], ky=t[:, 1], mx=t[:, 2], my=t[:, 3], b00=t[:, 4],
        b01=t[:, 5], b11=t[:, 6], valid=t[:, 7] > 0, origin=grid.origin,
        nx=grid.nx, ny=grid.ny, resolution=grid.resolution, table=t,
        cell_slot=gs.cell_slot[0])


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


class GridStack(NamedTuple):
    """G compact tables of one grid shape (nx, ny, resolution), stacked
    for the grid axis of the window kernels: `table` [G, K, 8],
    `cell_slot` int32 [G, nx*ny] and `origin` [G, 2], each grid's
    `CompactGrid` fields one row apart."""
    table: torch.Tensor
    cell_slot: torch.Tensor
    origin: torch.Tensor
    nx: int
    ny: int
    resolution: float

    @property
    def grids(self) -> int:
        return self.table.shape[0]

    @property
    def capacity(self) -> int:
        return self.table.shape[1]


def compact_grids(grid: NDTGrid, capacity: int) -> GridStack:
    """The compact tables of B windows (a batched `grid`, [B] leading
    every tensor, from `build_grid` over rows) as a `GridStack`, row b
    the table and window index of window b alone.

    The fixed-size nonzero is a cumsum and a scatter on the device (no
    host sync, no data-dependent shape): valid cell c goes to slot
    rank(c) when that is < capacity, everything else to a dump slot
    that is sliced off; empty slots keep the fill id nx*ny."""
    num_cells = grid.nx * grid.ny
    dev = grid.valid.device
    b = grid.valid.shape[0]
    rank = torch.cumsum(grid.valid.to(torch.int64), -1) - 1
    slot = torch.where(grid.valid & (rank < capacity), rank, capacity)
    idx = torch.full((b, capacity + 1), num_cells, dtype=torch.int64,
                     device=dev)
    idx.scatter_(1, slot, torch.arange(num_cells, device=dev).expand(b, -1))
    idx = idx[:, :capacity]
    ok = idx < num_cells
    safe = torch.where(ok, idx, 0)
    mean = grid.mean.gather(1, safe[..., None].expand(-1, -1, 2))
    icov = grid.inv_cov.reshape(b, num_cells, 4).gather(
        1, safe[..., None].expand(-1, -1, 4))
    valid = ok & grid.valid.gather(1, safe)
    table = torch.stack([
        torch.where(ok, (safe // grid.ny).to(torch.float32), -1e9),
        torch.where(ok, (safe % grid.ny).to(torch.float32), -1e9),
        torch.where(ok, mean[..., 0], 0.0),
        torch.where(ok, mean[..., 1], 0.0),
        torch.where(ok, icov[..., 0], 0.0),
        torch.where(ok, icov[..., 1], 0.0),
        torch.where(ok, icov[..., 3], 0.0),
        valid.to(torch.float32),
    ], dim=-1)
    cell_slot = torch.where(slot < capacity, rank, -1).to(torch.int32)
    return GridStack(table=table, cell_slot=cell_slot, origin=grid.origin,
                     nx=grid.nx, ny=grid.ny, resolution=grid.resolution)


def stack_grids(cgs) -> GridStack:
    """Stack compact grids of one shape (same nx, ny, resolution and
    capacity, each with its window index) into a `GridStack`."""
    first = cgs[0]
    for cg in cgs:
        if (cg.nx, cg.ny, cg.resolution, cg.capacity) != (
                first.nx, first.ny, first.resolution, first.capacity):
            raise ValueError("stack_grids needs grids of one shape")
        if cg.table is None or cg.cell_slot is None:
            raise ValueError("stack_grids needs grids with a window index "
                             "(table, cell_slot)")
    return GridStack(
        table=torch.stack([cg.table for cg in cgs]),
        cell_slot=torch.stack([cg.cell_slot for cg in cgs]),
        origin=torch.stack([cg.origin for cg in cgs]),
        nx=first.nx, ny=first.ny, resolution=first.resolution,
    )


def _block_tree_sum(v):
    """[P, N, V] per-point values -> [P, V], summed as the window
    kernels sum them: points in blocks of WINDOW_THREADS, a shuffle
    butterfly inside each warp of 32, the warps of a block in order,
    then the blocks in order."""
    p, n, nv = v.shape
    blocks = -(-n // WINDOW_THREADS)
    pad = blocks * WINDOW_THREADS - n
    if pad:
        v = torch.cat([v, v.new_zeros((p, pad, nv))], dim=1)
    v = v.reshape(p, blocks, WINDOW_THREADS // 32, 32, nv)
    for off in (16, 8, 4, 2, 1):
        v = v[:, :, :, :off] + v[:, :, :, off:2 * off]
    block = v.new_zeros((p, blocks, nv))
    for w in range(WINDOW_THREADS // 32):
        block = block + v[:, :, w, 0]
    total = v.new_zeros((p, nv))
    for b in range(blocks):
        total = total + block[:, b]
    return total


def window_rows(poses_rad, grid_index, xy, mask, gs: GridStack, d1: float,
                d2: float, radius: int = 1, derivs: bool = True):
    """Pose p against grid `grid_index[p]` of `gs`: [P, 16] rows of
    (E, matched, grad[3], hess[3,3] row-major, 2 zeros) with `derivs`,
    else E [P]. `xy` [N, 2] / `mask` [N] is one source for every pose;
    [G, N, 2] / [G, N] gives pose p source row `grid_index[p]`. A pose
    whose grid index is outside [0, G) matches nothing.

    The plain twin of the window kernels' grid axis, one tensor program
    over the poses (see the module docstring)."""
    g = grid_index.to(torch.int64)
    ok = (g >= 0) & (g < gs.grids)
    g = torch.where(ok, g, 0)
    if xy.dim() == 3:
        xy, mask = xy.index_select(0, g), mask.index_select(0, g)
    x, y = xy[..., 0], xy[..., 1]
    nx, ny, r = gs.nx, gs.ny, int(radius)
    origin = gs.origin.index_select(0, g)
    tx, ty = poses_rad[:, 0:1], poses_rad[:, 1:2]
    c = torch.cos(poses_rad[:, 2:3])
    s = torch.sin(poses_rad[:, 2:3])
    px = c * x - s * y + tx
    py = s * x + c * y + ty
    fx = torch.floor((px - origin[:, 0:1]) / gs.resolution)
    fy = torch.floor((py - origin[:, 1:2]) / gs.resolution)
    live = (ok[:, None] & mask & (fx >= -r) & (fx <= nx - 1 + r)
            & (fy >= -r) & (fy <= ny - 1 + r))
    cx = torch.where(live, fx, 0.0).to(torch.int64)
    cy = torch.where(live, fy, 0.0).to(torch.int64)
    slots = gs.cell_slot.reshape(-1)
    rows = gs.table.reshape(-1, 8)
    slot0 = (g * (nx * ny))[:, None]
    row0 = (g * gs.capacity)[:, None]
    neg_half_d2, md_cap = -0.5 * d2, 50.0 / d2
    zero = px.new_zeros(())
    se = torch.zeros_like(px)
    sw, gqx, gqy, h00, h01, h11 = (torch.zeros_like(px) for _ in range(6))
    for dx in range(-r, r + 1):
        gx = cx + dx
        for dy in range(-r, r + 1):
            gy = cy + dy
            inside = live & (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny)
            slot = slots[slot0 + torch.where(inside, gx * ny + gy, 0)]
            hit = inside & (slot >= 0)
            cell = rows[row0 + torch.where(hit, slot, 0).to(torch.int64)]
            qx, qy = px - cell[..., 2], py - cell[..., 3]
            b00, b01, b11 = cell[..., 4], cell[..., 5], cell[..., 6]
            bqx = b00 * qx + b01 * qy
            bqy = b01 * qx + b11 * qy
            md = qx * bqx + qy * bqy
            e = torch.exp(neg_half_d2 * torch.clamp(md, max=md_cap))
            se = torch.where(hit, se + e, se)
            if derivs:
                coef = (-d1 * d2) * e
                sw = torch.where(hit, sw + 1.0, sw)
                gqx = torch.where(hit, gqx + coef * bqx, gqx)
                gqy = torch.where(hit, gqy + coef * bqy, gqy)
                h00 = torch.where(hit, h00 + coef * (b00 - d2 * bqx * bqx),
                                  h00)
                h01 = torch.where(hit, h01 + coef * (b01 - d2 * bqx * bqy),
                                  h01)
                h11 = torch.where(hit, h11 + coef * (b11 - d2 * bqy * bqy),
                                  h11)
    values = [d1 * se]
    if derivs:
        a = -s * x - c * y
        b = c * x - s * y
        d2x = -(px - tx)
        d2y = -(py - ty)
        values += [
            sw, gqx, gqy, a * gqx + b * gqy, h00, h01, a * h00 + b * h01,
            h11, a * h01 + b * h11,
            a * a * h00 + 2.0 * a * b * h01 + b * b * h11,
            gqx * d2x + gqy * d2y,
        ]
    v = torch.where(live[..., None], torch.stack(values, dim=-1), zero)
    t = _block_tree_sum(v)
    if not derivs:
        return t[:, 0]
    h = [t[:, 5], t[:, 6], t[:, 7], t[:, 6], t[:, 8], t[:, 9], t[:, 7],
         t[:, 9], t[:, 10] + t[:, 11]]
    return torch.stack([t[:, 0], t[:, 1], t[:, 2], t[:, 3], t[:, 4], *h,
                        zero.expand(t.shape[0]), zero.expand(t.shape[0])],
                       dim=-1)
