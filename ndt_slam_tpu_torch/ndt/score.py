"""NDT objective for SE(2) registration on a dense window grid: the
gather engine (port of `ndt_slam_tpu.ndt.score`), and the
Gaussian-mixture constants every engine shares.

Objective (minimised): E(p) = sum_i sum_c d1 * exp(-d2/2 * q' Sigma^-1 q),
q = T_p(x_i) - mu_c, over the (2r+1)^2 cells around each transformed
point, with d1 < 0 (Magnusson 2009, PCL's gauss_d1_ / gauss_d2_ adapted
to 2D). The engine gathers each point's neighbour cells straight out of
the `NDTGrid` window, in component form (2-vectors and symmetric 2x2
matrices as separate tensors), as tensor code on the device of its
inputs: no kernel of its own. The compact engine (`ndt/compact.py`, the
CUDA kernels of `ndt/kernels.py`) computes the same function over the
grid's table of valid cells.

Rows stand in for the JAX package's `vmap` over poses: P poses [P,3]
against one window, or pose p against window `grid_index[p]` of a
stacked `NDTGrid` ([G] leading its tensors, from `build_grid` over
rows), the source shared ([N,2]) or one a window ([G,N,2]). A row
reduces over its own cells and points only, in a fixed order: the
(2r+1)^2 cells of a point front to back, then the points in the window
kernels' tree (`compact._block_tree_sum`). Every step is elementwise
or a slice, so row p gives the bits of a call with pose p and window
`grid_index[p]` alone, whatever the other rows hold.
"""

from __future__ import annotations

import math

import torch

from ndt_slam_tpu_torch.ndt.compact import _block_tree_sum
from ndt_slam_tpu_torch.ndt.grid import NDTGrid


def gauss_constants(resolution: float, outlier_ratio: float = 0.55):
    """(d1, d2); the uniform-outlier density uses resolution^2."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (resolution ** 2)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return float(d1), float(d2)


def _neighbor_offsets(radius: int, device):
    """(dx, dy), each [K] int64, K = (2r+1)^2, dx the outer loop (the JAX
    package's order); made on the device, no host copy."""
    d = torch.arange(-radius, radius + 1, device=device)
    return d.repeat_interleave(2 * radius + 1), d.repeat(2 * radius + 1)


def _gather_cells(grid: NDTGrid, cx, cy, radius: int, base=None):
    """Neighbour-cell statistics of each point in component form: (mx,
    my, b00, b01, b11, valid), each [..., N, K] for the K cells of the
    (2r+1)^2 neighbourhood of cells (cx, cy) [..., N] (b: the inverse
    covariance's entries). On a stacked grid `base` [..., 1] is the
    first cell of each row's window in the flattened stack."""
    dx, dy = _neighbor_offsets(radius, cx.device)
    nxi = cx[..., None] + dx
    nyi = cy[..., None] + dy
    inb = (nxi >= 0) & (nxi < grid.nx) & (nyi >= 0) & (nyi < grid.ny)
    cid = torch.clamp(nxi * grid.ny + nyi, 0, grid.nx * grid.ny - 1)
    if base is not None:
        cid = cid + base[..., None]
    mean = grid.mean.reshape(-1, 2)[cid]
    inv = grid.inv_cov.reshape(-1, 2, 2)[cid]
    return (mean[..., 0], mean[..., 1], inv[..., 0, 0], inv[..., 0, 1],
            inv[..., 1, 1], grid.valid.reshape(-1)[cid] & inb)


def _point_values(pose_rad, xy, mask, grid: NDTGrid, d1: float, d2: float,
                  radius: int, grid_index, derivs: bool):
    """[P, N, V] per-point values of P rows (see the module docstring),
    V = 12 with `derivs` (E, matched, grad[3], the Hessian's six terms
    and the transform's curvature term, in `compact.window_rows`'s
    order), else 1 (E)."""
    poses = pose_rad.reshape(-1, 3)
    cells = grid.nx * grid.ny
    if grid.mean.dim() == 3:
        if grid_index is None:
            raise ValueError("a stacked NDTGrid takes a grid index per pose")
        g = grid_index.to(torch.int64)
        origin = grid.origin.index_select(0, g)
        base = (g * cells)[:, None]
        if xy.dim() == 3:
            xy, mask = xy.index_select(0, g), mask.index_select(0, g)
    else:
        origin, base = grid.origin[None, :], None
    x, y = xy[..., 0], xy[..., 1]
    tx, ty = poses[:, 0:1], poses[:, 1:2]
    c = torch.cos(poses[:, 2:3])
    s = torch.sin(poses[:, 2:3])
    px = c * x - s * y + tx
    py = s * x + c * y + ty
    cx = torch.floor((px - origin[:, 0:1]) / grid.resolution).to(torch.int64)
    cy = torch.floor((py - origin[:, 1:2]) / grid.resolution).to(torch.int64)
    mx, my, b00, b01, b11, valid = _gather_cells(grid, cx, cy, radius, base)
    qx = px[..., None] - mx
    qy = py[..., None] - my
    bqx = b00 * qx + b01 * qy                # Sigma^-1 q
    bqy = b01 * qx + b11 * qy
    md = qx * bqx + qy * bqy                 # Mahalanobis^2
    w = (valid & mask[..., None]).to(xy.dtype)
    e = torch.exp(-0.5 * d2 * torch.clamp(md, max=50.0 / d2))
    terms = [w * d1 * e]
    if derivs:
        # dE/dq per (point, cell): coef * Bq with coef = -d1*d2*w*e, and
        # Hq = coef * (B - d2 * Bq Bq'), symmetric 2x2
        coef = (-d1 * d2) * w * e
        terms += [w, coef * bqx, coef * bqy,
                  coef * (b00 - d2 * bqx * bqx),
                  coef * (b01 - d2 * bqx * bqy),
                  coef * (b11 - d2 * bqy * bqy)]
    # the point's cells, front to back
    sums = []
    for t in terms:
        acc = t[..., 0]
        for k in range(1, t.shape[-1]):
            acc = acc + t[..., k]
        sums.append(acc)
    if not derivs:
        return sums[0][..., None]
    se, sw, gqx, gqy, h00, h01, h11 = sums
    # Jacobian of the transformed point in (tx, ty, th):
    # [[1, 0, a], [0, 1, b]], a = -s*x - c*y, b = c*x - s*y; the
    # transform's own curvature: d2x'/dth2 = -(x' - t)
    a = -s * x - c * y
    b = c * x - s * y
    d2x = -(px - tx)
    d2y = -(py - ty)
    return torch.stack([
        se, sw, gqx, gqy, a * gqx + b * gqy, h00, h01, a * h00 + b * h01,
        h11, a * h01 + b * h11,
        a * a * h00 + 2.0 * a * b * h01 + b * b * h11,
        gqx * d2x + gqy * d2y,
    ], dim=-1)


def _row_sums(pose_rad, xy, mask, grid, d1, d2, radius, grid_index,
              derivs):
    """[P, V] sums over the points of `_point_values`."""
    return _block_tree_sum(_point_values(pose_rad, xy, mask, grid, d1, d2,
                                         radius, grid_index, derivs))


def ndt_negative_score(pose_rad, xy, mask, grid: NDTGrid, d1: float,
                       d2: float, radius: int = 1, grid_index=None):
    """E(p) of one pose [3] (a 0-dim tensor), or of P poses [P,3] at
    once ([P]): the line search's candidates, on one window or, with
    `grid_index` [P], pose p on window `grid_index[p]` of a stacked
    grid."""
    t = _row_sums(pose_rad, xy, mask, grid, d1, d2, radius, grid_index,
                  derivs=False)[:, 0]
    return t[0] if pose_rad.dim() == 1 else t


def ndt_score_grad_hess(pose_rad, xy, mask, grid: NDTGrid, d1: float,
                        d2: float, radius: int = 1, grid_index=None):
    """(E, grad [3], hess [3,3], matched) at one pose [3]; matched counts
    the contributing (point, cell) pairs. P poses [P,3] (with
    `grid_index` on a stacked grid) give ([P], [P,3], [P,3,3], [P])."""
    t = _row_sums(pose_rad, xy, mask, grid, d1, d2, radius, grid_index,
                  derivs=True)
    h = [t[:, 5], t[:, 6], t[:, 7], t[:, 6], t[:, 8], t[:, 9], t[:, 7],
         t[:, 9], t[:, 10] + t[:, 11]]
    E, grad = t[:, 0], t[:, 2:5]
    hess = torch.stack(h, dim=-1).unflatten(-1, (3, 3))
    matched = t[:, 1]
    if pose_rad.dim() == 1:
        return E[0], grad[0], hess[0], matched[0]
    return E, grad, hess, matched
