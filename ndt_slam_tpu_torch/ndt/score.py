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
"""

from __future__ import annotations

import math

import torch

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


def _gather_cells(grid: NDTGrid, cx, cy, radius: int):
    """Neighbour-cell statistics of each point in component form: (mx,
    my, b00, b01, b11, valid), each [..., N, K] for the K cells of the
    (2r+1)^2 neighbourhood of cells (cx, cy) [..., N] (b: the inverse
    covariance's entries)."""
    dx, dy = _neighbor_offsets(radius, cx.device)
    nxi = cx[..., None] + dx
    nyi = cy[..., None] + dy
    inb = (nxi >= 0) & (nxi < grid.nx) & (nyi >= 0) & (nyi < grid.ny)
    cid = torch.clamp(nxi * grid.ny + nyi, 0, grid.nx * grid.ny - 1)
    mean = grid.mean[cid]
    inv = grid.inv_cov[cid]
    return (mean[..., 0], mean[..., 1], inv[..., 0, 0], inv[..., 0, 1],
            inv[..., 1, 1], grid.valid[cid] & inb)


def _transform(pose_rad, xy):
    """xy [N,2] through the pose(s) [..., 3]: (x, y) [..., N], cos, sin
    [..., 1]."""
    c = torch.cos(pose_rad[..., 2:3])
    s = torch.sin(pose_rad[..., 2:3])
    x = c * xy[:, 0] - s * xy[:, 1] + pose_rad[..., 0:1]
    y = s * xy[:, 0] + c * xy[:, 1] + pose_rad[..., 1:2]
    return x, y, c, s


def _point_cell_terms(pose_rad, xy, mask, grid: NDTGrid, d2: float,
                      radius: int) -> dict:
    """The terms every pass shares, [..., N] and [..., N, K]."""
    px, py, c, s = _transform(pose_rad, xy)
    cx = torch.floor((px - grid.origin[0]) / grid.resolution).to(torch.int64)
    cy = torch.floor((py - grid.origin[1]) / grid.resolution).to(torch.int64)
    mx, my, b00, b01, b11, valid = _gather_cells(grid, cx, cy, radius)
    qx = px[..., None] - mx
    qy = py[..., None] - my
    bqx = b00 * qx + b01 * qy                # Sigma^-1 q
    bqy = b01 * qx + b11 * qy
    md = qx * bqx + qy * bqy                 # Mahalanobis^2
    w = (valid & mask[:, None]).to(xy.dtype)
    e = torch.exp(-0.5 * d2 * torch.clamp(md, max=50.0 / d2))
    return dict(px=px, py=py, c=c, s=s, bqx=bqx, bqy=bqy,
                b00=b00, b01=b01, b11=b11, w=w, e=e)


def ndt_negative_score(pose_rad, xy, mask, grid: NDTGrid, d1: float,
                       d2: float, radius: int = 1):
    """E(p) of one pose [3] (a 0-dim tensor), or of C poses [C,3] at
    once ([C]): the line search's candidates."""
    t = _point_cell_terms(pose_rad, xy, mask, grid, d2, radius)
    return (t["w"] * d1 * t["e"]).sum(dim=(-2, -1))


def ndt_score_grad_hess(pose_rad, xy, mask, grid: NDTGrid, d1: float,
                        d2: float, radius: int = 1):
    """(E, grad [3], hess [3,3], matched) at one pose [3]; matched counts
    the contributing (point, cell) pairs."""
    t = _point_cell_terms(pose_rad, xy, mask, grid, d2, radius)
    w, e = t["w"], t["e"]
    bqx, bqy = t["bqx"], t["bqy"]
    E = (w * d1 * e).sum()
    matched = w.sum()

    # dE/dq per (point, cell): coef * Bq with coef = -d1*d2*w*e
    coef = (-d1 * d2) * w * e
    gqx_s = (coef * bqx).sum(dim=1)          # [N]
    gqy_s = (coef * bqy).sum(dim=1)
    # Jacobian of the transformed point in (tx, ty, th):
    # [[1, 0, a], [0, 1, b]], a = -s*x - c*y, b = c*x - s*y
    c, s = t["c"], t["s"]
    a = -s * xy[:, 0] - c * xy[:, 1]
    b = c * xy[:, 0] - s * xy[:, 1]
    grad = torch.stack([gqx_s.sum(), gqy_s.sum(),
                        (a * gqx_s + b * gqy_s).sum()])

    # Hq = coef * (B - d2 * Bq Bq') per (point, cell), symmetric 2x2
    hq00_s = (coef * (t["b00"] - d2 * bqx * bqx)).sum(dim=1)
    hq01_s = (coef * (t["b01"] - d2 * bqx * bqy)).sum(dim=1)
    hq11_s = (coef * (t["b11"] - d2 * bqy * bqy)).sum(dim=1)
    h00, h01, h11 = hq00_s.sum(), hq01_s.sum(), hq11_s.sum()
    h02 = (a * hq00_s + b * hq01_s).sum()
    h12 = (a * hq01_s + b * hq11_s).sum()
    h22_rot = (a * a * hq00_s + 2.0 * a * b * hq01_s
               + b * b * hq11_s).sum()
    # curvature of the transform itself: d2x'/dth2 = -(x' - t)
    d2x = -(t["px"] - pose_rad[0])
    d2y = -(t["py"] - pose_rad[1])
    h22 = h22_rot + (gqx_s * d2x + gqy_s * d2y).sum()
    hess = torch.stack([torch.stack([h00, h01, h02]),
                        torch.stack([h01, h11, h12]),
                        torch.stack([h02, h12, h22])])
    return E, grad, hess, matched
