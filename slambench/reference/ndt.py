"""The reference's scan registration: the NDT grid of a target, the NDT
objective with its gradient and Hessian, the Newton solve with its line
search, the fitness score, and the fusion with odometry.

Semantics as the upstream defines them (Biber and Strasser 2003,
Magnusson 2009 in 2D; hibikid39/ndt_slam `ndt_mapping.launch`), with
the program's stated choices: a window of cells centred on the
predicted pose, cells of fewer than `ndt_min_points_per_cell` points
dropped, a cell's smaller eigenvalue floored at a hundredth of its
larger, at most `ndt_max_active_cells` cells (the first by cell index),
each point scored against the cells around its own, a Levenberg ridge,
steps clamped to `ndt_step_size` and 12 line-search candidates. Sums
and matrices in float64."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from slambench.reference.cloud import group_sums, nn_sq, voxel_centroids
from slambench.reference.geometry import (
    compose, motion, to_map, wrap_deg, wrap_rad,
)

LINE_SEARCH = (1.0, 0.5, 0.25, 0.1, 0.04, 0.015)
FAR = 1.0e12        # the fitness of a scan that has nothing to match


def gauss_constants(res: float, outlier_ratio: float):
    """(d1, d2) of the Gaussian-plus-uniform cell likelihood (Magnusson
    2009, eq. 6.8), the uniform part over a cell's area res^2."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (res * res)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


class Table(NamedTuple):
    """The cells of one window that take part, K rows: mean [K,2] and
    inverse covariance [K,2,2]; `slot` maps window cell ix * ny + iy to
    its row, -1 where the cell takes no part."""
    origin: torch.Tensor      # float32 [2]
    res: float
    nx: int
    ny: int
    mean: torch.Tensor
    icov: torch.Tensor
    slot: torch.Tensor


def window_origin(center, nx: int, res: float) -> np.ndarray:
    """Lower-left corner of a window of nx x nx cells centred on `center`
    (x, y), on the lattice of multiples of `res` (float32, as stored)."""
    half = np.float32(nx) * np.float32(res / 2.0)
    corner = np.asarray(center, np.float32)[:2] - half
    return (np.floor(corner / np.float32(res)) * np.float32(res)).astype(
        np.float32)


def build_table(tgt: torch.Tensor, center, nx: int, ny: int, res: float,
                min_pts: int, capacity: int) -> Table:
    dev = tgt.device
    origin = torch.from_numpy(window_origin(center, nx, res)).to(dev)
    ci = torch.floor((tgt - origin) / np.float32(res))
    inside = ((ci[:, 0] >= 0) & (ci[:, 0] < nx) & (ci[:, 1] >= 0)
              & (ci[:, 1] < ny))
    ci, pts = ci[inside], tgt[inside]
    corner = ci * np.float32(res) + origin          # float32, as stored
    rel = (pts - corner).double()
    cid = ci[:, 0].long() * ny + ci[:, 1].long()
    cells = nx * ny
    moments = torch.cat([rel, (rel[:, :, None] * rel[:, None, :]).flatten(1)],
                        1)
    live, n, sums = group_sums(cid, moments)
    keep = n >= min_pts
    live, n, sums = live[keep], n[keep].double(), sums[keep]
    s, ss = sums[:, :2], sums[:, 2:].unflatten(1, (2, 2))
    mu = s / n[:, None]
    cov = (ss - n[:, None, None] * mu[:, :, None] * mu[:, None, :]) \
        / (n - 1.0)[:, None, None]
    lam, vec = torch.linalg.eigh(cov)
    big = torch.clamp(lam[:, 1], min=1e-12)
    lam = torch.stack([torch.maximum(lam[:, 0], 0.01 * big), big], -1)
    ok = lam[:, 0] * lam[:, 1] > 1e-20
    live, mu, lam, vec = live[ok], mu[ok], lam[ok], vec[ok]
    live, mu, lam, vec = (live[:capacity], mu[:capacity], lam[:capacity],
                          vec[:capacity])
    icov = (vec / lam[:, None, :]) @ vec.mT
    kx = torch.div(live, ny, rounding_mode="floor")
    corner = torch.stack([kx, live - kx * ny], -1).double() * float(
        np.float32(res)) + origin.double()
    slot = torch.full((cells,), -1, dtype=torch.int64, device=dev)
    slot[live] = torch.arange(len(live), device=dev)
    return Table(origin, res, nx, ny, mu + corner, icov, slot)


def objective(poses: np.ndarray, src: torch.Tensor, tab: Table, d1: float,
              d2: float, radius: int = 1, derivs: bool = True):
    """The NDT objective E = sum over points and the cells around each
    of d1 exp(-d2/2 q' C^-1 q) at poses [P,3] (x, y, heading in rad):
    E [P]; with `derivs` also the gradient [P,3], the Hessian [P,3,3]
    and the matched (point, cell) pairs [P], as numpy float64."""
    dev = src.device
    p = torch.from_numpy(np.asarray(poses, np.float64)).to(dev)
    x, y = src[:, 0].double(), src[:, 1].double()
    c, s = torch.cos(p[:, 2:3]), torch.sin(p[:, 2:3])
    px = c * x - s * y + p[:, 0:1]
    py = s * x + c * y + p[:, 1:2]
    o = tab.origin.double()
    fx = torch.floor((px - o[0]) / tab.res).long()
    fy = torch.floor((py - o[1]) / tab.res).long()
    offs = torch.arange(-radius, radius + 1, device=dev)
    cx, cy = torch.broadcast_tensors(fx[..., None, None] + offs[:, None],
                                     fy[..., None, None] + offs[None, :])
    cx, cy = cx.flatten(-2), cy.flatten(-2)                 # [P,N,K]
    inb = (cx >= 0) & (cx < tab.nx) & (cy >= 0) & (cy < tab.ny)
    row = tab.slot[torch.where(inb, cx * tab.ny + cy, 0)]
    w = (inb & (row >= 0)).double()
    row = row.clamp(min=0)
    qx = px[..., None] - tab.mean[row, 0]
    qy = py[..., None] - tab.mean[row, 1]
    b00, b01, b11 = (tab.icov[row, 0, 0], tab.icov[row, 0, 1],
                     tab.icov[row, 1, 1])
    bqx = b00 * qx + b01 * qy
    bqy = b01 * qx + b11 * qy
    md = torch.clamp(qx * bqx + qy * bqy, max=50.0 / d2)
    e = w * torch.exp(-0.5 * d2 * md)
    E = d1 * e.sum((1, 2))
    if not derivs:
        return E.cpu().numpy()
    k = -d1 * d2 * e
    gx, gy = (k * bqx).sum(-1), (k * bqy).sum(-1)           # [P,N]
    hxx = (k * (b00 - d2 * bqx * bqx)).sum(-1)
    hxy = (k * (b01 - d2 * bqx * bqy)).sum(-1)
    hyy = (k * (b11 - d2 * bqy * bqy)).sum(-1)
    # d(point)/d(heading) = (a, b); d2(point)/d(heading)2 = -(R x)
    a = -s * x - c * y
    b = c * x - s * y
    grad = torch.stack([gx.sum(1), gy.sum(1), (a * gx + b * gy).sum(1)], -1)
    h02 = (a * hxx + b * hxy).sum(1)
    h12 = (a * hxy + b * hyy).sum(1)
    h22 = (a * a * hxx + 2 * a * b * hxy + b * b * hyy
           - gx * (px - p[:, 0:1]) - gy * (py - p[:, 1:2])).sum(1)
    h00, h01, h11 = hxx.sum(1), hxy.sum(1), hyy.sum(1)
    H = torch.stack([torch.stack([h00, h01, h02], -1),
                     torch.stack([h01, h11, h12], -1),
                     torch.stack([h02, h12, h22], -1)], -2)
    return (E.cpu().numpy(), grad.cpu().numpy(), H.cpu().numpy(),
            w.sum((1, 2)).cpu().numpy())


def _clamp(v: np.ndarray, size: float) -> np.ndarray:
    n = float(np.linalg.norm(v))
    return v * (min(n, size) / max(n, 1e-12))


class Solve(NamedTuple):
    pose: np.ndarray          # x, y, heading in rad
    iterations: int
    usable: bool
    objective: float
    hessian: np.ndarray
    matched: float


def newton(init_rad, src: torch.Tensor, tab: Table, d1: float, d2: float,
           max_iterations: int, step_size: float, trans_eps: float,
           radius: int = 1) -> Solve:
    """Newton's method on the objective: a ridge lifts the Hessian's
    smallest eigenvalue where it is under a thousandth of the largest;
    the Newton step and the steepest descent, each clamped to
    `step_size`, are tried at the LINE_SEARCH scales, and the lowest
    objective is taken if it improves. It stops when no candidate
    improves, the step taken is under `trans_eps`, or nothing matched."""
    pose = np.asarray(init_rad, np.float64).copy()
    it = 0
    for _ in range(max_iterations):
        E, g, H, m = (v[0] for v in objective(pose[None], src, tab, d1, d2,
                                              radius))
        lam = np.linalg.eigvalsh(H) if np.isfinite(H).all() else None
        ridge = 0.0
        if lam is not None:
            big = max(float(np.abs(lam).max()), 1e-6)
            if lam[0] < 1e-3 * big:
                ridge = -min(lam[0], 0.0) + 1e-2 * big
        A = H + ridge * np.eye(3)
        step = np.zeros(3)
        if np.isfinite(A).all() and abs(np.linalg.det(A)) > 1e-30:
            step = -np.linalg.solve(A, g)
        step = np.where(np.isfinite(step), step, 0.0)
        dirs = (_clamp(step, step_size), _clamp(-g, step_size))
        cands = np.array([f * d for f in LINE_SEARCH for d in dirs])
        Ec = objective(pose[None] + cands, src, tab, d1, d2, radius,
                       derivs=False)
        best = int(np.argmin(Ec))
        it += 1
        if not Ec[best] < E:
            break
        pose = pose + cands[best]
        if np.linalg.norm(cands[best]) < trans_eps or m < 1.0:
            break
    E, g, H, m = (v[0] for v in objective(pose[None], src, tab, d1, d2,
                                          radius))
    usable = m >= 1.0 and len(src) >= 1 and bool(np.isfinite(pose).all())
    return Solve(pose, it, usable, float(E), H, float(m))


def fitness(src_map: torch.Tensor, tgt: torch.Tensor) -> float:
    """Mean squared distance from each source point to its nearest
    target point."""
    if not len(src_map) or not len(tgt):
        return FAR
    return float(nn_sq(src_map, tgt).mean())


def _odometry_cov(mot, last_deg, last_cov, cfg) -> np.ndarray:
    dt = cfg.del_time
    v = math.hypot(mot[0], mot[1]) / dt
    w = math.radians(mot[2]) / dt
    th = math.radians(last_deg[2])
    c, s = math.cos(th), math.sin(th)
    F = np.array([[1, 0, -v * dt * s], [0, 1, v * dt * c], [0, 0, 1.0]])
    A = np.array([[dt * c, 0], [dt * s, 0], [0, dt]])
    M = np.diag([cfg.coe_vel * v * v, cfg.coe_omega * w * w])
    return F @ last_cov @ F.T + A @ M @ A.T


class Registered(NamedTuple):
    fused: np.ndarray         # degrees
    cov: np.ndarray           # (m, m, rad)
    accept: bool
    est: np.ndarray           # the NDT pose, degrees
    cost: float
    iterations: int
    matched: float
    src_live: int
    tgt_live: int


def register(cfg, scan: torch.Tensor, odo, prev_odo, last_pose, last_cov,
             tgt: torch.Tensor) -> Registered:
    """One scan registered against `tgt` from the odometry prediction,
    then gated and fused with the odometry (an EKF update whose
    measurement noise is the inverse of the NDT Hessian, clamped, and
    whose innovation drops the Hessian's near-flat directions); a
    rejected scan takes the prediction and the grown covariance."""
    mot = motion(odo, prev_odo)
    pred = compose(last_pose, mot)
    src = voxel_centroids(scan, cfg.source_leaf_size)
    tab = build_table(tgt, pred, cfg.grid_cells_x, cfg.grid_cells_y,
                      cfg.ndt_resolution, cfg.ndt_min_points_per_cell,
                      cfg.ndt_max_active_cells)
    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)
    init = np.array([pred[0], pred[1], math.radians(pred[2])])
    sol = newton(init, src, tab, d1, d2, cfg.ndt_max_iterations,
                 cfg.ndt_step_size, cfg.ndt_trans_eps, cfg.ndt_neighborhood)
    est = np.array([sol.pose[0], sol.pose[1],
                    math.degrees(wrap_rad(sol.pose[2]))])
    cost = (fitness(to_map(est, src), tgt) if sol.usable
            else cfg.failed_cost)

    last_cov = np.asarray(last_cov, np.float64)
    H = sol.hessian if np.isfinite(sol.hessian).all() else np.eye(3)
    lam, V = np.linalg.eigh(H)
    q = np.clip(cfg.coe_ndt_cov / np.maximum(lam, 1e-3), 1e-6, 1e-2)
    Q = (V * q) @ V.T
    if cfg.fuse_degenerate_ratio > 0:
        keep = lam > cfg.fuse_degenerate_ratio * max(lam[-1], 1e-9)
        P = (V * keep) @ V.T
    else:
        P = np.eye(3)
    cov_odo = _odometry_cov(mot, last_pose, last_cov, cfg)

    def gate(p):
        return (math.hypot(p[0] - pred[0], p[1] - pred[1])
                <= cfg.max_innovation_trans
                and abs(wrap_deg(p[2] - pred[2])) <= cfg.max_innovation_rot)

    S = Q + cov_odo
    S = 0.5 * (S + S.T)
    S = S + (1e-6 * np.trace(S) + 1e-9) * np.eye(3)
    K = np.linalg.solve(S.T, cov_odo.T).T
    cov_k = (np.eye(3) - K) @ cov_odo
    cov_k = 0.5 * (cov_k + cov_k.T)
    innov = P @ np.array([est[0] - pred[0], est[1] - pred[1],
                          math.radians(wrap_deg(est[2] - pred[2]))])
    mu = K @ innov + np.array([pred[0], pred[1], math.radians(pred[2])])
    fused_k = np.array([mu[0], mu[1], math.degrees(wrap_rad(mu[2]))])
    accept = (cost <= cfg.score_thre and gate(est) and gate(fused_k)
              and bool(np.isfinite(fused_k).all()))
    fused, cov = (fused_k, cov_k) if accept else (pred, cov_odo)
    return Registered(fused, cov, accept, est, cost, sol.iterations,
                      sol.matched, len(src), len(tgt))
