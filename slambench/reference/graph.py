"""The reference's back end: the pose graph, the loop candidates, their
verification and the graph's solve.

As the program's configuration states it: every frame a node, chained
by its motion from the one before; every `loop_keyframe_skip`-th node a
keyframe; every `loop_check_skip`-th node a check for keyframes within
`loop_radius` plus `loop_drift_gain` times the drift since, at least
`loop_min_frame_gap` frames old, nearest first by their share of that
radius. A candidate is verified by NDT at coarse-to-fine resolutions
(`loop_stage_mults`; `loop_coarse_starts` starts at the coarsest), a
trimmed point-to-point ICP (Besl and McKay 1992, closed-form 2D
Procrustes), and gates on both overlaps and the ICP error. The graph is
solved by Gauss-Newton on SE(2) (Grisetti et al. 2010) with node 0
held, each step scaled by the best of a short ladder."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from slambench.reference.cloud import nn_sq
from slambench.reference.geometry import motion, to_map, wrap_rad
from slambench.reference.ndt import build_table, gauss_constants, newton

DEG = np.float32(np.pi / 180.0)
LADDER = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


def _rad(p_deg) -> np.ndarray:
    """(x, y, heading) degrees to radians, float32 as the nodes store."""
    return np.array([p_deg[0], p_deg[1], np.deg2rad(p_deg[2])], np.float32)


def _deg(p_rad) -> np.ndarray:
    return np.array([p_rad[0], p_rad[1], np.rad2deg(p_rad[2])], np.float32)


def largest_pos_var(cov) -> float:
    a, b, c = float(cov[0, 0]), float(cov[0, 1]), float(cov[1, 1])
    h = 0.5 * (a + c)
    return max(0.0, h + math.sqrt(max(0.0, (0.5 * (a - c)) ** 2 + b * b)))


def odometry_information(cov_deg) -> np.ndarray:
    """Information of a chain edge: the fused covariance, heading in
    radians, floored at 1 cm and 0.2 deg."""
    J = np.diag([1.0, 1.0, float(DEG)])
    cov = J @ np.asarray(cov_deg, np.float64) @ J.T
    cov = cov + np.diag([1e-4, 1e-4, (0.2 * DEG) ** 2])
    return np.linalg.inv(cov).astype(np.float32)


def loop_information(H, cost: float, sigma_floor: float) -> np.ndarray:
    """Information of a loop edge: the shape of the fine stage's NDT
    Hessian, its strongest direction scaled to 1 / sigma^2 with sigma
    the ICP's RMS error (at least `sigma_floor`)."""
    w, V = np.linalg.eigh((H + H.T) / 2)
    w = np.clip(w, 0.0, None)
    sigma = max(math.sqrt(max(cost, 0.0)), sigma_floor)
    return ((V * (w / (sigma ** 2 * max(float(w[-1]), 1e-9)))) @ V.T
            ).astype(np.float32)


class Verified(NamedTuple):
    z: np.ndarray             # relative pose old -> new, radians
    cost: float
    accepted: bool
    hessian: np.ndarray


def _transform(pose_rad, xy: torch.Tensor) -> torch.Tensor:
    c, s = math.cos(pose_rad[2]), math.sin(pose_rad[2])
    x, y = xy[:, 0].double(), xy[:, 1].double()
    return torch.stack([c * x - s * y + pose_rad[0],
                        s * x + c * y + pose_rad[1]], -1)


def icp(pose_rad, src: torch.Tensor, tgt: torch.Tensor, match: float,
        iterations: int = 10):
    """Trimmed ICP: each iteration pairs every source point with its
    nearest target closer than `match` and applies the closed-form rigid
    fit of the pairs (kept only with 3 pairs or more). Returns (pose,
    matched share, mean squared distance of the matched)."""
    pose = np.asarray(pose_rad, np.float64).copy()
    for _ in range(iterations):
        moved = _transform(pose, src)
        d2, idx = nn_sq(moved, tgt, index=True)
        w = (d2 < match * match).double()
        if float(w.sum()) < 3.0:
            continue
        t = tgt[idx].double()
        ws = w.sum()
        ms = (moved * w[:, None]).sum(0) / ws
        mt = (t * w[:, None]).sum(0) / ws
        a, b = moved - ms, t - mt
        sxx = (w * a[:, 0] * b[:, 0]).sum()
        sxy = (w * a[:, 0] * b[:, 1]).sum()
        syx = (w * a[:, 1] * b[:, 0]).sum()
        syy = (w * a[:, 1] * b[:, 1]).sum()
        dth = float(torch.atan2(sxy - syx, sxx + syy))
        c, s = math.cos(dth), math.sin(dth)
        ms, mt = ms.cpu().numpy(), mt.cpu().numpy()
        dx = mt[0] - (c * ms[0] - s * ms[1])
        dy = mt[1] - (s * ms[0] + c * ms[1])
        pose = np.array([c * pose[0] - s * pose[1] + dx,
                         s * pose[0] + c * pose[1] + dy, pose[2] + dth])
    d2 = nn_sq(_transform(pose, src), tgt)
    hit = d2 < match * match
    n = int(hit.sum())
    mse = float(d2[hit].mean()) if n else 1.0e12
    return pose, n / max(len(src), 1), mse


def verify(cfg, scan: torch.Tensor, old: torch.Tensor, init_rad) -> Verified:
    """Whether the current scan (own frame) matches the keyframe scan
    `old` (own frame) near the relative pose `init_rad`."""
    res = cfg.ndt_resolution
    pose = np.asarray(init_rad, np.float64)
    sol = None
    for stage, mult in enumerate(cfg.loop_stage_mults):
        n = max(16, cfg.grid_cells_x // mult)
        tab = build_table(old, pose, n, max(16, cfg.grid_cells_y // mult),
                          res * mult, cfg.ndt_min_points_per_cell,
                          cfg.ndt_max_active_cells)
        d1, d2 = gauss_constants(res * mult, cfg.ndt_outlier_ratio)
        kw = dict(max_iterations=(cfg.loop_stage_max_iterations
                                  or cfg.ndt_max_iterations),
                  step_size=cfg.ndt_step_size * mult,
                  trans_eps=cfg.ndt_trans_eps * min(mult, 2),
                  radius=cfg.ndt_neighborhood)
        starts = [pose]
        if stage == 0 and cfg.loop_coarse_starts > 1:
            h = res * mult * 0.5
            offs = [(0, 0), (h, 0), (-h, 0), (0, h), (0, -h), (h, h),
                    (-h, -h), (h, -h), (-h, h)][:cfg.loop_coarse_starts]
            starts = [pose + np.array([dx, dy, 0.0]) for dx, dy in offs]
        sols = [newton(p, scan, tab, d1, d2, **kw) for p in starts]
        score = [s.objective if s.usable else math.inf for s in sols]
        sol = sols[int(np.argmin(score))]
        pose = sol.pose
    pose, share, mse = icp(pose, scan, old, cfg.loop_match_dist)
    back = nn_sq(old, to_map(_deg(pose), scan))
    share_old = float((back <= cfg.loop_match_dist ** 2).sum()) / max(
        len(old), 1)
    cost = mse if sol.usable else cfg.failed_cost
    ok = (sol.usable and share >= cfg.loop_min_overlap
          and share_old >= cfg.loop_min_overlap
          and cost <= cfg.loop_score_thre)
    return Verified(pose, cost, bool(ok), sol.hessian)


def _residual(pi, pj, z):
    c, s = np.cos(pi[:, 2]), np.sin(pi[:, 2])
    dx, dy = pj[:, 0] - pi[:, 0], pj[:, 1] - pi[:, 1]
    return np.stack([c * dx + s * dy - z[:, 0], -s * dx + c * dy - z[:, 1],
                     wrap_rad(pj[:, 2] - pi[:, 2] - z[:, 2])], -1)


def _chi2(poses, ii, jj, z, om) -> float:
    r = _residual(poses[ii], poses[jj], z)
    return float(np.einsum("ei,eij,ej->", r, om, r))


def solve_graph(poses_rad, ii, jj, z, om, iterations: int,
                damping: float = 1e-6, device="cpu") -> np.ndarray:
    """Gauss-Newton on the graph (node 0 held): the normal equations
    solved by Cholesky (on `device`), the step scaled by the LADDER
    entry of least chi2, taken only if chi2 does not grow. Returns the
    poses [N,3] (radians). All in float64."""
    poses = np.asarray(poses_rad, np.float64).copy()
    n = len(poses)
    ii, jj = np.asarray(ii), np.asarray(jj)
    z, om = np.asarray(z, np.float64), np.asarray(om, np.float64)
    e = len(ii)
    blocks = torch.from_numpy(np.concatenate(
        [ii * n + ii, ii * n + jj, jj * n + ii, jj * n + jj]))
    ends = torch.from_numpy(np.concatenate([ii, jj]))
    for _ in range(iterations):
        pi, pj = poses[ii], poses[jj]
        r = _residual(pi, pj, z)
        c, s = np.cos(pi[:, 2]), np.sin(pi[:, 2])
        dx, dy = pj[:, 0] - pi[:, 0], pj[:, 1] - pi[:, 1]
        A = np.zeros((e, 3, 3))
        A[:, 0] = np.stack([-c, -s, -s * dx + c * dy], -1)
        A[:, 1] = np.stack([s, -c, -c * dx - s * dy], -1)
        A[:, 2, 2] = -1.0
        B = np.zeros((e, 3, 3))
        B[:, 0, :2] = np.stack([c, s], -1)
        B[:, 1, :2] = np.stack([-s, c], -1)
        B[:, 2, 2] = 1.0
        AtO = A.transpose(0, 2, 1) @ om
        BtO = B.transpose(0, 2, 1) @ om
        vals = np.concatenate([AtO @ A, AtO @ B, BtO @ A, BtO @ B])
        H = torch.zeros((n * n, 9), dtype=torch.float64).index_add_(
            0, blocks, torch.from_numpy(vals.reshape(-1, 9)))
        H = H.reshape(n, n, 3, 3).permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
        g = np.concatenate([(AtO @ r[..., None])[..., 0],
                            (BtO @ r[..., None])[..., 0]])
        b = torch.zeros((n, 3), dtype=torch.float64).index_add_(
            0, ends, torch.from_numpy(g))
        Hf = H[3:, 3:] + damping * torch.eye(3 * n - 3, dtype=torch.float64)
        L, info = torch.linalg.cholesky_ex(Hf.to(device))
        step = torch.cholesky_solve(-b[1:].reshape(-1, 1).to(device),
                                    L)[:, 0].cpu().numpy()
        if int(info) != 0 or not np.isfinite(step).all():
            step = np.zeros(3 * n - 3)
        dxs = np.concatenate([np.zeros(3), step]).reshape(n, 3)
        now = _chi2(poses, ii, jj, z, om)
        best, best_chi = None, math.inf
        for f in LADDER:
            cand = poses + f * dxs
            cand[:, 2] = np.arctan2(np.sin(cand[:, 2]), np.cos(cand[:, 2]))
            chi = _chi2(cand, ii, jj, z, om)
            if chi < best_chi:
                best, best_chi = cand, chi
        if best_chi <= now:
            poses = best
    return poses


class Graph:
    """Nodes, chain and loop edges, keyframes (scans in their own
    frame), and the drift that widens the candidate search."""

    def __init__(self, cfg, device="cpu"):
        self.cfg = cfg
        self.device = device          # where the graph's solve runs
        self.nodes = []               # float32 radians
        self.sids = []
        self.chain = []               # (z radians, information)
        self.loops = []               # (i, j, z radians, information)
        self.kf = []                  # [sid, pose deg, scan, drift]
        self.drift = 0.0

    def add(self, sid: int, pose_deg, cov, scan: torch.Tensor):
        pose_deg = np.asarray(pose_deg, np.float32)
        node = len(self.nodes)
        self.nodes.append(_rad(pose_deg))
        self.sids.append(int(sid))
        self.drift += largest_pos_var(np.asarray(cov))
        if node > 0:
            prev = _deg(self.nodes[node - 1])
            z = motion(pose_deg, prev).astype(np.float32)
            self.chain.append((_rad(z), odometry_information(cov)))
        if node % max(1, self.cfg.loop_keyframe_skip) == 0:
            if len(self.kf) >= self.cfg.max_keyframes:
                self.kf = self.kf[::2]
            self.kf.append([int(sid), pose_deg.copy(), scan, self.drift])

    def candidates(self, pose_deg, sid: int) -> list:
        """The keyframes to verify, as indices into `kf`."""
        cfg = self.cfg
        if not self.kf:
            return []
        poses = np.stack([k[1] for k in self.kf])
        d = np.hypot(poses[:, 0] - pose_deg[0], poses[:, 1] - pose_deg[1])
        radius = np.full(d.shape, cfg.loop_radius, np.float64)
        if cfg.loop_drift_gain > 0.0 and self.drift > 0.0:
            drift = np.asarray([k[3] for k in self.kf], np.float64)
            radius = radius + cfg.loop_drift_gain * np.sqrt(
                np.maximum(0.0, self.drift - drift))
        sids = np.asarray([k[0] for k in self.kf])
        idx = np.nonzero((d <= radius)
                         & (sid - sids >= cfg.loop_min_frame_gap))[0]
        idx = idx[np.argsort(d[idx] / np.maximum(radius[idx], 1e-9),
                             kind="stable")]
        return idx[:cfg.loop_max_candidates].tolist()

    def check(self, sid: int, pose_deg, scan: torch.Tensor, cand) -> dict:
        """{keyframe sid: (z radians, information)} of the candidates
        `cand` that verify."""
        out = {}
        for k in cand:
            s_old, p_old, old, _ = self.kf[k]
            init = _rad(motion(np.asarray(pose_deg, np.float32),
                               p_old).astype(np.float32))
            v = verify(self.cfg, scan, old, init)
            if v.accepted:
                out[s_old] = (v.z, loop_information(
                    v.hessian, v.cost, self.cfg.loop_info_sigma_floor))
        return out

    def add_loops(self, sid: int, found: dict):
        rows = {s: i for i, s in enumerate(self.sids)}
        for s_old, (z, om) in found.items():
            self.loops.append((rows[s_old], rows[sid],
                               np.asarray(z, np.float32), om))

    def solve(self) -> np.ndarray:
        """The corrected poses of every node (degrees, float32)."""
        n = len(self.nodes)
        ii = list(range(n - 1)) + [e[0] for e in self.loops]
        jj = list(range(1, n)) + [e[1] for e in self.loops]
        z = [c[0] for c in self.chain] + [e[2] for e in self.loops]
        om = [c[1] for c in self.chain] + [e[3] for e in self.loops]
        poses = solve_graph(np.stack(self.nodes), ii, jj, np.stack(z),
                            np.stack(om), self.cfg.pgo_iterations,
                            device=self.device)
        return np.stack([_deg(p.astype(np.float32)) for p in poses])

    def take(self, poses_deg):
        """Corrected poses (degrees) for every node and keyframe."""
        rows = {s: i for i, s in enumerate(self.sids)}
        self.nodes = [_rad(p) for p in poses_deg]
        for k in self.kf:
            k[1] = np.asarray(poses_deg[rows[k[0]]], np.float32).copy()
