"""SE(2) pose-graph optimisation (port of
`ndt_slam_tpu.graph.pose_graph`).

Edge (i, j) stores the measured relative pose z_ij in frame i; its
residual is

    r = [R_i^T (t_j - t_i) - z_t,  wrap(th_j - th_i - z_th)]

weighted by the 3x3 information Omega_ij. Angles are radians here.
Buffers have fixed capacities with node and edge masks, as in the JAX
package; node 0 is the gauge and stays where it is.

- `optimize`: dense Gauss-Newton on the [3N,3N] normal equations, node
  0 and the invalid nodes eliminated exactly (identity diagonal, zero
  right-hand side), `cholesky_ex` + `cholesky_solve` on the device (a
  failed factorization or a non-finite step gives a zero step, decided
  on the device: no host sync), and a ladder of six scaled steps scored
  as one [6,N,3] batch, the best kept only if it lowers chi2. A fixed
  number of iterations, so no host read at all.
- `optimize_pcg`: matrix-free Gauss-Newton with preconditioned CG (the
  3x3 block-Jacobi or the chain-aware segment preconditioner), O(N+E)
  memory.
- `optimize_hierarchical`: chain condensation onto every `seg_len`-th
  node (numpy on the host), a dense solve of the coarse graph, rigid
  prolongation and a PCG polish of the full graph, in V-cycles.

Two things differ from the JAX package in how, not in what:

- Scatter-adds into the normal equations reduce in a fixed order.
  `.at[].add` has no deterministic counterpart on CUDA (float
  `index_add_` uses atomics), so the contributions' target ids are
  sorted once per solve (stable: `core.segment.SortedSegments`) and
  every assembly is a gather plus a front-to-back segment sum, the
  order a sequential scatter-add takes. Two runs give the same bits, as
  bitwise resume needs.
- `lax.while_loop` becomes a Python loop whose continue flag stays on
  the device: the CG state is updated under that flag (`torch.where`),
  so iterations after convergence change no bit, and the host reads the
  flag only every `CG_POLL` iterations; the Gauss-Newton loop of
  `optimize_pcg` reads its chi2-plateau flag once a step.

`make_sharded_optimize` (edges sharded over devices) comes with the
distributed slice of the port.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ndt_slam_tpu_torch.core.segment import SortedSegments

# Host reads of the conjugate-gradient loop's continue flag: every
# CG_POLL iterations (one sync each).
CG_POLL = 16


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph (all tensors on one device).

    nodes:  poses_rad [N,3] (tx, ty, th_rad), node_mask [N]
    edges:  idx_i/idx_j [E] int64, z_rad [E,3] relative measurement,
            omega [E,3,3] information, edge_mask [E]
    """
    poses_rad: torch.Tensor
    node_mask: torch.Tensor
    idx_i: torch.Tensor
    idx_j: torch.Tensor
    z_rad: torch.Tensor
    omega: torch.Tensor
    edge_mask: torch.Tensor

    @property
    def capacity_nodes(self) -> int:
        return self.poses_rad.shape[0]

    @property
    def capacity_edges(self) -> int:
        return self.idx_i.shape[0]


def empty_graph(max_nodes: int, max_edges: int, device="cuda") -> PoseGraph:
    f32 = dict(dtype=torch.float32, device=device)
    return PoseGraph(
        poses_rad=torch.zeros((max_nodes, 3), **f32),
        node_mask=torch.zeros((max_nodes,), dtype=torch.bool, device=device),
        idx_i=torch.zeros((max_edges,), dtype=torch.int64, device=device),
        idx_j=torch.zeros((max_edges,), dtype=torch.int64, device=device),
        z_rad=torch.zeros((max_edges, 3), **f32),
        omega=torch.zeros((max_edges, 3, 3), **f32),
        edge_mask=torch.zeros((max_edges,), dtype=torch.bool, device=device),
    )


def graph_from_numpy(poses, node_mask, idx_i, idx_j, z, omega, edge_mask,
                     device) -> PoseGraph:
    """A PoseGraph on `device` from host arrays."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return PoseGraph(
        poses_rad=t(poses, np.float32), node_mask=t(node_mask, bool),
        idx_i=t(idx_i, np.int64), idx_j=t(idx_j, np.int64),
        z_rad=t(z, np.float32), omega=t(omega, np.float32),
        edge_mask=t(edge_mask, bool),
    )


def _wrap(th):
    return torch.atan2(torch.sin(th), torch.cos(th))


# Backtracking ladder for the GN step: plain full steps diverge from
# large-drift starts (rotation residuals are strongly nonlinear), so a
# few scaled steps are scored and the best chi2 kept (the stand-in for
# a trust region); none is taken if none improves.
_STEP_LADDER = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


@functools.lru_cache(maxsize=None)
def _ladder(device: torch.device) -> torch.Tensor:
    """[6] step scales on `device`, copied once (a host-to-device copy
    waits for the stream)."""
    return torch.tensor(_STEP_LADDER, dtype=torch.float32, device=device)


def _best_step(poses, dx, node_f, chi2_of):
    """Poses advanced by the ladder step with the lowest chi2 (the first
    on a tie), or unchanged if no step improves. The six candidates are
    one [6,N,3] batch."""
    scales = _ladder(poses.device)
    cand = poses + scales[:, None, None] * dx * node_f[:, None]
    cand = torch.cat([cand[..., :2], _wrap(cand[..., 2:])], dim=-1)
    chis = chi2_of(cand)
    best = torch.argmin(chis).reshape(1)
    keep = chis.index_select(0, best)[0] <= chi2_of(poses)
    return torch.where(keep, cand.index_select(0, best)[0], poses)


def edge_residual(pose_i, pose_j, z):
    """r [...,3] of edges [...,3]; see the module docstring."""
    c, s = torch.cos(pose_i[..., 2]), torch.sin(pose_i[..., 2])
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    rx = c * dx + s * dy
    ry = -s * dx + c * dy
    return torch.stack(
        [rx - z[..., 0], ry - z[..., 1],
         _wrap(pose_j[..., 2] - pose_i[..., 2] - z[..., 2])], dim=-1)


def _edge_jacobians(pose_i, pose_j):
    """(A [...,3,3], B [...,3,3]) = d r / d pose_i, d r / d pose_j."""
    c, s = torch.cos(pose_i[..., 2]), torch.sin(pose_i[..., 2])
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    A = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], dim=-1),
        torch.stack([s, -c, -c * dx - s * dy], dim=-1),
        torch.stack([zero, zero, -one], dim=-1),
    ], dim=-2)
    B = torch.stack([
        torch.stack([c, s, zero], dim=-1),
        torch.stack([-s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return A, B


def _masked_omega(graph: PoseGraph):
    return graph.omega * graph.edge_mask.to(torch.float32)[:, None, None]


def _chi2(graph: PoseGraph, om, poses):
    """chi2 of poses [..., N, 3] (a leading batch gives one a batch row);
    `om` is the masked information."""
    r = edge_residual(poses.index_select(-2, graph.idx_i),
                      poses.index_select(-2, graph.idx_j), graph.z_rad)
    return torch.einsum("...ei,eij,...ej->...", r, om, r)


def _edge_terms(graph: PoseGraph, om, poses):
    """Per-edge residuals and Jacobians with the A^T Omega, B^T Omega
    products. [E,...]"""
    pi = poses.index_select(0, graph.idx_i)
    pj = poses.index_select(0, graph.idx_j)
    r = edge_residual(pi, pj, graph.z_rad)
    A, B = _edge_jacobians(pi, pj)
    AtO = A.transpose(-1, -2) @ om
    BtO = B.transpose(-1, -2) @ om
    return r, A, B, AtO, BtO


def _free(graph: PoseGraph):
    """[N] 1 for the nodes being solved for (valid, not the anchor)."""
    free = graph.node_mask.to(torch.float32).clone()
    free[0] = 0.0
    return free


def _gauge_diag(free, damping: float):
    """[N,3,3]: damping on the free nodes' diagonal, identity on the
    fixed and invalid ones (keeps the system SPD at full shape)."""
    eye = torch.eye(3, dtype=torch.float32, device=free.device)
    return (damping * free[:, None, None] * eye
            + (1.0 - free)[:, None, None] * eye)


def optimize(graph: PoseGraph, iterations: int = 20,
             damping: float = 1e-6):
    """Dense Gauss-Newton. Returns (poses_rad [N,3], final chi2), on the
    graph's device.

    Node 0 is anchored exactly: its rows and columns are eliminated
    from the normal equations (identity diagonal, zero right-hand side)
    rather than pinned by a huge prior, which inside an f32 Cholesky
    destroys the conditioning. Invalid nodes get the same treatment so
    H stays SPD at full shape."""
    n = graph.capacity_nodes
    om = _masked_omega(graph)
    free = _free(graph)
    node_f = graph.node_mask.to(torch.float32)
    ii, jj = graph.idx_i, graph.idx_j
    # the four blocks of every edge and the two halves of its gradient,
    # summed in a fixed order
    blocks = SortedSegments(torch.cat([ii * n + ii, ii * n + jj,
                                       jj * n + ii, jj * n + jj]), n * n)
    nodes = SortedSegments(torch.cat([ii, jj]), n)
    fm = (free[:, None] * free[None, :])[:, :, None, None]
    diag = _gauge_diag(free, damping)
    rows = torch.arange(n, device=free.device)

    def chi2_of(p):
        return _chi2(graph, om, p)

    poses = graph.poses_rad
    for _ in range(iterations):
        r, A, B, AtO, BtO = _edge_terms(graph, om, poses)
        H_ij = AtO @ B
        H = blocks.sum(torch.cat([
            AtO @ A, H_ij, H_ij.transpose(-1, -2), BtO @ B,
        ]).reshape(-1, 9)).reshape(n, n, 3, 3) * fm
        H[rows, rows] = H[rows, rows] + diag
        b = nodes.sum(torch.cat([(AtO @ r[:, :, None])[..., 0],
                                 (BtO @ r[:, :, None])[..., 0]]))
        b = b * free[:, None]
        L, info = torch.linalg.cholesky_ex(
            H.permute(0, 2, 1, 3).reshape(3 * n, 3 * n))
        dx = torch.cholesky_solve(-b.reshape(3 * n, 1), L)[:, 0]
        dx = torch.where((info == 0) & torch.isfinite(dx), dx, 0.0)
        poses = _best_step(poses, dx.reshape(n, 3), node_f, chi2_of)
    return poses, chi2_of(poses)


def _pcg(hvp, rhs, precond, max_iters: int, tol: float):
    """Preconditioned CG for H x = rhs (x [N,3]): `hvp` applies the
    projected Gauss-Newton Hessian, `precond` the (SPD) preconditioner
    inverse. Stops when |r|^2 <= tol^2 |rhs|^2 or after max_iters.

    The JAX package's record stands: a residual-stagnation early exit
    degraded the 4096-node sweep (CG residuals plateau non-monotonically
    on clustered spectra); runaway CG cost is the segment
    preconditioner's job (`optimize_pcg`). Returns (x, iterations)."""
    def dot(a, b):
        return torch.sum(a * b)

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    stop = torch.clamp(dot(r, r), min=1e-30) * (tol * tol)
    active = dot(r, r) > stop
    k = torch.zeros((), dtype=torch.int32, device=rhs.device)
    for it in range(max_iters):
        if it % CG_POLL == 0 and not bool(active):
            break
        hp = hvp(p)
        rz = dot(r, z)
        alpha = rz / torch.clamp(dot(p, hp), min=1e-30)
        r_new = r - alpha * hp
        z_new = precond(r_new)
        beta = dot(r_new, z_new) / torch.clamp(rz, min=1e-30)
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, z_new + beta * p, p)
        z = torch.where(active, z_new, z)
        k = k + active.to(torch.int32)
        active = active & (dot(r, r) > stop)
    return x, k


def optimize_pcg(graph: PoseGraph, iterations: int = 20, cg_iters: int = 512,
                 cg_tol: float = 1e-5, damping: float = 1e-6,
                 precond_seg_len: int = 0):
    """Matrix-free GN/PCG solve. Same contract as `optimize` (node 0
    held at its input value) with O(N + E) memory: Gauss-Newton with
    PCG steps, until `iterations` steps or a step that lowers chi2 by
    less than 0.1 %.

    precond_seg_len > 0 selects the chain-aware segment preconditioner
    (the node capacity must be a multiple of it): nodes are grouped into
    runs of that length and the per-segment dense sub-Hessians
    [M, 3L, 3L] are assembled and inverted once per solve, from the
    initial linearization, so that every application solves the odometry
    chain exactly within segments instead of only its 3x3 diagonal.
    Cross-segment couplings keep only their diagonal blocks, which
    preserves SPD. The JAX package measured both lessons kept here:
    apply an explicit inverse (not triangular solves), and let the
    preconditioner lag the linearization (CG only takes its search
    directions from it). 0 selects block Jacobi, rebuilt every step."""
    n = graph.capacity_nodes
    om = _masked_omega(graph)
    node_f = graph.node_mask.to(torch.float32)
    free = _free(graph)
    ff = free[:, None]
    diag = _gauge_diag(free, damping)
    ii, jj = graph.idx_i, graph.idx_j
    nodes = SortedSegments(torch.cat([ii, jj]), n)
    if precond_seg_len > 0 and n % precond_seg_len:
        raise ValueError(f"node capacity {n} is no multiple of the "
                         f"segment length {precond_seg_len}")

    def chi2_of(p):
        return _chi2(graph, om, p)

    def seg_inverse(poses):
        """The [M, 3L, 3L] inverses of the per-segment sub-Hessians at
        `poses`; a segment whose inversion failed is NaN, so that the
        preconditioner falls back to the identity there."""
        L = precond_seg_len
        m = n // L
        _, A, B, AtO, BtO = _edge_terms(graph, om, poses)
        fi = free.index_select(0, ii)[:, None, None]
        fj = free.index_select(0, jj)[:, None, None]
        si, sj, oi, oj = ii // L, jj // L, ii % L, jj % L
        cpl = (si == sj).to(torch.float32)[:, None, None] * fi * fj
        H_ij = AtO @ B
        ids = torch.cat([si * L * L + oi * L + oi, sj * L * L + oj * L + oj,
                         si * L * L + oi * L + oj, si * L * L + oj * L + oi])
        blocks = SortedSegments(ids, m * L * L).sum(torch.cat([
            (AtO @ A) * fi, (BtO @ B) * fj, H_ij * cpl,
            H_ij.transpose(-1, -2) * cpl,
        ]).reshape(-1, 9)).reshape(m * L * L, 3, 3)
        at = torch.arange(n, device=free.device)
        at = at // L * (L * L) + (at % L) * (L + 1)
        blocks[at] = blocks[at] + diag
        hseg = blocks.reshape(m, L, L, 3, 3).permute(0, 1, 3, 2, 4)
        inv, info = torch.linalg.inv_ex(hseg.reshape(m, 3 * L, 3 * L))
        return torch.where((info == 0)[:, None, None], inv, float("nan"))

    if precond_seg_len > 0:
        minv_seg = seg_inverse(graph.poses_rad)

        def seg_precond(v):
            vf = (v * ff).reshape(minv_seg.shape[0], -1, 1)
            out = (minv_seg @ vf).reshape(n, 3) * ff
            # a failed segment must not poison CG: identity there
            return torch.where(torch.isfinite(out), out, v * ff)

    def jacobi_precond(A, B, AtO, BtO):
        D = nodes.sum(torch.cat([AtO @ A, BtO @ B]).reshape(-1, 9))
        inv, info = torch.linalg.inv_ex(D.reshape(n, 3, 3) + diag)
        minv = torch.where((info == 0)[:, None, None], inv, float("nan"))

        def precond(v):
            return (minv @ v[:, :, None])[..., 0] * ff
        return precond

    def gn_step(poses):
        r, A, B, AtO, BtO = _edge_terms(graph, om, poses)
        b = nodes.sum(torch.cat([(AtO @ r[:, :, None])[..., 0],
                                 (BtO @ r[:, :, None])[..., 0]]))
        precond = (seg_precond if precond_seg_len > 0
                   else jacobi_precond(A, B, AtO, BtO))

        def hvp(v):
            vf = v * ff
            u = ((A @ vf.index_select(0, ii)[:, :, None])
                 + (B @ vf.index_select(0, jj)[:, :, None]))
            out = nodes.sum(torch.cat([(AtO @ u)[..., 0],
                                       (BtO @ u)[..., 0]]))
            out = out + damping * vf
            # identity on fixed and invalid rows keeps the operator SPD
            return out * ff + v * (1.0 - ff)

        dx, _ = _pcg(hvp, -b * ff, precond, cg_iters, cg_tol)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        return _best_step(poses, dx, node_f, chi2_of)

    # the chi2-plateau exit: a step that lowers chi2 by less than 0.1 %
    # ends the loop (warm solves finish in two or three steps)
    poses = graph.poses_rad
    prev = torch.full((), float("inf"), device=poses.device)
    cur = chi2_of(poses)
    for _ in range(iterations):
        if not bool(cur < prev * 0.999):
            break
        poses = gn_step(poses)
        prev, cur = cur, chi2_of(poses)
    return poses, cur


# ---------------------------------------------------------------------------
# Hierarchical solve: Schur-style condensation onto separator nodes.
#
# A SLAM trajectory is a chain (the odometry backbone) plus sparse loop
# edges. A segment's odometry measurements compose into one relative
# constraint between its separators, and loop edges re-anchor to
# separators through the current within-segment offsets. The coarse
# graph (n / seg_len nodes) is solved densely, each segment is carried
# rigidly by its leading separator, and a short PCG polish restores the
# interior detail.
# ---------------------------------------------------------------------------


def _compose_z(a, b):
    """SE(2) compose of relative measurements a ∘ b (numpy [...,3])."""
    ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([
        a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
        a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
        a[..., 2] + b[..., 2],
    ], axis=-1)


def _inv_z(a):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([
        -(c * a[..., 0] + s * a[..., 1]),
        -(-s * a[..., 0] + c * a[..., 1]),
        -a[..., 2],
    ], axis=-1)


def _compose_cov(a, cov_a, b, cov_b):
    """First-order covariance of a ∘ b (numpy, batched)."""
    ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
    bx, by = b[..., 0], b[..., 1]
    n = a.shape[0]
    Ja = np.tile(np.eye(3, dtype=np.float64), (n, 1, 1))
    Ja[:, 0, 2] = -sa * bx - ca * by
    Ja[:, 1, 2] = ca * bx - sa * by
    Jb = np.zeros((n, 3, 3))
    Jb[:, 0, 0] = ca
    Jb[:, 0, 1] = -sa
    Jb[:, 1, 0] = sa
    Jb[:, 1, 1] = ca
    Jb[:, 2, 2] = 1.0
    return (
        Ja @ cov_a @ Ja.transpose(0, 2, 1)
        + Jb @ cov_b @ Jb.transpose(0, 2, 1)
    )


def optimize_hierarchical(
    poses_rad: np.ndarray,
    chain_z: np.ndarray,
    chain_omega: np.ndarray,
    loop_i: np.ndarray,
    loop_j: np.ndarray,
    loop_z: np.ndarray,
    loop_omega: np.ndarray,
    seg_len: int = 32,
    coarse_iterations: int = 20,
    fine_iterations: int = 10,
    cg_iters: int = 1024,
    cg_tol: float = 1e-4,
    cycles: int = 3,
    device="cuda",
) -> np.ndarray:
    """Two-level pose-graph solve for chain + loops trajectories.

    poses_rad [n,3]; chain edge k connects nodes (k, k+1) with
    measurement chain_z[k] and information chain_omega[k]; loop edges
    are arbitrary (i, j) pairs. Returns corrected poses [n,3] (radians,
    host numpy). The condensation is O(n) numpy on the host; both
    solves run on `device`."""
    n = poses_rad.shape[0]
    if n <= seg_len + 1:
        g = pack_graph(poses_rad, chain_z, chain_omega,
                       loop_i, loop_j, loop_z, loop_omega, device)
        out, _ = optimize(g, iterations=coarse_iterations)
        return out[:n].cpu().numpy()

    # separators: 0, seg_len, 2*seg_len, ..., and the last node
    seps = np.arange(0, n, seg_len)
    if seps[-1] != n - 1:
        seps = np.append(seps, n - 1)
    M = len(seps)
    seg_of = np.minimum(np.arange(n) // seg_len, M - 2)  # node -> coarse

    # coarse odometry edges: composed (z, cov) per segment, batched over
    # the segments (padded with identity motions and zero covariance)
    cov_chain = np.linalg.inv(
        chain_omega.astype(np.float64) + 1e-12 * np.eye(3)[None]
    )
    seg_lens = np.diff(seps)
    Lmax = int(seg_lens.max())
    z_pad = np.zeros((M - 1, Lmax, 3), np.float64)
    cov_pad = np.zeros((M - 1, Lmax, 3, 3), np.float64)
    for m in range(M - 1):
        lo, hi = seps[m], seps[m + 1]
        z_pad[m, : hi - lo] = chain_z[lo:hi].astype(np.float64)
        cov_pad[m, : hi - lo] = cov_chain[lo:hi]
    z = np.zeros((M - 1, 3))
    cov = np.zeros((M - 1, 3, 3))
    for t in range(Lmax):
        cov = _compose_cov(z, cov, z_pad[:, t], cov_pad[:, t])
        z = _compose_z(z, z_pad[:, t])
    cz = z
    ccov = cov

    # coarse loop information: the loop's own (intra-segment loops drop
    # out of the coarse level; the polish owns the fine geometry)
    li = seg_of[loop_i].astype(np.int32) if len(loop_i) else loop_i
    lj = seg_of[loop_j].astype(np.int32) if len(loop_j) else loop_j
    keep = li != lj
    li, lj = li[keep], lj[keep]
    om_l = loop_omega[keep].astype(np.float64)
    loop_i_k, loop_j_k = loop_i[keep], loop_j[keep]
    loop_z_k = loop_z[keep].astype(np.float64)

    def rel_of(P, a, b):
        """Batched measured-frame relative pose P[a] -> P[b]."""
        c, s = np.cos(P[a, 2]), np.sin(P[a, 2])
        dx, dy = P[b, 0] - P[a, 0], P[b, 1] - P[a, 1]
        th = np.arctan2(np.sin(P[b, 2] - P[a, 2]),
                        np.cos(P[b, 2] - P[a, 2]))
        return np.stack([c * dx + s * dy, -s * dx + c * dy, th], axis=1)

    # V-cycles: coarse correction -> rigid prolongation -> PCG polish.
    # The condensed chain measurements are fixed; loop edges re-anchor
    # to separators through the current estimate each cycle. (The JAX
    # package records an early exit after the first cycle as a negative:
    # it skipped the second cycle's real improvement.)
    com = np.linalg.inv(ccov + 1e-12 * np.eye(3)[None])
    cur = poses_rad.astype(np.float64)
    prev_chi2 = np.inf
    fine_graph = None
    for _cycle in range(max(1, cycles)):
        off_i = rel_of(cur, seps[li], loop_i_k)
        off_j = rel_of(cur, seps[lj], loop_j_k)
        zl = _compose_z(_compose_z(off_i, loop_z_k), _inv_z(off_j))
        cg_graph = pack_graph(
            cur[seps].astype(np.float32),
            cz.astype(np.float32), com.astype(np.float32),
            li, lj, zl.astype(np.float32), om_l.astype(np.float32), device,
        )
        coarse_out, _ = optimize(cg_graph, iterations=coarse_iterations)
        coarse_out = coarse_out[:M].cpu().numpy().astype(np.float64)

        # prolongation: carry each segment rigidly by its separator
        delta = _compose_z(coarse_out, _inv_z(cur[seps]))
        d = delta[seg_of]
        c, s = np.cos(d[:, 2]), np.sin(d[:, 2])
        new = np.stack([
            d[:, 0] + c * cur[:, 0] - s * cur[:, 1],
            d[:, 1] + s * cur[:, 0] + c * cur[:, 1],
            d[:, 2] + cur[:, 2],
        ], axis=1)
        new[seps] = coarse_out
        new[:, 2] = np.arctan2(np.sin(new[:, 2]), np.cos(new[:, 2]))

        # fine polish: a short PCG solve of the full graph with the
        # segment preconditioner (its length floored to a power of two,
        # so that it divides the padded node capacity); the edges do
        # not change between cycles, only the poses
        if fine_graph is None:
            fine_graph = pack_graph(
                new.astype(np.float32), chain_z, chain_omega,
                loop_i, loop_j, loop_z, loop_omega, device,
            )
            pl = 1 << max(0, int(seg_len).bit_length() - 1)
            pl = min(pl, fine_graph.capacity_nodes)
        poses_pad = np.zeros((fine_graph.capacity_nodes, 3), np.float32)
        poses_pad[:n] = new.astype(np.float32)
        out, chi2 = optimize_pcg(
            fine_graph._replace(
                poses_rad=torch.from_numpy(poses_pad).to(device)),
            iterations=fine_iterations,
            cg_iters=cg_iters, cg_tol=cg_tol,
            precond_seg_len=pl,
        )
        cur = out[:n].cpu().numpy().astype(np.float64)
        chi2 = float(chi2)
        # converged: a further cycle would not move the coarse level
        if chi2 >= prev_chi2 * 0.99:
            break
        prev_chi2 = chi2
    return cur.astype(np.float32)


def pack_graph(poses_rad, chain_z, chain_omega,
               loop_i, loop_j, loop_z, loop_omega, device) -> PoseGraph:
    """Pad a chain + loops edge set (host arrays; chain edge k connects
    nodes k and k+1) into a PoseGraph on `device` whose capacities are
    powers of two, at least 16: the chain's edges first, then the
    loops'."""
    n = poses_rad.shape[0]
    e = (n - 1) + len(loop_i)
    N = max(16, 1 << (n - 1).bit_length())
    E = max(16, 1 << max(e - 1, 1).bit_length())
    poses = np.zeros((N, 3), np.float32)
    poses[:n] = poses_rad
    nm = np.zeros(N, bool)
    nm[:n] = True
    ii = np.zeros(E, np.int64)
    jj = np.zeros(E, np.int64)
    zz = np.zeros((E, 3), np.float32)
    om = np.zeros((E, 3, 3), np.float32)
    em = np.zeros(E, bool)
    ii[:n - 1] = np.arange(n - 1)
    jj[:n - 1] = np.arange(1, n)
    zz[:n - 1] = chain_z
    om[:n - 1] = chain_omega
    em[:n - 1] = True
    if len(loop_i):
        ii[n - 1:e] = loop_i
        jj[n - 1:e] = loop_j
        zz[n - 1:e] = loop_z
        om[n - 1:e] = loop_omega
        em[n - 1:e] = True
    return graph_from_numpy(poses, nm, ii, jj, zz, om, em, device)
