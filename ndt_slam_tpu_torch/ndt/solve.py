"""Newton solve for NDT registration (port of `ndt_slam_tpu.ndt.solve`).

Up to `max_iterations` Newton steps on the 3-DoF objective, with a
Levenberg ridge keyed off the smallest Hessian eigenvalue (closed-form
3x3 bounds), step-norm clamping to `step_size`, and a batched
backtracking line search: 2 directions (damped Newton, steepest
descent) x 6 step scales = 12 candidate poses scored in one
`kernels.ndt_scores` call. The loop ends when the applied step norm
drops below `trans_eps`, no candidate improves, or nothing matched.

On CUDA tensors against a `CompactGrid` (or rows on a `GridStack`),
without `axis`, the whole loop is one launch of `kernels.ndt_newton`:
the iterations, the stop and the final derivatives run on the card, a
block a row, and the host reads nothing until the caller does.

Everywhere else the loop is stepwise, in tensor code around the score
calls: on CPU tensors (the kernel's plain twin, the compact table's
kernels' twins under it), on an `NDTGrid` (the dense-window gather
engine of `ndt/score.py`) and with `axis` (the sums need a collective
between iterations). `lax.while_loop` has no counterpart there. The
loop keeps its `done` flag on the device and updates pose and
iteration count under the mask `~done`, so the result equals the JAX
loop's whatever the host does. The host reads the flag only every
`DONE_POLL` iterations (one sync) to stop early; between two reads at
most DONE_POLL-1 iterations run masked after convergence. The kernel
stops a row where this loop stops it, and its pose and count are the
masked loop's.

A row axis stands in for the JAX package's `vmap` of `align` (the
loop-closure verifier's coarse starts and candidates, the lockstep
runner's sequences): R poses [R,3], row r against grid `grid_index[r]`
of a `GridStack` or of a stacked `NDTGrid`. `done` and the iteration
count are [R], a row that is done stays masked as the vmapped
`while_loop` keeps it, and the host polls `done.all()`. The 3x3
algebra runs on [R,3,3] in the same operations as for one pose, so an
iteration issues as many small operations for 20 rows as for one; the
two score calls take all rows (and their 12 line-search candidates
each) at once.

With `axis` (`parallel.dist.Axis`, the JAX package's `axis_name`) the
source is this rank's shard of the points: the partial sums of (E, g,
H, matched), the 12 candidate scores and the source count are summed
over the axis's ranks, so every rank runs the same Newton iteration on
the same bits. On CUDA tensors the window kernels run on the shard and
their sums are the partials.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ndt_slam_tpu_torch.ndt import score as gather
from ndt_slam_tpu_torch.ndt.compact import CompactGrid, GridStack
from ndt_slam_tpu_torch.ndt.grid import NDTGrid
from ndt_slam_tpu_torch.ndt.kernels import (
    ndt_newton, ndt_score_grad_hess, ndt_score_grad_hess_grids, ndt_scores,
    ndt_scores_grids,
)

# Candidate step-length scales evaluated in parallel each iteration.
_LS_SCALES = np.array([1.0, 0.5, 0.25, 0.1, 0.04, 0.015], dtype=np.float32)

# Host reads of the device-side done flag: every DONE_POLL iterations.
DONE_POLL = 2

# Calls of the stepwise loop on CUDA tensors (the gather engine, the
# sharded solve): `stepwise_cuda_calls()`, `reset_stepwise_count()`.
_stepwise_cuda = 0


def stepwise_cuda_calls() -> int:
    """Calls of `align` on CUDA tensors that took the stepwise loop."""
    return _stepwise_cuda


def reset_stepwise_count():
    global _stepwise_cuda
    _stepwise_cuda = 0


def _sym3_eig_bounds(H):
    """(min_eig, max_abs_eig) of a symmetric 3x3 [..., 3, 3], closed form
    (Smith's trigonometric method)."""
    q = (H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]) / 3.0
    p1 = H[..., 0, 1] ** 2 + H[..., 0, 2] ** 2 + H[..., 1, 2] ** 2
    p2 = ((H[..., 0, 0] - q) ** 2 + (H[..., 1, 1] - q) ** 2
          + (H[..., 2, 2] - q) ** 2 + 2.0 * p1)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=1e-20)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    B = (H - q[..., None, None] * eye) / safe_p[..., None, None]
    b = [[B[..., i, j] for j in range(3)] for i in range(3)]
    detB = (
        b[0][0] * (b[1][1] * b[2][2] - b[1][2] * b[2][1])
        - b[0][1] * (b[1][0] * b[2][2] - b[1][2] * b[2][0])
        + b[0][2] * (b[1][0] * b[2][1] - b[1][1] * b[2][0])
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    # p == 0: H is q*I, all eigenvalues equal q
    e_max = torch.where(p2 > 0.0, e_max, q)
    e_min = torch.where(p2 > 0.0, e_min, q)
    return e_min, torch.maximum(torch.abs(e_min), torch.abs(e_max))


def _solve3(A, b):
    """x = A^-1 b for 3x3 [..., 3, 3] via the adjugate (Cramer)."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / det, 0.0)
    if b.dim() == 1:
        adjT = torch.stack([
            torch.stack([c00, c10, c20]),
            torch.stack([c01, c11, c21]),
            torch.stack([c02, c12, c22]),
        ])
        return inv_det * (adjT @ b)
    # rows: the products written out (a batched matmul's summation order
    # could depend on the batch)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x = torch.stack([c00 * b0 + c10 * b1 + c20 * b2,
                     c01 * b0 + c11 * b1 + c21 * b2,
                     c02 * b0 + c12 * b1 + c22 * b2], dim=-1)
    return inv_det[..., None] * x


class NDTResult(NamedTuple):
    """One pose, or [R] leading every field for R rows."""
    pose_rad: torch.Tensor    # [3] converged pose (tx, ty, th_rad)
    iterations: torch.Tensor  # int32
    converged: torch.Tensor   # bool: grid/source were usable
    objective: torch.Tensor   # final E (negative of PCL's score sum)
    hessian: torch.Tensor     # [3,3] Hessian of E at the final pose
    matched: torch.Tensor     # matched (point,cell) pairs at final pose


@functools.lru_cache(maxsize=None)
def _ls_scales(device: torch.device) -> torch.Tensor:
    """_LS_SCALES on `device`, copied once per device (a host-to-device
    copy waits for the stream)."""
    return torch.from_numpy(_LS_SCALES).to(device)


def _clamp_norm(v, step_size: float):
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v * (torch.clamp(nrm, max=step_size) / torch.clamp(nrm, min=1e-12))


def _summed(sgh, scores, axis):
    """`sgh` and `scores` of a source shard, their results summed over
    `axis`: (E, g, H, matched) in one collective as [..., 14] rows, the
    candidate scores in another."""
    def sgh_sum(p):
        E, g, H, m = sgh(p)
        t = axis.sum(torch.cat([E[..., None], g, H.flatten(-2),
                                m[..., None]], dim=-1))
        H = t[..., 4:13].unflatten(-1, (3, 3))
        return t[..., 0], t[..., 1:4], H, t[..., 13]

    def scores_sum(c):
        return axis.sum(scores(c))
    return sgh_sum, scores_sum


def align(init_pose_rad, src_xy, src_mask,
          grid: CompactGrid | GridStack | NDTGrid, d1: float, d2: float,
          max_iterations: int = 35, step_size: float = 0.1,
          trans_eps: float = 0.01, radius: int = 1,
          grid_index=None, axis=None) -> NDTResult:
    """Newton NDT solve of `src` against `grid`: one pose [3] against a
    `CompactGrid` (the kernels) or an `NDTGrid` (the gather engine), or
    R rows [R,3], row r against grid `grid_index[r]` (int32 [R]) of a
    `GridStack` or a stacked `NDTGrid`. With `axis`, `src` is this
    rank's shard and every reduction is summed over the axis."""
    global _stepwise_cuda
    lead = init_pose_rad.shape[:-1]
    if (axis is None and src_xy.is_cuda
            and isinstance(grid, GridStack if lead else CompactGrid)):
        if lead and grid_index is None:
            raise ValueError("align over rows takes a grid index per row")
        out = ndt_newton(
            init_pose_rad.to(torch.float32).reshape(-1, 3).contiguous(),
            grid_index, src_xy, src_mask, grid, d1, d2, radius,
            max_iterations, step_size, trans_eps)
        return NDTResult(*(f if lead else f[0] for f in out))
    if src_xy.is_cuda:
        _stepwise_cuda += 1
    return _align_stepwise(init_pose_rad, src_xy, src_mask, grid, d1, d2,
                           max_iterations, step_size, trans_eps, radius,
                           grid_index, axis)


def _align_stepwise(init_pose_rad, src_xy, src_mask, grid, d1, d2,
                    max_iterations, step_size, trans_eps, radius, grid_index,
                    axis) -> NDTResult:
    """`align` as a loop of score calls and tensor operations."""
    dev = src_xy.device
    scales = _ls_scales(dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    pose = init_pose_rad.to(torch.float32)
    lead = pose.shape[:-1]
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    if lead and grid_index is None:
        raise ValueError("align over rows takes a GridStack or a stacked "
                         "NDTGrid, and a grid index per row")
    if isinstance(grid, NDTGrid):
        cand_index = (None if grid_index is None else
                      grid_index.repeat_interleave(2 * len(_LS_SCALES)))

        def sgh(p):
            return gather.ndt_score_grad_hess(p, src_xy, src_mask, grid, d1,
                                              d2, radius, grid_index)

        def scores(c):
            return gather.ndt_negative_score(
                c.reshape(-1, 3), src_xy, src_mask, grid, d1, d2, radius,
                cand_index).reshape(c.shape[:-1])
    elif lead:
        if not isinstance(grid, GridStack):
            raise ValueError("align over rows takes a GridStack or a "
                             "stacked NDTGrid")
        cand_index = grid_index.repeat_interleave(2 * len(_LS_SCALES))

        def sgh(p):
            return ndt_score_grad_hess_grids(p, grid_index, src_xy,
                                             src_mask, grid, d1, d2, radius)

        def scores(c):
            return ndt_scores_grids(c.reshape(-1, 3), cand_index, src_xy,
                                    src_mask, grid, d1, d2,
                                    radius).reshape(c.shape[:-1])
    else:
        def sgh(p):
            return ndt_score_grad_hess(p, src_xy, src_mask, grid, d1, d2,
                                       radius)

        def scores(c):
            return ndt_scores(c, src_xy, src_mask, grid, d1, d2, radius)

    if axis is not None:
        sgh, scores = _summed(sgh, scores, axis)

    for k in range(max_iterations):
        if k and k % DONE_POLL == 0 and bool(done.all() if lead else done):
            break
        E, g, H, matched = sgh(pose)
        # Levenberg ridge: make H positive definite and well-conditioned
        e_min, e_absmax = _sym3_eig_bounds(H)
        abs_max = torch.clamp(e_absmax, min=1e-6)
        lam = torch.where(
            e_min < 1e-3 * abs_max,
            -torch.clamp(e_min, max=0.0) + 1e-2 * abs_max,
            0.0,
        )
        step = -_solve3(H + lam[..., None, None] * eye, g)
        step = torch.where(torch.isfinite(step), step, 0.0)

        dirs = torch.stack([_clamp_norm(step, step_size),
                            _clamp_norm(-g, step_size)], dim=-2)  # [..,2,3]
        cand_steps = (scales[:, None, None]
                      * dirs[..., None, :, :]).reshape(*lead, -1, 3)
        Ec = scores(pose[..., None, :] + cand_steps)               # [..,12]
        best = torch.argmin(Ec, dim=-1, keepdim=True)
        improved = Ec.gather(-1, best)[..., 0] < E
        chosen = cand_steps.gather(
            -2, best[..., None].expand(*lead, 1, 3))[..., 0, :]
        applied = torch.where(improved, 1.0, 0.0)[..., None] * chosen
        step_norm = torch.linalg.vector_norm(applied, dim=-1)
        now_done = (~improved) | (step_norm < trans_eps) | (matched < 1.0)
        active = ~done
        pose = torch.where(active[..., None], pose + applied, pose)
        it = it + active.to(torch.int32)
        done = done | now_done

    # final derivatives at the converged pose (feed the NDT covariance)
    E, g, H, matched = sgh(pose)
    n_src = src_mask.sum(dim=-1, dtype=torch.float32)
    if n_src.dim():
        n_src = n_src.index_select(0, grid_index.to(torch.int64))
    if axis is not None:
        n_src = axis.sum(n_src)
    usable = ((matched >= 1.0) & (n_src >= 1.0)
              & torch.isfinite(pose).all(dim=-1))
    return NDTResult(pose_rad=pose, iterations=it, converged=usable,
                     objective=E, hessian=H, matched=matched)
