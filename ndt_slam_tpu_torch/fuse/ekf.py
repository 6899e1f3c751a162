"""EKF-style fusion of the odometry prediction with the NDT measurement.

Port of `ndt_slam_tpu.fuse.ekf` (reference PoseFuser math):

predict:  cov_hat = F·lastCov·Fᵀ + A·M·Aᵀ,
          M = diag(coe_vel·v², coe_omega·ω²), v = |odo t|/Δt, ω = odo θ/Δt
update:   K = cov_hat (Q + cov_hat)⁻¹,  cov = (I−K) cov_hat,
          μ = μ_hat + K·(z − h),  innovation angle wrapped.

Covariances are in (m, m, rad); poses cross the API in degrees. The
3x3 products are float32 torch matmuls, which run in full float32
unless TF32 is switched on globally (it is off by default). Every
function also takes a leading batch dimension (the lockstep batch
runner's B sequences), each row computed on its own.

The device routes, as in `ndt/kernels.py`: on CUDA tensors
`gate_and_fuse` and `fuse_stage` (the whole fuse stage of a
registration: the cost, `gate_and_fuse`, the map-frame scan,
`error_pose` and `trans_probability`) are one launch of `fuse_kernel`
(`kernels.ndt_fuse`, one block a row, no sync: its eigen-decomposition
is cyclic Jacobi on the card where the twin calls `torch.linalg.eigh`);
on CPU tensors they run the plain twins `gate_and_fuse_plain` and
`fuse_stage_plain`, the torch code below. There is no fallback.
"""

from __future__ import annotations

import torch

from ndt_slam_tpu_torch.core import pose2
from ndt_slam_tpu_torch.core.angles import (
    deg2rad, rad2deg, sub_deg, wrap_rad,
)
from ndt_slam_tpu_torch.core.points import PAD_COORD
from ndt_slam_tpu_torch.ndt.kernels import ndt_fuse


def _mv(A, x):
    """A @ x of [..., 3, 3] matrices and [..., 3] vectors."""
    if x.dim() == 1:
        return A @ x
    return (A @ x[..., None])[..., 0]


def odometry_covariance(odo_motion_deg, last_pose_deg, last_cov,
                        del_time: float, coe_vel: float, coe_omega: float):
    """Propagated covariance cov_hat."""
    v = torch.sqrt(odo_motion_deg[..., 0] ** 2
                   + odo_motion_deg[..., 1] ** 2) / del_time
    omega = deg2rad(odo_motion_deg[..., 2]) / del_time
    th = deg2rad(last_pose_deg[..., 2])
    c, s = torch.cos(th), torch.sin(th)

    M = torch.diag_embed(torch.stack([coe_vel * v * v,
                                      coe_omega * omega * omega], dim=-1))
    zero = torch.zeros_like(v)
    one = torch.ones_like(v)
    A = torch.stack([
        torch.stack([del_time * c, zero], dim=-1),
        torch.stack([del_time * s, zero], dim=-1),
        torch.stack([zero, del_time * one], dim=-1),
    ], dim=-2)
    F = torch.stack([
        torch.stack([one, zero, -v * del_time * s], dim=-1),
        torch.stack([zero, one, v * del_time * c], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return F @ last_cov @ F.mT + A @ M @ A.mT


def fuse_pose(pred_pose_deg, est_pose_deg, odo_motion_deg, last_pose_deg,
              last_cov, q_mat, del_time: float, coe_vel: float,
              coe_omega: float, innov_proj=None):
    """Kalman blend. Returns (fused_pose_deg [3], cov [3,3]).
    `innov_proj` [3,3] projects the innovation before the gain."""
    cov_hat = odometry_covariance(
        odo_motion_deg, last_pose_deg, last_cov, del_time, coe_vel, coe_omega
    )
    mu_hat = torch.stack(
        [pred_pose_deg[..., 0], pred_pose_deg[..., 1],
         deg2rad(pred_pose_deg[..., 2])], dim=-1
    )
    eye = torch.eye(3, dtype=cov_hat.dtype, device=cov_hat.device)
    # symmetrize + jitter S: both terms can sit near the f32 noise floor
    S = q_mat + cov_hat
    S = 0.5 * (S + S.mT)
    trace = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
    S = S + (1e-6 * trace + 1e-9)[..., None, None] * eye
    # solve_ex: no error check, so no host sync (S is SPD by the jitter)
    K = torch.linalg.solve_ex(S.mT, cov_hat.mT).result.mT
    cov = (eye - K) @ cov_hat
    cov = 0.5 * (cov + cov.mT)

    zh = torch.stack([
        est_pose_deg[..., 0] - pred_pose_deg[..., 0],
        est_pose_deg[..., 1] - pred_pose_deg[..., 1],
        deg2rad(sub_deg(est_pose_deg[..., 2], pred_pose_deg[..., 2])),
    ], dim=-1)
    if innov_proj is not None:
        zh = _mv(innov_proj, zh)
    mu = _mv(K, zh) + mu_hat
    fused = torch.stack([mu[..., 0], mu[..., 1],
                         rad2deg(wrap_rad(mu[..., 2]))], dim=-1)
    return fused, cov


def gate_and_fuse(cfg, pred_pose_deg, est_pose_deg, hessian, cost,
                  odo_motion_deg, last_pose_deg, last_cov):
    """NDT covariance from the objective Hessian, fitness + innovation
    gates, Kalman fuse on accept / odometry propagation on reject.
    Returns (fused_pose_deg [3], cov [3,3], accept bool); [B,3] poses,
    [B,3,3] matrices and [B] costs give B rows, each fused alone.

    CUDA: one launch of `fuse_kernel`; CPU: `gate_and_fuse_plain`."""
    if hessian.is_cuda:
        # the stepwise loop's results can be views into one buffer
        _, fused, cov, accept, *_ = ndt_fuse(
            cfg, *(t.contiguous() for t in (
                pred_pose_deg, est_pose_deg, hessian, cost, odo_motion_deg,
                last_pose_deg, last_cov)))
        return fused, cov, accept
    return gate_and_fuse_plain(cfg, pred_pose_deg, est_pose_deg, hessian,
                               cost, odo_motion_deg, last_pose_deg, last_cov)


def gate_and_fuse_plain(cfg, pred_pose_deg, est_pose_deg, hessian, cost,
                        odo_motion_deg, last_pose_deg, last_cov):
    """`gate_and_fuse` in torch: the twin of `fuse_kernel`."""
    H = hessian
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    H = torch.where(torch.isfinite(H).flatten(-2).all(-1)[..., None, None],
                    H, eye)
    # ascending eigenvalues, like jnp.linalg.eigh (evals[-1] is the max)
    evals, evecs = torch.linalg.eigh(H)
    inv_e = cfg.coe_ndt_cov / torch.clamp(evals, min=1e-3)
    # Q's variances capped into [1e-6, 1e-2] (1 mm .. 10 cm std)
    inv_e = torch.clamp(inv_e, 1e-6, 1e-2)
    q_mat = (evecs * inv_e[..., None, :]) @ evecs.mT

    # degenerate-direction projection: innovation components along
    # eigendirections with relatively ~zero curvature follow odometry
    ratio = cfg.fuse_degenerate_ratio
    if ratio > 0.0:
        wmax = torch.clamp(evals[..., -1:], min=1e-9)
        keep = (evals > ratio * wmax).to(H.dtype)
        innov_proj = (evecs * keep[..., None, :]) @ evecs.mT
    else:
        innov_proj = eye

    innov_t = torch.hypot(est_pose_deg[..., 0] - pred_pose_deg[..., 0],
                          est_pose_deg[..., 1] - pred_pose_deg[..., 1])
    innov_r = torch.abs(sub_deg(est_pose_deg[..., 2], pred_pose_deg[..., 2]))
    plausible = ((innov_t <= cfg.max_innovation_trans)
                 & (innov_r <= cfg.max_innovation_rot))
    successful = (cost <= cfg.score_thre) & plausible

    fused_k, cov_k = fuse_pose(
        pred_pose_deg, est_pose_deg, odo_motion_deg, last_pose_deg,
        last_cov, q_mat, cfg.del_time, cfg.coe_vel, cfg.coe_omega,
        innov_proj=innov_proj,
    )
    cov_odo = odometry_covariance(
        odo_motion_deg, last_pose_deg, last_cov,
        cfg.del_time, cfg.coe_vel, cfg.coe_omega,
    )
    # the fused pose must also stay within the innovation gate
    fused_t = torch.hypot(fused_k[..., 0] - pred_pose_deg[..., 0],
                          fused_k[..., 1] - pred_pose_deg[..., 1])
    fused_r = torch.abs(sub_deg(fused_k[..., 2], pred_pose_deg[..., 2]))
    fused_ok = ((fused_t <= cfg.max_innovation_trans)
                & (fused_r <= cfg.max_innovation_rot)
                & torch.isfinite(fused_k).all(dim=-1))
    accept = successful & fused_ok
    fused = torch.where(accept[..., None], fused_k, pred_pose_deg)
    cov = torch.where(accept[..., None, None], cov_k, cov_odo)
    return fused, cov, accept


def fuse_stage(cfg, pred_pose, est_pose, hessian, objective, converged, fit,
               odo_pose, odo_motion, last_pose, last_cov, src_mask, scan_xy,
               scan_mask):
    """The fuse stage of a registration (`pipeline/frontend.py`): the
    cost (`fit`, or `failed_cost` where the solve did not converge),
    `gate_and_fuse`, the scan in the map frame at the fused pose
    (`PAD_COORD` where masked), `error_pose` (the fused pose less the
    odometry) and `trans_probability` (the score a live source point).
    One row or [B] rows, as `gate_and_fuse`. Returns (cost, fused, cov,
    accept, global_xy, error_pose, trans_probability).

    CUDA: one launch of `fuse_kernel`; CPU: `fuse_stage_plain`."""
    if scan_xy.is_cuda:
        # the stepwise loop's results can be views into one buffer
        c = [t.contiguous() for t in (
            pred_pose, est_pose, hessian, fit, odo_motion, last_pose,
            last_cov, converged, odo_pose, objective, src_mask, scan_xy,
            scan_mask)]
        return ndt_fuse(cfg, *c)
    return fuse_stage_plain(cfg, pred_pose, est_pose, hessian, objective,
                            converged, fit, odo_pose, odo_motion, last_pose,
                            last_cov, src_mask, scan_xy, scan_mask)


def fuse_stage_plain(cfg, pred_pose, est_pose, hessian, objective, converged,
                     fit, odo_pose, odo_motion, last_pose, last_cov,
                     src_mask, scan_xy, scan_mask):
    """`fuse_stage` in torch: the twin of `fuse_kernel`."""
    cost = torch.where(converged, fit, cfg.failed_cost)
    fused, cov, accept = gate_and_fuse_plain(
        cfg, pred_pose, est_pose, hessian, cost, odo_motion, last_pose,
        last_cov,
    )
    # scan into the map frame at the fused pose (growMap input)
    g = pose2.global_points(fused, scan_xy)
    g = torch.where(scan_mask[..., None], g, PAD_COORD)
    error_pose = pose2.cal_global_motion(fused, odo_pose)
    n_src = src_mask.sum(dim=-1, dtype=torch.float32)
    trans_prob = -objective / torch.clamp(n_src, min=1.0)
    return cost, fused, cov, accept, g, error_pose, trans_prob
