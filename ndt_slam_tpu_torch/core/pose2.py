"""SE(2) pose algebra on torch tensors.

A pose is a length-3 tensor [tx, ty, th_deg]; rotation convention
R(th) = [[c,-s],[s,c]]. Small rotations are written in component form,
so no matrix product (and no TF32) is involved. Functions batch over
leading dimensions like their `ndt_slam_tpu.core.pose2` counterparts.
"""

from __future__ import annotations

import torch

from ndt_slam_tpu_torch.core.angles import (
    add_deg, deg2rad, rad2deg, sub_deg, wrap_rad,
)


def rot2(th_deg):
    """2x2 rotation matrix (batched over leading dims of th_deg)."""
    c, s = _cs(th_deg)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def _cs(th_deg):
    a = deg2rad(th_deg)
    return torch.cos(a), torch.sin(a)


def cal_motion(cur_pose, prev_pose):
    """Relative motion cur⊖prev expressed in prev's robot frame."""
    dx = cur_pose[..., 0] - prev_pose[..., 0]
    dy = cur_pose[..., 1] - prev_pose[..., 1]
    c, s = _cs(prev_pose[..., 2])
    tx = c * dx + s * dy
    ty = -s * dx + c * dy
    th = sub_deg(cur_pose[..., 2], prev_pose[..., 2])
    return torch.stack([tx, ty, th], dim=-1)


def cal_global_motion(cur_pose, prev_pose):
    """World-frame delta cur - prev."""
    dx = cur_pose[..., 0] - prev_pose[..., 0]
    dy = cur_pose[..., 1] - prev_pose[..., 1]
    th = sub_deg(cur_pose[..., 2], prev_pose[..., 2])
    return torch.stack([dx, dy, th], dim=-1)


def cal_pred_pose(motion, last_pose):
    """Compose robot-frame motion onto last_pose."""
    c, s = _cs(last_pose[..., 2])
    tx = c * motion[..., 0] - s * motion[..., 1] + last_pose[..., 0]
    ty = s * motion[..., 0] + c * motion[..., 1] + last_pose[..., 1]
    th = add_deg(last_pose[..., 2], motion[..., 2])
    return torch.stack([tx, ty, th], dim=-1)


def global_points(pose, pts):
    """Transform local points [N,2] into the world frame of `pose`."""
    c, s = _cs(pose[..., 2:3])
    x = c * pts[..., 0] - s * pts[..., 1] + pose[..., 0:1]
    y = s * pts[..., 0] + c * pts[..., 1] + pose[..., 1:2]
    return torch.stack([x, y], dim=-1)


def relative_points(pose, pts):
    """Transform world points [N,2] into the local frame of `pose`."""
    c, s = _cs(pose[..., 2:3])
    dx = pts[..., 0] - pose[..., 0:1]
    dy = pts[..., 1] - pose[..., 1:2]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)


def pose_deg_to_rad(pose_deg):
    """[tx, ty, th_deg] -> [tx, ty, th_rad]."""
    return torch.stack(
        [pose_deg[..., 0], pose_deg[..., 1], deg2rad(pose_deg[..., 2])],
        dim=-1,
    )


def pose_rad_to_deg(pose_rad):
    return torch.stack(
        [pose_rad[..., 0], pose_rad[..., 1],
         rad2deg(wrap_rad(pose_rad[..., 2]))],
        dim=-1,
    )


def distance(pose):
    """Translation norm."""
    return torch.sqrt(pose[..., 0] ** 2 + pose[..., 1] ** 2)
