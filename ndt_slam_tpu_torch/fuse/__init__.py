"""Odometry/NDT fusion."""
from ndt_slam_tpu_torch.fuse.ekf import fuse_pose, odometry_covariance

__all__ = ["odometry_covariance", "fuse_pose"]
