"""SE(2) angles, poses and fixed-capacity point buffers."""
from ndt_slam_tpu_torch.core.angles import (
    add_deg, deg2rad, rad2deg, sub_deg, wrap_deg,
)
from ndt_slam_tpu_torch.core.pose2 import (
    cal_global_motion,
    cal_motion,
    cal_pred_pose,
    global_points,
    pose_deg_to_rad,
    pose_rad_to_deg,
    relative_points,
    rot2,
)
from ndt_slam_tpu_torch.core.points import (
    PointBuffer, concat_buffers, pad_points,
)

__all__ = [
    "add_deg", "sub_deg", "wrap_deg", "deg2rad", "rad2deg",
    "rot2", "cal_motion", "cal_global_motion", "cal_pred_pose",
    "global_points", "relative_points", "pose_deg_to_rad", "pose_rad_to_deg",
    "PointBuffer", "pad_points", "concat_buffers",
]
