"""Voxel filter, dynamic-object removal and the submap map."""
from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
from ndt_slam_tpu_torch.mapping.dynamic import (
    keep_far_from_mask,
    occupancy_diff_mask,
    process_interior_scan,
)
from ndt_slam_tpu_torch.mapping.pointcloud_map import PointCloudMap, Submap

__all__ = [
    "voxel_filter",
    "occupancy_diff_mask", "keep_far_from_mask", "process_interior_scan",
    "PointCloudMap", "Submap",
]
