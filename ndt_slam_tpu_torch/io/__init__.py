"""Host-side log readers and output writers (numpy only)."""
from ndt_slam_tpu_torch.io.simulate import (
    World, default_world, simulate_sequence,
)
from ndt_slam_tpu_torch.io.tsukuba import read_tsukuba_log, write_tsukuba_log
from ndt_slam_tpu_torch.io.carmen import read_carmen_log
from ndt_slam_tpu_torch.io.pcd import load_pcd, save_pcd
from ndt_slam_tpu_torch.io.traj import (
    save_poses_full, save_poses_reference_format,
)

__all__ = [
    "World", "simulate_sequence", "default_world",
    "read_tsukuba_log", "write_tsukuba_log", "read_carmen_log",
    "save_pcd", "load_pcd",
    "save_poses_reference_format", "save_poses_full",
]
