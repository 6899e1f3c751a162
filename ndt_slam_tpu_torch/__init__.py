"""PyTorch port of ndt_slam_tpu, with hand-written CUDA kernels.

The single-device scan-to-map loop of `ndt_slam_tpu` (resample, NDT
grid rebuilt in full or cut from the incremental moment lattice, Newton
align, fitness, EKF fusion, submap map with dynamic-object removal,
loop closure with the pose-graph back end and the map rewrite,
checkpoint and exact resume, log readers, the simulator and the map
picture) on torch tensors, and the lockstep batch runner that maps
several logs at once. The device of the input tensors picks the
engine: CUDA tensors run the kernels of `ndt/kernels.py`, CPU tensors
their plain PyTorch twins. Nothing here imports JAX or `ndt_slam_tpu`.
"""

from ndt_slam_tpu_torch.config import SlamConfig

__all__ = ["SlamConfig"]
