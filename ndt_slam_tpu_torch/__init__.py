"""PyTorch port of ndt_slam_tpu, with hand-written CUDA kernels.

The single-device scan-to-map loop of `ndt_slam_tpu` (resample, NDT
grid rebuilt in full or cut from the incremental moment lattice, Newton
align, fitness, EKF fusion, submap map with dynamic-object removal,
checkpoint and exact resume, log readers and the simulator) on torch
tensors. The device of the input tensors picks the
engine: CUDA tensors run the kernels of `ndt/kernels.py`, CPU tensors
their plain PyTorch twins. Nothing here imports JAX or `ndt_slam_tpu`.
"""

from ndt_slam_tpu_torch.config import SlamConfig

__all__ = ["SlamConfig"]
