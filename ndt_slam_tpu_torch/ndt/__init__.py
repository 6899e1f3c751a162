"""NDT grid, compact table, kernels, Newton solve and fitness.

Importing this package neither builds nor loads the kernel library:
`ndt/kernels.py` loads it at the first launch on a CUDA tensor."""
from ndt_slam_tpu_torch.ndt.grid import NDTGrid, build_grid
from ndt_slam_tpu_torch.ndt.score import (
    gauss_constants,
    ndt_negative_score,
    ndt_score_grad_hess,
)
from ndt_slam_tpu_torch.ndt.solve import NDTResult, align
from ndt_slam_tpu_torch.ndt.fitness import fitness_score

__all__ = [
    "NDTGrid", "build_grid",
    "gauss_constants", "ndt_negative_score", "ndt_score_grad_hess",
    "NDTResult", "align", "fitness_score",
]
