"""Host-side scan preprocessing (numpy; the JAX package's
`resample_points_jax` has no counterpart)."""
from ndt_slam_tpu_torch.pre.resample import resample_points_np

__all__ = ["resample_points_np"]
