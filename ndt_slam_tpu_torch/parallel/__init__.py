"""Multi-rank execution on torch.distributed: meshes, the runtime and
its collectives, and the sharded registration steps."""

from ndt_slam_tpu_torch.parallel.dist import (
    Axis, axis, broadcast_frame, broadcast_scalar, initialize,
    is_coordinator, shard, spawn, start,
)
from ndt_slam_tpu_torch.parallel.mesh import (
    axis_size, balanced_factors, make_mesh,
)
from ndt_slam_tpu_torch.parallel.register import (
    FrameStepOut, RegisterOut, SeqStepOut, make_batch_register,
    make_sharded_frame_step, make_sharded_register,
    make_sharded_sequential_step,
)

__all__ = [
    "Axis", "FrameStepOut", "RegisterOut", "SeqStepOut", "axis",
    "axis_size", "balanced_factors", "broadcast_frame", "broadcast_scalar",
    "initialize", "is_coordinator", "make_batch_register", "make_mesh",
    "make_sharded_frame_step", "make_sharded_register",
    "make_sharded_sequential_step", "shard", "spawn", "start",
]
