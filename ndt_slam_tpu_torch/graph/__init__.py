"""Loop closure: the keyframe store and the batched candidate verifier.

The pose graph, its optimizers and the back end that drives them are
not ported yet; `FrontEnd` refuses `loop_enable` until they are."""

from ndt_slam_tpu_torch.graph.keyframes import KeyframeStore
from ndt_slam_tpu_torch.graph.loop_closure import (
    LoopVerifyOut, pack_verify_out, relative_pose_deg, unpack_verify_row,
    verify_candidates,
)

__all__ = [
    "KeyframeStore",
    "LoopVerifyOut",
    "pack_verify_out",
    "relative_pose_deg",
    "unpack_verify_row",
    "verify_candidates",
]
