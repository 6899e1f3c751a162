"""Loop closure: the keyframe store, the batched candidate verifier,
the pose graph with its optimisers, and the back end that drives them."""

from ndt_slam_tpu_torch.graph.backend import GraphBackend
from ndt_slam_tpu_torch.graph.keyframes import KeyframeStore
from ndt_slam_tpu_torch.graph.loop_closure import (
    LoopVerifyOut, pack_verify_out, relative_pose_deg, unpack_verify_row,
    verify_candidates,
)
from ndt_slam_tpu_torch.graph.pose_graph import (
    PoseGraph, edge_residual, empty_graph, optimize, optimize_hierarchical,
    optimize_pcg,
)

__all__ = [
    "GraphBackend",
    "KeyframeStore",
    "LoopVerifyOut",
    "PoseGraph",
    "edge_residual",
    "empty_graph",
    "optimize",
    "optimize_hierarchical",
    "optimize_pcg",
    "pack_verify_out",
    "relative_pose_deg",
    "unpack_verify_row",
    "verify_candidates",
]
