"""Multi-rank sequential SLAM loop (port of
`ndt_slam_tpu.pipeline.dist_runner`).

The per-frame registration spreads over the ranks of a process group:

- the coordinator (rank 0) reads the log; each frame goes to every rank
  in one collective (`parallel/dist.broadcast_frame`);
- the registration step runs on every rank with the voxel-filtered
  source and the registration target sharded over the mesh's "pt"
  dimension: grid-moment sums, a lockstep Newton loop, the sharded
  fitness (`parallel/register.make_sharded_sequential_step`);
- the map and pose-graph bookkeeping is host code that is deterministic
  given the step's outputs, and those are bitwise the same on every
  rank, so every rank runs it and keeps the same trajectory; only the
  coordinator writes files.

`DistFrontEnd` is a FrontEnd whose `_run_step` goes through the sharded
step, so the sequential driver, the records, checkpoints and the
loop-closure back end are reused as they are; `PipelinedDistFrontEnd`
does the same for the pipelined front end, whose speculation and
replays then give the synchronous run's trajectory bit for bit. The
sharded step always rebuilds the grid in full (the JAX package's
choice): every frame's grid is summed from the target shards, and the
map keeps no moment lattice (the JAX package's sharded front ends keep
one they never read).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PointBuffer
from ndt_slam_tpu_torch.io.pcd import save_pcd
from ndt_slam_tpu_torch.io.traj import (
    save_poses_full, save_poses_reference_format,
)
from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
from ndt_slam_tpu_torch.parallel.dist import (
    axis, broadcast_frame, broadcast_scalar, is_coordinator,
)
from ndt_slam_tpu_torch.parallel.mesh import make_mesh
from ndt_slam_tpu_torch.parallel.register import make_sharded_sequential_step
from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd
from ndt_slam_tpu_torch.pipeline.frontend import FrameResult, FrontEnd


class _ShardedStepMixin:
    """The sharded `_run_step` of the synchronous and the pipelined
    multi-rank front ends. Nothing crosses to the host a frame: the
    rank cuts its shards from the replicated source and target on the
    device, and the step's outputs are the same tensors on every rank."""

    def _init_sharded_step(self, cfg: SlamConfig, mesh):
        import torch.distributed as dist

        if mesh is None and dist.is_initialized():
            mesh = make_mesh()
        self.mesh = mesh
        self._pt = axis(mesh, "pt")
        for name in ("max_scan_points", "max_local_map_points"):
            if getattr(cfg, name) % self._pt.size:
                raise ValueError(f"{name}={getattr(cfg, name)} does not "
                                 f"divide over {self._pt.size} ranks")
        self._seq_step = make_sharded_sequential_step(mesh, cfg)
        # the sharded step reads no lattice, so the map keeps none
        self.incremental_grid = self.pcmap.incremental_grid = False

    def _run_step(self, scan: PointBuffer, odo_dev, prev_odo_dev,
                  last_pose_dev, local: PointBuffer) -> FrameResult:
        # the source voxel filter runs on every rank (the same input
        # gives the same output), as the single-device step runs it
        src = voxel_filter(scan, self.cfg.source_leaf_size)
        pt = self._pt.shard
        out = self._seq_step(
            pt(src.xy), pt(src.mask), odo_dev, prev_odo_dev, last_pose_dev,
            self.last_cov, pt(local.xy), pt(local.mask), scan.xy, scan.mask)
        return FrameResult(
            est_pose=out.est_pose, fused_pose=out.fused_pose, cov=out.cov,
            cost=out.cost, successful=out.successful,
            iterations=out.iterations, matched=out.matched,
            global_xy=out.global_xy, error_pose=out.error_pose,
            trans_probability=out.trans_probability,
            grid_ok=out.packed[23])


class DistFrontEnd(_ShardedStepMixin, FrontEnd):
    """FrontEnd whose registration is sharded over the "pt" ranks of
    `mesh` (all ranks of the group by default; a single rank without a
    group). `loop_mesh` shards the loop-closure verification over its
    "dp" ranks."""

    def __init__(self, cfg: SlamConfig, device, mesh=None, loop_mesh=None):
        super().__init__(cfg, device, mesh=loop_mesh)
        self._init_sharded_step(cfg, mesh)


class PipelinedDistFrontEnd(_ShardedStepMixin, PipelinedFrontEnd):
    """The pipelined front end over the sharded step: frames dispatched
    speculatively and resolved in chunks, as on one device. Every rank
    takes the same decisions from the same outputs, so the ranks stay
    in step without a barrier a frame."""

    def __init__(self, cfg: SlamConfig, device, mesh=None, loop_mesh=None,
                 depth: Optional[int] = None):
        super().__init__(cfg, device, depth=depth, mesh=loop_mesh)
        self._init_sharded_step(cfg, mesh)


def run_slam_distributed(frames: Optional[List], cfg: SlamConfig, device,
                         mesh=None, out_dir: Optional[str] = None,
                         verbose: bool = False,
                         loop_mesh=None) -> FrontEnd:
    """Drive the sequential loop on every rank: only the coordinator
    passes `frames` (the others pass None and receive each frame by
    broadcast). With `cfg.resolved_pipeline_depth` above 0 on the device
    the pipelined front end runs (on a CUDA device pass the depth in
    `pipeline_depth`: -1 resolves to 0 there). Returns this rank's front
    end, whose trajectory is the same on every rank; with `out_dir`
    (give it on the coordinator only) the pose files and the map are
    written."""
    device = torch.device(device)
    depth = cfg.resolved_pipeline_depth(device.type)
    if depth > 0:
        fe = PipelinedDistFrontEnd(cfg, device, mesh=mesh,
                                   loop_mesh=loop_mesh, depth=depth)
    else:
        fe = DistFrontEnd(cfg, device, mesh=mesh, loop_mesh=loop_mesh)
    if is_coordinator():
        if frames is None:
            raise ValueError("the coordinator needs the frames")
        n_frames = min(len(frames), cfg.end_frame)
    else:
        n_frames = 0
    n_frames = int(broadcast_scalar(n_frames))
    capacity = 4 * cfg.max_scan_points
    for t in range(n_frames):
        if is_coordinator():
            fr = frames[t]
            sid = getattr(fr, "sid", None)
            if sid is None:
                sid = getattr(fr, "stamp", t)
            scan, odo = broadcast_frame(fr.scan_xy, fr.odo_pose, capacity)
        else:
            scan, odo = broadcast_frame(None, None, capacity)
            sid = 0
        sid = int(broadcast_scalar(sid))
        fe.process(scan, odo, sid=sid)
        if verbose and is_coordinator() and (t + 1) % 50 == 0:
            print(f"[dist_runner] frame {t + 1}/{n_frames}", flush=True)
    # a correction the back end still holds, from replicated state
    fe.finalize()

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        poses = fe.get_poses()
        save_poses_reference_format(os.path.join(out_dir, "poses.txt"),
                                    poses)
        save_poses_full(os.path.join(out_dir, "poses_full.txt"), poses)
        save_pcd(os.path.join(out_dir, "map.pcd"), fe.pcmap.global_map())
    return fe
