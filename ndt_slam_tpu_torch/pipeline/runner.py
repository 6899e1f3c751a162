"""Host loop over a log (port of `ndt_slam_tpu.pipeline.runner.run_slam`):
feed frames into the FrontEnd, or the pipelined front end when the
config's depth resolves above 0 on the device, save and resume
checkpoints, render the map every few frames,
optionally under a torch.profiler session, then apply a correction the
back end still holds and write the pose files, the global and
per-submap PCD maps and the map picture."""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.pcd import save_pcd
from ndt_slam_tpu_torch.io.traj import (
    save_poses_full, save_poses_reference_format,
)
from ndt_slam_tpu_torch.metrics import JsonlWriter
from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd
from ndt_slam_tpu_torch.pipeline.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd
from ndt_slam_tpu_torch.viz import render_frontend_png


def run_slam(
    frames: Iterable,
    cfg: SlamConfig,
    device,
    out_dir: Optional[str] = None,
    metrics_path: Optional[str] = None,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    checkpoint_save: bool = True,
    viz_every: int = 0,
    viz_final: bool = False,
    profile_dir: Optional[str] = None,
    mesh=None,
) -> FrontEnd:
    """Run the pipeline on `device` over frames (objects with .odo_pose
    and .scan_xy, e.g. io.carmen.LogFrame): stop after cfg.end_frame
    frames, skip frames below cfg.start_frame.

    With `checkpoint_path` the complete state is saved every
    `checkpoint_every` frames (if not 0) and at the end, unless
    `checkpoint_save` is false; with `resume` an existing checkpoint is
    loaded, the prefix of `frames` it covers is skipped and the metrics
    file is appended to: the run resumes exactly.

    With `out_dir`, `viz_every` > 0 renders `viz_NNNNN.png` every that
    many frames (< 0: every cfg.draw_skip frames, the reference's map
    publish period) and `viz_final` (or `viz_every`) renders `map.png`
    at the end (`viz.render_frontend_png`).

    With `cfg.resolved_pipeline_depth` above 0 on the device the frames
    go through `PipelinedFrontEnd`: records arrive in chunks, each
    stamped with its `wall_s` when it resolves, and the front end is
    drained before a checkpoint and at the end. With `profile_dir` the
    frame loop runs under a torch.profiler session (CUDA activity on a
    CUDA device) written to `profile_dir/trace.json` as a Chrome trace.
    With `mesh` the loop-closure verification is sharded over its "dp"
    ranks (`FrontEnd(mesh=)`); every rank of the mesh runs this loop
    over the same frames."""
    device = torch.device(device)
    resume_skip = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        fe = load_checkpoint(checkpoint_path, device, cfg, mesh=mesh)
        resume_skip = fe.cnt
        if verbose:
            print(f"[runner] resumed from {checkpoint_path} "
                  f"(frames processed: {resume_skip})")
    elif cfg.resolved_pipeline_depth(device.type) > 0:
        fe = PipelinedFrontEnd(cfg, device, mesh=mesh)
    else:
        fe = FrontEnd(cfg, device, mesh=mesh)
    pipelined = isinstance(fe, PipelinedFrontEnd)
    # truncating on resume would lose the records before the checkpoint
    jl = JsonlWriter(metrics_path, append=resume_skip > 0)
    if viz_every < 0:
        viz_every = max(1, cfg.draw_skip)
    prof = None
    if profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    t0 = time.perf_counter()

    def write(recs):
        for rec in recs:
            rec["wall_s"] = time.perf_counter() - t0
            jl.write(rec)

    n = 0
    try:
        for cnt, fr in enumerate(frames, start=1):
            if cnt > cfg.end_frame:
                break
            sid = getattr(fr, "sid", None)
            if sid is None:
                sid = getattr(fr, "stamp", cnt - 1)
            if sid < cfg.start_frame:
                continue
            # fe.cnt counts only frames past start_frame
            if n < resume_skip:
                n += 1
                continue
            out = fe.process(fr.scan_xy, fr.odo_pose, sid=sid)
            # records of the pipelined front end resolve in chunks
            write(out if pipelined else [out])
            n += 1
            if checkpoint_path and checkpoint_every and checkpoint_save \
                    and n % checkpoint_every == 0:
                if pipelined:   # a checkpoint holds the resolved state
                    write(fe.drain())
                save_checkpoint(fe, checkpoint_path)
            if viz_every and out_dir and n % viz_every == 0:
                os.makedirs(out_dir, exist_ok=True)
                render_frontend_png(
                    os.path.join(out_dir, f"viz_{n:05d}.png"), fe)
            if verbose and cnt % 50 == 0:
                print(f"[runner] frame {cnt}, {len(fe.pose_history)} "
                      f"resolved")
        if pipelined:
            write(fe.drain())
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        jl.close()
    fe.finalize()
    if checkpoint_path and checkpoint_save and n > resume_skip:
        save_checkpoint(fe, checkpoint_path)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        poses = fe.get_poses()
        save_poses_reference_format(os.path.join(out_dir, "poses.txt"), poses)
        save_poses_full(os.path.join(out_dir, "poses_full.txt"), poses)
        save_pcd(os.path.join(out_dir, "map.pcd"), fe.pcmap.global_map())
        for i, sm in enumerate(fe.pcmap.submap_clouds()):
            save_pcd(os.path.join(out_dir, f"submap_{i:03d}.pcd"), sm)
        if viz_final or viz_every:
            render_frontend_png(os.path.join(out_dir, "map.png"), fe)
    if verbose:
        elapsed = time.perf_counter() - t0
        print(f"[runner] {n} frames in {elapsed:.2f}s "
              f"({n / max(elapsed, 1e-9):.2f} scans/s)")
    return fe
