#!/usr/bin/env python
"""Run the PyTorch/CUDA port (ndt_slam_tpu_torch) over a log file.

Examples:
  python cli/run_slam_torch.py --log tests/data/office_loop.clf \\
      --format carmen --out out/ --gt tests/data/office_loop.gt
  python cli/run_slam_torch.py --log data/tsukuba.txt --format tsukuba \\
      --out out/ --checkpoint out/state.npz --checkpoint-every 100
  python cli/run_slam_torch.py --log data/tsukuba.txt --format tsukuba \\
      --out out/ --checkpoint out/state.npz --resume
  python cli/run_slam_torch.py --simulate 120 --out out/ --device cpu

  python cli/run_slam_torch.py --log tests/data/office_loop.clf \
      --format carmen --out out/ --gt tests/data/office_loop.gt --loop --viz

Writes poses.txt, poses_full.txt, map.pcd, submap_NNN.pcd,
metrics.jsonl and summary.json into --out (and map.png with --viz,
viz_NNNNN.png with --viz-every); --loop turns on loop closure and the
pose-graph back end, and summary.json then holds its counts and times; with --gt (or --simulate)
summary.json holds the ATE of the trajectory and of the raw odometry,
both against the ground-truth rows of the processed frames (from
--start-frame on). --device defaults to cuda
and fails when there is no CUDA device; pass --device cpu to run the
plain PyTorch twins instead of the kernels. The incremental moment
lattice is switched through --config ({"ndt_incremental_grid": 1} or
0); summary.json says which grid path and which resampler ran, and
which PCD writer wrote the maps (pcd_writer: the native one of
csrc/libndtslam.so where it loads, as the JAX package's, else numpy). The
pipelined front end too ({"pipeline_depth": 8}: frames in flight
before their outputs are fetched in one copy; -1 resolves to
config.PIPELINE_AUTO_DEPTH_ON_CUDA on cuda and to 0 on the CPU);
summary.json then holds pipeline_depth, pipeline_rollbacks and
pipeline_replayed. --profile DIR writes a torch.profiler Chrome trace
of the frame loop to DIR/trace.json.

Several ranks, launched by torchrun (RANK, WORLD_SIZE, MASTER_ADDR):

  torchrun --nproc-per-node 2 cli/run_slam_torch.py --distributed \
      --log tests/data/office_loop.clf --format carmen --out out/ \
      --device cpu

--distributed joins the process group (nccl when every rank has a card
of its own, gloo when ranks share one or run on the CPU; the choice is
printed). With more than one rank, rank 0 reads the log and broadcasts
every frame, the registration runs sharded over all ranks
(pipeline/dist_runner.py), every rank keeps the same trajectory and
rank 0 writes the pose files, the map and summary.json (the JAX CLI's
multi-process keys: frames, processes, accept_rate, ate_rmse_m);
checkpoints, --viz and --profile are refused there. --loop-shard
(implies --loop) fans the loop-closure verification out over the ranks'
"dp" axis; in a single process it runs over a one-rank group.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log", help="input log file")
    ap.add_argument("--format", choices=["tsukuba", "carmen"],
                    default="tsukuba")
    ap.add_argument("--simulate", type=int, default=0,
                    help="run on N simulated frames instead of a log")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--config", help="JSON file of SlamConfig overrides")
    ap.add_argument("--gt", help="ground-truth poses file (one "
                                 "'tx ty theta_deg' line per frame); "
                                 "adds ATE to summary.json")
    ap.add_argument("--start-frame", type=int)
    ap.add_argument("--end-frame", type=int)
    ap.add_argument("--sidelidar", action="store_true")
    ap.add_argument("--loop", action="store_true",
                    help="enable loop closure + pose-graph backend")
    ap.add_argument("--viz", action="store_true",
                    help="render the final map + trajectory + loop "
                         "edges to <out>/map.png")
    ap.add_argument("--viz-every", type=int, nargs="?", const=-1,
                    default=0,
                    help="also render <out>/viz_NNNNN.png every N "
                         "frames; bare --viz-every renders every "
                         "draw_skip frames")
    ap.add_argument("--checkpoint",
                    help="checkpoint file (.npz) to save SLAM state to")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the checkpoint every N frames (0 = only "
                         "at the end, when --checkpoint is given)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    ap.add_argument("--profile",
                    help="write a torch.profiler trace of the frame loop "
                         "to this directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; under "
                         "--distributed each rank's own card)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torchrun process group; with more "
                         "than one rank the registration is sharded over "
                         "the ranks and only rank 0 writes files")
    ap.add_argument("--loop-shard", action="store_true",
                    help="shard loop-closure candidate verification over "
                         "the ranks (implies --loop)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if not args.simulate and not args.log:
        ap.error("need --log or --simulate")  # before any heavy import

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("run_slam_torch: --device cuda but no CUDA device is "
                 "available (pass --device cpu to run on the CPU)")

    rt, store = None, None
    if args.distributed or args.loop_shard:
        import tempfile

        from ndt_slam_tpu_torch.parallel import dist as pdist

        rt = pdist.initialize(device=device)
        if rt is None and args.loop_shard:
            # a mesh needs a process group: one rank, over a file store
            store = tempfile.TemporaryDirectory()
            rt = pdist.initialize(init_file=os.path.join(store.name, "pg"),
                                  world_size=1, rank=0, device=device)
        if rt is not None:
            device = rt.device
    try:
        _run(args, device, rt)
    finally:
        if rt is not None:
            pdist.shutdown()
        if store is not None:
            store.cleanup()


def _run(args, device, rt):
    import torch

    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.io import native, pcd
    from ndt_slam_tpu_torch.io.carmen import read_carmen_gt, read_carmen_log
    from ndt_slam_tpu_torch.io.simulate import simulate_sequence
    from ndt_slam_tpu_torch.io.tsukuba import read_tsukuba_log
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    overrides = {}
    if args.config:
        with open(args.config) as f:
            overrides.update(json.load(f))
    if args.start_frame is not None:
        overrides["start_frame"] = args.start_frame
    if args.end_frame is not None:
        overrides["end_frame"] = args.end_frame
    if args.sidelidar:
        overrides["sidelidar"] = True
    if args.loop or args.loop_shard:
        overrides["loop_enable"] = True
    cfg = SlamConfig().replace(**overrides)
    mesh = None
    if args.loop_shard:
        from ndt_slam_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(dp=rt.world_size)   # every rank on the "dp" axis
    multi = rt is not None and rt.world_size > 1
    coordinator = rt is None or rt.rank == 0

    true_poses = read_carmen_gt(args.gt) if args.gt else None
    if args.simulate:
        frames = simulate_sequence(n_frames=args.simulate)
        stamps = [f.sid for f in frames]
        if true_poses is None:
            true_poses = np.asarray([f.true_pose for f in frames])
        cfg = cfg.replace(end_frame=max(cfg.end_frame, args.simulate))
        reader = "simulator"
    elif multi and not coordinator:
        frames, stamps, reader = None, None, None   # rank 0 broadcasts
    else:
        # the native parsers where csrc/libndtslam.so loads, else numpy
        reader = "native" if native.available() else "numpy"
        if args.format == "carmen":
            read = native.read_carmen_log if native.available() \
                else read_carmen_log
            frames = read(args.log)
        else:
            read = native.read_tsukuba_log if native.available() \
                else read_tsukuba_log
            frames = read(args.log, sidelidar=cfg.sidelidar)
        stamps = [f.stamp for f in frames]

    if multi:
        _run_distributed(args, cfg, device, rt, frames, true_poses, mesh)
        return
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    fe = run_slam(frames, cfg, device, out_dir=args.out,
                  metrics_path=os.path.join(args.out, "metrics.jsonl"),
                  verbose=args.verbose, checkpoint_path=args.checkpoint,
                  checkpoint_every=args.checkpoint_every, resume=args.resume,
                  viz_every=args.viz_every, viz_final=args.viz,
                  profile_dir=args.profile, mesh=mesh)
    summary = {
        "frames": len(fe.pose_history),
        "device": str(device),
        "incremental_grid": fe.incremental_grid,
        "n_grid_fallbacks": fe.n_grid_fallbacks,
        "native_library": native.status(),
        "log_reader": reader,
        "resampler": fe.resampler,
        "pcd_writer": pcd.writer(),
        "wall_s": round(time.perf_counter() - t0, 2),
        "accept_rate": float(np.mean([
            1.0 if m.get("successful") else 0.0 for m in fe.metrics
        ])) if fe.metrics else 0.0,
    }
    if fe.backend is not None:
        summary.update({
            "loops_accepted": fe.backend.loops_accepted,
            "corrections": fe.n_corrections,
            "keyframes": len(fe.backend.keyframes),
            "t_backend_s": round(fe.t_backend, 2),
            "t_verify_s": round(fe.backend.t_verify, 2),
            "t_optimize_s": round(fe.backend.t_optimize, 2),
            "t_remake_s": round(fe.t_remake, 2),
            "remake_stats": fe.pcmap.remake_stats,
        })
    if isinstance(fe, PipelinedFrontEnd):
        summary.update({
            "pipeline_depth": fe.depth,
            "pipeline_rollbacks": fe.n_rollbacks,
            "pipeline_replayed": fe.n_replayed,
        })
    if fe.n_grid_fallbacks:
        # the JAX CLI's key, written only when a window escaped
        summary["grid_fallbacks"] = fe.n_grid_fallbacks
    if device.type == "cuda":
        summary["device_name"] = torch.cuda.get_device_name(device)
    if rt is not None:
        summary["backend"] = rt.backend
    if true_poses is not None and fe.pose_history:
        n = len(fe.pose_history)
        # poses_full.txt row k is the k-th processed frame
        first = next(i for i, s in enumerate(stamps)
                     if s >= cfg.start_frame)
        gt = true_poses[first:first + n]
        summary["ate_rmse_m"] = ate_rmse(fe.get_poses(), gt)
        odo = np.asarray([f.odo_pose for f in frames[first:first + n]])
        summary["ate_odometry_m"] = ate_rmse(odo, gt)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))


def _run_distributed(args, cfg, device, rt, frames, true_poses, mesh):
    """The multi-rank sequential loop: rank 0 holds the frames and
    writes the outputs and summary.json."""
    import numpy as np

    from ndt_slam_tpu_torch.io import pcd
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.pipeline.dist_runner import run_slam_distributed

    coordinator = rt.rank == 0
    for flag, name in [(args.checkpoint, "--checkpoint"),
                       (args.profile, "--profile"),
                       (args.viz or args.viz_every, "--viz")]:
        if flag:
            sys.exit(f"run_slam_torch: {name} is not supported with more "
                     f"than one rank")
    if coordinator:
        os.makedirs(args.out, exist_ok=True)
    fe = run_slam_distributed(
        frames if coordinator else None, cfg, device, loop_mesh=mesh,
        out_dir=args.out if coordinator else None,
        verbose=args.verbose and coordinator)
    if not coordinator:
        return
    summary = {
        "frames": len(fe.pose_history),
        "processes": rt.world_size,
        "backend": rt.backend,
        "device": str(device),
        "pcd_writer": pcd.writer(),
        "accept_rate": float(np.mean([
            1.0 if m.get("successful") else 0.0 for m in fe.metrics
        ])) if fe.metrics else 0.0,
    }
    if true_poses is not None and fe.pose_history:
        n = len(fe.pose_history)
        summary["ate_rmse_m"] = ate_rmse(fe.get_poses(), true_poses[:n])
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
