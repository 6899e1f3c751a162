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
0); summary.json says which grid path and which resampler ran.
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
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if not args.simulate and not args.log:
        ap.error("need --log or --simulate")  # before any heavy import

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("run_slam_torch: --device cuda but no CUDA device is "
                 "available (pass --device cpu to run on the CPU)")

    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.io import native
    from ndt_slam_tpu_torch.io.carmen import read_carmen_gt, read_carmen_log
    from ndt_slam_tpu_torch.io.simulate import simulate_sequence
    from ndt_slam_tpu_torch.io.tsukuba import read_tsukuba_log
    from ndt_slam_tpu_torch.metrics import ate_rmse
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
    if args.loop:
        overrides["loop_enable"] = True
    cfg = SlamConfig().replace(**overrides)

    true_poses = read_carmen_gt(args.gt) if args.gt else None
    if args.simulate:
        frames = simulate_sequence(n_frames=args.simulate)
        stamps = [f.sid for f in frames]
        if true_poses is None:
            true_poses = np.asarray([f.true_pose for f in frames])
        cfg = cfg.replace(end_frame=max(cfg.end_frame, args.simulate))
        reader = "simulator"
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

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    fe = run_slam(frames, cfg, device, out_dir=args.out,
                  metrics_path=os.path.join(args.out, "metrics.jsonl"),
                  verbose=args.verbose, checkpoint_path=args.checkpoint,
                  checkpoint_every=args.checkpoint_every, resume=args.resume,
                  viz_every=args.viz_every, viz_final=args.viz)
    summary = {
        "frames": len(fe.pose_history),
        "device": str(device),
        "incremental_grid": fe.incremental_grid,
        "n_grid_fallbacks": fe.n_grid_fallbacks,
        "native_library": native.status(),
        "log_reader": reader,
        "resampler": fe.resampler,
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
    if fe.n_grid_fallbacks:
        # the JAX CLI's key, written only when a window escaped
        summary["grid_fallbacks"] = fe.n_grid_fallbacks
    if device.type == "cuda":
        summary["device_name"] = torch.cuda.get_device_name(device)
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


if __name__ == "__main__":
    main()
