#!/usr/bin/env python
"""Frame-loop profile of the PyTorch/CUDA port on one GPU, as one JSON
line: frames/s and the stage split of a whole run, then, for a steady
window of frames, the device operations a frame, the device's busy
share, and the device time of this repository's kernels by name.

  python cli/profile_torch.py                      # this checkout
  python cli/profile_torch.py --root build/parent  # another checkout
  python cli/profile_torch.py --compare build/parent --pairs 10

--root names the checkout whose `ndt_slam_tpu_torch` is profiled (the
log is always read from this one). --compare measures two checkouts in
turns in one process on one card, so that the host's drift hits both
alike: `--pairs` pairs of whole runs, the side that goes first
alternating, and prints each run's frames/s and stage split, the
medians, and how many pairs the --root side won. Unpack the other
commit with `git archive` into a directory that .gitignore lists.

The busy share is the summed duration of the device events of the
window (one stream, so they do not overlap) over the wall time of the
same frames in an unprofiled run. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOKENS = ("sgh_kernel", "score_many_kernel", "nn_kernel",
                 "nn_finish_kernel", "window_kernel", "window_sum_kernel")


def _kernel_key(name: str) -> str:
    """Short name of one of this repository's kernels, '' for others."""
    for tok in KERNEL_TOKENS:
        if tok in name:
            variant = ""
            if tok == "window_kernel":
                derivs = "<true>" in name or "ILb1EE" in name
                variant = "<sgh>" if derivs else "<score_many>"
            return tok + variant
    return ""


def _load_tree(root: str) -> dict:
    """Import the port from the checkout `root` and take its modules
    out of sys.modules, so that another checkout's can be imported
    beside them. Returns the modules by name."""
    import importlib

    sys.path.insert(0, root)
    try:
        for mod in ("config", "io.carmen", "metrics", "ndt.kernels",
                    "pipeline.frontend", "pipeline.runner"):
            importlib.import_module("ndt_slam_tpu_torch." + mod)
    finally:
        sys.path.remove(root)
    return {name: sys.modules.pop(name) for name in list(sys.modules)
            if name.split(".")[0] == "ndt_slam_tpu_torch"}


def _activate(tree: dict):
    """Make `tree` the port that imports at call time resolve to."""
    for name in list(sys.modules):
        if name.split(".")[0] == "ndt_slam_tpu_torch":
            del sys.modules[name]
    sys.modules.update(tree)


def _compare(trees: dict, pairs: int, frames, card: str) -> dict:
    """Whole runs of the two trees in turns; the first of each pair
    alternates."""
    import torch

    device = torch.device("cuda", 0)
    names = list(trees)
    runs = {name: [] for name in names}

    def one(name):
        _activate(trees[name])
        mods = trees[name]
        cfg = mods["ndt_slam_tpu_torch.config"].SlamConfig()
        fe = mods["ndt_slam_tpu_torch.pipeline.runner"].run_slam(
            frames, cfg, device)
        torch.cuda.synchronize()
        n = len(fe.pose_history)
        ms = {k: v / n for k, v in fe.timer.ms.items()}
        return {"frames_per_s": n / fe.metrics[-1]["wall_s"],
                "align_ms": ms["align"], "fuse_ms": ms["fuse"],
                "fitness_ms": ms["fitness"], "map_ms": ms["map"],
                "other_ms": sum(ms.values()) - ms["align"]}

    for name in names:                                   # warm-up, build
        one(name)
    for pair in range(pairs):
        order = names if pair % 2 == 0 else names[::-1]
        for name in order:
            runs[name].append(one(name))
    a, b = names
    out = {"card": card, "pairs": pairs, "runs": runs}
    for key in ("frames_per_s", "align_ms", "fuse_ms", "fitness_ms",
                "map_ms", "other_ms"):
        out["median_" + key] = {
            name: statistics.median(r[key] for r in runs[name])
            for name in names}
    out["pairs_won_by_" + a] = sum(
        x["frames_per_s"] > y["frames_per_s"]
        for x, y in zip(runs[a], runs[b]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=os.path.join(HERE, ".."),
                    help="checkout whose package is profiled")
    ap.add_argument("--compare", help="a second checkout, measured in "
                                      "turns with --root")
    ap.add_argument("--pairs", type=int, default=10,
                    help="pairs of whole runs for --compare")
    ap.add_argument("--warm", type=int, default=40,
                    help="frames before the window")
    ap.add_argument("--window", type=int, default=50,
                    help="frames in the profiled window")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA device", file=sys.stderr)
        return 1
    top = os.path.join(HERE, "..")
    tree = _load_tree(root)
    _activate(tree)
    SlamConfig = tree["ndt_slam_tpu_torch.config"].SlamConfig
    carmen = tree["ndt_slam_tpu_torch.io.carmen"]
    ate_rmse = tree["ndt_slam_tpu_torch.metrics"].ate_rmse
    kernels = tree["ndt_slam_tpu_torch.ndt.kernels"]
    FrontEnd = tree["ndt_slam_tpu_torch.pipeline.frontend"].FrontEnd
    run_slam = tree["ndt_slam_tpu_torch.pipeline.runner"].run_slam

    data = os.path.join(top, "tests", "data")
    frames = carmen.read_carmen_log(os.path.join(data, "office_loop.clf"))
    gt = carmen.read_carmen_gt(os.path.join(data, "office_loop.gt"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.compare:
        other = os.path.abspath(args.compare)
        trees = {os.path.relpath(root, top): tree,
                 os.path.relpath(other, top): _load_tree(other)}
        print(json.dumps(_compare(trees, args.pairs, frames, card)))
        return 0
    device = torch.device("cuda", 0)
    cfg = SlamConfig()
    kernels._load()

    # whole run: frames/s, stage split, accuracy
    run_slam(frames, cfg.replace(end_frame=20), device)      # warm-up
    kernels.reset_launch_counts()
    fe = run_slam(frames, cfg, device)
    torch.cuda.synchronize()
    n = len(fe.pose_history)
    loop_s = fe.metrics[-1]["wall_s"]
    result = {
        "root": os.path.relpath(root, top), "card": card,
        "frames": n, "loop_s": loop_s, "frames_per_s": n / loop_s,
        "ate_m": float(ate_rmse(fe.get_poses(), gt[:n])),
        "accept": float(np.mean([bool(m.get("successful"))
                                 for m in fe.metrics])),
        "launches": kernels.launch_counts(),
        "stage_ms_per_frame": {k: v / n for k, v in sorted(
            fe.timer.ms.items(), key=lambda kv: -kv[1])},
    }

    # steady window, unprofiled then profiled
    def window(profiled: bool):
        fe = FrontEnd(cfg, device)
        for fr in frames[:args.warm]:
            fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
        torch.cuda.synchronize()
        span = frames[args.warm:args.warm + args.window]
        if not profiled:
            t0 = time.perf_counter()
            for fr in span:
                fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fr in span:
                fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
            torch.cuda.synchronize()
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == DeviceType.CUDA]

    wall_s = window(False)
    events = window(True)
    if not events:
        print("profile_torch: the profiler recorded no device event",
              file=sys.stderr)
        return 1
    device_ms = sum(us for _, us in events) / 1e3
    by_kernel: dict[str, list] = {}
    for name, us in events:
        key = _kernel_key(name)
        if key:
            by_kernel.setdefault(key, []).append(us)
    result.update({
        "window_frames": args.window,
        "window_wall_ms_per_frame": wall_s * 1e3 / args.window,
        "device_ops_per_frame": len(events) / args.window,
        "device_ms_per_frame": device_ms / args.window,
        "device_busy_share": device_ms / (wall_s * 1e3),
        "kernels_us": {k: {"launches": len(v),
                           "median": statistics.median(v),
                           "max": max(v), "sum_ms": sum(v) / 1e3}
                       for k, v in sorted(by_kernel.items())},
    })
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
