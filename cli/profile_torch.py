#!/usr/bin/env python
"""Frame-loop profile of the PyTorch/CUDA port on one GPU, as one JSON
line: frames/s and the stage split of a whole run, then, for a steady
window of frames, the device operations a frame, the device's busy
share, and the device time of this repository's kernels by name.

  python cli/profile_torch.py                      # this checkout
  python cli/profile_torch.py --root build/parent  # another checkout
  python cli/profile_torch.py --compare build/parent --pairs 10
  python cli/profile_torch.py --incremental-grid --pairs 10
  python cli/profile_torch.py --loop-verify-async --pairs 10

--root names the checkout whose `ndt_slam_tpu_torch` is profiled (the
log is always read from this one). --compare measures two checkouts in
turns in one process on one card, so that the host's drift hits both
alike: `--pairs` pairs of whole runs, the side that goes first
alternating, and prints each run's frames/s and stage split, the
medians, and how many pairs the --root side won. Unpack the other
commit with `git archive` into a directory that .gitignore lists.
--incremental-grid measures the two grid paths of the --root checkout
the same way (ndt_incremental_grid = 1 against 0, whole runs in turns),
and then profiles the steady window of each. --loop-verify-async
measures office_loop with loop closure (full rebuild) the same way,
the verify resolved a check late (loop_verify_async = 1) against at
once (0), with each run's back-end times.

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


def _compare(sides: dict, pairs: int, frames, card: str) -> dict:
    """Whole runs of two sides in turns; the first of each pair
    alternates. `sides` maps a name to (modules of a checkout, SlamConfig
    overrides)."""
    import torch

    device = torch.device("cuda", 0)
    names = list(sides)
    runs = {name: [] for name in names}

    def one(name):
        mods, overrides = sides[name]
        _activate(mods)
        cfg = mods["ndt_slam_tpu_torch.config"].SlamConfig().replace(
            **overrides)
        fe = mods["ndt_slam_tpu_torch.pipeline.runner"].run_slam(
            frames, cfg, device)
        torch.cuda.synchronize()
        n = len(fe.pose_history)
        ms = {k: v / n for k, v in fe.timer.ms.items()}
        out = {f"{k}_ms": v for k, v in ms.items()}
        out["frames_per_s"] = n / fe.metrics[-1]["wall_s"]
        out["other_ms"] = sum(ms.values()) - ms["align"]
        be = getattr(fe, "backend", None)
        if be is not None:
            out.update(t_verify_s=be.t_verify, t_optimize_s=be.t_optimize,
                       t_remake_s=fe.t_remake,
                       loops_accepted=be.loops_accepted,
                       corrections=fe.n_corrections)
        return out

    for name in names:                                   # warm-up, build
        one(name)
    for pair in range(pairs):
        order = names if pair % 2 == 0 else names[::-1]
        for name in order:
            runs[name].append(one(name))
    a, b = names
    out = {"card": card, "pairs": pairs, "runs": runs}
    keys = sorted(set.intersection(*(set(r) for rs in runs.values()
                                     for r in rs)))
    for key in keys:
        out["median_" + key] = {
            name: statistics.median(r[key] for r in runs[name])
            for name in names}
    out["pairs_won_by_" + a] = sum(
        x["frames_per_s"] > y["frames_per_s"]
        for x, y in zip(runs[a], runs[b]))
    return out


def _profile(tree: dict, overrides: dict, frames, gt, args, label: str,
             card: str) -> dict:
    """One whole run (frames/s, stage split, accuracy, launches), then
    the steady window unprofiled and profiled."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _activate(tree)
    cfg = tree["ndt_slam_tpu_torch.config"].SlamConfig().replace(**overrides)
    ate_rmse = tree["ndt_slam_tpu_torch.metrics"].ate_rmse
    kernels = tree["ndt_slam_tpu_torch.ndt.kernels"]
    FrontEnd = tree["ndt_slam_tpu_torch.pipeline.frontend"].FrontEnd
    run_slam = tree["ndt_slam_tpu_torch.pipeline.runner"].run_slam
    device = torch.device("cuda", 0)
    kernels._load()

    run_slam(frames, cfg.replace(end_frame=20), device)      # warm-up
    kernels.reset_launch_counts()
    fe = run_slam(frames, cfg, device)
    torch.cuda.synchronize()
    n = len(fe.pose_history)
    loop_s = fe.metrics[-1]["wall_s"]
    result = {
        "root": label, "card": card, "config": overrides,
        "incremental_grid": getattr(fe, "incremental_grid", False),
        "n_grid_fallbacks": getattr(fe, "n_grid_fallbacks", 0),
        "frames": n, "loop_s": loop_s, "frames_per_s": n / loop_s,
        "ate_m": float(ate_rmse(fe.get_poses(), gt[:n])),
        "accept": float(np.mean([bool(m.get("successful"))
                                 for m in fe.metrics])),
        "launches": kernels.launch_counts(),
        "stage_ms_per_frame": {k: v / n for k, v in sorted(
            fe.timer.ms.items(), key=lambda kv: -kv[1])},
    }

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
        raise RuntimeError("the profiler recorded no device event")
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
        "d2h_copies_per_frame": sum(
            "memcpy dtoh" in name.lower() for name, _ in events)
        / args.window,
        "device_ms_per_frame": device_ms / args.window,
        "device_busy_share": device_ms / (wall_s * 1e3),
        "kernels_us": {k: {"launches": len(v),
                           "median": statistics.median(v),
                           "max": max(v), "sum_ms": sum(v) / 1e3}
                       for k, v in sorted(by_kernel.items())},
    })
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=os.path.join(HERE, ".."),
                    help="checkout whose package is profiled")
    ap.add_argument("--compare", help="a second checkout, measured in "
                                      "turns with --root")
    ap.add_argument("--incremental-grid", action="store_true",
                    help="measure the lattice path and the full rebuild "
                         "of --root in turns, then profile each")
    ap.add_argument("--loop-verify-async", action="store_true",
                    help="measure office_loop with loops, the verify "
                         "resolved a check late against at once, in turns")
    ap.add_argument("--pairs", type=int, default=10,
                    help="pairs of whole runs for --compare, "
                         "--incremental-grid and --loop-verify-async")
    ap.add_argument("--warm", type=int, default=40,
                    help="frames before the window")
    ap.add_argument("--window", type=int, default=50,
                    help="frames in the profiled window")
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA device", file=sys.stderr)
        return 1
    top = os.path.join(HERE, "..")
    tree = _load_tree(root)
    carmen = tree["ndt_slam_tpu_torch.io.carmen"]
    data = os.path.join(top, "tests", "data")
    frames = carmen.read_carmen_log(os.path.join(data, "office_loop.clf"))
    gt = carmen.read_carmen_gt(os.path.join(data, "office_loop.gt"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    label = os.path.relpath(root, top)
    if args.compare:
        other = os.path.abspath(args.compare)
        sides = {label: (tree, {}),
                 os.path.relpath(other, top): (_load_tree(other), {})}
        print(json.dumps(_compare(sides, args.pairs, frames, card)))
        return 0
    if args.incremental_grid:
        sides = {"lattice": (tree, {"ndt_incremental_grid": 1}),
                 "full_rebuild": (tree, {"ndt_incremental_grid": 0})}
        print(json.dumps(_compare(sides, args.pairs, frames, card)))
        for name, (mods, overrides) in sides.items():
            print(json.dumps(_profile(mods, overrides, frames, gt, args,
                                      f"{label} ({name})", card)))
        return 0
    if args.loop_verify_async:
        loop = {"loop_enable": True, "ndt_incremental_grid": 0}
        sides = {"async": (tree, {**loop, "loop_verify_async": 1}),
                 "sync": (tree, {**loop, "loop_verify_async": 0})}
        print(json.dumps(_compare(sides, args.pairs, frames, card)))
        return 0
    print(json.dumps(_profile(tree, {}, frames, gt, args, label, card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
