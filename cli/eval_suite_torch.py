#!/usr/bin/env python
"""Run the PyTorch/CUDA port (ndt_slam_tpu_torch) over a suite of logs
and tabulate ATE and accept rate side by side.

Input: a JSON manifest (the repository's suite.json), e.g.

  [
    {"name": "office", "log": "tests/data/office_loop.clf",
     "format": "carmen", "gt": "tests/data/office_loop.gt",
     "overrides": {"loop_enable": true}, "expect_ate_below": 0.3},
    {"name": "sim120", "simulate": 120}
  ]

Examples:
  python cli/eval_suite_torch.py suite.json --out out/suite
  python cli/eval_suite_torch.py suite.json --out out/lockstep --lockstep
  python cli/eval_suite_torch.py suite.json --out out/suite --device cpu

Each entry runs the port's pipeline (`pipeline.runner.run_slam`) with
its config overrides and, where ground truth exists (a `gt` file or the
simulator's true poses), reports the SE(2)-aligned ATE; an entry with
`expect_ate_below` is held to it. With --lockstep every entry runs in
one lockstep batch (`pipeline.batch_runner.run_slam_batch`: one batched
registration step and one batched map step a tick for all of them),
under the first entry's overrides, and a last row gives the aggregate
scans/s. Rows print as JSON lines and go to <out>/suite.json, with the
keys of the JAX package's cli/eval_suite.py; a markdown table follows.
Exits 1 when an entry misses its ATE bound. --device defaults to cuda
and fails without a CUDA device; --device cpu runs the plain PyTorch
twins instead of the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def _config(entry: dict):
    from ndt_slam_tpu_torch.config import SlamConfig
    return SlamConfig().replace(**entry.get("overrides", {}))


def _load_frames(entry: dict, cfg):
    """The entry's frames: simulated, or read by the native parsers
    where csrc/libndtslam.so loads (else the numpy ones)."""
    from ndt_slam_tpu_torch.io import native
    if "simulate" in entry:
        from ndt_slam_tpu_torch.io.simulate import simulate_sequence
        return simulate_sequence(n_frames=int(entry["simulate"]),
                                 seed=int(entry.get("seed", 0)))
    if entry.get("format", "tsukuba") == "carmen":
        from ndt_slam_tpu_torch.io.carmen import read_carmen_log
        read = native.read_carmen_log if native.available() \
            else read_carmen_log
        return read(entry["log"])
    from ndt_slam_tpu_torch.io.tsukuba import read_tsukuba_log
    read = native.read_tsukuba_log if native.available() \
        else read_tsukuba_log
    return read(entry["log"], sidelidar=cfg.sidelidar)


def _ground_truth(entry: dict, frames):
    if "simulate" in entry:
        return np.asarray([f.true_pose for f in frames])
    if "gt" in entry:
        from ndt_slam_tpu_torch.io.carmen import read_carmen_gt
        return read_carmen_gt(entry["gt"])
    return None


def _accept_rate(fe) -> float:
    return round(float(np.mean([
        1.0 if m.get("successful") else 0.0 for m in fe.metrics
    ])), 4) if fe.metrics else 0.0


def run_entry(entry: dict, out_root: str, device, verbose: bool) -> dict:
    """One entry through `run_slam`; its row."""
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    cfg = _config(entry)
    frames = _load_frames(entry, cfg)
    true_poses = _ground_truth(entry, frames)
    if "simulate" in entry:
        cfg = cfg.replace(end_frame=max(cfg.end_frame, len(frames)))
    out_dir = os.path.join(out_root, entry["name"])
    t0 = time.perf_counter()
    fe = run_slam(frames, cfg, device, out_dir=out_dir,
                  metrics_path=os.path.join(out_dir, "metrics.jsonl"),
                  verbose=verbose)
    wall = time.perf_counter() - t0
    n = len(fe.pose_history)
    rec = {
        "name": entry["name"],
        "frames": n,
        "wall_s": round(wall, 2),
        "scans_per_s": round(n / max(wall, 1e-9), 3),
        "accept_rate": _accept_rate(fe),
        "loops_accepted": (fe.backend.loops_accepted
                           if fe.backend is not None else None),
    }
    if true_poses is not None and n:
        rec["ate_rmse_m"] = round(
            float(ate_rmse(fe.get_poses(), true_poses[:n])), 4)
    if "expect_ate_below" in entry and "ate_rmse_m" in rec:
        rec["ate_bound_m"] = float(entry["expect_ate_below"])
        rec["ate_ok"] = rec["ate_rmse_m"] <= rec["ate_bound_m"]
    return rec


def run_lockstep(entries, out_root: str, device, verbose: bool) -> list:
    """Every entry in one lockstep batch under the first entry's
    overrides; a row an entry and the aggregate row last."""
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.pipeline.batch_runner import run_slam_batch

    cfg = _config(entries[0])
    seqs = [_load_frames(e, cfg) for e in entries]
    gts = [_ground_truth(e, s) for e, s in zip(entries, seqs)]
    t0 = time.perf_counter()
    fes = run_slam_batch(seqs, cfg, device, verbose=verbose)
    wall = time.perf_counter() - t0
    total = sum(len(fe.pose_history) for fe in fes)

    rows = []
    for e, fe, gt in zip(entries, fes, gts):
        n = len(fe.pose_history)
        rec = {"name": e["name"], "frames": n, "accept_rate": _accept_rate(fe)}
        if gt is not None and n:
            rec["ate_rmse_m"] = round(float(ate_rmse(fe.get_poses(),
                                                     gt[:n])), 4)
        out_dir = os.path.join(out_root, e["name"])
        os.makedirs(out_dir, exist_ok=True)
        np.savetxt(os.path.join(out_dir, "poses_full.txt"), fe.get_poses(),
                   fmt="%.6f")
        rows.append(rec)
    rows.append({
        "name": "(aggregate)", "frames": total, "wall_s": round(wall, 2),
        "scans_per_s": round(total / max(wall, 1e-9), 3),
    })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("manifest", help="JSON list of suite entries")
    ap.add_argument("--out", required=True, help="output root directory")
    ap.add_argument("--lockstep", action="store_true",
                    help="run every entry in one lockstep batch (the "
                         "first entry's overrides; aggregate throughput)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("eval_suite_torch: --device cuda but no CUDA device is "
              "available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2

    with open(args.manifest) as f:
        entries = json.load(f)
    os.makedirs(args.out, exist_ok=True)
    if args.lockstep:
        rows = run_lockstep(entries, args.out, device, args.verbose)
        for r in rows:
            print(json.dumps(r), flush=True)
    else:
        rows = []
        for entry in entries:
            rows.append(run_entry(entry, args.out, device, args.verbose))
            print(json.dumps(rows[-1]), flush=True)
    with open(os.path.join(args.out, "suite.json"), "w") as f:
        json.dump(rows, f, indent=2)

    cols = ["name", "frames", "ate_rmse_m", "accept_rate",
            "loops_accepted", "scans_per_s", "wall_s"]
    print("\n| " + " | ".join(cols) + " |")
    print("|" + "---|" * len(cols))
    for r in rows:
        print("| " + " | ".join(str(r.get(c, "-")) for c in cols) + " |")

    failed = [r for r in rows if r.get("ate_ok") is False]
    for r in failed:
        print(f"REGRESSION: {r['name']} ATE {r['ate_rmse_m']} > bound "
              f"{r['ate_bound_m']}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
