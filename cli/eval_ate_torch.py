#!/usr/bin/env python
"""Evaluate a trajectory against a reference: ATE (+ optional RPE),
without JAX (the PyTorch package's `metrics`).

The counterpart of cli/eval_ate.py, whose JSON line it prints with the
same keys and values: ATE RMSE between an estimated SE(2) trajectory and
a ground-truth / reference trajectory, after an SE(2) alignment unless
--no-align, and the RPE over --rpe-delta frames when that is above 0.

Accepted trajectory formats (auto-detected per file):
  - full:      one "tx ty theta_deg" per line (poses_full.txt)
  - reference: first line = TOTAL pose count, then every 10th pose as
               "tx ty theta_deg" (poses.txt). When one side is
               decimated, the other is decimated to match before the
               comparison.

Examples:
  python cli/eval_ate_torch.py out/poses_full.txt tests/data/office_loop.gt
  python cli/eval_ate_torch.py out/poses.txt gt/poses_full.txt --rpe-delta 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from ndt_slam_tpu_torch.metrics import ate_rmse, rpe_rmse  # noqa: E402


def load_trajectory(path: str) -> tuple[np.ndarray, bool]:
    """Returns (poses [n,3], decimated?). A file whose first line is a
    single integer is the reference's decimated format."""
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    decimated = len(lines) > 0 and len(lines[0]) == 1
    rows = lines[1:] if decimated else lines
    poses = np.asarray([[float(v) for v in r[:3]] for r in rows],
                       dtype=np.float64)
    if poses.ndim != 2 or poses.shape[1] != 3:
        raise ValueError(f"{path}: expected 'tx ty theta' rows")
    return poses, decimated


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("estimated", help="estimated trajectory file")
    ap.add_argument("reference", help="ground-truth / reference trajectory")
    ap.add_argument("--no-align", action="store_true",
                    help="skip SE(2) Umeyama alignment before ATE")
    ap.add_argument("--rpe-delta", type=int, default=0,
                    help="also report RPE over this frame interval (>0)")
    args = ap.parse_args(argv)

    est, est_dec = load_trajectory(args.estimated)
    ref, ref_dec = load_trajectory(args.reference)
    if est_dec and not ref_dec:
        ref = ref[::10]
    elif ref_dec and not est_dec:
        est = est[::10]
    n = min(len(est), len(ref))
    if n == 0:
        print(json.dumps({"error": "empty trajectory"}))
        return 1
    dropped = max(len(est), len(ref)) - n
    if dropped > max(2, 0.02 * n):
        # a large mismatch means inputs that cover different frames (a
        # run from start_frame > 0 against the full ground truth, other
        # decimation offsets): the first n pairs would be the wrong ones
        print(
            f"[eval_ate] WARNING: trajectory lengths differ by {dropped} "
            f"frames ({len(est)} vs {len(ref)}); comparing the first {n} "
            "pairwise — verify the inputs cover the same frames",
            file=sys.stderr,
        )
    est, ref = est[:n], ref[:n]

    out = {
        "frames": n,
        "dropped_frames": dropped,
        "ate_rmse_m": ate_rmse(est, ref, align=not args.no_align),
    }
    if args.rpe_delta > 0 and n > args.rpe_delta:
        tr, rot = rpe_rmse(est, ref, delta=args.rpe_delta)
        out["rpe_trans_rmse_m"] = tr
        out["rpe_rot_rmse_deg"] = rot
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
