#!/usr/bin/env python
"""Scaling report of the PyTorch/CUDA port's multi-rank paths
(`cli/bench_scaling.py` on `ndt_slam_tpu_torch`).

Workloads, with the JAX tool's sizes and random inputs:
  verify (default) — `make_sharded_verify` at production sizes
    (`SlamConfig(ndt_min_points_per_cell=3, ndt_max_active_cells=1024)`:
    the coarse-to-fine ladder, the ICP finisher and the symmetric
    overlap gate on 2048-slot scans), a batch of candidates with
    loop-closure-scale initial errors sharded over "dp";
  seqstep — `make_sharded_sequential_step`: one frame of the
    multi-rank sequential loop with the source and a 131072-slot target
    sharded over "pt";
  pairs — `make_batch_register`, the light micro-workload (64 x 64
    grid, 512-slot sources, near-converged inits) sharded over "dp".

A row for N devices is N ranks of one process group
(`parallel.dist.start`, a (dp, pt) mesh from `parallel.make_mesh`):
gloo ranks on the CPU, each with its share of the host's cores as
threads (OMP_NUM_THREADS), then one rank on the card (nccl) unless
--cpu-only. Every call is timed with a value read back on the host.
The CPU ranks share one host, so the sweep measures what widening the
mesh costs (collectives, the split), not a speedup. A failing card row
fails the tool; without a card it refuses to run unless --cpu-only.

    python cli/bench_scaling_torch.py                     # CPU sweep + card
    python cli/bench_scaling_torch.py --workload seqstep --devices 1 2
    python cli/bench_scaling_torch.py --cpu-only

Writes build/scaling_torch.json and build/scaling_torch.md by default.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the room of bench.py; with the noise given it draws the JAX tool's
# worker's points bit for bit
from bench_torch import _room_scan as room_scan  # noqa: E402

WORKLOADS = ("verify", "seqstep", "pairs")


def _pad(xy, capacity):
    """(xy [capacity, 2] padded with the sentinel, mask [capacity])."""
    from ndt_slam_tpu_torch.core.points import PAD_COORD

    n = min(len(xy), capacity)
    out = np.full((capacity, 2), PAD_COORD, np.float32)
    out[:n] = xy[:n]
    return out, np.arange(capacity) < n


def inputs(workload: str, batch: int, reps: int, small: bool = False):
    """(config, numpy inputs) of a workload: the JAX tool's, drawn in its
    order; `small` (a test hook) cuts the capacities to
    `SlamConfig.small`'s, the beams to a third and a quarter and the
    table to 256 cells."""
    from ndt_slam_tpu_torch.config import SlamConfig

    beams, tgt_beams = (361, 1081) if small else (1081, 4321)
    cells = {"ndt_max_active_cells": 256} if small else {}
    if workload == "pairs":
        cfg = SlamConfig(grid_cells_x=64, grid_cells_y=64,
                         ndt_min_points_per_cell=3, **cells)
        tgt, tgt_mask = _pad(room_scan(720, noise=0.01), 2048)
        rng = np.random.default_rng(0)
        offs = rng.uniform(-0.05, 0.05, (batch, 3)).astype(np.float32)
        srcs = [_pad(room_scan(360, pose=tuple(o), noise=0.01, seed=i), 512)
                for i, o in enumerate(offs)]
        return cfg, {
            "src_xy": np.stack([s[0] for s in srcs]),
            "src_mask": np.stack([s[1] for s in srcs]),
            "tgt_xy": np.broadcast_to(tgt, (batch,) + tgt.shape).copy(),
            "tgt_mask": np.broadcast_to(tgt_mask, (batch,)
                                        + tgt_mask.shape).copy(),
            "init": np.zeros((batch, 3), np.float32),
            "center": np.zeros((batch, 2), np.float32),
            "inits": [rng.uniform(-0.05, 0.05, (batch, 3)).astype(np.float32)
                      for _ in range(reps)],
        }
    cfg = (SlamConfig.small(ndt_min_points_per_cell=3, **cells) if small
           else SlamConfig(ndt_min_points_per_cell=3,
                           ndt_max_active_cells=1024))
    S = cfg.max_scan_points
    if workload == "verify":
        src, src_mask = _pad(room_scan(beams, pose=(0.1, -0.05, 0.03),
                                       noise=0.01), S)
        rng = np.random.default_rng(0)

        def draw():
            return np.concatenate([rng.uniform(-1.5, 1.5, (batch, 2)),
                                   rng.uniform(-0.17, 0.17, (batch, 1))],
                                  1).astype(np.float32)
        init = draw()
        tgts = [_pad(room_scan(beams, noise=0.01, seed=i + 1), S)
                for i in range(batch)]
        return cfg, {
            "src_xy": src, "src_mask": src_mask,
            "tgt_xy": np.stack([t[0] for t in tgts]),
            "tgt_mask": np.stack([t[1] for t in tgts]),
            "init": init, "inits": [draw() for _ in range(reps)],
        }
    if workload == "seqstep":
        parts = [room_scan(tgt_beams, pose=(0.2 * i, 0.1 * i, 0.05 * i),
                           noise=0.01, seed=i) for i in range(4)]
        tgt, tgt_mask = _pad(np.concatenate(parts, 0),
                             cfg.max_local_map_points)
        raw, raw_mask = _pad(room_scan(beams, pose=(0.05, 0.03, 0.02),
                                       noise=0.01, seed=9), S)
        rng = np.random.default_rng(0)
        return cfg, {
            "tgt_xy": tgt, "tgt_mask": tgt_mask, "raw_xy": raw,
            "raw_mask": raw_mask,
            "odos": [np.concatenate([rng.uniform(-0.2, 0.2, 2),
                                     rng.uniform(-3.0, 3.0, 1)]).astype(
                                         np.float32) for _ in range(reps)],
        }
    raise ValueError(f"unknown workload {workload!r}")


def card() -> str:
    """The card's `nvidia-smi` name and power limit."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run_rows(n: int, workloads, reps: int, batch: int, device: str = "cpu",
             backend: str | None = None, threads: int | None = None,
             small: bool = False) -> list:
    """One row a workload, each run by `n` ranks of one process group
    (started once for all of them) on `device`: gloo on the CPU, nccl on
    the card unless `backend` says otherwise (two ranks sharing a card
    need gloo). `threads`: each rank's CPU threads (default: the host's
    cores over n). Raises when a rank fails or the ranks disagree."""
    from ndt_slam_tpu_torch.parallel import dist as pdist
    from ndt_slam_tpu_torch.parallel import jobs

    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    if backend is None:
        backend = "nccl" if device.startswith("cuda") else "gloo"
    jobs_ = []
    for w in workloads:
        cfg, inp = inputs(w, batch, reps, small)
        jobs_.append(("scaling", (cfg, w, inp, reps, device, threads), {}))
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(threads)   # the ranks inherit it
    try:
        ranks = pdist.start(jobs.run, n, jobs_, backend=backend,
                            device=device).result()
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    rows = []
    for i, w in enumerate(workloads):
        mine = [r[i] for r in ranks]
        key = next(k for k in ("accepted", "iterations", "converged")
                   if k in mine[0])
        if len({m[key] for m in mine}) != 1:
            raise RuntimeError(f"{w}: the ranks' {key} differ: "
                               f"{[m[key] for m in mine]}")
        sec = max(m["sec_per_batch"] for m in mine)
        b = 1 if w == "seqstep" else batch
        rows.append({
            "devices": n, "platform": "gpu" if device.startswith("cuda")
            else "cpu", "batch": b, "workload": w, "sec_per_batch": sec,
            "pairs_per_sec": b / sec, key: mine[0][key],
            "launches": [m["wrappers"] for m in mine],
        })
    return rows


WHAT = {
    "verify": "make_sharded_verify (full ladder + ICP + symmetric gate, "
              "production sizes)",
    "seqstep": "make_sharded_sequential_step (ONE frame of the multi-rank "
               "sequential loop, pt-sharded source + target, production "
               "operating point)",
    "pairs": "make_batch_register (light micro-workload)",
}
TITLE = {
    "verify": "# SCALING (PyTorch port) — loop-closure candidate "
              "verification",
    "seqstep": "# SCALING (PyTorch port) — sequential frame step "
               "(pt-sharded)",
    "pairs": "# SCALING (PyTorch port) — batch pair registration (micro)",
}


def write_report(rows, card_row, args, out_json: str, out_md: str):
    """The JAX tool's report: JSON (host cores, batch, reps, workload, the
    CPU rows with `rel_throughput_vs_1dev`, the card row) and markdown."""
    base = rows[0]["pairs_per_sec"]
    n_cores = os.cpu_count() or 1
    for r in rows:
        r["rel_throughput_vs_1dev"] = r["pairs_per_sec"] / base
    report = {"host_cores": n_cores, "batch": args.batch, "reps": args.reps,
              "workload": args.workload, "cpu_rows": rows,
              "gpu_row": card_row}
    for path in (out_json, out_md):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    unit = ("frame steps/s" if args.workload == "seqstep"
            else "candidates/s")
    lines = [
        TITLE[args.workload], "",
        (f"Workload: {WHAT[args.workload]} — point buffers sharded over "
         "the `pt` axis (`parallel/register.py`)."
         if args.workload == "seqstep" else
         f"Workload: {WHAT[args.workload]}, batch of {args.batch} "
         "candidates sharded over the `dp` mesh axis."),
        f"Host: {n_cores} cores; the CPU rows are gloo ranks on that host,",
        "each with its share of the cores, so the sweep measures what the",
        "wider mesh costs (collectives, the split), not a speedup.", "",
        f"| devices | platform | {unit} | rel. throughput vs 1 dev |",
        "|---|---|---|---|",
    ]
    for r in rows:
        lines.append(f"| {r['devices']} | cpu | {r['pairs_per_sec']:.2f} "
                     f"| {100 * r['rel_throughput_vs_1dev']:.0f}% |")
    if card_row:
        lines.append(f"| 1 | {card_row['card']} | "
                     f"{card_row['pairs_per_sec']:.2f} | — |")
    lines.append("")
    with open(out_md, "w") as f:
        f.write("\n".join(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--workload", choices=WORKLOADS, default="verify")
    ap.add_argument("--cpu-only", action="store_true",
                    help="skip the card's row")
    ap.add_argument("--out-json",
                    default=os.path.join(REPO, "build", "scaling_torch.json"))
    ap.add_argument("--out-md",
                    default=os.path.join(REPO, "build", "scaling_torch.md"))
    args = ap.parse_args(argv)

    import torch

    if not args.cpu_only and not torch.cuda.is_available():
        print("bench_scaling_torch: no CUDA device; pass --cpu-only for "
              "the CPU rows alone", file=sys.stderr)
        return 1
    rows = []
    for n in args.devices:
        r, = run_rows(n, [args.workload], args.reps, args.batch)
        rows.append(r)
        print(json.dumps(r), flush=True)
    card_row = None
    if not args.cpu_only:
        card_row, = run_rows(1, [args.workload], args.reps, args.batch,
                             device="cuda")
        card_row["card"] = card()
        print(json.dumps(card_row), flush=True)
    write_report(rows, card_row, args, args.out_json, args.out_md)
    print(f"wrote {args.out_json} and {args.out_md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
