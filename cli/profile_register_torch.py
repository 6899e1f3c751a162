#!/usr/bin/env python
"""Registration-step time breakdown of the PyTorch/CUDA port.

Times each stage of `ndt_slam_tpu_torch/pipeline/frontend._registration_step`
alone and warm, and the full step, at the operating point of
cli/profile_register.py: a 192 x 192 window, ndt_min_points_per_cell 3,
2048 scan slots and 1024 active cells, a 32768-slot local map made of
four room scans and a 1081-beam scan (`bench_torch.register_config`
and `register_inputs`, the bench's register line). Prints the JAX
tool's markdown table (stage | time [us] | eff. GFLOP/s) with the
device operations of one call added:

  python cli/profile_register_torch.py              # on the card
  python cli/profile_register_torch.py --reps 100
  python cli/profile_register_torch.py --device cpu  # the plain twins

Every timed call sees other inputs (reps + 2 variants shifted by up to
1 mm; the two warm-up calls take the last two, outside the timed set).
A row's time is CUDA events around its batch of reps over reps (the
host clock on the CPU); its device operations are the device events
torch.profiler records for a few calls, over the calls (between spin
kernels, a session remade when it lost its edges). The first row
is the floor a launch costs: the kernel library's empty kernel (a
trivial tensor operation on the CPU). The GFLOP/s column divides the
JAX tool's nominal operation counts, taken on the padded slots (N
source slots x K table cells, 2048 scan slots x L target slots), by the
row's time, so the two tables line up; the kernels skip masked slots,
so it is not the card's rate. --device cpu runs the plain PyTorch twins;
the default needs a card. `profile_rows(small=True)` cuts the operating
point to a CPU-sized one for the tests.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

SPINS = 8              # spin kernels on each side of the profiled calls
SPIN_CYCLES = 100_000  # their length: about 50 us at 1980 MHz
EDGE_S = 0.05          # host time at each end of a profiler session
PROFILED_CALLS = 3
PROFILE_TRIES = 3      # sessions before a count is taken as it is


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _out_device(out):
    """The device of the first tensor in a call's result."""
    import torch

    if isinstance(out, torch.Tensor):
        return out.device
    for v in out:
        d = _out_device(v)
        if d is not None:
            return d
    return None


def _time(fn, variants, reps, cuda: bool) -> float:
    """Seconds a call of fn over variants[0..reps-1], warmed on the two
    variants after them; CUDA events around the batch on the card."""
    import torch

    assert len(variants) >= reps + 2, (len(variants), reps)
    for v in variants[reps:reps + 2]:
        fn(*v)
    if not cuda:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(*variants[i])
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        fn(*variants[i])
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3 / reps


def _device_ops(fn, args) -> float:
    """Device events (kernels, copies, memsets) of one call of fn(*args),
    over PROFILED_CALLS calls. The profiler has lost the events at a
    session's edges, so the calls sit between SPINS spin kernels and
    EDGE_S seconds of host time on each side; a session that lost every
    spin on one side, or saw fewer events than calls (every stage
    launches at least once), is made again, up to PROFILE_TRIES."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(EDGE_S)
            for _ in range(SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(PROFILED_CALLS):
                fn(*args)
            for _ in range(SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spins = [e.time_range.start for e in dev if "spin_kernel" in e.name]
        inner = [e.time_range.start for e in dev
                 if "spin_kernel" not in e.name]
        if len(inner) >= PROFILED_CALLS \
                and any(t < min(inner) for t in spins) \
                and any(t > max(inner) for t in spins):
            break
    return len(inner) / PROFILED_CALLS


def profile_rows(device="cuda", reps: int = 30, small: bool = False):
    """(header, rows): the operating point's n_src, valid cells and
    iterations, and one row a stage: {"name", "us", "gflops" (None
    where the JAX tool has none), "device_ops" (None on the CPU),
    "device" (where the stage's output lies)}."""
    import torch

    from bench_torch import register_config, register_inputs, register_step
    from ndt_slam_tpu_torch.core.points import PointBuffer
    from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.ndt.compact import compact_grid
    from ndt_slam_tpu_torch.ndt.grid import build_grid
    from ndt_slam_tpu_torch.ndt.score import gauss_constants
    from ndt_slam_tpu_torch.ndt.solve import align

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the "
                           "plain PyTorch twins")
    cfg = register_config(small)
    V = reps + 2        # every rep distinct; the last two variants warm up
    inp = register_inputs(cfg, device, small, variants=V)
    put = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    scan_xy, scan_mask = inp["scan"].xy, inp["scan"].mask
    local = inp["local"]
    local_xy, local_mask = local.xy, local.mask
    shifts = np.linspace(0.0, 1e-3, V).astype(np.float32)
    scan_host = scan_xy.cpu().numpy()
    pose_vars = [put(np.array([s, s, s], np.float32)) for s in shifts]
    scan_vars = [put(scan_host + s) for s in shifts]
    center_vars = [put(np.array([s, s], np.float32)) for s in shifts]
    rows = []

    def row(name, fn, variants, flops=None):
        t = _time(fn, variants, reps, cuda)
        rows.append({
            "name": name, "us": t * 1e6,
            "gflops": None if flops is None else flops / t / 1e9,
            "device_ops": _device_ops(fn, variants[0]) if cuda else None,
            "device": str(_out_device(fn(*variants[0]))),
        })

    # the floor of a launch: the empty kernel (a trivial op on the CPU)
    if cuda:
        def floor(p):
            kernels.empty_launch(device)
            return p
        row("(launch floor: empty kernel)", floor,
            [(p,) for p in pose_vars])
    else:
        row("(floor: trivial torch op)", lambda p: p + 1.0,
            [(p,) for p in pose_vars])

    full = register_step(cfg, inp)
    odo_vars = [(o,) for o in inp["odos"]]
    it = int(full(inp["odo"]).iterations)

    def vf(xy, m):
        return voxel_filter(PointBuffer(xy, m), cfg.source_leaf_size)
    src = vf(scan_xy, scan_mask)
    n_src = int(src.mask.sum())

    def gb(xy, m, c):
        return build_grid(xy, m, c, cfg.grid_cells_x, cfg.grid_cells_y,
                          cfg.ndt_resolution,
                          min_pts=cfg.ndt_min_points_per_cell)
    grids = [gb(local_xy, local_mask, c) for c in center_vars]

    def cgf(g):
        return compact_grid(g, cfg.ndt_max_active_cells)
    cg = cgf(grids[0])
    k_valid = int(cg.valid.sum())
    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)

    def sgh(p):
        return kernels.ndt_score_grad_hess(p, src.xy, src.mask, cg, d1, d2, 1)

    def ls(p):
        return kernels.ndt_scores(p, src.xy, src.mask, cg, d1, d2, 1)

    def al(p):
        return align(p, src.xy, src.mask, cg, d1, d2,
                     max_iterations=cfg.ndt_max_iterations,
                     step_size=cfg.ndt_step_size,
                     trans_eps=cfg.ndt_trans_eps, radius=1)

    def fit(xy, m):
        return kernels.fitness_score(xy, m, local_xy, local_mask)

    N = src.xy.shape[0]           # padded pair-pass rows
    K = cfg.ndt_max_active_cells
    L = local.xy.shape[0]
    # the JAX tool's nominal counts: ~28 operations a (point, cell) for
    # sgh, 12 candidates of ~14 for the line search, 5 a fitness pair
    flops_sgh = N * K * 28
    flops_ls = N * K * 12 * 14
    flops_fit = cfg.max_scan_points * L * 5
    row("source voxel filter", vf, [(x, scan_mask) for x in scan_vars])
    row("NDT grid build (131k-cap scatter)", gb,
        [(local_xy, local_mask, c) for c in center_vars])
    row("grid compaction (top-K)", cgf, [(g,) for g in grids])
    row(f"one sgh pass (N={N}, K={K})", sgh, [(p,) for p in pose_vars],
        flops_sgh)
    row("one 12-candidate line-search pass", ls,
        [(put(np.full((12, 3), s, np.float32)),) for s in shifts], flops_ls)
    row(f"Newton align (it={it})", al, [(p,) for p in pose_vars])
    row(f"fitness NN (2048 x {L})", fit, [(x, scan_mask) for x in scan_vars],
        flops_fit)
    row("FULL fused step", full, odo_vars)
    header = {"device": str(device), "card": _card() if cuda else None,
              "reps": reps, "n_src": n_src, "valid_cells": k_valid,
              "iterations": it}
    return header, rows


def format_table(header, rows) -> str:
    """The JAX tool's printout, with the device operations a call."""
    where = (f"{header['device']} ({header['card']})" if header["card"]
             else header["device"])
    lines = [f"device: {where}; reps={header['reps']}; "
             f"n_src={header['n_src']}, valid cells={header['valid_cells']}, "
             f"iterations={header['iterations']}",
             "| stage | time [us] | eff. GFLOP/s | device ops |",
             "|---|---|---|---|"]
    for r in rows:
        fl = f"{r['gflops']:.1f}" if r["gflops"] else "—"
        ops = f"{r['device_ops']:g}" if r["device_ops"] is not None else "—"
        lines.append(f"| {r['name']} | {r['us']:.2f} | {fl} | {ops} |")
    t = {r["name"].split(" (")[0]: r["us"] for r in rows}
    acc = sum(t[k] for k in ("source voxel filter", "NDT grid build",
                             "grid compaction", "Newton align",
                             "fitness NN"))
    lines.append(
        f"(sum of stages ~ {acc:.0f} us vs full {t['FULL fused step']:.0f}"
        f" us; align includes {header['iterations']}x(sgh+line search); "
        f"eff. GFLOP/s: the JAX tool's nominal counts on padded slots)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("profile_register_torch: no CUDA device; pass --device cpu "
              "to run the plain PyTorch twins", file=sys.stderr)
        return 1
    header, rows = profile_rows(args.device, args.reps)
    print(format_table(header, rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
