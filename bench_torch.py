#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port: NDT scan-to-map registrations
per second on one card, and the pipeline's throughput (`bench.py` on
`ndt_slam_tpu_torch`).

Workload = the per-frame hot path at the reference's operating point
(SURVEY.md §6.1: resolution 0.3 m, <= 35 Newton iterations, step 0.1,
eps 0.01). `vs_baseline` divides by the same workload on one CPU core
of the card's host (`--cpu-baseline`: the port's plain twins with one
thread and the gather engine), the reference's execution model
(single-core PCL, SURVEY.md §2.3).

The default invocation prints FOUR JSON lines, `<plat>` being `gpu` on
the card and `cpu` with `--device cpu`:
  {"metric": "ndt_register_scans_per_s_<plat>", ...}   registration step
  {"metric": "pipeline_scans_per_s_<plat>", ...}       FrontEnd.process
  {"metric": "pipeline_batch8_scans_per_s_<plat>", ...} lockstep, 8 logs
  {"metric": "pipeline_device_scans_per_s_<plat>", ...} device chain
With --pipeline / --pipeline-device / --batch the corresponding single
line is printed, with --register-only or --cpu-baseline the first.

    python bench_torch.py                  # on the card
    python bench_torch.py --quick
    python bench_torch.py --device cpu     # the plain twins
    python bench_torch.py --cpu-baseline   # one core: the baseline

On the card every timed call is queued and the clock stops after one
`torch.cuda.synchronize()`; the Newton solve is one launch there and
reads nothing back. Without a card the default device fails: pass
--device cpu.
`main(argv, small=True)` runs every line at a CPU-sized cut (a test
hook, not a flag).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# One core of the card's host (8 cores; lscpu names no model), the
# port's plain twins with one thread and the gather engine, measured in
# one run on the host of an NVIDIA H100 80GB HBM3, 700.00 W, torch
# 2.11.0+cu128: `python bench_torch.py --cpu-baseline --reps 20` (1.134
# scans/s) and `--pipeline --cpu-baseline --reps 16` (0.26).
BASELINE_CPU_SCANS_PER_S = 1.134
BASELINE_CPU_PIPELINE_SCANS_PER_S = 0.26

WARM = 8          # frames that settle the pipeline lines before the clock
BEAMS = 1081      # beams of the simulated frames
SMALL_BEAMS = 361


def _room_scan(n, pose=(0.0, 0.0, 0.0), noise=0.01, seed=0):
    rng = np.random.default_rng(seed)
    tx, ty, th = pose
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    wa = angles + th
    dx, dy = np.cos(wa), np.sin(wa)
    t = np.full(n, np.inf)
    with np.errstate(divide="ignore"):
        for lim, comp, sgn in [(5.0, dx, 1), (-5.0, dx, -1),
                               (4.0, dy, 1), (-4.0, dy, -1)]:
            off = tx if comp is dx else ty
            tt = (lim - off) / comp
            tt = np.where((comp * sgn > 1e-9) & (tt > 0), tt, np.inf)
            t = np.minimum(t, tt)
    t = t + noise * rng.standard_normal(n)
    return np.stack([t * np.cos(angles), t * np.sin(angles)], 1).astype(np.float32)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _line(name, value, baseline, device) -> dict:
    plat = "gpu" if device.type == "cuda" else "cpu"
    return {"metric": f"{name}_{plat}", "value": round(value, 3),
            "unit": "scans/s", "vs_baseline": round(value / baseline, 2)}


# --- the registration step ------------------------------------------------

def register_config(small: bool = False, engine: str = "auto",
                    incremental: int = -1):
    """`bench.py`'s operating point: a 192 x 192 window, 3 points a
    cell, 2048 scan slots, 1024 active cells (small: 48 x 48, 256);
    `incremental` is `ndt_incremental_grid` (-1 auto, 0 the full
    rebuild, 1 the moment lattice)."""
    from ndt_slam_tpu_torch.config import SlamConfig

    cells, active = (48, 256) if small else (192, 1024)
    return SlamConfig(
        grid_cells_x=cells, grid_cells_y=cells, ndt_min_points_per_cell=3,
        max_scan_points=2048, ndt_engine=engine,
        ndt_max_active_cells=active, ndt_incremental_grid=incremental,
    )


def register_inputs(cfg, device, small: bool = False,
                    variants: int = 100) -> dict:
    """The register line's inputs on `device`: a 32768-slot local map of
    four room scans of 4321 beams (small: 4096 slots, 541 beams), a
    1081-beam scan (small: 361) in `cfg.max_scan_points` slots, zero
    previous odometry and last pose, a 1e-4 covariance, the odometry
    `odo` and `variants` copies of it shifted by up to 1 mm (`odos`)."""
    import torch

    from ndt_slam_tpu_torch.core.points import pad_points

    tgt_slots, tgt_beams, beams = ((4096, 541, 361) if small
                                   else (32768, 4321, 1081))
    device = torch.device(device)
    parts = [_room_scan(tgt_beams, pose=(0.2 * i, 0.1 * i, 0.05 * i), seed=i)
             for i in range(4)]
    put = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    odo = np.array([0.05, 0.03, 1.5], np.float32)
    shifts = np.linspace(0.0, 1e-3, variants).astype(np.float32)
    return {
        "scan": pad_points(_room_scan(beams, pose=(0.05, 0.03, 0.02), seed=9),
                           cfg.max_scan_points, device),
        "local": pad_points(np.concatenate(parts, 0), tgt_slots, device),
        "odo": put(odo), "odos": [put(odo + s) for s in shifts],
        "prev": put(np.zeros(3, np.float32)),
        "last": put(np.zeros(3, np.float32)),
        "cov": put(np.eye(3, dtype=np.float32) * 1e-4),
    }


def register_step(cfg, inp: dict):
    """fn(odo) -> FrameResult: `_registration_step` on `inp`, or on the
    grid path `cfg` resolves to for the inputs' device the incremental
    step against a lattice of the local map (built here, off the clock)
    with the scan as the newest raw scan."""
    import torch

    from ndt_slam_tpu_torch.ndt.grid import lattice_anchor, moments_abs
    from ndt_slam_tpu_torch.pipeline.frontend import (
        _registration_step, _registration_step_inc,
    )

    scan, local = inp["scan"], inp["local"]
    dev = scan.xy.device
    rest = (inp["prev"], inp["last"], inp["cov"], local.xy, local.mask)
    if not cfg.resolved_ndt_incremental_grid(dev.type):
        return lambda odo: _registration_step(cfg, scan.xy, scan.mask, odo,
                                              *rest)
    B = cfg.resolved_grid_mom_cells
    anchor = lattice_anchor(torch.zeros(2, device=dev), B, cfg.ndt_resolution)
    mom = moments_abs(local.xy, local.mask, anchor, B, B, cfg.ndt_resolution)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    return lambda odo: _registration_step_inc(
        cfg, scan.xy, scan.mask, odo, *rest, mom, anchor, scan.xy,
        scan.mask, count, True)


def bench_register(args, device, small: bool = False) -> dict:
    cfg = register_config(small, "gather" if args.cpu_baseline else "auto",
                          args.ndt_incremental_grid)
    reps = args.reps or (10 if args.quick else 100)
    inp = register_inputs(cfg, device, small, variants=reps)
    step = register_step(cfg, inp)
    step(inp["odo"])     # build the kernels, warm up
    _sync(device)
    t0 = time.perf_counter()
    for odo in inp["odos"]:
        step(odo)
    _sync(device)
    dt = time.perf_counter() - t0
    return _line("ndt_register_scans_per_s", reps / dt,
                 BASELINE_CPU_SCANS_PER_S, device)


# --- the pipeline -----------------------------------------------------------

def pipeline_config(args, small: bool = False):
    """The default config with 1024 active cells (small:
    `SlamConfig.small` with 256), the gather engine for the baseline,
    the grid path of --ndt-incremental-grid."""
    from ndt_slam_tpu_torch.config import SlamConfig

    kw = dict(ndt_engine="gather" if args.cpu_baseline else "auto",
              ndt_max_active_cells=256 if small else 1024,
              ndt_incremental_grid=args.ndt_incremental_grid)
    cfg = SlamConfig.small(**kw) if small else SlamConfig(**kw)
    if args.pipeline_depth is not None:
        cfg = cfg.replace(pipeline_depth=args.pipeline_depth)
    return cfg


def bench_pipeline(args, device, batch: int, small: bool = False) -> dict:
    """`FrontEnd.process` over simulated frames (the pipelined front end
    where the config resolves a depth above 0 on this device, drained
    inside the clock); with batch > 1, `batch` sequences in lockstep
    through `BatchFrontEnd` and the metric is their aggregate scans/s."""
    from ndt_slam_tpu_torch.io.simulate import simulate_sequence
    from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd
    from ndt_slam_tpu_torch.pipeline.batch_runner import BatchFrontEnd
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

    cfg = pipeline_config(args, small)
    n = args.reps or (32 if args.quick else 120)
    beams = SMALL_BEAMS if small else BEAMS
    if batch > 1:
        seqs = [simulate_sequence(n_frames=n + WARM, beams=beams, seed=4 + i)
                for i in range(batch)]
        bfe = BatchFrontEnd(cfg, batch, device)

        def tick(t):
            bfe.process_batch([s[t].scan_xy for s in seqs],
                              [s[t].odo_pose for s in seqs],
                              [s[t].sid for s in seqs])
        for t in range(WARM):
            tick(t)
        _sync(device)
        t0 = time.perf_counter()
        for t in range(WARM, WARM + n):
            tick(t)
        _sync(device)
        dt = time.perf_counter() - t0
        return _line(f"pipeline_batch{batch}_scans_per_s", batch * n / dt,
                     BASELINE_CPU_PIPELINE_SCANS_PER_S, device)
    frames = simulate_sequence(n_frames=n + WARM, beams=beams, seed=4)
    pipelined = (cfg.resolved_pipeline_depth(device.type) > 0
                 and not args.cpu_baseline)
    fe = PipelinedFrontEnd(cfg, device) if pipelined else FrontEnd(cfg, device)
    fe.warmup()
    for fr in frames[:WARM]:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    if pipelined:
        fe.drain()
    _sync(device)
    t0 = time.perf_counter()
    for fr in frames[WARM:]:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    if pipelined:
        fe.drain()
    _sync(device)
    dt = time.perf_counter() - t0
    if len(fe.pose_history) != n + WARM:
        raise RuntimeError(f"{len(fe.pose_history)} poses for {n + WARM} "
                           "frames")
    return _line("pipeline_scans_per_s", n / dt,
                 BASELINE_CPU_PIPELINE_SCANS_PER_S, device)


def device_chain(cfg, frames, device, warm: int = 0):
    """The sequential pipeline's per-frame chain with its carries on the
    device: `_registration_step`, then `_add_scan_and_target` under the
    steady flags of a frame inside a submap (interior pass and newest
    raw scan with remove_moving), from a state whose previous submap is
    the first four scans. Every frame's scan is resampled, padded and
    put on the device first. The registration step is the full rebuild
    whatever the config's grid path, as in `bench.py`. Returns
    ([len(frames), 24] `small()` outputs on the device, seconds of
    frames[warm:] from a synchronised start to a synchronised end, the
    last frame's target `PointBuffer`)."""
    import torch

    from ndt_slam_tpu_torch.core.points import PointBuffer, pad_points
    from ndt_slam_tpu_torch.io import native
    from ndt_slam_tpu_torch.mapping.pointcloud_map import _add_scan_and_target
    from ndt_slam_tpu_torch.pipeline.frontend import _registration_step
    from ndt_slam_tpu_torch.pre.resample import resample_points_np

    device = torch.device(device)
    resample = (native.resample_points if native.available()
                else resample_points_np)
    cap = cfg.max_scan_points
    host = [resample(fr.scan_xy, cfg.resample_space, cfg.resample_space_thre)
            for fr in frames]
    scans = [pad_points(rs, cap, device) for rs in host]
    odos = [torch.from_numpy(np.asarray(fr.odo_pose, np.float32)).to(device)
            for fr in frames]
    flags = dict(
        append_scan=False, do_interior=cfg.remove_moving,
        include_newest=cfg.remove_moving, has_prev=True,
        filtered=cfg.ndt_target_filtered, cap_sub=cfg.max_submap_points,
        cap_local=cfg.max_local_map_points, resol=cfg.diff_resol,
        thre=cfg.thre_neighbor, leaf=cfg.submap_leaf_size,
    )

    def step(state, scan, odo):
        (prev_odo, last_pose, last_cov, proc, count,
         raw_a, raw_b, prev_cloud, local) = state
        out = _registration_step(cfg, scan.xy, scan.mask, odo, prev_odo,
                                 last_pose, last_cov, local.xy, local.mask)
        gbuf = PointBuffer(out.global_xy, scan.mask)
        proc, count, target = _add_scan_and_target(
            proc, count, raw_a, raw_b, gbuf, prev_cloud, **flags)
        return (odo, out.fused_pose, out.cov, proc, count,
                raw_b, gbuf, prev_cloud, target), out

    prev_cloud = pad_points(np.concatenate([rs[:cap] for rs in host[:4]], 0),
                            cfg.max_submap_points, device)
    state = (odos[0], odos[0],
             torch.eye(3, dtype=torch.float32, device=device) * 1e-4,
             PointBuffer.empty(cfg.max_submap_points, device),
             torch.zeros((), dtype=torch.int32, device=device),
             scans[0], scans[1], prev_cloud, prev_cloud)
    rows = []
    for t in range(warm):
        state, out = step(state, scans[t], odos[t])
        rows.append(out.small())
    _sync(device)
    t0 = time.perf_counter()
    for t in range(warm, len(frames)):
        state, out = step(state, scans[t], odos[t])
        rows.append(out.small())
    _sync(device)
    return torch.stack(rows), time.perf_counter() - t0, state[-1]


def bench_pipeline_device(args, device, small: bool = False) -> dict:
    from ndt_slam_tpu_torch.io.simulate import simulate_sequence

    cfg = pipeline_config(args, small)
    n = args.reps or (32 if args.quick else 120)
    frames = simulate_sequence(n_frames=n + WARM,
                               beams=SMALL_BEAMS if small else BEAMS, seed=4)
    _, dt, _ = device_chain(cfg, frames, device, warm=WARM)
    return _line("pipeline_device_scans_per_s", n / dt,
                 BASELINE_CPU_PIPELINE_SCANS_PER_S, device)


# --- the command line -------------------------------------------------------

def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="fewer reps")
    ap.add_argument("--cpu-baseline", action="store_true",
                    help="one CPU core, the gather engine: the baseline")
    ap.add_argument("--pipeline", action="store_true",
                    help="benchmark the FULL per-frame pipeline "
                         "(FrontEnd.process) instead of the "
                         "registration step")
    ap.add_argument("--pipeline-device", action="store_true",
                    help="benchmark the sequential pipeline's DEVICE "
                         "chain (carries on the device, one final sync)")
    ap.add_argument("--batch", type=int, default=1,
                    help="with --pipeline: run N sequences in lockstep "
                         "(aggregate scans/s)")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="override cfg.pipeline_depth for --pipeline")
    ap.add_argument("--register-only", action="store_true",
                    help="only the registration-step line")
    ap.add_argument("--ndt-incremental-grid", type=int, default=-1,
                    choices=(-1, 0, 1),
                    help="grid path of the register and pipeline lines: "
                         "-1 the config's auto (the full rebuild on the "
                         "card), 0 the full rebuild, 1 the moment lattice")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain twins)")
    return ap


def main(argv=None, small: bool = False) -> int:
    args = _parser().parse_args(argv)
    import torch

    device = torch.device("cpu" if args.cpu_baseline else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; pass --device cpu to run the "
              "plain PyTorch twins", file=sys.stderr)
        return 1
    threads = torch.get_num_threads()
    if args.cpu_baseline:
        torch.set_num_threads(1)

    def emit(line):
        print(json.dumps(line), flush=True)

    try:
        if args.pipeline_device:
            emit(bench_pipeline_device(args, device, small))
        elif args.pipeline:
            emit(bench_pipeline(args, device, args.batch, small))
        else:
            emit(bench_register(args, device, small))
            if not args.register_only and not args.cpu_baseline:
                emit(bench_pipeline(args, device, 1, small))
                emit(bench_pipeline(args, device, 8, small))
                # last: the chain with its carries on the device
                emit(bench_pipeline_device(args, device, small))
    finally:
        torch.set_num_threads(threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
