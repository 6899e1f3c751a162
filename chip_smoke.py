#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ndt_slam_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device: require a CUDA device; print the card's name and power
     limit (nvidia-smi) and the torch / CUDA versions;
  2. build: compile the kernel library with nvcc and time it;
  3. kernels: each CUDA kernel against its plain PyTorch twin on the
     card, at the main path's shapes, on seeded synthetic data and on a
     real office_loop frame against its 131072-point target, the two
     window kernels also on a table that overflowed its capacity, and
     the point features they compute bit for bit against the twin's;
     the nearest-neighbour kernel bit for bit on scattered, empty and
     sliced masks and on NaN operands, and its fitness mean; wrapper
     times from CUDA events (median of 20), the kernels' own device time
     and the device operations of one wrapper call from torch.profiler
     (two, both this repository's, for every entry point), each kernel's
     bound from this run's inputs, kernel 3 again at full load with its
     operations bound, the time of an empty launch, and one library call
     beside kernel 3;
  4. main paths: `run_slam` over tests/data/office_loop.clf at the
     default capacities on the card, launch counts set to 0 before each:
     [main] the first 150 frames with the grid rebuilt in full every
     frame, [main-inc] all 500 frames against the incremental moment
     lattice; ATE against the ground truth, accept rate, launch counts,
     outputs, no window escaped the lattice; [lattice] at frames 40 and
     300 the window grid cut from the lattice against from-scratch
     builds over the same target buffer, and what each piece of the two
     grid paths costs at frame 300; [fetch] the device-to-host
     copies a frame on both paths; [escape] 30 frames with a lattice no
     wider than the window; [reference] the first 15 frames at the small
     capacities on the card and on the CPU twins, lattice on, within
     0.05 m and 0.3 deg of each other;
  5. [resume] frames 0-29 with a checkpoint after frame 14 and the run
     continued from the loaded file, and [determinism] frames 0-29
     twice, lattice on: poses bitwise equal, the loaded lattice bitwise
     equal to the saved one.
The last line is the JSON result; the kernels' JSON line and the
card's name and power limit come just before it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LOG = os.path.join(ROOT, "tests", "data", "office_loop.clf")
GT = os.path.join(ROOT, "tests", "data", "office_loop.gt")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores
OWN_KERNELS = ("window_kernel", "window_sum_kernel", "nn_kernel",
               "nn_finish_kernel", "empty_kernel")
ATE_BOUND = 0.3            # suite.json office_default
ACCEPT_BOUND = 0.95
REAL_FRAME = 40            # frame whose registration feeds the checks


def _require(ok, what):
    """Fail the smoke test (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of fn() over `reps` CUDA-event-timed calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_events(fn, calls: int = 10):
    """The device events (every kernel, copy and memset the card ran) of
    `calls` calls of fn(), from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    _require(dev, "the profiler recorded device events")
    return dev


def _profile_calls(fn, calls: int = 10):
    """(device operations, launches of this repository's kernels, their
    device microseconds, the same by kernel) of one fn() call: every
    device event counts as one device operation."""
    dev = _device_events(fn, calls)
    own = {}
    for e in dev:
        for k in OWN_KERNELS:
            if k in e.name:
                own.setdefault(k, []).append(e.time_range.elapsed_us())
    split = {k: round(sum(v) / calls, 2) for k, v in own.items()}
    return (len(dev) / calls, sum(len(v) for v in own.values()) / calls,
            sum(sum(v) for v in own.values()) / calls, split)


def _empty_launch_us():
    """(microseconds from just before one launch of an empty kernel to
    its end, by CUDA events, median of 50; its device time by the
    profiler)."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels

    dev = torch.device("cuda", 0)
    _, _, prof_us, _ = _profile_calls(lambda: kernels.empty_launch(dev), 50)
    return _time_ms(lambda: kernels.empty_launch(dev), reps=50) * 1e3, prof_us


def _f32_lanes():
    """(SMs, highest SM clock in MHz, f32 instructions a second without
    FMA: SMs x 128 lanes x that clock)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    return sms, mhz, sms * 128 * mhz * 1e6


def _bound(n_bytes: float, ops: float, ops_per_s: float = F32_FLOP_PER_S):
    """Least time for the work on this card: (ms, what bounds it)."""
    t_bytes = float(n_bytes) / HBM_BYTES_PER_S
    t_ops = float(ops) / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _synthetic_scene(rng, n_tgt: int, n_src: int):
    """Seeded walls in a 40 m x 40 m square: target points on random
    segments, a source scan of the same walls seen from a pose offset
    by a few cm and a few mrad."""
    a = rng.uniform(-20.0, 20.0, size=(80, 2))
    b = a + rng.uniform(-6.0, 6.0, size=(80, 2))

    def sample(n, noise):
        seg = rng.integers(0, 80, size=n)
        t = rng.uniform(0.0, 1.0, size=(n, 1))
        p = a[seg] + t * (b[seg] - a[seg])
        return p + noise * rng.standard_normal((n, 2))

    tgt = sample(n_tgt, 0.01)
    pose = np.array([0.04, -0.03, 0.01])
    c, s = np.cos(pose[2]), np.sin(pose[2])
    world = sample(n_src, 0.01)
    # source in the frame of `pose`: the solve should recover `pose`
    d = world - pose[:2]
    src = np.stack([c * d[:, 0] + s * d[:, 1],
                    -s * d[:, 0] + c * d[:, 1]], axis=1)
    return tgt.astype(np.float32), src.astype(np.float32)


def _check_window_kernels(name, sc, cg, d1, d2, r, err, min_matched=100):
    """sgh and score_many against their twins on one scene and table;
    returns the matched count and E."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.ndt.compact import (
        ndt_negative_score_compact, ndt_score_grad_hess_compact,
    )

    pose, src, cand = sc["pose_rad"], sc["src"], sc["cand"]
    E1, g1, H1, m1 = kernels.ndt_score_grad_hess(
        pose, src.xy, src.mask, cg, d1, d2, r)
    E0, g0, H0, m0 = ndt_score_grad_hess_compact(
        pose, src.xy, src.mask, cg, d1, d2, r)
    torch.cuda.synchronize()
    _require(float(m1) == float(m0),
             f"{name}: matched {float(m1)} != twin {float(m0)}")
    _require(float(m0) > min_matched,
             f"{name}: only {float(m0)} matched pairs")
    np.testing.assert_allclose(E1.item(), E0.item(), rtol=1e-5)
    np.testing.assert_allclose(g1.cpu().numpy(), g0.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(H1.cpu().numpy(), H0.cpu().numpy(),
                               rtol=1e-3, atol=0.05)
    err["sgh"] = max(err["sgh"], max(
        abs(E1.item() - E0.item()), abs(m1.item() - m0.item()),
        (g1 - g0).abs().max().item(), (H1 - H0).abs().max().item()))

    s1 = kernels.ndt_scores(cand, src.xy, src.mask, cg, d1, d2, r)
    s0 = torch.stack([ndt_negative_score_compact(
        p, src.xy, src.mask, cg, d1, d2, r) for p in cand])
    np.testing.assert_allclose(s1.cpu().numpy(), s0.cpu().numpy(),
                               rtol=1e-5)
    err["score_many"] = max(err["score_many"],
                            (s1 - s0).abs().max().item())
    return int(m0.item()), E0.item()


def _check_nn(name, sc, err) -> int:
    """Kernel 3 on one scene: `nn_sq_dists` equal to the twin bit for
    bit and `fitness_score` equal to the twin's mean to rtol 1e-6 (the
    sum runs in another order; the 1e12 cases exactly), on the scene's
    masks, a scattered target mask, a target view off the 16-byte grid,
    an all-masked target, an all-masked source, a one-slot empty target
    and a NaN and an infinite source. Returns the number of cases."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.ndt.fitness import (
        BIG, fitness_score_plain, nn_sq_dists as nn_plain,
    )

    src, smap, tgt = sc["src"], sc["src_map"], sc["tgt"]
    gen = torch.Generator(device=smap.device).manual_seed(5)
    scattered = tgt.mask & (torch.rand(tgt.capacity, generator=gen,
                                       device=smap.device) < 0.03)
    bad = smap.clone()
    live = torch.nonzero(src.mask)[:, 0]
    bad[live[0], 0] = float("nan")
    bad[live[-1], 1] = float("inf")
    none_t, none_s = torch.zeros_like(tgt.mask), torch.zeros_like(src.mask)
    cases = {
        "scene": (smap, src.mask, tgt.xy, tgt.mask),
        "scattered target": (smap, src.mask, tgt.xy, scattered),
        "target view": (smap, src.mask, tgt.xy[5:-6], scattered[5:-6]),
        "no target": (smap, src.mask, tgt.xy, none_t),
        "no source": (smap, none_s, tgt.xy, tgt.mask),
        "one empty slot": (smap, src.mask, tgt.xy[:1], none_t[:1]),
        "NaN and inf source": (bad, src.mask, tgt.xy, tgt.mask),
    }
    for case, args in cases.items():
        got, want = kernels.nn_sq_dists(*args), nn_plain(*args)
        fit, fit0 = kernels.fitness_score(*args), fitness_score_plain(*args)
        torch.cuda.synchronize()
        differ = int(((got.view(torch.int32) != want.view(torch.int32))
                      & ~(torch.isnan(got) & torch.isnan(want))).sum())
        _require(differ == 0, f"{name}, {case}: nn differs from the twin in "
                              f"{differ} of {got.numel()} sources")
        np.testing.assert_allclose(fit.item(), fit0.item(), rtol=1e-6,
                                   err_msg=f"{name}, {case}: fitness")
        if case in ("no target", "no source", "one empty slot"):
            _require(fit.item() == fit0.item() == float(np.float32(BIG)),
                     f"{name}, {case}: fitness is 1e12")
        if case.startswith("NaN"):
            _require(bool(torch.isnan(got[live[0]]))
                     and bool(torch.isnan(fit)), f"{name}: a NaN source "
                     f"gives a NaN distance and a NaN fitness")
        else:
            err["nn"] = max(err["nn"], (got - want).abs().max().item())
    return len(cases)


def _check_kernels(cfg, scenes):
    """Each kernel vs its twin on every scene; returns the JSON rows."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.ndt.compact import (
        compact_grid, ndt_negative_score_compact,
        ndt_score_grad_hess_compact, point_features,
    )
    from ndt_slam_tpu_torch.ndt.fitness import (
        fitness_score_plain, nn_sq_dists as nn_plain,
    )
    from ndt_slam_tpu_torch.ndt.score import gauss_constants

    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)
    r = cfg.ndt_neighborhood
    err = {"sgh": 0.0, "score_many": 0.0, "nn": 0.0}
    for name, sc in scenes.items():
        src, cg = sc["src"], sc["cg"]
        matched, E0 = _check_window_kernels(name, sc, cg, d1, d2, r, err)

        # a table that overflowed: half the valid cells are dropped
        n_valid = int(cg.valid.sum())
        small = compact_grid(sc["grid"], n_valid // 2)
        m_small, _ = _check_window_kernels(f"{name} (overflowed table)", sc,
                                           small, d1, d2, r, err,
                                           min_matched=0)
        _require(m_small < matched, f"{name}: the overflowed table matched "
                                    f"{m_small} of {matched} pairs")

        # the features the window kernels compute, bit for bit
        poses = torch.cat([sc["pose_rad"][None, :], sc["cand"]])
        got = kernels.kernel_point_features(poses, src.xy, cg)
        px, py, fx, fy, _, _ = point_features(poses, src.xy, cg)
        want = torch.stack((px, py, fx, fy), dim=-1)
        differ = int((got.view(torch.int32) != want.view(torch.int32))
                     .any(dim=-1).sum())
        _require(differ == 0, f"{name}: {differ} of {want[..., 0].numel()} "
                              f"(pose, point) features differ from the twin")

        n_cases = _check_nn(name, sc, err)
        print(f"[kernels] {name}: N={src.capacity} K={cg.capacity} "
              f"M={sc['tgt'].capacity} matched={matched} (overflowed table "
              f"K={small.capacity}: {m_small}) E={E0:.6g} "
              f"sgh/score_many agree with the twins; px, py, fx, fy of "
              f"{want[..., 0].numel()} (pose, point) pairs and nn on "
              f"{n_cases} mask and NaN cases equal the twin's bit for bit; "
              f"the fitness mean agrees to rtol 1e-6")

    sc = scenes["office_loop"]
    pose, src, cg, cand = sc["pose_rad"], sc["src"], sc["cg"], sc["cand"]
    smap, tgt = sc["src_map"], sc["tgt"]
    calls = {
        "sgh": (
            lambda: kernels.ndt_score_grad_hess(
                pose, src.xy, src.mask, cg, d1, d2, r),
            lambda: ndt_score_grad_hess_compact(
                pose, src.xy, src.mask, cg, d1, d2, r)),
        "score_many": (
            lambda: kernels.ndt_scores(cand, src.xy, src.mask, cg, d1, d2, r),
            lambda: torch.stack([ndt_negative_score_compact(
                p, src.xy, src.mask, cg, d1, d2, r) for p in cand])),
        "nn": (
            lambda: kernels.nn_sq_dists(smap, src.mask, tgt.xy, tgt.mask),
            lambda: nn_plain(smap, src.mask, tgt.xy, tgt.mask)),
    }
    fitness_calls = (
        lambda: kernels.fitness_score(smap, src.mask, tgt.xy, tgt.mask),
        lambda: fitness_score_plain(smap, src.mask, tgt.xy, tgt.mask))
    replaces = {
        "sgh": "ndt_slam_tpu/ndt/pallas_kernels.py:106",
        "score_many": "ndt_slam_tpu/ndt/pallas_kernels.py:213",
        "nn": "ndt_slam_tpu/ndt/pallas_kernels.py:303",
    }

    # Bounds from this run's inputs: each input read once, each output
    # written once, and only the work the data needs: the window cells a
    # live point looks up, the table cells that matched, the valid
    # (source, target) pairs.
    n, m = src.capacity, tgt.capacity
    n_live, m_live = int(src.mask.sum()), int(tgt.mask.sum())
    win = (2 * r + 1) ** 2
    cells, k_valid = cg.nx * cg.ny, int(cg.valid.sum())
    all_poses = torch.cat([pose[None, :], cand])
    pairs = kernels.ndt_score_grad_hess(all_poses, src.xy, src.mask, cg,
                                        d1, d2, r)[3].cpu().numpy()
    nc = cand.shape[0]

    def window_bytes(poses, matched_pairs, out_floats):
        return (n * 9 + poses * 12 + 8 + min(poses * n_live * win, cells) * 4
                + min(matched_pairs, k_valid) * 32 + out_floats * 4)

    bounds = {
        # ~20 flop of features a point, ~45 (sgh) / ~25 (score) a pair
        "sgh": _bound(window_bytes(1, pairs[0], 16),
                      n_live * 20 + pairs[0] * 45),
        "score_many": _bound(window_bytes(nc, pairs[1:].sum(), nc),
                             nc * n_live * 20 + pairs[1:].sum() * 25),
        # both masks, the live points, d2 out; 2 sub, 2 mul, add, min a
        # live pair, one f32 instruction each (the build forbids FMA)
        "nn": _bound(n + m + 8 * (n_live + m_live) + 4 * n,
                     n_live * m_live * 6, _f32_lanes()[2]),
    }

    print(f"[kernels] bounds from {n_live} live of {n} source slots, "
          f"{m_live} live of {m} target slots, {int(pairs[0])} matched "
          f"pairs at the pose and {int(pairs[1:].sum())} over the {nc} "
          f"candidates, {k_valid} valid cells")

    def cdist_min():
        d = torch.cdist(smap, tgt.xy,
                        compute_mode="donot_use_mm_for_euclid_dist")
        return torch.where(tgt.mask[None, :], d, 1.0e6).amin(dim=1) ** 2

    lib = cdist_min()
    np.testing.assert_allclose(
        lib[src.mask].cpu().numpy(),
        nn_plain(smap, src.mask, tgt.xy, tgt.mask)[src.mask].cpu().numpy(),
        rtol=1e-3, atol=1e-4)
    del lib
    library_ms = {"sgh": None, "score_many": None,
                  "nn": _time_ms(cdist_min, reps=5)}

    rows = []
    for name, (kern, plain) in calls.items():
        # plain, kernel, kernel, plain: the median of each pair
        p0 = _time_ms(plain)
        k0 = _time_ms(kern)
        k1 = _time_ms(kern)
        p1 = _time_ms(plain)
        ms, plain_ms = (k0 + k1) / 2, (p0 + p1) / 2
        ops, own, kernel_us, split = _profile_calls(kern)
        bound_ms, bound_by = bounds[name]
        lib_txt = ("none" if library_ms[name] is None
                   else f"{library_ms[name]:.4f} ms")
        print(f"[kernels] {name}: wrapper {ms:.4f} ms, its kernels alone "
              f"{kernel_us:.2f} us in {own:g} launches {split}, {ops:g} device "
              f"operations a call; bound {bound_ms * 1e3:.4f} us "
              f"({bound_by}); twin {plain_ms:.4f} ms; library call "
              f"{lib_txt} (max abs err {err[name]:.3g})")
        _require(ops == 2 and own == 2,
                 f"{name}: {ops:g} device operations a call, {own:g} of "
                 f"them this repository's kernels (2 and 2)")
        rows.append({
            "name": name, "route": "cuda",
            "source": "ndt_slam_tpu_torch/csrc/ndt_kernels.cu",
            "replaces": replaces[name], "launches": 0,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms[name], "kernel_us": kernel_us,
            "bound_us": bound_ms * 1e3, "device_ops_per_call": ops,
        })
    _nn_extra_lines(scenes["synthetic"], fitness_calls)
    return rows


def _nn_extra_lines(syn, fitness_calls):
    """The second entry point of kernel 3 at the real frame, and kernel 3
    at full load: every slot of the synthetic scene's raw scan against
    every slot of its target, with its own, operations bound."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.ndt.fitness import nn_sq_dists as nn_plain

    kern, plain = fitness_calls
    ms, plain_ms = _time_ms(kern), _time_ms(plain)
    ops, own, kernel_us, split = _profile_calls(kern)
    print(f"[kernels] nn, fitness_score: wrapper {ms:.4f} ms, its kernels "
          f"alone {kernel_us:.2f} us in {own:g} launches {split}, {ops:g} "
          f"device operations a call; twin {plain_ms:.4f} ms")
    _require(ops == 2 and own == 2,
             f"fitness_score: {ops:g} device operations a call, {own:g} of "
             f"them this repository's kernels (2 and 2)")

    scan, tgt = syn["scan"], syn["tgt"]
    n_live, m_live = int(scan.mask.sum()), int(tgt.mask.sum())
    _require(n_live == scan.capacity and m_live == tgt.capacity,
             "the synthetic scene fills every source and target slot")
    args = (scan.xy, scan.mask, tgt.xy, tgt.mask)
    got, want = kernels.nn_sq_dists(*args), nn_plain(*args)
    _require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
             "nn at full load equals the twin bit for bit")
    # 2 sub, 2 mul, 1 add, 1 min a pair, no FMA: one f32 instruction
    # each, against SMs x 128 lanes x the card's highest SM clock
    sms, mhz, lanes_per_s = _f32_lanes()
    bound_us = n_live * m_live * 6 / lanes_per_s * 1e6
    for label, fn in (("nn_sq_dists", kernels.nn_sq_dists),
                      ("fitness_score", kernels.fitness_score)):
        ms = _time_ms(lambda: fn(*args))
        ops, own, kernel_us, split = _profile_calls(lambda: fn(*args))
        print(f"[kernels] nn at full load, {label}: {n_live} x {m_live} "
              f"live pairs, wrapper {ms:.4f} ms, its kernels alone "
              f"{kernel_us:.2f} us {split}, {ops:g} device operations a "
              f"call; bound {bound_us:.2f} us (operations: 6 a pair over "
              f"{sms} SMs x 128 lanes x {mhz:g} MHz)")


def _scenes(device, cfg, frames):
    """Main-path inputs of the three kernels: a seeded synthetic scene
    and frame REAL_FRAME of office_loop against its real target."""
    import torch
    from ndt_slam_tpu_torch.core import pose2
    from ndt_slam_tpu_torch.core.points import PAD_COORD, pad_points
    from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
    from ndt_slam_tpu_torch.ndt.compact import compact_grid
    from ndt_slam_tpu_torch.ndt.grid import build_grid
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd
    from ndt_slam_tpu_torch.pre.resample import resample_points_np

    def scene(tgt, scan, pred_deg):
        grid = build_grid(tgt.xy, tgt.mask, pred_deg[:2], cfg.grid_cells_x,
                          cfg.grid_cells_y, cfg.ndt_resolution,
                          min_pts=cfg.ndt_min_points_per_cell)
        cg = compact_grid(grid, cfg.ndt_max_active_cells)
        src = voxel_filter(scan, cfg.source_leaf_size)
        pose_rad = pose2.pose_deg_to_rad(pred_deg)
        offs = torch.linspace(-0.03, 0.03, 12, device=device)[:, None]
        cand = pose_rad[None, :] + offs * torch.tensor(
            [1.0, -0.5, 0.3], device=device)
        src_map = pose2.global_points(pred_deg, src.xy)
        src_map = torch.where(src.mask[:, None], src_map, PAD_COORD)
        return dict(pose_rad=pose_rad, src=src, grid=grid, cg=cg, cand=cand,
                    src_map=src_map, tgt=tgt, scan=scan)

    rng = np.random.default_rng(0)
    tgt_np, src_np = _synthetic_scene(rng, cfg.max_local_map_points,
                                      cfg.max_scan_points)
    syn = scene(pad_points(tgt_np, cfg.max_local_map_points, device),
                pad_points(src_np, cfg.max_scan_points, device),
                torch.zeros(3, device=device))

    fe = FrontEnd(cfg, device)
    for fr in frames[:REAL_FRAME]:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
    fr = frames[REAL_FRAME]
    rs = resample_points_np(fr.scan_xy, cfg.resample_space,
                            cfg.resample_space_thre)
    odo = torch.tensor(fr.odo_pose, device=device)
    prev = torch.tensor(fe.prev_odo, device=device)
    pred = pose2.cal_pred_pose(pose2.cal_motion(odo, prev),
                               fe._last_pose_dev)
    real = scene(fe.pcmap.registration_target(),
                 pad_points(rs, cfg.max_scan_points, device), pred)
    return {"synthetic": syn, "office_loop": real}


def _run_main_path(tag, frames, gt, cfg, device):
    """One whole run through `run_slam` with the launch counts set to 0
    just before it and read just after; checks the outputs, the ATE and
    the accept rate. Returns (front end, launch counts)."""
    import torch
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        fe = run_slam(frames, cfg, device, out_dir=out)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        written = sorted(os.listdir(out))
        for f in ("poses.txt", "poses_full.txt", "map.pcd",
                  "submap_000.pcd"):
            _require(f in written and os.path.getsize(os.path.join(out, f)),
                     f"{tag}: output {f} written")
    n = len(fe.pose_history)
    _require(n == min(len(frames), cfg.end_frame),
             f"{tag}: {n} of {len(frames)} frames run")
    poses = fe.get_poses()
    _require(np.isfinite(poses).all(), f"{tag}: finite poses")
    ate = ate_rmse(poses, gt[:n])
    accept = float(np.mean([bool(m.get("successful")) for m in fe.metrics]))
    loop_s = fe.metrics[-1]["wall_s"]
    iters = np.mean([m.get("iterations", 0) for m in fe.metrics[1:]])
    split = {k: round(v / n, 3) for k, v in sorted(
        fe.timer.ms.items(), key=lambda kv: -kv[1])}
    print(f"[{tag}] {n} frames in {loop_s:.2f} s = {n / loop_s:.2f} frames/s; "
          f"incremental grid {fe.incremental_grid}, "
          f"{fe.n_grid_fallbacks} fallbacks; ATE {ate:.4f} m; accept "
          f"{accept:.4f}; mean iterations {iters:.2f}; "
          f"{len(fe.pcmap.submaps)} submaps; launches {counts}; outputs "
          f"{len(written)} files", flush=True)
    print(f"[{tag}] stage ms a frame (card timeline): {json.dumps(split)}")
    _require(ate < ATE_BOUND, f"{tag}: ATE {ate} < {ATE_BOUND} m")
    _require(accept >= ACCEPT_BOUND,
             f"{tag}: accept rate {accept} >= {ACCEPT_BOUND}")
    for name, c in counts.items():
        _require(c > 0, f"{tag}: kernel {name} launched on the main path")
    return fe, counts


def _check_lattice(cfg, frames, device, at=(40, 300)):
    """Before each frame of `at`, in a run with the lattice on: the
    window grid cut from the running lattice (plus the newest scan's
    moments, under the overflow rule) against two from-scratch builds
    over the same target buffer. Against the build keyed by absolute
    cell index (`moments_abs` of the whole target) the bar is strict:
    identical `valid`, `mean` to atol 1e-4, `inv_cov` to atol 2e-2 + rtol
    2e-3 of the cell's largest entry (entry by entry the small
    off-diagonals of a thin wall's cell, whose diagonal is 1e3-1e5, fail
    that bar on f32 summation order alone; they are counted). Against the window-relative build (`grid_moments`, what
    `build_grid` runs) a point within an ulp of a cell edge may sit in
    the neighbouring cell, so the cells that differ are counted and may
    be at most 1 % of the valid ones."""
    import torch
    from ndt_slam_tpu_torch.core import pose2
    from ndt_slam_tpu_torch.ndt import grid as G
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

    nx, ny, res = cfg.grid_cells_x, cfg.grid_cells_y, cfg.ndt_resolution
    B, min_pts = cfg.resolved_grid_mom_cells, cfg.ndt_min_points_per_cell
    fe = FrontEnd(cfg, device)
    _require(fe.incremental_grid, "[lattice] runs with the lattice on")
    for i, fr in enumerate(frames[:max(at) + 1]):
        if i in at:
            odo = torch.tensor(fr.odo_pose, device=device)
            pred = pose2.cal_pred_pose(
                pose2.cal_motion(odo, fe._prev_odo_dev), fe._last_pose_dev)
            tgt = fe.pcmap.registration_target()
            mom, anchor = fe.pcmap.mom_state()
            newest = fe.pcmap.newest_raw()
            fa = G.lattice_anchor(pred[:2], nx, res)
            rank = torch.cumsum(newest.mask.to(torch.int32), dim=0) - 1
            keep = newest.mask & (rank < cfg.max_submap_points
                                  - fe.pcmap.submaps[-1].proc_count)
            extra = G.moments_abs(newest.xy, keep, fa, nx, ny, res)
            g, ok = G.window_grid_from_lattice(
                mom, anchor, B, B, fa, nx, ny, res, extra=extra,
                min_pts=min_pts)
            _require(bool(ok), f"[lattice] frame {i}: window in range")
            m_abs = G.moments_abs(tgt.xy, tgt.mask, fa, nx, ny, res)
            strict = G._finalize_abs(tuple(m_abs[:, k] for k in range(6)),
                                     g.origin, fa, nx, ny, res, min_pts, 0.01)
            rel = G.grid_finalize(
                G.grid_moments(tgt.xy, tgt.mask, g.origin, nx, ny, res),
                g.origin, nx, ny, res, min_pts)
            _require(torch.equal(g.valid, strict.valid),
                     f"[lattice] frame {i}: valid cells identical")
            v = g.valid
            np.testing.assert_allclose(g.mean[v].cpu().numpy(),
                                       strict.mean[v].cpu().numpy(), atol=1e-4)
            # inv_cov against the cell's own scale: a thin wall's cell
            # has entries of 1e3-1e5 beside off-diagonals of a few units
            d_cov = (g.inv_cov[v] - strict.inv_cov[v]).abs().amax(dim=(1, 2))
            scale = strict.inv_cov[v].abs().amax(dim=(1, 2))
            worst = float((d_cov / (2e-2 + 2e-3 * scale)).max())
            _require(worst <= 1.0, f"[lattice] frame {i}: inv_cov within "
                     f"atol 2e-2 + rtol 2e-3 of each cell's largest entry "
                     f"(worst {worst:.3g} of that bound)")
            elementwise = int((
                (g.inv_cov[v] - strict.inv_cov[v]).abs()
                > 2e-2 + 2e-3 * strict.inv_cov[v].abs()).sum())
            both = v & rel.valid
            differ = int((v != rel.valid).sum()) + int((
                ((g.mean - rel.mean).abs().amax(dim=1) > 1e-4) & both).sum())
            n_valid = int(v.sum())
            print(f"[lattice] frame {i}: {n_valid} valid cells, "
                  f"{int(tgt.mask.sum())} target points, "
                  f"{int(mom[:, 0].sum())} in the lattice + {int(keep.sum())}"
                  f" fresh; equal to the from-scratch build by absolute "
                  f"cell (valid identical, mean max "
                  f"{(g.mean[v] - strict.mean[v]).abs().max().item():.3g}, "
                  f"inv_cov at most {worst:.3g} of atol 2e-2 + rtol 2e-3 of "
                  f"the cell's largest entry, {elementwise} of "
                  f"{4 * n_valid} entries beyond that bar taken entry by "
                  f"entry); {differ} cells differ from the window-relative "
                  f"build", flush=True)
            _require(n_valid > 20 and differ <= 0.01 * n_valid,
                     f"[lattice] frame {i}: {differ} of {n_valid} cells "
                     f"differ from the window-relative build")
            if i == max(at) and device.type == "cuda":
                _time_lattice_pieces(cfg, tgt, newest, keep, mom, anchor, fa,
                                     pred, fe.pcmap)
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
    _require(fe.n_grid_fallbacks == 0, "[lattice] no window escaped")


def _time_lattice_pieces(cfg, tgt, newest, keep, mom, anchor, fa, pred,
                         pcmap):
    """What each piece of the two grid paths costs on the card at one
    frame's state: milliseconds of a call from CUDA events (median of
    20; the host's launches included), and from the profiler the device
    operations a call and their summed device time."""
    from ndt_slam_tpu_torch.core.points import PointBuffer
    from ndt_slam_tpu_torch.mapping.pointcloud_map import _rebuild_mom
    from ndt_slam_tpu_torch.ndt import grid as G

    nx, ny, res = cfg.grid_cells_x, cfg.grid_cells_y, cfg.ndt_resolution
    B, min_pts = cfg.resolved_grid_mom_cells, cfg.ndt_min_points_per_cell
    extra = G.moments_abs(newest.xy, keep, fa, nx, ny, res)
    has_prev = len(pcmap.submaps) >= 2
    prev = (pcmap.submaps[-2].final_cloud if has_prev
            else PointBuffer.empty(1, tgt.xy.device))
    pieces = {
        "full rebuild: build_grid over the 131072-slot target":
            lambda: G.build_grid(tgt.xy, tgt.mask, pred[:2], nx, ny, res,
                                 min_pts=min_pts),
        "lattice: moments_abs of a 2048-slot scan into the window":
            lambda: G.moments_abs(newest.xy, keep, fa, nx, ny, res),
        "lattice: window_grid_from_lattice (gather + finalize)":
            lambda: G.window_grid_from_lattice(
                mom, anchor, B, B, fa, nx, ny, res, extra=extra,
                min_pts=min_pts),
        f"lattice, map stage: mom + moments_abs of a scan into {B}x{B}":
            lambda: mom + G.moments_abs(newest.xy, keep, anchor, B, B, res),
        "lattice, after a submap close: _rebuild_mom (65536 + 65536 slots)":
            lambda: _rebuild_mom(prev, pcmap.submaps[-1].proc, anchor,
                                 mom_cells=B, grid_res=res,
                                 has_prev=has_prev),
    }
    for name, fn in pieces.items():
        ms = _time_ms(fn)
        dev = _device_events(fn)
        print(f"[lattice] {name}: {ms:.4f} ms a call, {len(dev) / 10:g} "
              f"device operations, "
              f"{sum(e.time_range.elapsed_us() for e in dev) / 10:.1f} us "
              f"of device time", flush=True)


def _d2h_copies_per_frame(cfg, frames, device, warm=40, window=20):
    """Device-to-host copies a frame over `window` steady frames, from a
    torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

    fe = FrontEnd(cfg, device)
    for fr in frames[:warm]:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fr in frames[warm:warm + window]:
            fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    _require(dev, "the profiler recorded device events")
    d2h = sum("memcpy dtoh" in e.name.lower() for e in dev)
    return d2h / window, len(dev) / window, fe.n_grid_fallbacks


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.io import native
    from ndt_slam_tpu_torch.io.carmen import read_carmen_gt, read_carmen_log
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.pipeline.checkpoint import load_checkpoint
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    smi = _nvidia_smi()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path, log = kernels.build_kernels()
    kernels._load()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(lib_path, ROOT)}", flush=True)
    for line in log.splitlines():
        if "Used" in line or "Function properties" in line:
            print(f"[build] {line.strip()}")

    # 3. kernels vs twins at the main path's shapes
    cfg = SlamConfig()
    inc = cfg.replace(ndt_incremental_grid=1)
    full = cfg.replace(ndt_incremental_grid=0)
    frames = read_carmen_log(LOG)
    gt = read_carmen_gt(GT)
    _require(len(frames) == 500, "office_loop has 500 frames")
    print(f"[host] csrc/libndtslam.so: {native.status()}; the front end "
          f"resamples with the {FrontEnd(cfg, device).resampler} resampler; "
          f"ndt_incremental_grid = -1 resolves to "
          f"{cfg.resolved_ndt_incremental_grid('cuda')} on cuda", flush=True)
    rows = _check_kernels(cfg, _scenes(device, full, frames))
    event_us, device_us = _empty_launch_us()
    print(f"[launch] an empty kernel: {event_us:.2f} us from before its "
          f"launch to its end (CUDA events, median of 50), {device_us:.2f} "
          f"us of device time (profiler)", flush=True)

    # 4. the main paths at the default capacities: the full rebuild (the
    # earlier path, cut to 150 frames) and the incremental lattice
    _, counts_full = _run_main_path("main", frames,  gt,
                                    full.replace(end_frame=150), device)
    fe, counts = _run_main_path("main-inc", frames, gt, inc, device)
    _require(fe.incremental_grid and fe.n_grid_fallbacks == 0,
             "[main-inc] ran on the lattice and no window escaped it")
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["launches_full_rebuild_150_frames"] = counts_full[row["name"]]

    _check_lattice(inc, frames, device)

    # one fetch a frame on either path: the lattice path adds no
    # device-to-host copy (the solver's done-flag polls are the others)
    d2h_inc, ops_inc, esc = _d2h_copies_per_frame(inc, frames, device)
    d2h_full, ops_full, _ = _d2h_copies_per_frame(full, frames, device)
    print(f"[fetch] frames 40-59: {d2h_inc:g} device-to-host copies and "
          f"{ops_inc:g} device operations a frame on the lattice path, "
          f"{d2h_full:g} and {ops_full:g} with the full rebuild", flush=True)
    _require(esc == 0 and d2h_inc <= d2h_full,
             "the lattice path adds no device-to-host copy to the frame")

    # an escape: a lattice no wider than the window
    off30 = run_slam(frames, full.replace(end_frame=30), device).get_poses()
    fe_esc = run_slam(frames, inc.replace(end_frame=30, grid_mom_cells=192),
                      device)
    esc30 = fe_esc.get_poses()
    d_esc = float(np.hypot(esc30[:, 0] - off30[:, 0],
                           esc30[:, 1] - off30[:, 1]).max())
    print(f"[escape] 30 frames, grid_mom_cells = 192: "
          f"{fe_esc.n_grid_fallbacks} frames redone through the full "
          f"rebuild, at most {d_esc:.3g} m from the full-rebuild run",
          flush=True)
    _require(fe_esc.n_grid_fallbacks > 0 and d_esc <= 0.02,
             "escaped windows fall back to the full rebuild")

    # reference on a small input: the card against the CPU twins (which
    # tests/test_torch_lattice.py holds to the JAX package), first 15
    # frames at the small capacities, lattice on, within the f32-noise
    # bounds
    small = SlamConfig.small(end_frame=15, ndt_incremental_grid=1)
    on_card = run_slam(frames, small, device).get_poses()
    on_cpu = run_slam(frames, small, torch.device("cpu")).get_poses()
    dxy = float(np.abs(on_card[:, :2] - on_cpu[:, :2]).max())
    dth = float(np.abs((on_card[:, 2] - on_cpu[:, 2] + 180.0) % 360.0
                       - 180.0).max())
    print(f"[reference] 15 frames, small config, lattice on, card vs CPU "
          f"twins: max {dxy:.3g} m, {dth:.3g} deg", flush=True)
    _require(on_card.shape == (15, 3) and dxy <= 0.05 and dth <= 0.3,
             "card and CPU twins agree on the first 15 frames")

    # 5. determinism and resume on the lattice path: frames 0-29 twice,
    # then again with a checkpoint after frame 14 and the run continued
    # from the loaded file; bitwise equal poses
    short = inc.replace(end_frame=30)
    a = run_slam(frames, short, device).get_poses()
    b = run_slam(frames, short, device).get_poses()
    _require(a.shape == (30, 3) and a.tobytes() == b.tobytes(),
             "a rerun of frames 0-29 gives bitwise equal poses")
    print("[determinism] frames 0-29 twice, lattice on: poses bitwise equal",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        fe15 = run_slam(frames, inc.replace(end_frame=15), device,
                        checkpoint_path=ckpt)
        loaded = load_checkpoint(ckpt, device, inc.replace(end_frame=15))
        _require(loaded.cnt == 15 and loaded.pcmap._mom_valid
                 and torch.equal(loaded.pcmap._mom, fe15.pcmap._mom)
                 and torch.equal(loaded.last_cov, fe15.last_cov),
                 "the loaded lattice and covariance equal the saved bits")
        size = os.path.getsize(ckpt)
        c = run_slam(frames, short, device, checkpoint_path=ckpt,
                     resume=True, checkpoint_save=False).get_poses()
    _require(c.shape == (30, 3) and c.tobytes() == a.tobytes(),
             "a run resumed from the checkpoint of frame 14 gives the "
             "uninterrupted run's poses bit for bit")
    print(f"[resume] checkpoint after frame 14 ({size} bytes), frames 15-29 "
          f"from the loaded file: poses and lattice bitwise equal",
          flush=True)

    print(json.dumps({"kernels": rows}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
