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
     beside kernel 3; the Newton kernel against the stepwise loop of
     `solve.align` on the same CUDA inputs (office_loop from the
     predicted pose and pushed off it, the synthetic scan at full load),
     timed alone, against its bound and against the stepwise loop's wall
     time;
  4. main paths: `run_slam` over tests/data/office_loop.clf at the
     default capacities on the card, launch counts set to 0 before each:
     [main] all 500 frames with the grid rebuilt in full every frame
     (what ndt_incremental_grid = -1 runs on cuda), [main-inc] all 500
     frames against the incremental moment lattice; ATE against the
     ground truth, accept rate, launch counts,
     outputs, no window escaped the lattice; [lattice] at frames 40 and
     300 the window grid cut from the lattice against from-scratch
     builds over the same target buffer, and what each piece of the two
     grid paths costs at frame 300; [fetch] the device-to-host
     copies a frame on both paths; [escape] 30 frames with a lattice no
     wider than the window; [reference] the first 15 frames at the small
     capacities on the card and on the CPU twins, lattice on, within
     0.05 m and 0.3 deg of each other;
  5. [loop] all 500 frames with loop closure on the full rebuild
     (suite.json's office_loop), launch counts set to 0 before the run:
     ATE, accept rate, loops accepted, corrections, the rewrite's
     counts, the back end's times, frames/s beside [main]'s, the five
     largest loop-edge residuals after the last optimisation, and what
     one correction costs (device operations and ms of the solve and of
     a full map rewrite), each batched nearest-neighbour call of a full
     rewrite ([n_pad, S] a submap) bit for bit against the twin, and
     each kernel variant's launches on the run (the verify resolved a
     check late is measured in turns with the synchronous one by
     cli/profile_torch.py --loop-verify-async);
  6. [verify] the loop-closure verifier at the default config: the
     keyframes of the [main] run (every loop_keyframe_skip frames, with
     the chain model's position variance), the first check frame whose
     candidates are loop_max_candidates keyframes a loop apart, one row
     of the initial guesses pushed 0.5 m / 5 deg off; launch counts set
     to 0 before the verify and read after it; card against the CPU
     twins (accepted equal, relative pose within 0.05 m / 0.3 deg), the
     pushed row recovered; ms, launches, device operations and
     device-to-host copies a verify. Then the kernel variants it runs
     against their twins at its shapes: the window kernels' grid axis
     (4 grids, 240 poses; with one grid bit for bit against the
     single-grid call), the nearest-neighbour kernel's batch axis and
     argmin form ([4, 2048] against [4, 2048], and at full load; ties
     and NaN), each with its time, bound and library call; [pgo] the
     pose-graph solvers on the card against the CPU: the 4096-node
     drifted sweep of tests/unit/test_pose_graph.py through
     optimize_hierarchical, the 512-node sweep and [loop]'s final graph
     through optimize and optimize_pcg, with ms and device operations a
     solve;
  7. [determinism] frames 0-29 twice on each grid path, and [resume]
     frames 0-29 with a checkpoint after frame 14 and the run continued
     from the loaded file, lattice on: poses bitwise equal, the loaded
     lattice bitwise equal to the saved one; then with loops on, through
     LOOP_TAIL frames past [loop]'s first correction, twice, and resumed
     from a checkpoint taken right after that correction: poses bitwise
     equal;
  8. [batch] the lockstep batch runner (`run_slam_batch`), this slice's
     main path, at the default config and capacities, loops off, launch
     counts set to 0 just before the run and read just after: four rows
     (office_loop, killian_robot, killian_movers, a 120-frame
     simulation) to their ends, each held to its ATE bound (the
     suite.json entry of its log with loops off; a killian log, which
     suite.json runs with loops only, to the port's sequential run of it
     plus 5 cm) and an accept rate >= 0.95, with its largest pose gap to
     the sequential run; the batched fitness kernel at [4, 2048] x
     [4, 131072] against its twin and, row by row, bit for bit against
     the single call, timed beside its bound and a library call; the
     rows permuted over 100 ticks and a rerun, bit for bit; scans/s at
     B = 1, 2, 4 and 8 beside the sequential frames/s of the same
     windows; [suite] cli/eval_suite_torch.py over suite.json in its
     per-entry mode on the card: every entry within its bound, accept
     >= 0.95;
  9. [pipeline] the pipelined front end (PIPE_DEPTH frames in flight),
     each run bit for bit against its synchronous run above: all 500
     frames on the full rebuild (launch counts set to 0 just before:
     the kernels' `launches_pipeline`) with its rollbacks, frames/s
     beside [main]'s and the device-to-host copies a frame over frames
     40-59 beside the synchronous path's; all 500 on the lattice, with
     rollbacks; the 30-frame escape run; all 500 with loops on (the
     same loops and corrections as [loop], frames replayed after a
     correction; the variants' `launches_pipeline`); a checkpoint taken
     with frames in flight after frame 14 and resumed;
 10. [gather] the dense-window gather engine: 150 office_loop frames at
     the default config on the card, ATE and accept rate beside the
     compact engine's [main] over the same frames, and 15 frames at the
     small capacities, card against CPU within 0.05 m and 0.3 deg; the
     verifier with the gather engine on [verify]'s inputs, card against
     CPU (accepted equal, within 0.05 m and 0.3 deg); 100 lockstep ticks
     at B = 4 ([batch]'s rows) with the gather engine against the
     sequential gather runs of the same frames (ATE within 5 cm of the
     sequential run's, accept >= 0.95, the largest pose gap printed);
 11. [dist] the multi-rank runners on torch.distributed: (a)
     `run_slam_distributed` at world size 1 on nccl in this process,
     all 500 office_loop frames at the default config, loops off, ATE
     and accept within [main]'s bounds, its largest pose gap to [main];
     (b) two ranks sharing the card over gloo (spawned processes),
     DIST_FRAMES frames: both ranks' trajectories bitwise equal, their
     gap to [main]'s first DIST_FRAMES frames, every kernel wrapper's
     launches and the host copies gloo needs on each rank; (c) in those
     two ranks `make_sharded_verify` on [verify]'s inputs against the
     one-device verify (accepted equal) and `make_sharded_optimize` on
     [loop]'s final graph against `optimize_pcg` (5e-4 m); (d) in the same
     two ranks, at capacities where every shard holds
     live points (512 source slots, a 1024-slot target, 256 cells),
     DIST_SPLIT_FRAMES simulated frames: live points in both ranks'
     source and target shards from the second frame on (counted on the
     rank side), both ranks bitwise equal, and each held to one device's
     FrontEnd on the card: the first registration within 5e-5 m, frames
     0-9 within 5e-4 m, the later frames within 5e-4 m or, where a
     bistable frame parts them, the ATE band. Launch counts are set to 0
     just before each run and read just after;
 12. [register] cli/profile_register_torch.py in this process at its
     default operating point (REGISTER_REPS calls a row), its table
     printed: every row on the card, each kernel's wrapper launched;
 13. [entry] `__graft_entry_torch__.entry("cuda")`'s per-frame step
     against the same step on entry("cpu")'s tensors (the plain twins):
     successful and iterations equal, poses within 1e-4 m and 1e-4 rad,
     cost to rtol 1e-4, map-frame points within 2e-4 m; then
     `dryrun_multichip(2, "cuda")`: the sharded frame step, sequential
     step, PCG and verify on two ranks sharing the card, finite and
     bitwise equal;
 14. [tools] cli/eval_ate_torch.py in a fresh interpreter on [main]'s
     poses_full.txt gives [main]'s ATE to 1e-9 m, the JAX-free fixture
     generator's first 5 frames equal the committed office_loop.clf
     lines, and [main]'s map.pcd reads back through `io.pcd.load_pcd`;
 15. [bench] `bench_torch.main(["--quick"])` in this process: its four
     lines in order, named `*_gpu`, finite and above 0, each with the
     three kernels launched (the launch counts read after each line);
     then the register line on the moment lattice
     (`--ndt-incremental-grid 1`), its kernels launched; `device_chain`
     on the card against the CPU twins for 8 frames at `SlamConfig.small`
     capacities: fused poses within 1e-3 m and 0.01 deg, the last
     target's point count within 1 %; the chain's device-to-host copies
     a frame at the bench's config;
 16. [scaling] cli/bench_scaling_torch.py's workloads (verify, seqstep,
     pairs) as one rank on the card (nccl), 3 timed calls each, and
     verify as two ranks sharing the card over gloo, accepting what one
     rank accepts; candidates/s and frame steps/s printed.
Each of 11 (d), 12, 13, 15 and 16 sets the launch counts to 0 just
before its run and reads them just after; the kernels line carries
them.
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
               "nn_finish_kernel", "nn_argmin_finish_kernel", "newton_kernel",
               "fuse_kernel", "empty_kernel")
ATE_BOUND = 0.3            # suite.json office_default
ACCEPT_BOUND = 0.95
REAL_FRAME = 40            # frame whose registration feeds the checks
DETERMINISM_FRAMES = 30
LOOP_APART = 200           # frames between a [verify] frame and its keyframes
PUSH = (0.64, 5.0)         # the [verify] row pushed off: m, deg
LOOP_TAIL = 10             # frames after the first correction in the loop runs
PGO_TIMES = 2              # CUDA-event-timed solves a [pgo] row
PGO_TOL_M = 1e-3           # [pgo] card against CPU: metres, and
PGO_TOL_RAD = 1e-3         # radians, every node
PROFILE_TRIES = 3          # profiler sessions before a count is believed
SPINS = 8                  # spin kernels on each side of a profiled call
SPIN_CYCLES = 100_000      # their length: about 50 us at 1980 MHz
EDGE_S = 0.05              # host time at each end of a profiler session
BATCH_LOGS = ("office_loop", "killian_robot", "killian_movers")
BATCH_SIM = 120            # frames of the [batch] run's simulated row
BATCH_PERM = (2, 0, 3, 1)  # the rows of the permuted [batch] run
BATCH_TICKS = 100          # ticks of the permuted run and of the rerun
BATCH_ATE_SLACK = 0.05     # m over the sequential run, rows without a bound
SWEEP = (1, 2, 4, 8)       # rows of the [batch] throughput sweep
SWEEP_WARM, SWEEP_TICKS = 20, 80   # ticks before the timed window, in it
VARIANT_WRAPPERS = {"sgh_grids": "ndt_score_grad_hess_grids",
                    "score_many_grids": "ndt_scores_grids",
                    "nn_batched": "nn_sq_dists_batched",
                    "nn_argmin": "nn_argmin"}
# the rows whose [pipeline] launches are read by wrapper (the loops-on run)
PIPELINE_WRAPPERS = {**VARIANT_WRAPPERS,
                     "fitness_batched": "fitness_score_batched"}
PIPE_DEPTH = 8             # frames in flight of the [pipeline] runs
GATHER_FRAMES = 150        # office_loop frames of the [gather] run
GATHER_TICKS = 100         # lockstep ticks of the [gather] batch run
DIST_FRAMES = 50           # office_loop frames of the [dist] two-rank run
DIST_PGO_TOL_M = 5e-4      # [dist] sharded PCG against optimize_pcg, m
# [dist] (d): two ranks at capacities where every shard holds live points
# (512 source slots, a 1024-slot target, 256 cells) over simulated frames
DIST_SPLIT_FRAMES = 30
DIST_SPLIT_KW = dict(end_frame=10_000, ndt_trans_eps=1e-4,
                     ndt_max_iterations=80, ndt_max_active_cells=256,
                     max_local_map_points=1024)
DIST_REGISTER_TOL_M = 5e-5   # the first registration against one device, m
DIST_FRAMES_TOL_M = 5e-4     # every one of the first 10 frames, and after, m
REGISTER_REPS = 30           # timed calls a [register] row
ENTRY_TOL = 1e-4             # [entry] card against CPU: m, rad, cost rtol
ENTRY_XY_TOL = 2e-4          # [entry] map-frame points, m
TOOLS_ATE_TOL_M = 1e-9       # [tools] eval_ate_torch against [main]'s ATE
BENCH_LINES = ("ndt_register_scans_per_s", "pipeline_scans_per_s",
               "pipeline_batch8_scans_per_s", "pipeline_device_scans_per_s")
BENCH_CHAIN_FRAMES = 8       # [bench] device_chain, card against CPU twins
# [bench] device_chain bars, card against the CPU twins: the two part by
# 2e-5 m and 2.4e-4 deg on the H100; a target left stale or a scan
# dropped from it moves the fused poses 0.034 m and 0.33 deg on the CPU
# and the last target's point count by about 30 %
BENCH_CHAIN_M, BENCH_CHAIN_DEG, BENCH_CHAIN_COUNT = 1e-3, 0.01, 0.01
BENCH_D2H_FRAMES = 16        # [bench] chain frames profiled for copies
SCALING_REPS = 3             # [scaling] timed calls a row
SCALING_BATCH = 8            # [scaling] candidates (verify, pairs)


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


def _profile_session(fn, calls: int):
    """One torch.profiler session of `calls` calls of fn(): (the device
    events of the calls, every kernel, copy and memset the card ran;
    whether the session kept its edges; a note of what it lost).

    The profiler has dropped the device events at one edge of a session
    (19 of 20 kernels; after a large session every session lost its
    first or last 3 kernels), so the calls sit between SPINS spin kernels
    on each side, on the same stream, and EDGE_S seconds of host time at
    each end of the session. The spins are left out of what is returned;
    a session that lost every spin on one side lost its edge."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        for _ in range(SPINS):
            torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(calls):
            fn()
        for _ in range(SPINS):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spins = [e.time_range.start for e in dev if "spin_kernel" in e.name]
    inner = [e for e in dev if "spin_kernel" not in e.name]
    starts = [e.time_range.start for e in inner] or [0.0]
    lead = sum(t < min(starts) for t in spins)
    trail = sum(t > max(starts) for t in spins)
    return (inner, bool(inner) and lead > 0 and trail > 0,
            f"{lead} of {SPINS} leading and {trail} of {SPINS} trailing "
            f"spins, {len(inner)} other events seen")


def _device_events(fn, calls: int = 10, complete=None, warm: bool = True):
    """The device events of `calls` calls of fn() after one warm-up call
    (none without `warm`: fn is warm already; see `_profile_session`).
    A session that lost an edge, or whose events fail complete(events)
    (a count that comes out short only when an event was dropped), is
    made again, up to PROFILE_TRIES sessions; the last one is returned
    for the caller's own check."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        dev, ok, note = _profile_session(fn, calls)
        if ok and (complete is None or complete(dev)):
            break
        print(f"[profile] a session lost device events ({note}); made "
              f"again", flush=True)
    _require(dev, "the profiler recorded device events")
    return dev


def _profile_calls(fn, calls: int = 10, want: int | None = None):
    """(device operations, launches of this repository's kernels, their
    device microseconds, the same by kernel) of one fn() call: every
    device event counts as one device operation. `want`: the device
    operations a call should make; a session that saw fewer is made
    again."""
    complete = None if want is None else (
        lambda dev: len(dev) >= want * calls)
    dev = _device_events(fn, calls, complete)
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


def _same_bits(x, y) -> bool:
    """Tensors equal bit for bit as float32 (int32 counts and bools
    exactly), any NaN matching any NaN."""
    import torch
    x, y = x.float(), y.float()
    return bool(((x.view(torch.int32) == y.view(torch.int32))
                 | (torch.isnan(x) & torch.isnan(y))).all())


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


def _wall_ms(fn, reps: int = 20) -> float:
    """Median host milliseconds of fn() to a synchronized card."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _check_newton(cfg, scenes):
    """The Newton kernel (`solve.align` on the card) against the
    stepwise loop on the same CUDA inputs: office_loop frame REAL_FRAME
    from the predicted pose and pushed 15 cm and 1 degree off it, and the
    synthetic scene's raw scan at full load (2048 live source points).
    Every field bit for bit; against the stepwise loop on CPU copies of
    the inputs (the plain twins, which the CPU tests hold to the JAX
    package; the CUDA loop shares the kernel's pair visit), the pose
    solved as a row of a one-grid stack on both sides (CPU and CUDA
    torch sum one pose's matrix-vector product in other orders),
    iterations, converged and matched equal and the pose within 1e-4 m /
    rad, and E, the Hessian and matched at the kernel's pose within the
    kernel bars of the twins' at that pose; the kernel alone by
    the profiler (one launch, the call's only device operation), its
    bound (slambench/yardstick/roofline.newton_least_s), the wrapper by
    CUDA events and the stepwise loop's wall time. Returns the kernel's
    JSON row at the pushed office frame."""
    import torch
    from ndt_slam_tpu_torch.ndt import solve
    from ndt_slam_tpu_torch.ndt.compact import stack_grids
    from ndt_slam_tpu_torch.ndt.kernels import ndt_score_grad_hess
    from ndt_slam_tpu_torch.ndt.score import gauss_constants
    from slambench.yardstick.roofline import newton_least_s

    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)
    r = cfg.ndt_neighborhood
    kw = (cfg.ndt_max_iterations, cfg.ndt_step_size, cfg.ndt_trans_eps, r)
    real, syn = scenes["office_loop"], scenes["synthetic"]
    push = torch.tensor([0.12, -0.09, 0.0175], device=real["pose_rad"].device)
    cases = {
        "office_loop": (real["pose_rad"], real["src"], real["cg"]),
        "office_loop pushed": (real["pose_rad"] + push, real["src"],
                               real["cg"]),
        "full load": (syn["pose_rad"], syn["scan"], syn["cg"]),
    }
    row = None
    for name, (pose, src, cg) in cases.items():
        def kern():
            return solve.align(pose, src.xy, src.mask, cg, d1, d2,
                               max_iterations=kw[0], step_size=kw[1],
                               trans_eps=kw[2], radius=r)

        def stepwise():
            return solve._align_stepwise(pose, src.xy, src.mask, cg, d1, d2,
                                         *kw, None, None)
        solve.reset_stepwise_count()
        got, want = kern(), stepwise()
        cpu = (src.xy.cpu(), src.mask.cpu(),
               type(cg)(*(f.cpu() if torch.is_tensor(f) else f for f in cg)))
        one = torch.zeros(1, dtype=torch.int32)
        rows = solve.align(pose[None], src.xy, src.mask, stack_grids([cg]),
                           d1, d2, max_iterations=kw[0], step_size=kw[1],
                           trans_eps=kw[2], radius=r,
                           grid_index=one.to(pose.device))
        twin = solve._align_stepwise(pose.cpu()[None], *cpu[:2],
                                     stack_grids([cpu[2]]), d1, d2, *kw, one,
                                     None)
        E, _, H, m = ndt_score_grad_hess(got.pose_rad.cpu(), *cpu, d1, d2,
                                         r)
        torch.cuda.synchronize()
        _require(solve.stepwise_cuda_calls() == 0,
                 f"newton, {name}: align took the kernel")
        differ = [f for f in solve.NDTResult._fields
                  if not _same_bits(getattr(got, f), getattr(want, f))]
        _require(not differ, f"newton, {name}: every field bit for bit the "
                 f"stepwise loop's (not {differ})")
        for f in ("iterations", "converged", "matched"):
            _require(torch.equal(getattr(rows, f).cpu(), getattr(twin, f)),
                     f"newton, {name}: {f} equal to the CPU twin's")
        twin_gap = float((rows.pose_rad.cpu() - twin.pose_rad).abs().max())
        _require(twin_gap <= 1e-4,
                 f"newton, {name}: pose within 1e-4 of the CPU twin's")
        _require(float(got.matched) == float(m),
                 f"newton, {name}: matched at its pose the twins'")
        np.testing.assert_allclose(got.objective.item(), E.item(), rtol=1e-5)
        np.testing.assert_allclose(got.hessian.cpu().numpy(), H.numpy(),
                                   rtol=1e-3, atol=0.05)
        n_live = int(src.mask.sum())
        its, matched = int(got.iterations), float(got.matched)
        bound_ms = newton_least_s(src.capacity, n_live, matched, its,
                                  cg.nx * cg.ny, r) * 1e3
        ms, step_ms = _time_ms(kern), _wall_ms(stepwise)
        wall_ms = _wall_ms(kern)
        ops, own, kernel_us, split = _profile_calls(kern, want=1)
        _require(ops == 1 and own == 1,
                 f"newton, {name}: {ops:g} device operations a call, {own:g} "
                 f"of them this repository's kernels (1 and 1)")
        print(f"[kernels] newton, {name}: {n_live} live of {src.capacity} "
              f"source slots, {int(cg.valid.sum())} valid cells, iterations "
              f"{its}, matched {matched:g}; every field bit for bit the "
              f"stepwise loop's; pose {twin_gap:.3g} from the CPU twin's; "
              f"kernel alone {kernel_us:.2f} us in "
              f"{own:g} launch {split}, {ops:g} device operation a call; "
              f"bound {bound_ms * 1e3:.4f} us; wrapper {ms:.4f} ms (CUDA "
              f"events), {wall_ms:.4f} ms wall; stepwise loop {step_ms:.4f} "
              f"ms wall", flush=True)
        if name == "office_loop pushed":
            row = {"name": "newton", "route": "cuda",
                   "source": "ndt_slam_tpu_torch/csrc/ndt_kernels.cu",
                   "replaces": "ndt_slam_tpu/ndt/solve.py (the Newton loop)",
                   "launches": 0, "max_abs_err": 0.0,
                   "ms": ms, "plain_ms": step_ms, "bound_ms": bound_ms,
                   "bound_by": "operations", "library_ms": None,
                   "kernel_us": kernel_us, "bound_us": bound_ms * 1e3,
                   "device_ops_per_call": ops}
    return row


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


def _check_fuse(cfg, scenes):
    """The fuse kernel (`fuse.ekf.fuse_stage` on the card) against its
    twin (`fuse_stage_plain`, torch on the card with
    `torch.linalg.eigh`) on the same CUDA inputs: office_loop frame
    REAL_FRAME's Newton result from the pose pushed 15 cm and 1 degree,
    with a fixed odometry, one row and as 16 rows (the farm's R, each row
    its pose shifted); the fused pose within 1e-5 or one float32 step,
    the covariance within rtol 1e-4 / atol 1e-8, accept and the cost
    equal, the map-frame scan bit for bit `pose2.global_points` at the
    kernel's own pose; two launches bit for bit; the kernel alone by the
    profiler (one launch, the call's only device operation), the wrapper
    by CUDA events and wall, the twin's wall time and device operations.
    Returns the kernel's JSON row at one row."""
    import torch
    from ndt_slam_tpu_torch.core import pose2
    from ndt_slam_tpu_torch.fuse import ekf
    from ndt_slam_tpu_torch.ndt import solve
    from ndt_slam_tpu_torch.ndt.kernels import fitness_score
    from ndt_slam_tpu_torch.ndt.score import gauss_constants

    real = scenes["office_loop"]
    dev = real["pose_rad"].device
    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)
    push = torch.tensor([0.12, -0.09, 0.0175], device=dev)
    src = real["src"]
    res = solve.align(real["pose_rad"] + push, src.xy, src.mask, real["cg"],
                      d1, d2, max_iterations=cfg.ndt_max_iterations,
                      step_size=cfg.ndt_step_size,
                      trans_eps=cfg.ndt_trans_eps,
                      radius=cfg.ndt_neighborhood)
    est = pose2.pose_rad_to_deg(res.pose_rad)
    pred = pose2.pose_rad_to_deg(real["pose_rad"])
    src_map = torch.where(src.mask[:, None],
                          pose2.global_points(est, src.xy), 1.0e8)
    fit = fitness_score(src_map, src.mask, real["tgt"].xy, real["tgt"].mask)
    motion = torch.tensor([0.2, 0.01, 1.5], device=dev)
    one = dict(pred=pred, est=est, hessian=res.hessian,
               objective=res.objective, converged=res.converged, fit=fit,
               odo=pred + torch.tensor([0.3, -0.1, 2.0], device=dev),
               motion=motion, last=pred - motion,
               last_cov=torch.diag(torch.tensor([1e-3, 2e-3, 5e-4],
                                                device=dev)) + 1e-4,
               src_mask=src.mask, scan_xy=real["scan"].xy,
               scan_mask=real["scan"].mask)
    shift = torch.linspace(-1.0, 1.0, 16, device=dev)[:, None] * torch.tensor(
        [0.5, -0.3, 20.0], device=dev)
    rows16 = {k: v[None].expand(16, *v.shape).contiguous()
              for k, v in one.items()}
    for k in ("pred", "est", "odo", "last"):
        rows16[k] = rows16[k] + shift

    def stage(fn, o):
        return fn(cfg, o["pred"], o["est"], o["hessian"], o["objective"],
                  o["converged"], o["fit"], o["odo"], o["motion"],
                  o["last"], o["last_cov"], o["src_mask"], o["scan_xy"],
                  o["scan_mask"])
    row = None
    for name, o in (("office_loop pushed", one), ("16 rows", rows16)):
        got, want = stage(ekf.fuse_stage, o), stage(ekf.fuse_stage_plain, o)
        again = stage(ekf.fuse_stage, o)
        torch.cuda.synchronize()
        _require(all(_same_bits(a, b) for a, b in zip(got, again)),
                 f"fuse, {name}: two launches bit for bit")
        _require(torch.equal(got[3], want[3]) and torch.equal(got[0], want[0]),
                 f"fuse, {name}: accept and the cost the twin's")
        bar = torch.clamp(torch.finfo(torch.float32).eps * want[1].abs(),
                          min=1e-5)
        d_pose = float(((got[1] - want[1]).abs() - bar).max())
        _require(d_pose <= 0, f"fuse, {name}: the fused pose within 1e-5 or "
                 f"one float32 step of the twin's ({d_pose:.3g} over)")
        np.testing.assert_allclose(got[2].cpu().numpy(),
                                   want[2].cpu().numpy(), rtol=1e-4,
                                   atol=1e-8)
        at_own = pose2.global_points(got[1], o["scan_xy"])
        m = o["scan_mask"]
        _require(_same_bits(got[4][m], at_own[m])
                 and bool((got[4][~m] == 1.0e8).all()),
                 f"fuse, {name}: the map-frame scan bit for bit "
                 f"global_points at the kernel's pose")
        d_cov = float((got[2] - want[2]).abs().max())

        def kern():
            return stage(ekf.fuse_stage, o)

        def plain():
            return stage(ekf.fuse_stage_plain, o)
        ms, wall_ms, plain_ms = _time_ms(kern), _wall_ms(kern), _wall_ms(plain)
        ops, own, kernel_us, split = _profile_calls(kern, want=1)
        plain_ops, _, _, _ = _profile_calls(plain)
        _require(ops == 1 and own == 1,
                 f"fuse, {name}: {ops:g} device operations a call, {own:g} "
                 f"of them this repository's kernels (1 and 1)")
        print(f"[kernels] fuse, {name}: accept {got[3].tolist()}; fused "
              f"pose {float((got[1] - want[1]).abs().max()):.3g} and "
              f"covariance {d_cov:.3g} from the twin's; kernel alone "
              f"{kernel_us:.2f} us in {own:g} launch {split}, {ops:g} device "
              f"operation a call; wrapper {ms:.4f} ms (CUDA events), "
              f"{wall_ms:.4f} ms wall; twin {plain_ms:.4f} ms wall, "
              f"{plain_ops:g} device operations a call", flush=True)
        if row is None:
            row = {"name": "fuse", "route": "cuda",
                   "source": "ndt_slam_tpu_torch/csrc/ndt_kernels.cu",
                   "replaces": "ndt_slam_tpu/fuse/ekf.py (gate_and_fuse, "
                               "XLA) and the tail of _register_with_grid",
                   "launches": 0, "max_abs_err": d_cov, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": None, "bound_by": None,
                   "library_ms": None, "kernel_us": kernel_us,
                   "bound_us": None, "device_ops_per_call": ops}
    return row


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
        ops, own, kernel_us, split = _profile_calls(kern, want=2)
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
    rows.append(_check_newton(cfg, scenes))
    rows.append(_check_fuse(cfg, scenes))
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
    ops, own, kernel_us, split = _profile_calls(kern, want=2)
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


def _run_main_path(tag, frames, gt, cfg, device, keep=None):
    """One whole run through `run_slam` with the launch counts set to 0
    just before it and read just after; checks the outputs, the ATE and
    the accept rate; copies poses_full.txt and map.pcd into `keep` when
    given. Returns (front end, launch counts)."""
    import shutil

    import torch
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.ndt import kernels, solve
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    kernels.reset_launch_counts()
    solve.reset_stepwise_count()
    with tempfile.TemporaryDirectory() as out:
        fe = run_slam(frames, cfg, device, out_dir=out)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        written = sorted(os.listdir(out))
        for f in ("poses.txt", "poses_full.txt", "map.pcd",
                  "submap_000.pcd"):
            _require(f in written and os.path.getsize(os.path.join(out, f)),
                     f"{tag}: output {f} written")
        if keep is not None:
            for f in ("poses_full.txt", "map.pcd"):
                shutil.copy(os.path.join(out, f), os.path.join(keep, f))
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
    # one Newton and one fuse launch a registration (every frame but the
    # first), the stepwise loop and kernels 1 and 2 not at all
    _require(counts["newton"] >= n - 1 and counts["nn"] > 0
             and counts["sgh"] == counts["score_many"] == 0
             and solve.stepwise_cuda_calls() == 0,
             f"{tag}: the Newton kernel solves every registration")
    _require(counts["fuse"] == counts["newton"],
             f"{tag}: the fuse kernel fuses every registration")
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
    """(device-to-host copies and device operations a frame over the
    `window` steady frames after `warm`, from a torch.profiler trace; the
    windows escaped). With a pipeline depth the front end is the
    pipelined one, drained before the window and at its last frame, so
    that the window holds the fetches of its own frames. A session that
    lost an edge is made again on a front end run anew to the same
    frame."""
    import torch
    from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

    pipelined = cfg.resolved_pipeline_depth("cuda") > 0
    for _ in range(PROFILE_TRIES):
        fe = (PipelinedFrontEnd(cfg, device) if pipelined
              else FrontEnd(cfg, device))
        for fr in frames[:warm]:
            fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
        if pipelined:
            fe.drain()
        torch.cuda.synchronize()
        upcoming = iter(frames[warm:warm + window])
        last = frames[warm + window - 1].stamp

        def step():
            fr = next(upcoming)
            fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
            if pipelined and fr.stamp == last:
                fe.drain()

        dev, ok, note = _profile_session(step, window)
        if ok:
            break
        print(f"[profile] a session lost device events ({note}); made "
              f"again", flush=True)
    _require(dev, "the profiler recorded device events")
    d2h = sum("memcpy dtoh" in e.name.lower() for e in dev)
    return d2h / window, len(dev) / window, fe.n_grid_fallbacks


def _verify_inputs(cfg, frames, gt, fe, device):
    """The [verify] batch from the [main] run, as the JAX back end forms
    it: a keyframe every loop_keyframe_skip frames with the cumulative
    position variance, candidates every loop_check_skip frames with the
    drift-aware radius. Of the check frames whose candidates are
    loop_max_candidates keyframes at least LOOP_APART frames old, the
    one nearest to its first candidate (the revisit with the most
    overlap); without one, the frame with the most candidates, the rest
    masked rows. The initial guesses are the fused trajectory's relative
    poses (`guess`), but row 0's. Row 0 is the first candidate the
    verifier accepts from those guesses, and its guess the verifier's
    answer there pushed by PUSH: PUSH[0] metres across its keyframe's
    scan (along the least spread of its points: across a corridor, where
    a scan match sees a shift, and along one it may not) and PUSH[1]
    degrees. Measured from that answer, the push does not add to the
    trajectory's drift, which moves with every rounding upstream."""
    import torch
    from ndt_slam_tpu_torch.core import pose2
    from ndt_slam_tpu_torch.core.points import PAD_COORD, pad_points
    from ndt_slam_tpu_torch.graph import (
        KeyframeStore, relative_pose_deg, verify_candidates,
    )
    from ndt_slam_tpu_torch.graph.backend import pos_var

    def scan(i):
        rs = fe._resample(frames[i].scan_xy, cfg.resample_space,
                          cfg.resample_space_thre)
        return pad_points(rs, cfg.max_scan_points, device)

    store = KeyframeStore(cfg)
    cum, loops, most = 0.0, [], (None, [])
    for i, pose in enumerate(fe.pose_history):
        cum += pos_var(fe.cov_history[i])
        if i % max(1, cfg.loop_keyframe_skip) == 0:
            store.add(i, pose, scan(i), pos_var=cum)
        if i % max(1, cfg.loop_check_skip) == 0:
            cand = store.candidates(pose, i,
                                    max_candidates=cfg.loop_max_candidates,
                                    cur_pos_var=cum)
            if len(cand) == cfg.loop_max_candidates and \
                    min(i - store.sids[k] for k in cand) >= LOOP_APART:
                near = store.poses_deg[cand[0]][:2] - pose[:2]
                loops.append((float(np.hypot(*near)), i, cand))
            if len(cand) > len(most[1]):
                most = (i, cand)
    cur, cand = min(loops)[1:] if loops else most
    _require(cur is not None, "[verify] office_loop offers a candidate")
    b = cfg.loop_max_candidates
    src = scan(cur)
    pad = (torch.full_like(src.xy, PAD_COORD), torch.zeros_like(src.mask))
    tgt_xy = torch.stack([store.scan_xy[k] for k in cand]
                         + [pad[0]] * (b - len(cand)))
    tgt_mask = torch.stack([store.scan_mask[k] for k in cand]
                           + [pad[1]] * (b - len(cand)))
    cur_pose = torch.from_numpy(fe.pose_history[cur])
    rel = torch.zeros((b, 3))
    rel_gt = torch.zeros((b, 3))
    for r, k in enumerate(cand):
        rel[r] = relative_pose_deg(torch.from_numpy(store.poses_deg[k]),
                                   cur_pose)
        rel_gt[r] = relative_pose_deg(torch.from_numpy(gt[store.sids[k]]),
                                      torch.from_numpy(gt[cur]))
    guess = pose2.pose_deg_to_rad(rel).to(device)
    answer = verify_candidates(cfg, src.xy, src.mask, tgt_xy, tgt_mask,
                               guess)
    acc = answer.accepted[:len(cand)].cpu()
    _require(bool(acc.any()), "[verify] the verifier accepts a candidate "
                              "from the fused trajectory's guesses")
    # the first accepted candidate becomes row 0
    first = int(acc.nonzero()[0])
    order = [first] + [r for r in range(b) if r != first]
    cand = [cand[r] for r in order[:len(cand)]]
    tgt_xy, tgt_mask, guess, rel_gt = (t[order] for t in (
        tgt_xy, tgt_mask, guess, rel_gt))
    init = guess.clone()
    init[0] = answer.rel_pose_rad[first]
    kf = tgt_xy[0][tgt_mask[0]].double().cpu()
    across = torch.linalg.eigh(torch.cov(kf.T))[1][:, 0]
    push = torch.tensor([PUSH[0] * float(across[0]),
                         PUSH[0] * float(across[1]), np.deg2rad(PUSH[1])],
                        device=device)
    init[0] += push
    return dict(cur=cur, sids=[store.sids[k] for k in cand], src=src,
                tgt_xy=tgt_xy, tgt_mask=tgt_mask, init=init, guess=guess,
                push=push,
                rel_gt=pose2.pose_deg_to_rad(rel_gt), n_real=len(cand),
                keyframes=len(store))


def _pose_gap(a, b):
    """(max metres, max degrees) between [B,3] rad poses."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    dxy = float(np.abs(a[:, :2] - b[:, :2]).max())
    dth = float(np.rad2deg(np.abs((a[:, 2] - b[:, 2] + np.pi) % (2 * np.pi)
                                  - np.pi)).max())
    return dxy, dth


def _check_verify(cfg, vin, device):
    """[verify]: the verifier on the card (its launch counts set to 0
    just before the call and read just after), against the CPU twins,
    the pushed row against the unpushed guesses, and what a verify
    costs. Returns the wrapper launch counts of the one verify."""
    import torch
    from ndt_slam_tpu_torch.graph import pack_verify_out, verify_candidates
    from ndt_slam_tpu_torch.ndt import kernels

    src, tgt_xy, tgt_mask, init = (vin[k] for k in
                                   ("src", "tgt_xy", "tgt_mask", "init"))
    unpushed = init.clone()
    unpushed[0] -= vin["push"]

    def verify(guess):
        return verify_candidates(cfg, src.xy, src.mask, tgt_xy, tgt_mask,
                                 guess)

    ref = verify(unpushed)
    kernels.reset_launch_counts()
    out = verify(init)
    torch.cuda.synchronize()
    counts = kernels.wrapper_launch_counts()
    t0 = time.perf_counter()
    cpu = verify_candidates(cfg, src.xy.cpu(), src.mask.cpu(), tgt_xy.cpu(),
                            tgt_mask.cpu(), init.cpu())
    cpu_s = time.perf_counter() - t0
    acc, acc_cpu = out.accepted.cpu(), cpu.accepted
    dxy, dth = _pose_gap(out.rel_pose_rad, cpu.rel_pose_rad)
    rxy, rth = _pose_gap(out.rel_pose_rad[:1], ref.rel_pose_rad[:1])
    ok = acc.numpy().astype(bool)
    gxy, gth = (_pose_gap(out.rel_pose_rad.cpu()[ok], vin["rel_gt"][ok])
                if ok.any() else (float("nan"), float("nan")))
    real = vin["n_real"]
    ixy, ith = _pose_gap(vin["guess"].cpu()[:real], vin["rel_gt"][:real])
    print(f"[verify] frame {vin['cur']} against keyframes {vin['sids']} "
          f"({vin['n_real']} real of {cfg.loop_max_candidates} rows, "
          f"{vin['keyframes']} keyframes stored); accepted {acc.tolist()} "
          f"(CPU twins {acc_cpu.tolist()}); card vs CPU twins max {dxy:.3g} "
          f"m, {dth:.3g} deg; row 0 pushed {PUSH[0]} m across its "
          f"keyframe's scan ({vin['push'][0]:.3f} m, {vin['push'][1]:.3f} "
          f"m) and {PUSH[1]} deg from the verifier's answer: {rxy:.3g} m, "
          f"{rth:.3g} deg from the unpushed "
          f"verify; the fused trajectory's guesses within {ixy:.3g} m, "
          f"{ith:.3g} deg of the ground truth's relative poses, the "
          f"accepted rows within {gxy:.3g} m, {gth:.3g} deg; cost "
          f"{out.cost.cpu().numpy().round(5).tolist()}, "
          f"overlap {out.overlap.cpu().numpy().round(4).tolist()}, "
          f"target overlap {out.overlap_tgt.cpu().numpy().round(4).tolist()}"
          f"; the CPU twins took {cpu_s:.2f} s", flush=True)
    _require(torch.equal(acc, acc_cpu), "[verify] accepted equal on the "
                                         "card and the CPU twins")
    _require(dxy <= 0.05 and dth <= 0.3, "[verify] relative poses within "
                                         "0.05 m and 0.3 deg of the CPU's")
    _require(bool(acc[0]) and rxy <= 0.05 and rth <= 0.3,
             "[verify] the pushed row recovered and accepted")
    _require(int(acc[vin["n_real"]:].sum()) == 0,
             "[verify] the masked rows are rejected")
    for name in ("ndt_newton", "nn_argmin", "nn_sq_dists_batched"):
        _require(counts[name] > 0, f"[verify] {name} launched")
    _require(counts["ndt_newton"] == len(cfg.loop_stage_mults),
             "[verify] one Newton launch a ladder stage")

    def fetched():
        return pack_verify_out(verify(init)).cpu()

    walls = []
    for rep in range(23):
        t0 = time.perf_counter()
        fetched()
        if rep >= 3:
            walls.append((time.perf_counter() - t0) * 1e3)
    # 5 verifies: two kernels a launching call, one for the Newton kernel
    launched = 5 * (2 * sum(counts.values()) - counts["ndt_newton"])

    def own_launches(dev):
        return sum(any(k in e.name for k in OWN_KERNELS) for e in dev)

    dev = _device_events(fetched, calls=5,
                         complete=lambda d: own_launches(d) >= launched)
    seen = own_launches(dev)
    _require(seen == launched, f"[verify] the profiler saw {seen} of the "
                               f"{launched} kernel launches of 5 verifies")
    d2h = sum("memcpy dtoh" in e.name.lower() for e in dev) / 5
    own_us = sum(e.time_range.elapsed_us() for e in dev
                 if any(k in e.name for k in OWN_KERNELS)) / 5
    all_us = sum(e.time_range.elapsed_us() for e in dev) / 5
    wall = statistics.median(walls)
    per = {k: v for k, v in counts.items() if v}
    print(f"[verify] a verify with its one fetch: {wall:.2f} ms wall "
          f"(median of 20, range {min(walls):.2f}-{max(walls):.2f}); "
          f"launching calls {per}; {len(dev) / 5:g} device operations, "
          f"{d2h:g} device-to-host copies; device time {all_us / 1e3:.3f} "
          f"ms, of it this repository's kernels {own_us / 1e3:.3f} ms "
          f"({100 * own_us / 1e3 / wall:.1f} % of the wall time)",
          flush=True)
    return counts


def _variant_rows(cfg, vin, syn):
    """The loop-closure variants against their twins at the verifier's
    shapes, timed beside their bounds and library calls; returns their
    JSON rows (launch counts filled in by the caller)."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.ndt.compact import (
        compact_grid, stack_grids, window_rows,
    )
    from ndt_slam_tpu_torch.ndt.fitness import nn_argmin, nn_sq_dists
    from ndt_slam_tpu_torch.ndt.grid import build_grid
    from ndt_slam_tpu_torch.ndt.icp import _transform
    from ndt_slam_tpu_torch.ndt.score import gauss_constants

    src, tgt_xy, tgt_mask, init = (vin[k] for k in
                                   ("src", "tgt_xy", "tgt_mask", "init"))
    device = init.device
    b, r = tgt_xy.shape[0], cfg.ndt_neighborhood
    mult, res = cfg.loop_stage_mults[0], cfg.ndt_resolution
    nxs, nys = max(16, cfg.grid_cells_x // mult), \
        max(16, cfg.grid_cells_y // mult)
    cgs = [compact_grid(build_grid(tgt_xy[k], tgt_mask[k], init[k, :2], nxs,
                                   nys, res * mult,
                                   min_pts=cfg.ndt_min_points_per_cell),
                        cfg.ndt_max_active_cells) for k in range(b)]
    gs = stack_grids(cgs)
    d1, d2 = gauss_constants(res * mult, cfg.ndt_outlier_ratio)
    # the coarse stage's rows (starts half a coarse cell apart) and their
    # 12 line-search candidates each
    h = res * mult * 0.5
    offs = torch.tensor([[0, 0, 0], [h, 0, 0], [-h, 0, 0], [0, h, 0],
                         [0, -h, 0]], device=device)[:cfg.loop_coarse_starts]
    starts = (init[:, None, :] + offs[None]).reshape(-1, 3)
    gi_rows = torch.arange(b, dtype=torch.int32,
                           device=device).repeat_interleave(offs.shape[0])
    gen = torch.Generator(device=device).manual_seed(3)
    steps = (torch.rand((starts.shape[0], 12, 3), generator=gen,
                        device=device) - 0.5) * torch.tensor(
                            [0.4, 0.4, 0.05], device=device)
    cand = (starts[:, None, :] + steps).reshape(-1, 3)
    gi_cand = gi_rows.repeat_interleave(12)
    err = {}

    # grid axis: 240 poses on 4 grids against the gather twin
    E, g, H, m = kernels.ndt_score_grad_hess_grids(cand, gi_cand, src.xy,
                                                   src.mask, gs, d1, d2, r)
    sc = kernels.ndt_scores_grids(cand, gi_cand, src.xy, src.mask, gs, d1,
                                  d2, r)
    want = window_rows(cand, gi_cand, src.xy, src.mask, gs, d1, d2, r)
    torch.cuda.synchronize()
    _require(torch.equal(m, want[:, 1]) and float(m.sum()) > 1000,
             "grid axis: matched pairs equal to the twin's")
    np.testing.assert_allclose(E.cpu().numpy(), want[:, 0].cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), want[:, 2:5].cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(H.reshape(-1, 9).cpu().numpy(),
                               want[:, 5:14].cpu().numpy(), rtol=1e-3,
                               atol=0.05)
    np.testing.assert_allclose(sc.cpu().numpy(), want[:, 0].cpu().numpy(),
                               rtol=1e-5)
    err["sgh_grids"] = max((E - want[:, 0]).abs().max().item(),
                           (g - want[:, 2:5]).abs().max().item(),
                           (H.reshape(-1, 9) - want[:, 5:14]).abs().max()
                           .item())
    err["score_many_grids"] = (sc - want[:, 0]).abs().max().item()
    # one grid: the single-grid call's bits
    zeros = torch.zeros(12, dtype=torch.int32, device=device)
    one = stack_grids(cgs[:1])
    got1 = kernels.ndt_score_grad_hess_grids(cand[:12], zeros, src.xy,
                                             src.mask, one, d1, d2, r)
    want1 = kernels.ndt_score_grad_hess(cand[:12], src.xy, src.mask, cgs[0],
                                        d1, d2, r)
    _require(all(torch.equal(x, y) for x, y in zip(got1, want1))
             and torch.equal(
                 kernels.ndt_scores_grids(cand[:12], zeros, src.xy, src.mask,
                                          one, d1, d2, r),
                 kernels.ndt_scores(cand[:12], src.xy, src.mask, cgs[0], d1,
                                    d2, r)),
             "grid axis with one grid: the single-grid call's bits")

    # batch axis and argmin form: ICP's first pass and the overlap pass
    smask = src.mask[None, :].expand(b, -1).contiguous()
    src_w = _transform(init, src.xy)
    src_map = torch.where(src.mask[:, None], src_w, 1.0e8)

    dup = tgt_xy.clone()
    half = dup.shape[1] // 2
    dup[:, half:] = dup[:, :half]
    dup_mask = tgt_mask.clone()
    dup_mask[:, half:] = dup_mask[:, :half]
    bad_src = src_w.clone()
    bad_src[1, int(torch.nonzero(src.mask)[0]), 0] = float("nan")
    bad_tgt = tgt_xy.clone()
    bad_tgt[2, int(torch.nonzero(tgt_mask[2])[3]), 1] = float("nan")
    full = (syn["scan"].xy[None], syn["scan"].mask[None],
            syn["tgt"].xy[None], syn["tgt"].mask[None])
    cases = {
        "ICP pass": (src_w, smask, tgt_xy, tgt_mask),
        "overlap pass": (tgt_xy, tgt_mask, src_map, smask),
        "ties (targets duplicated)": (src_w, smask, dup, dup_mask),
        "NaN source": (bad_src, smask, tgt_xy, tgt_mask),
        "NaN target": (src_w, smask, bad_tgt, tgt_mask),
        "full load": full,
    }
    err["nn_argmin"] = err["nn_batched"] = 0.0
    for case, args in cases.items():
        d, idx = kernels.nn_argmin(*args)
        dist = kernels.nn_sq_dists_batched(*args)
        d0, idx0 = nn_argmin(*args)
        torch.cuda.synchronize()
        _require(_same_bits(d, d0) and _same_bits(dist, d0)
                 and torch.equal(idx, idx0),
                 f"nn argmin, {case}: distance bit for bit and index equal "
                 f"to the twin's")
        for k in range(args[0].shape[0]):
            _require(_same_bits(dist[k], nn_sq_dists(*(a[k] for a in args))),
                     f"nn batched, {case}: row {k} is the single call's")
        fin = torch.isfinite(d0)
        err["nn_argmin"] = max(err["nn_argmin"],
                               (d - d0)[fin].abs().max().item())
        err["nn_batched"] = max(err["nn_batched"],
                                (dist - d0)[fin].abs().max().item())
    print(f"[variants] grid axis: {cand.shape[0]} poses on {b} grids "
          f"{nxs}x{nys} at {res * mult} m, matched {int(m.sum())} pairs "
          f"equal to the twin's, E/grad/H at the parity bar, one grid bit "
          f"for bit; nn batched and argmin on {len(cases)} cases "
          f"({', '.join(cases)}): distances bit for bit, indices equal",
          flush=True)

    # times and bounds at the verifier's shapes
    n = src.capacity
    n_live = int(src.mask.sum())
    m_live = tgt_mask.sum(dim=1).cpu().numpy().astype(float)
    cells = nxs * nys
    k_valid = sum(int(cg.valid.sum()) for cg in cgs)
    rows_pairs = float(kernels.ndt_score_grad_hess_grids(
        starts, gi_rows, src.xy, src.mask, gs, d1, d2, r)[3].sum())
    cand_pairs = float(m.sum())
    lanes = _f32_lanes()[2]

    def window_bytes(poses, pairs, out_floats):
        return (n * 9 + poses * 16 + b * 8 + min(poses * n_live * 9,
                                                 b * cells) * 4
                + min(pairs, k_valid) * 32 + out_floats * 4)

    def nn_bytes(out_bytes):
        return (b * 2 * n + 8 * (b * n_live + m_live.sum())
                + out_bytes * b * n)

    pair_count = n_live * m_live.sum()
    bounds = {
        "sgh_grids": _bound(window_bytes(starts.shape[0], rows_pairs,
                                         16 * starts.shape[0]),
                            starts.shape[0] * n_live * 20 + rows_pairs * 45),
        "score_many_grids": _bound(window_bytes(cand.shape[0], cand_pairs,
                                                cand.shape[0]),
                                   cand.shape[0] * n_live * 20
                                   + cand_pairs * 25),
        # 2 sub, 2 mul, 1 add a pair, then 1 compare (batched) or 3
        # (argmin: less, equal, index), no FMA
        "nn_batched": _bound(nn_bytes(4), pair_count * 6, lanes),
        "nn_argmin": _bound(nn_bytes(8), pair_count * 8, lanes),
    }

    def cdist_argmin():
        d = torch.cdist(src_w, tgt_xy,
                        compute_mode="donot_use_mm_for_euclid_dist")
        return torch.where(tgt_mask[:, None, :], d, 1.0e6).argmin(dim=-1)

    def cdist_min():
        d = torch.cdist(tgt_xy, src_map,
                        compute_mode="donot_use_mm_for_euclid_dist")
        return torch.where(smask[:, None, :], d, 1.0e6).amin(dim=-1) ** 2

    icp, ovl = cases["ICP pass"], cases["overlap pass"]
    # the library calls compute the same functions (up to their rounding)
    lib_idx = cdist_argmin()[..., None].expand(-1, -1, 2)
    lib_d2 = ((src_w - tgt_xy.gather(1, lib_idx)) ** 2).sum(dim=-1)
    np.testing.assert_allclose(lib_d2[smask].cpu().numpy(),
                               nn_argmin(*icp)[0][smask].cpu().numpy(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(cdist_min()[tgt_mask].cpu().numpy(),
                               nn_sq_dists(*ovl)[tgt_mask].cpu().numpy(),
                               rtol=1e-3, atol=1e-4)
    calls = {
        "sgh_grids": (
            lambda: kernels.ndt_score_grad_hess_grids(
                starts, gi_rows, src.xy, src.mask, gs, d1, d2, r),
            lambda: window_rows(starts, gi_rows, src.xy, src.mask, gs, d1,
                                d2, r),
            None, "sgh", "ndt_slam_tpu/ndt/pallas_kernels.py:106",
            "ndt_slam_tpu/graph/loop_closure.py:84-106 (vmap of align)"),
        "score_many_grids": (
            lambda: kernels.ndt_scores_grids(cand, gi_cand, src.xy, src.mask,
                                             gs, d1, d2, r),
            lambda: window_rows(cand, gi_cand, src.xy, src.mask, gs, d1, d2,
                                r, derivs=False),
            None, "score_many", "ndt_slam_tpu/ndt/pallas_kernels.py:213",
            "ndt_slam_tpu/graph/loop_closure.py:84-106 (vmap of align)"),
        "nn_batched": (
            lambda: kernels.nn_sq_dists_batched(*ovl),
            lambda: nn_sq_dists(*ovl), cdist_min, "nn",
            "ndt_slam_tpu/ndt/pallas_kernels.py:303",
            "ndt_slam_tpu/graph/loop_closure.py:126-134 (vmap of "
            "nn_sq_dists)"),
        "nn_argmin": (
            lambda: kernels.nn_argmin(*icp), lambda: nn_argmin(*icp),
            cdist_argmin, "nn", "ndt_slam_tpu/ndt/pallas_kernels.py:303",
            "ndt_slam_tpu/ndt/icp.py:43-86 (_nn, XLA)"),
    }
    rows = []
    for name, (kern, plain, lib, parent, replaces, variant_of) in \
            calls.items():
        p0 = _time_ms(plain)
        k0 = _time_ms(kern)
        k1 = _time_ms(kern)
        p1 = _time_ms(plain)
        ms, plain_ms = (k0 + k1) / 2, (p0 + p1) / 2
        library_ms = None if lib is None else _time_ms(lib, reps=10)
        ops, own, kernel_us, split = _profile_calls(kern, want=2)
        bound_ms, bound_by = bounds[name]
        lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"[variants] {name} (of {parent}): wrapper {ms:.4f} ms, its "
              f"kernels alone {kernel_us:.2f} us in {own:g} launches "
              f"{split}, {ops:g} device operations a call; bound "
              f"{bound_ms * 1e3:.4f} us ({bound_by}); twin {plain_ms:.4f} "
              f"ms; library call {lib_txt} (max abs err {err[name]:.3g})",
              flush=True)
        _require(ops == 2 and own == 2,
                 f"{name}: {ops:g} device operations a call, {own:g} of "
                 f"them this repository's kernels (2 and 2)")
        rows.append({
            "name": name, "route": "cuda",
            "source": "ndt_slam_tpu_torch/csrc/ndt_kernels.cu",
            "replaces": replaces, "variant_of": variant_of, "launches": 0,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "kernel_us": kernel_us,
            "bound_us": bound_ms * 1e3, "device_ops_per_call": ops,
        })
    return rows


def _loop_closure_phases(vin, syn, office):
    """[variants], [verify] and [pgo] in a process of their own: in one
    process, a torch.profiler session after a large one (the frame
    loop's [fetch], a verify) has come back with device events missing,
    and these phases count device operations. The inputs go through a file;
    the child's lines are printed here. Returns the variants' rows, their
    launches those of the one verify run with the counts set to 0."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "loop_closure_inputs.pt")
        torch.save({
            **vin, "src": (vin["src"].xy, vin["src"].mask),
            "office_graph": tuple(office),
            "syn_scan": (syn["scan"].xy, syn["scan"].mask),
            "syn_tgt": (syn["tgt"].xy, syn["tgt"].mask),
        }, path)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--loop-closure",
             path], capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    _require(proc.returncode == 0 and lines,
             f"the loop-closure phases ran ({proc.returncode}): "
             f"{proc.stderr[-4000:]}")
    return json.loads(lines[-1])["variant_rows"]


def _loop_closure_child(path) -> int:
    """The child of `_loop_closure_phases`: the variants against their
    twins and timed, then the verify, on inputs saved by the parent."""
    import torch
    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.core.points import PointBuffer
    from ndt_slam_tpu_torch.ndt import kernels

    if not torch.cuda.is_available():
        return 1
    vin = torch.load(path)
    syn = {"scan": PointBuffer(*vin.pop("syn_scan")),
           "tgt": PointBuffer(*vin.pop("syn_tgt"))}
    vin["src"] = PointBuffer(*vin["src"])
    device = vin["init"].device
    cfg = SlamConfig()
    kernels._load()
    office = vin.pop("office_graph")
    t0 = time.perf_counter()
    rows = _variant_rows(cfg, vin, syn)
    t1 = time.perf_counter()
    counts = _check_verify(cfg, vin, device)
    t2 = time.perf_counter()
    pgo = _check_pgo(office)
    print(f"[time] variants {t1 - t0:.1f} s, verify {t2 - t1:.1f} s, pgo "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    for row in rows:
        row["launches"] = counts[VARIANT_WRAPPERS[row["name"]]]
    print(json.dumps({"variant_rows": rows, "pgo": pgo}))
    return 0


def _loop_edge_residuals(be, gt, top: int = 5):
    """The `top` largest loop-edge residuals at the back end's final node
    poses (translation norm, m; rotation, deg), each with the edge's
    frames, its measurement's distance from the ground truth's relative
    pose and its information's weakest / strongest eigenvalue."""
    import torch
    from ndt_slam_tpu_torch.graph.pose_graph import edge_residual

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    rows = []
    for i, j, z, om in be.loop_edges:
        r = edge_residual(t(be.node_poses_rad[i]), t(be.node_poses_rad[j]),
                          t(z)).numpy()
        si, sj = be.node_sids[i], be.node_sids[j]
        a, b = gt[si].astype(np.float64), gt[sj].astype(np.float64)
        c, s_ = np.cos(np.radians(a[2])), np.sin(np.radians(a[2]))
        d = b[:2] - a[:2]
        z_gt = np.array([c * d[0] + s_ * d[1], -s_ * d[0] + c * d[1]])
        w = np.linalg.eigvalsh(om.astype(np.float64))
        rows.append((float(np.hypot(r[0], r[1])), float(np.degrees(abs(r[2]))),
                     si, sj, float(np.hypot(*(z[:2] - z_gt))),
                     float(w[0] / max(w[-1], 1e-30))))
    rows.sort(key=lambda t: -t[0])
    return rows[:top]


def _run_loop_path(tag, frames, gt, cfg, device, fps_off):
    """[loop]: one whole run with loop closure through `run_slam`, launch
    counts set to 0 just before it and read just after; ATE, accept
    rate, loops, corrections, the rewrite's counts, the back end's times,
    frames/s beside `fps_off` (the same frames without loops, this
    process), the largest loop-edge residuals after the last
    optimisation. Returns (front end, launch counts by kernel and by
    wrapper, frames whose check ran a correction)."""
    import torch
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    kernels.reset_launch_counts()
    fe = run_slam(frames, cfg, device)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wrappers = kernels.wrapper_launch_counts()
    n = len(fe.pose_history)
    poses = fe.get_poses()
    _require(n == len(frames) and np.isfinite(poses).all(),
             f"[{tag}] {n} finite poses of {len(frames)} frames")
    ate = ate_rmse(poses, gt[:n])
    accept = float(np.mean([bool(m.get("successful")) for m in fe.metrics]))
    loop_s = fe.metrics[-1]["wall_s"]
    be = fe.backend
    closed = [i for i, m in enumerate(fe.metrics) if m.get("loop_closed")]
    split = {k: round(v / n, 3) for k, v in sorted(
        fe.timer.ms.items(), key=lambda kv: -kv[1])}
    print(f"[{tag}] {n} frames in {loop_s:.2f} s = {n / loop_s:.2f} frames/s "
          f"(without loops in this process: {fps_off:.2f}); async verify "
          f"{be.verify_async}; ATE {ate:.4f} m; accept {accept:.4f}; "
          f"loops accepted {be.loops_accepted}; corrections "
          f"{fe.n_corrections} (first at frame {closed[0] if closed else None}"
          f"); keyframes {len(be.keyframes)}; remake_stats "
          f"{fe.pcmap.remake_stats}; t_backend {fe.t_backend:.3f} s, "
          f"t_verify {be.t_verify:.3f} s, t_optimize {be.t_optimize:.3f} s, "
          f"t_remake {fe.t_remake:.3f} s; launches {counts}, by wrapper "
          f"{wrappers}", flush=True)
    print(f"[{tag}] stage ms a frame (card timeline): {json.dumps(split)}")
    res = _loop_edge_residuals(be, gt)
    print(f"[{tag}] the {len(res)} largest loop-edge residuals after the "
          f"last optimisation (m, deg, frames, measurement's distance from "
          f"the ground truth's relative pose m, information's weakest/"
          f"strongest eigenvalue): " + "; ".join(
              f"{a:.4f} m {b:.3f} deg {i}->{j} off {c:.4f} m ratio {d:.2e}"
              for a, b, i, j, c, d in res), flush=True)
    _require(ate < ATE_BOUND, f"[{tag}] ATE {ate} < {ATE_BOUND} m")
    _require(be.loops_accepted >= 1 and fe.n_corrections >= 1,
             f"[{tag}] a loop accepted and a correction run")
    # the front end's and the verify's solves are Newton launches
    _require(counts["newton"] > 0 and counts["nn"] > 0
             and counts["sgh"] == counts["score_many"] == 0,
             f"[{tag}] the solves launch the Newton kernel, fitness and the "
             f"verify kernel 3")
    _require(counts["fuse"] == n - 1,
             f"[{tag}] one fuse launch a registration ({counts['fuse']} for "
             f"{n - 1})")
    for name in ("nn_sq_dists_batched", "nn_argmin"):
        _require(wrappers[name] > 0,
                 f"[{tag}] wrapper {name} launched on the loop path")
    return fe, counts, wrappers, closed


def _rewrite_cost(fe):
    """[loop] what one correction costs on the device: device operations
    and CUDA-event ms of the dense solve of the run's final graph and of
    a full map rewrite through the run's poses (every submap rebuilt)."""
    import torch

    be, pm = fe.backend, fe.pcmap
    poses = np.stack(pm.poses)
    calls = {"optimize_all": be.optimize_all,
             "remake_maps, full": lambda: pm.remake_maps(
                 poses, thresh_trans=-1.0, thresh_rot=-1.0)}
    out = {}
    for name, fn in calls.items():
        ops = len(_device_events(fn, calls=1))
        ms = _time_ms(fn, reps=3)
        torch.cuda.synchronize()
        out[name] = (ops, ms)
    print(f"[loop] a correction's pieces on the run's final state: "
          + "; ".join(f"{k} {v[0]} device operations, {v[1]:.2f} ms"
                      for k, v in out.items())
          + f" ({len(pm.submaps)} submaps, {len(be.node_sids)} nodes, "
          f"{len(be.loop_edges)} loop edges)", flush=True)
    return out


def _check_rewrite_nn(fe):
    """[loop] kernel 3's batch axis at the map rewrite's shapes: a full
    rewrite of the run's final map through its own poses, with every
    `nn_sq_dists_batched` call it makes recorded (one a rebuilt submap:
    its interior dynamic-removal windows, [n_pad, S] points against
    [n_pad, S] candidates), then each call's output held bit for bit
    against the twin on the same card tensors. Returns the largest
    absolute difference over the finite distances."""
    import torch
    from ndt_slam_tpu_torch.mapping import dynamic
    from ndt_slam_tpu_torch.ndt.fitness import nn_sq_dists

    wrapper, calls = dynamic.nn_sq_dists_batched, []

    def record(*args):
        out = wrapper(*args)
        calls.append((args, out))
        return out

    pm = fe.pcmap
    dynamic.nn_sq_dists_batched = record
    try:
        pm.remake_maps(np.stack(pm.poses), thresh_trans=-1.0,
                       thresh_rot=-1.0)
    finally:
        dynamic.nn_sq_dists_batched = wrapper
    torch.cuda.synchronize()
    _require(len(calls) == len(pm.submaps),
             f"[loop] the rewrite ran one batched nearest-neighbour call "
             f"a submap ({len(calls)} calls, {len(pm.submaps)} submaps)")
    err, live = 0.0, 0
    for k, (args, got) in enumerate(calls):
        want = nn_sq_dists(*args)
        _require(_same_bits(got, want),
                 f"[loop] rewrite call {k} ({tuple(args[0].shape)}): "
                 f"nn_sq_dists_batched equal to the twin bit for bit")
        fin = torch.isfinite(want)
        if bool(fin.any()):
            err = max(err, (got - want)[fin].abs().max().item())
        live += int((want < 1e11).sum())
    rows = sorted({tuple(a[0].shape) for a, _ in calls})
    print(f"[loop] the rewrite's nearest-neighbour calls: {len(calls)} at "
          f"shapes {rows}, {live} source distances to a candidate, all "
          f"equal to the twin bit for bit (max abs err {err:g})",
          flush=True)
    return err


def _check_pgo(office):
    """[pgo]: the pose-graph solvers on the card against the CPU, within
    PGO_TOL_M / PGO_TOL_RAD a node: the 4096-node drifted sweep of
    tests/unit/test_pose_graph.py through optimize_hierarchical (its own
    bound: under 1 m from the truth), the 512-node sweep through optimize
    and optimize_pcg (its bound: the drift more than halved), and
    office_loop's final graph from [loop] through both (`office`: its
    PoseGraph's tensors, on the CPU). CUDA-event ms a solve, and device
    operations a solve where they are some thousands (the two PCG runs
    of the sweeps issue some 10^5)."""
    import torch
    from ndt_slam_tpu_torch.graph.pose_graph import (
        PoseGraph, optimize, optimize_hierarchical, optimize_pcg, pack_graph,
    )

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")

    def gap(a, b):
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        return (float(np.abs(d[:, :2]).max()),
                float(np.abs(np.arctan2(np.sin(d[:, 2]),
                                        np.cos(d[:, 2]))).max()))

    def row(name, solve, n, gt=None, bound=None, count=True):
        """solve(device) -> [n,3] host poses. Without `count` the device
        operations are not profiled: a profile of a solve of some 10^5
        operations takes minutes to read back."""
        t0 = time.perf_counter()
        on_cpu = solve(cpu)
        cpu_s = time.perf_counter() - t0
        on_card = solve(cuda)
        times = []
        for _ in range(PGO_TIMES):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            solve(cuda)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        ops = (len(_device_events(lambda: solve(cuda), calls=1, warm=False))
               if count else None)
        dxy, dth = gap(on_card, on_cpu)
        line = (f"[pgo] {name}: card vs CPU max {dxy:.3g} m, {dth:.3g} rad; "
                f"{ms:.2f} ms a solve on the card (CUDA events, median of "
                f"{PGO_TIMES}), "
                + (f"{ops} device operations a solve" if count
                   else "device operations not profiled")
                + f"; the CPU took {cpu_s:.2f} s")
        if gt is not None:
            err = [float(np.linalg.norm(p[:n, :2] - gt[:, :2], axis=1).max())
                   for p in (on_card, on_cpu)]
            line += (f"; max error from the truth {err[0]:.4f} m (card), "
                     f"{err[1]:.4f} m (CPU), bound {bound:.4g} m")
            _require(max(err) < bound, f"[pgo] {name} within its bound")
        print(line, flush=True)
        _require(np.isfinite(on_card).all() and dxy <= PGO_TOL_M
                 and dth <= PGO_TOL_RAD,
                 f"[pgo] {name}: card and CPU within {PGO_TOL_M} m, "
                 f"{PGO_TOL_RAD} rad")
        return {"name": name, "ms": ms, "device_ops": ops}

    rows = []
    gt, init, *edges = _sweep_fixture(4096, 256, 8)
    rows.append(row("4096-node sweep, optimize_hierarchical",
                    lambda d: optimize_hierarchical(init, *edges, device=d),
                    4096, gt, 1.0, count=False))
    gt, init, *edges = _sweep_fixture(512, 128, 4)
    drift = float(np.linalg.norm(init[:, :2] - gt[:, :2], axis=1).max())
    for name, fn in (("optimize", lambda g: optimize(g, iterations=20)),
                     ("optimize_pcg", lambda g: optimize_pcg(
                         g, iterations=20, cg_iters=1024, cg_tol=1e-4,
                         precond_seg_len=32))):
        rows.append(row(
            f"512-node sweep, {name}",
            lambda d, fn=fn: fn(pack_graph(init, *edges, d))[0]
            .cpu().numpy()[:512], 512, gt, 0.5 * drift,
            count=name == "optimize"))
        rows.append(row(
            f"office_loop's final graph ({int(office[1].sum())} nodes, "
            f"{int(office[6].sum())} edges), {name}",
            lambda d, fn=fn: fn(PoseGraph(*(t.to(d) for t in office)))[0]
            .cpu().numpy(), None))
    return rows


def _sweep_fixture(n, row_len, loop_stride, noise=0.005, seed=1):
    """tests/unit/test_pose_graph.py's boustrophedon sweep: (truth,
    drifted start, chain z, chain information, loop i, loop j, loop z,
    loop information)."""
    rng = np.random.default_rng(seed)
    pts = []
    for r in range(n // row_len):
        xs = np.arange(row_len) * 0.5
        pts += [[x, r * 2.0] for x in (xs[::-1] if r % 2 else xs)]
    pts = np.array(pts, np.float32)
    head = np.zeros(n, np.float32)
    head[:-1] = np.arctan2(np.diff(pts[:, 1]), np.diff(pts[:, 0]))
    head[-1] = head[-2]
    gt = np.concatenate([pts, head[:, None]], 1)

    def rel(a, b):
        c, s_ = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s_ * d[1], -s_ * d[0] + c * d[1],
                         np.arctan2(np.sin(b[2] - a[2]),
                                    np.cos(b[2] - a[2]))], np.float32)

    chain_z = np.stack([rel(gt[i], gt[i + 1])
                        + rng.normal(0, noise, 3).astype(np.float32)
                        for i in range(n - 1)])
    chain_om = np.tile(np.eye(3, dtype=np.float32)[None] * 400, (n - 1, 1, 1))
    li, lj, lz = [], [], []
    for r in range(n // row_len - 1):
        for c in range(0, row_len, loop_stride):
            i = r * row_len + c
            j = (r + 1) * row_len + (row_len - 1 - c if r % 2 == 0 else c)
            li.append(i)
            lj.append(j)
            lz.append(rel(gt[i], gt[j]))
    li, lj, lz = np.array(li, np.int32), np.array(lj, np.int32), np.stack(lz)
    lom = np.tile(np.eye(3, dtype=np.float32)[None] * 400, (len(li), 1, 1))
    init = np.zeros_like(gt)
    init[0] = gt[0]
    for i in range(n - 1):
        z = chain_z[i]
        c, s_ = np.cos(init[i, 2]), np.sin(init[i, 2])
        init[i + 1] = [init[i, 0] + c * z[0] - s_ * z[1],
                       init[i, 1] + s_ * z[0] + c * z[1], init[i, 2] + z[2]]
    return gt, init, chain_z, chain_om, li, lj, lz, lom


def _office_graph(be):
    """The back end's final graph, packed on the CPU as
    `GraphBackend.optimize_all` packs it for the dense solve."""
    from ndt_slam_tpu_torch.graph.pose_graph import pack_graph

    return pack_graph(np.stack(be.node_poses_rad), *be.edge_arrays(), "cpu")


def _batch_inputs():
    """[batch]'s rows: office_loop, killian_robot, killian_movers and a
    BATCH_SIM-frame simulation, with their ground truth and the ATE
    bound each is held to (see `_check_batch`)."""
    from ndt_slam_tpu_torch.io import native
    from ndt_slam_tpu_torch.io.carmen import read_carmen_gt, read_carmen_log
    from ndt_slam_tpu_torch.io.simulate import simulate_sequence

    read = native.read_carmen_log if native.available() else read_carmen_log
    data = os.path.join(ROOT, "tests", "data")
    seqs = [read(os.path.join(data, f"{n}.clf")) for n in BATCH_LOGS]
    gts = [read_carmen_gt(os.path.join(data, f"{n}.gt")) for n in BATCH_LOGS]
    sim = simulate_sequence(n_frames=BATCH_SIM)
    return ([*BATCH_LOGS, f"simulate {BATCH_SIM}"], [*seqs, sim],
            [*gts, np.asarray([f.true_pose for f in sim])])


def _trajectory_gap(a, b):
    """(max metres, max degrees) between [N,3] poses in degrees."""
    dxy = float(np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max())
    dth = float(np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0).max())
    return dxy, dth


def _check_fitness_batched(src, src_mask, tgt, tgt_mask):
    """The fitness call of the batched registration step on the card at
    [B, 2048] x [B, 131072]: against its twin (rtol 1e-6: one sum in
    another order) and each row bit for bit against `fitness_score` of
    that row alone; timed beside its bound, the twin and one library
    call. Returns its JSON row (launches filled in by the caller)."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.ndt.fitness import fitness_score_plain

    args = (src, src_mask, tgt, tgt_mask)
    got = kernels.fitness_score_batched(*args)
    want = fitness_score_plain(*args)
    rows = [kernels.fitness_score(*(a[k] for a in args))
            for k in range(src.shape[0])]
    torch.cuda.synchronize()
    for k, one in enumerate(rows):
        _require(_same_bits(got[k], one),
                 f"fitness_batched: row {k} is fitness_score of the row "
                 f"alone, bit for bit")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6)
    err = (got - want).abs().max().item()

    b, n = src_mask.shape
    m = tgt_mask.shape[1]
    n_live = src_mask.sum(dim=1).cpu().numpy().astype(float)
    m_live = tgt_mask.sum(dim=1).cpu().numpy().astype(float)
    # both masks, the live points, one mean a row out; 2 sub, 2 mul, add,
    # min a live pair (no FMA), one add a live source
    bound_ms, bound_by = _bound(
        b * (n + m) + 8 * (n_live.sum() + m_live.sum()) + 4 * b,
        6 * float((n_live * m_live).sum()) + n_live.sum(), _f32_lanes()[2])

    def library():
        d = torch.cdist(src, tgt, compute_mode="donot_use_mm_for_euclid_dist")
        d2 = torch.where(tgt_mask[:, None, :], d, 1.0e6).amin(dim=2) ** 2
        return torch.where(src_mask, d2, 0.0).sum(1) / src_mask.sum(1)

    np.testing.assert_allclose(library().cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3)
    kern = lambda: kernels.fitness_score_batched(*args)
    plain = lambda: fitness_score_plain(*args)
    p0, k0, k1, p1 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                      _time_ms(plain))
    ms, plain_ms = (k0 + k1) / 2, (p0 + p1) / 2
    library_ms = _time_ms(library, reps=3)
    ops, own, kernel_us, split = _profile_calls(kern, want=2)
    print(f"[batch] fitness_batched (of nn) at [{b}, {n}] x [{b}, {m}] "
          f"({int(n_live.sum())} and {int(m_live.sum())} live): every row "
          f"bit for bit fitness_score of the row alone, the twin within "
          f"{err:.3g}; wrapper {ms:.4f} ms, its kernels alone "
          f"{kernel_us:.2f} us in {own:g} launches {split}, {ops:g} device "
          f"operations a call; bound {bound_ms * 1e3:.4f} us ({bound_by}); "
          f"twin {plain_ms:.4f} ms; library call {library_ms:.4f} ms",
          flush=True)
    _require(ops == 2 and own == 2,
             f"fitness_batched: {ops:g} device operations a call, {own:g} "
             f"of them this repository's kernels (2 and 2)")
    return {
        "name": "fitness_batched", "route": "cuda",
        "source": "ndt_slam_tpu_torch/csrc/ndt_kernels.cu",
        "replaces": "ndt_slam_tpu/ndt/pallas_kernels.py:303",
        "variant_of": "ndt_slam_tpu/pipeline/batch_runner.py:79-97 (vmap "
                      "of _registration_step: fitness_score_pallas, "
                      "pallas_kernels.py:369)",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "kernel_us": kernel_us, "bound_us": bound_ms * 1e3,
        "device_ops_per_call": ops,
    }


def _lockstep_scans_per_s(seqs, cfg, device, rows):
    """(scans/s of a lockstep run of `rows` rows, the logs repeated, over
    ticks SWEEP_WARM .. SWEEP_WARM + SWEEP_TICKS; its stage ms a tick on
    the card's timeline over all its ticks)."""
    import torch
    from ndt_slam_tpu_torch.pipeline.batch_runner import BatchFrontEnd

    use = [seqs[k % len(seqs)] for k in range(rows)]
    bfe = BatchFrontEnd(cfg, rows, device)
    for t in range(SWEEP_WARM + SWEEP_TICKS):
        if t == SWEEP_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        bfe.process_batch([s[t].scan_xy for s in use],
                          [s[t].odo_pose for s in use], [t] * rows)
    torch.cuda.synchronize()
    rate = rows * SWEEP_TICKS / (time.perf_counter() - t0)
    bfe.timer.resolve(wait=True)
    ticks = SWEEP_WARM + SWEEP_TICKS
    return rate, {k: round(v / ticks, 3) for k, v in sorted(
        bfe.timer.ms.items(), key=lambda kv: -kv[1])}


def _sequential_scans_per_s(seqs, cfg, device):
    """Frames/s of the same windows as `_lockstep_scans_per_s`, one log
    after another through the sequential FrontEnd."""
    import torch
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

    wall = 0.0
    for s in seqs:
        fe = FrontEnd(cfg, device)
        for t in range(SWEEP_WARM + SWEEP_TICKS):
            if t == SWEEP_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            fe.process(s[t].scan_xy, s[t].odo_pose, sid=t)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    return len(seqs) * SWEEP_TICKS / wall


def _check_batch(office_seq, device):
    """[batch], this slice's main path: the lockstep batch runner at the
    default config and capacities, loops off, B = 4 rows (office_loop,
    killian_robot, killian_movers, a BATCH_SIM-frame simulation) run to
    their ends, launch counts set to 0 just before and read just after.
    Each row held to its ATE bound and an accept rate >= 0.95, with its
    largest pose gap to the sequential port run of the same log (made
    here; office_loop's is [main]'s); the batched fitness kernel against
    its twin and the single call on the run's final targets; the first
    BATCH_TICKS ticks with the rows permuted (trajectories permuted bit
    for bit) and again in order (a rerun, bit for bit); scans/s at
    B = 1, 2, 4, 8 beside the sequential frames/s of the same windows.
    Returns (fitness_batched row, launch counts by kernel, by wrapper)."""
    import torch
    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.pipeline.batch_runner import run_slam_batch
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    names, seqs, gts = _batch_inputs()
    bounds = _batch_bounds()
    cfg = SlamConfig(end_frame=10_000)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fes = run_slam_batch(seqs, cfg, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    wrappers = kernels.wrapper_launch_counts()
    total = sum(len(fe.pose_history) for fe in fes)
    print(f"[batch] {len(fes)} rows, {max(len(s) for s in seqs)} ticks, "
          f"{total} scans in {wall:.2f} s = {total / wall:.2f} scans/s; "
          f"launches {counts}; by wrapper {wrappers}", flush=True)
    for w in ("fitness_score_batched", "ndt_newton", "nn_sq_dists_batched",
              "ndt_fuse"):
        _require(wrappers[w] > 0, f"[batch]: {w} launched on the run")
    _require(wrappers["ndt_fuse"] == wrappers["ndt_newton"],
             "[batch]: one fuse launch a tick, as one Newton launch")

    for name, seq, fe, gt in zip(names, seqs, fes, gts):
        n = len(fe.pose_history)
        _require(n == len(seq), f"[batch] {name}: {n} of {len(seq)} frames")
        poses = fe.get_poses()
        _require(np.isfinite(poses).all(), f"[batch] {name}: finite poses")
        if name == "office_loop":
            ref = office_seq
        else:
            ref = run_slam(seq, cfg, device)
        ate = ate_rmse(poses, gt[:n])
        ate_seq = ate_rmse(ref.get_poses(), gt[:n])
        accept = float(np.mean([bool(m["successful"]) for m in fe.metrics]))
        gap, gap_deg = _trajectory_gap(poses, ref.get_poses())
        # a log whose suite.json entries all run loops on is held to the
        # sequential run of the same log (see `_batch_bounds`)
        bound = bounds.get(name, ate_seq + BATCH_ATE_SLACK)
        print(f"[batch] {name}: {n} frames, ATE {ate:.4f} m (bound "
              f"{bound:.4f} m; the sequential run {ate_seq:.4f} m), "
              f"accept {accept:.4f}, {len(fe.pcmap.submaps)} submaps; "
              f"largest pose gap to the sequential run {gap:.4g} m, "
              f"{gap_deg:.4g} deg", flush=True)
        _require(ate <= bound, f"[batch] {name}: ATE {ate} <= {bound} m")
        _require(accept >= ACCEPT_BOUND,
                 f"[batch] {name}: accept rate {accept} >= {ACCEPT_BOUND}")

    # the fitness call at its shapes on the run's final targets
    last = [fe.pcmap.last_scan for fe in fes]
    tgts = [fe.pcmap.registration_target() for fe in fes]
    row = _check_fitness_batched(
        torch.stack([b.xy for b in last]), torch.stack([b.mask for b in last]),
        torch.stack([b.xy for b in tgts]), torch.stack([b.mask for b in tgts]))

    # rows independent of their neighbours and position; a rerun
    head = [s[:BATCH_TICKS] for s in seqs]
    perm = run_slam_batch([head[i] for i in BATCH_PERM], cfg, device)
    again = run_slam_batch(head, cfg, device)
    for k, i in enumerate(BATCH_PERM):
        want = fes[i].get_poses()[:BATCH_TICKS].tobytes()
        _require(perm[k].get_poses().tobytes() == want,
                 f"[batch] {names[i]} in row {k} of the permuted run: its "
                 f"trajectory bit for bit")
        _require(again[i].get_poses().tobytes() == want,
                 f"[batch] {names[i]}: the rerun bit for bit")
    print(f"[batch] rows permuted {BATCH_PERM} over {BATCH_TICKS} ticks: "
          f"every trajectory bit for bit its own; a rerun bit for bit",
          flush=True)

    sweep = {b: _lockstep_scans_per_s(seqs, cfg, device, b) for b in SWEEP}
    seq_rate = _sequential_scans_per_s(seqs, cfg, device)
    print(f"[batch] sweep, ticks {SWEEP_WARM}-{SWEEP_WARM + SWEEP_TICKS} of "
          f"the logs repeated: " + ", ".join(
              f"B={b}: {r:.2f} scans/s" for b, (r, _) in sweep.items())
          + f"; sequential {seq_rate:.2f} frames/s over the same windows "
          f"({_nvidia_smi()})", flush=True)
    for b, (_, split) in sweep.items():
        print(f"[batch] B={b}: stage ms a tick (card timeline): "
              f"{json.dumps(split)}", flush=True)
    return row, counts, wrappers


def _check_suite():
    """[suite]: cli/eval_suite_torch.py over suite.json in its per-entry
    mode on the card (all six entries, loops on where the entry says):
    every entry within its expect_ate_below and accept >= 0.95."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "eval_suite_torch", os.path.join(ROOT, "cli", "eval_suite_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cwd = os.getcwd()
    os.chdir(ROOT)   # the manifest's paths are the repository's
    try:
        with tempfile.TemporaryDirectory() as out:
            rc = cli.main([os.path.join(ROOT, "suite.json"), "--out", out,
                           "--device", "cuda"])
            with open(os.path.join(out, "suite.json")) as f:
                rows = json.load(f)
    finally:
        os.chdir(cwd)
    for r in rows:
        print(f"[suite] {r['name']}: {r['frames']} frames, ATE "
              f"{r.get('ate_rmse_m')} m (bound {r.get('ate_bound_m')}), "
              f"accept {r['accept_rate']}, loops {r['loops_accepted']}, "
              f"{r['scans_per_s']} scans/s", flush=True)
        _require(r.get("ate_ok") is True,
                 f"[suite] {r['name']}: ATE within its bound")
        _require(r["accept_rate"] >= ACCEPT_BOUND,
                 f"[suite] {r['name']}: accept rate >= {ACCEPT_BOUND}")
    with open(os.path.join(ROOT, "suite.json")) as f:
        _require(rc == 0 and len(rows) == len(json.load(f)),
                 "[suite] every entry of suite.json ran and passed")


def _batch_bounds():
    """The ATE bounds of [batch]'s rows, by row name: `expect_ate_below`
    of the suite.json entry of the same log with loops off. suite.json
    runs the killian logs with loops on only, and their bound (0.25 m)
    is one that loop closure holds; without loops the JAX package's own
    runs of them land at 0.72-0.77 m (BASELINE.md:348-349, :533), so a
    killian row is held to the ATE of the port's sequential run of the
    same log plus BATCH_ATE_SLACK."""
    with open(os.path.join(ROOT, "suite.json")) as f:
        entries = json.load(f)
    bounds = {}
    for e in entries:
        if e.get("overrides", {}).get("loop_enable"):
            continue
        key = (f"simulate {e['simulate']}" if "simulate" in e
               and e.get("seed", 0) == 0 else
               os.path.splitext(os.path.basename(e.get("log", "")))[0])
        bounds.setdefault(key, e["expect_ate_below"])
    return bounds


def _check_determinism(frames, device, paths):
    """[determinism] frames 0-29 twice on each grid path: poses bitwise
    equal. Returns the poses by path."""
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    poses = {}
    for label, cfg in paths.items():
        short = cfg.replace(end_frame=DETERMINISM_FRAMES)
        a = run_slam(frames, short, device).get_poses()
        b = run_slam(frames, short, device).get_poses()
        _require(a.shape == (DETERMINISM_FRAMES, 3)
                 and a.tobytes() == b.tobytes(),
                 f"[determinism] {label}: a rerun of frames 0-29 gives "
                 f"bitwise equal poses")
        print(f"[determinism] frames 0-29 twice, {label}: poses bitwise "
              f"equal", flush=True)
        poses[label] = a
    return poses


def _check_loop_determinism(frames, device, cfg, closed):
    """[determinism] and [resume] with loops on: the frames up to
    LOOP_TAIL after the [loop] run's first correction, twice, poses
    bitwise equal and a correction in each; then the same frames from a
    checkpoint taken right after that correction, poses bitwise equal to
    the straight run and a rewrite after the resume when the [loop] run
    had a second one in reach."""
    import torch
    from ndt_slam_tpu_torch.pipeline.checkpoint import load_checkpoint
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    _require(bool(closed), "[loop] ran a correction")
    k = closed[0] + 1
    n = min(len(frames), k + LOOP_TAIL)
    short = cfg.replace(end_frame=n)
    a = run_slam(frames, short, device)
    b = run_slam(frames, short, device)
    pa, pb = a.get_poses(), b.get_poses()
    _require(pa.shape == (n, 3) and pa.tobytes() == pb.tobytes()
             and a.n_corrections == b.n_corrections >= 1,
             f"[determinism] loops on: frames 0-{n - 1} twice give bitwise "
             f"equal poses and a correction")
    print(f"[determinism] loops on, frames 0-{n - 1} twice ({a.n_corrections}"
          f" corrections, the first at frame {closed[0]}, "
          f"{a.backend.loops_accepted} loops accepted): poses bitwise equal",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        fe_k = run_slam(frames, cfg.replace(end_frame=k), device,
                        checkpoint_path=ckpt)
        loaded = load_checkpoint(ckpt, device, cfg.replace(end_frame=k))
        _require(loaded.cnt == k and fe_k.n_corrections >= 1
                 and loaded.backend.loops_accepted
                 == fe_k.backend.loops_accepted
                 and torch.equal(torch.stack(loaded.backend.keyframes.scan_xy),
                                 torch.stack(fe_k.backend.keyframes.scan_xy)),
                 "[resume] the loaded back end equals the saved one")
        size = os.path.getsize(ckpt)
        c = run_slam(frames, short, device, checkpoint_path=ckpt,
                     resume=True, checkpoint_save=False)
    pc = c.get_poses()
    _require(pc.tobytes() == pa.tobytes(),
             f"[resume] loops on: a run resumed from the checkpoint of frame "
             f"{k - 1} gives the straight run's poses bit for bit")
    print(f"[resume] loops on: checkpoint after frame {k - 1}, the first "
          f"correction ({size} bytes, {len(loaded.backend.keyframes)} "
          f"keyframes), frames {k}-{n - 1} from the loaded file "
          f"({c.n_corrections} corrections after the resume): poses bitwise "
          f"equal", flush=True)


def _same_run(a, b) -> bool:
    """Two front ends' poses and covariances bitwise equal."""
    return (a.get_poses().tobytes() == b.get_poses().tobytes()
            and np.stack(a.cov_history).tobytes()
            == np.stack(b.cov_history).tobytes())


def _frames_per_s(fe) -> float:
    return len(fe.pose_history) / fe.metrics[-1]["wall_s"]


def _check_pipeline(frames, gt, device, sync, d2h_sync):
    """[pipeline] the pipelined front end at PIPE_DEPTH frames in flight,
    each run held bit for bit to its synchronous run of this process
    (`sync`: name -> (config, front end)): all 500 frames on the full
    rebuild (what -1 runs on cuda, through `_run_main_path`, launch
    counts set to 0 just before) with its rollbacks, frames/s and the
    device-to-host copies a frame over frames 40-59 beside the
    synchronous path's `d2h_sync`; all 500 on the lattice (rollbacks on
    its submap closes); the 30-frame escape run; all 500 with loops on
    (the same loops and corrections, replays after the corrections,
    launch counts set to 0 just before); and a checkpoint taken with
    frames in flight after frame 14, resumed to frame 29, against the
    uninterrupted run. Returns (launch counts of the full-rebuild run by
    kernel, of the loops-on run by wrapper)."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd
    from ndt_slam_tpu_torch.pipeline.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    depth = dict(pipeline_depth=PIPE_DEPTH)
    full, fe_full = sync["main"]
    fe, counts = _run_main_path("pipeline", frames, gt,
                                full.replace(**depth), device)
    _require(isinstance(fe, PipelinedFrontEnd) and fe.depth == PIPE_DEPTH,
             "[pipeline] ran the pipelined front end")
    _require(_same_run(fe, fe_full),
             "[pipeline] full rebuild: poses and covariances bitwise equal "
             "to [main]'s")
    d2h, ops, _ = _d2h_copies_per_frame(full.replace(**depth), frames,
                                        device)
    print(f"[pipeline] full rebuild, depth {PIPE_DEPTH}, all "
          f"{len(fe.pose_history)} frames: poses and covariances bitwise "
          f"equal to [main]; {fe.n_rollbacks} rollbacks, {fe.n_replayed} "
          f"replayed; {_frames_per_s(fe):.2f} frames/s ([main] "
          f"{_frames_per_s(fe_full):.2f}); frames 40-59: {d2h:g} "
          f"device-to-host copies and {ops:g} device operations a frame "
          f"(depth 0: {d2h_sync:g})", flush=True)
    _require(d2h <= d2h_sync, "[pipeline] no more copies a frame than "
             "the synchronous path")

    inc, fe_inc = sync["main-inc"]
    fe_i = run_slam(frames, inc.replace(**depth), device)
    _require(fe_i.incremental_grid and _same_run(fe_i, fe_inc)
             and fe_i.n_rollbacks > 0,
             "[pipeline] lattice: bitwise equal to [main-inc], with "
             "rollbacks")
    print(f"[pipeline] lattice, all {len(fe_i.pose_history)} frames: "
          f"bitwise equal to [main-inc]; {fe_i.n_rollbacks} rollbacks, "
          f"{fe_i.n_replayed} replayed; {_frames_per_s(fe_i):.2f} frames/s "
          f"([main-inc] {_frames_per_s(fe_inc):.2f})", flush=True)

    esc, fe_esc = sync["escape"]
    fe_e = run_slam(frames, esc.replace(**depth), device)
    _require(_same_run(fe_e, fe_esc) and fe_e.n_grid_fallbacks
             == fe_esc.n_grid_fallbacks > 0,
             "[pipeline] escape: bitwise equal to the synchronous escape "
             "run, the same windows redone")
    print(f"[pipeline] escape, 30 frames: bitwise equal to [escape]; "
          f"{fe_e.n_grid_fallbacks} windows redone, {fe_e.n_rollbacks} "
          f"rollbacks, {fe_e.n_replayed} replayed", flush=True)

    loop, fe_loop = sync["loop"]
    kernels.reset_launch_counts()
    fe_l = run_slam(frames, loop.replace(**depth), device)
    torch.cuda.synchronize()
    wrappers = kernels.wrapper_launch_counts()
    be, be_s = fe_l.backend, fe_loop.backend
    _require(_same_run(fe_l, fe_loop)
             and be.loops_accepted == be_s.loops_accepted >= 1
             and fe_l.n_corrections == fe_loop.n_corrections >= 1
             and fe_l.n_replayed >= 1,
             "[pipeline] loops on: bitwise equal to [loop], the same loops "
             "and corrections, frames replayed after a correction")
    print(f"[pipeline] loops on, all {len(fe_l.pose_history)} frames: "
          f"bitwise equal to [loop]; loops accepted {be.loops_accepted}, "
          f"corrections {fe_l.n_corrections}; {fe_l.n_rollbacks} rollbacks, "
          f"{fe_l.n_replayed} replayed; {_frames_per_s(fe_l):.2f} frames/s "
          f"([loop] {_frames_per_s(fe_loop):.2f}); launches by wrapper "
          f"{wrappers}", flush=True)

    cfg = full.replace(**depth)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        fe_r = PipelinedFrontEnd(cfg, device)
        for fr in frames[:15]:
            fe_r.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
        in_flight = len(fe_r._queue)
        _require(in_flight > 0, "[pipeline] frames in flight at frame 14")
        save_checkpoint(fe_r, ckpt)
        loaded = load_checkpoint(ckpt, device, cfg)
    _require(isinstance(loaded, PipelinedFrontEnd) and loaded.cnt == 15,
             "[pipeline] the checkpoint loads into a pipelined front end")
    for fr in frames[15:DETERMINISM_FRAMES]:
        loaded.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
    loaded.finalize()
    _require(loaded.get_poses().tobytes()
             == fe_full.get_poses()[:DETERMINISM_FRAMES].tobytes(),
             "[pipeline] resumed from a checkpoint taken with frames in "
             "flight: the uninterrupted run's poses bit for bit")
    print(f"[pipeline] resume: checkpoint after frame 14 with {in_flight} "
          f"frames in flight (drained by the save), frames 15-29 from the "
          f"loaded file: poses bitwise equal to the uninterrupted run",
          flush=True)
    return counts, wrappers


def _check_gather(frames, gt, device, full, fe_full, vin):
    """[gather] the dense-window gather engine (tensor code, no kernel of
    its own): GATHER_FRAMES office_loop frames at the default config on
    the card, held to suite.json's office_default bound and the accept
    bound, with its ATE, accept rate and largest pose gap beside the
    compact engine's [main] run over the same frames; and the first 15
    frames at the small capacities, card against the CPU, within 0.05 m
    and 0.3 deg."""
    import torch
    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    n = GATHER_FRAMES
    kernels.reset_launch_counts()
    fe = run_slam(frames, full.replace(ndt_engine="gather", end_frame=n),
                  device)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    poses = fe.get_poses()
    _require(poses.shape == (n, 3) and np.isfinite(poses).all(),
             f"[gather] {n} finite poses")
    ate = ate_rmse(poses, gt[:n])
    ate_c = ate_rmse(fe_full.get_poses()[:n], gt[:n])
    acc = float(np.mean([bool(m.get("successful")) for m in fe.metrics]))
    acc_c = float(np.mean([bool(m.get("successful"))
                           for m in fe_full.metrics[:n]]))
    gap = np.hypot(*(poses[:, :2] - fe_full.get_poses()[:n, :2]).T)
    apart = int(np.argmax(gap > 0.05)) if (gap > 0.05).any() else None
    print(f"[gather] {n} frames, default config: ATE {ate:.4f} m, accept "
          f"{acc:.4f}, {_frames_per_s(fe):.2f} frames/s; the compact engine "
          f"([main]) over the same frames: ATE {ate_c:.4f} m, accept "
          f"{acc_c:.4f}; the two trajectories at most {gap.max():.4f} m "
          f"apart, first 5 cm apart at frame {apart}; launches {counts}",
          flush=True)
    _require(ate < ATE_BOUND and acc >= ACCEPT_BOUND,
             f"[gather] ATE {ate} < {ATE_BOUND} m, accept {acc} >= "
             f"{ACCEPT_BOUND}")
    _require(counts["sgh"] == counts["score_many"] == counts["newton"] == 0
             < counts["nn"],
             "[gather] the gather engine solves without the window kernels")
    small = SlamConfig.small(end_frame=15, ndt_engine="gather")
    on_card = run_slam(frames, small, device).get_poses()
    on_cpu = run_slam(frames, small, torch.device("cpu")).get_poses()
    dxy = float(np.hypot(on_card[:, 0] - on_cpu[:, 0],
                         on_card[:, 1] - on_cpu[:, 1]).max())
    dth = float(np.abs((on_card[:, 2] - on_cpu[:, 2] + 180.0) % 360.0
                       - 180.0).max())
    print(f"[gather] 15 frames, small config, card vs CPU: max {dxy:.3g} m, "
          f"{dth:.3g} deg", flush=True)
    _require(on_card.shape == (15, 3) and dxy <= 0.05 and dth <= 0.3,
             "[gather] card and CPU agree on the first 15 frames")
    _check_gather_rows(full.replace(ndt_engine="gather"), vin, device)


def _check_gather_rows(gcfg, vin, device):
    """[gather]'s row axis: the verifier with the gather engine on
    [verify]'s inputs, card against the CPU (accepted equal, relative
    poses within 0.05 m and 0.3 deg), and GATHER_TICKS lockstep ticks at
    B = 4 ([batch]'s rows) against the sequential gather runs of the
    same frames: each row's ATE within BATCH_ATE_SLACK of its sequential
    run's and its accept rate >= ACCEPT_BOUND, the largest pose gap
    printed. Launch counts set to 0 just before each and read after."""
    import torch
    from ndt_slam_tpu_torch.graph import verify_candidates
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.pipeline.batch_runner import run_slam_batch
    from ndt_slam_tpu_torch.pipeline.runner import run_slam

    args = (vin["src"].xy, vin["src"].mask, vin["tgt_xy"], vin["tgt_mask"],
            vin["init"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = verify_candidates(gcfg, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    t0 = time.perf_counter()
    cpu = verify_candidates(gcfg, *(a.cpu() for a in args))
    cpu_s = time.perf_counter() - t0
    dxy, dth = _pose_gap(out.rel_pose_rad, cpu.rel_pose_rad)
    print(f"[gather] verify with the gather engine, frame {vin['cur']} "
          f"against keyframes {vin['sids']}: accepted "
          f"{out.accepted.tolist()} (CPU {cpu.accepted.tolist()}), card vs "
          f"CPU max {dxy:.3g} m, {dth:.3g} deg; {wall * 1e3:.1f} ms on the "
          f"card, {cpu_s:.2f} s on the CPU; launches {counts}", flush=True)
    _require(torch.equal(out.accepted.cpu(), cpu.accepted)
             and dxy <= 0.05 and dth <= 0.3,
             "[gather] the gather verify agrees card and CPU")
    _require(counts["sgh"] == counts["score_many"] == counts["newton"] == 0
             < counts["nn"],
             "[gather] the gather verify runs without the window kernels")

    names, seqs, gts = _batch_inputs()
    head = [s[:GATHER_TICKS] for s in seqs]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fes = run_slam_batch(head, gcfg, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrappers = kernels.wrapper_launch_counts()
    print(f"[gather] lockstep, {len(head)} rows x {GATHER_TICKS} ticks in "
          f"{wall:.2f} s; launches by wrapper {wrappers}", flush=True)
    _require(wrappers["fitness_score_batched"] > 0
             and kernels.launch_counts()["sgh"] == 0,
             "[gather] the lockstep run solves on the gather engine and "
             "scores fitness with the batched kernel")
    for name, seq, fe, gt in zip(names, head, fes, gts):
        n = len(seq)
        ref = run_slam(seq, gcfg, device)
        poses = fe.get_poses()
        _require(poses.shape == (n, 3) and np.isfinite(poses).all(),
                 f"[gather] lockstep {name}: {n} finite poses")
        ate = ate_rmse(poses, gt[:n])
        ate_seq = ate_rmse(ref.get_poses(), gt[:n])
        accept = float(np.mean([bool(m["successful"]) for m in fe.metrics]))
        gap, gap_deg = _trajectory_gap(poses, ref.get_poses())
        print(f"[gather] lockstep {name}: ATE {ate:.4f} m (sequential "
              f"gather run {ate_seq:.4f} m), accept {accept:.4f}; largest "
              f"pose gap to the sequential run {gap:.4g} m, {gap_deg:.4g} "
              f"deg", flush=True)
        _require(ate <= ate_seq + BATCH_ATE_SLACK and accept >= ACCEPT_BOUND,
                 f"[gather] lockstep {name}: ATE {ate} <= {ate_seq} + "
                 f"{BATCH_ATE_SLACK} m, accept {accept} >= {ACCEPT_BOUND}")


def _check_dist(frames, gt, full, fe_full, vin, office, device):
    """[dist] (see the module docstring): (a) world size 1 on nccl in
    this process, (b), (c) and (d) in two spawned ranks sharing the card
    over gloo. Returns (launches of (a) by wrapper, each rank's launches
    of (b) by wrapper, each rank's launches of (d) by wrapper)."""
    import torch
    from ndt_slam_tpu_torch.graph.pose_graph import optimize_pcg
    from ndt_slam_tpu_torch.graph import verify_candidates, pack_verify_out
    from ndt_slam_tpu_torch.metrics import ate_rmse
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.parallel import dist as pdist
    from ndt_slam_tpu_torch.parallel import jobs
    from ndt_slam_tpu_torch.pipeline.dist_runner import run_slam_distributed
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

    main = fe_full.get_poses()
    # (a) one rank on nccl
    with tempfile.TemporaryDirectory() as tmp:
        rt = pdist.initialize(init_file=os.path.join(tmp, "pg"),
                              world_size=1, rank=0, backend="nccl",
                              device=device)
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            fe = run_slam_distributed(frames, full, device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts_a = kernels.launch_counts()
            wrappers_a = kernels.wrapper_launch_counts()
        finally:
            pdist.shutdown()
    poses = fe.get_poses()
    n = len(frames)
    _require(poses.shape == (n, 3) and np.isfinite(poses).all(),
             f"[dist] (a) {n} finite poses")
    ate = ate_rmse(poses, gt[:n])
    acc = float(np.mean([bool(m.get("successful")) for m in fe.metrics]))
    gap, gap_deg = _trajectory_gap(poses, main)
    print(f"[dist] (a) world size 1, backend {rt.backend}, {n} frames in "
          f"{wall:.2f} s = {n / wall:.2f} frames/s ([main] "
          f"{_frames_per_s(fe_full):.2f}): ATE {ate:.4f} m, accept "
          f"{acc:.4f}; largest pose gap to [main] {gap:.4g} m, "
          f"{gap_deg:.4g} deg; launches {counts_a} ({_nvidia_smi()})",
          flush=True)
    _require(rt.backend == "nccl", "[dist] (a) runs on nccl")
    _require(ate < ATE_BOUND and acc >= ACCEPT_BOUND,
             f"[dist] (a) ATE {ate} < {ATE_BOUND} m, accept {acc} >= "
             f"{ACCEPT_BOUND}")
    _require(counts_a["newton"] == 0
             and min(counts_a[k] for k in ("sgh", "score_many", "nn")) > 0,
             "[dist] (a) the sharded solve's stepwise loop launched kernels "
             "1-3, not the Newton kernel")

    # (b) and (c): two ranks sharing the card
    ver = {"src_xy": vin["src"].xy, "src_mask": vin["src"].mask,
           "tgt_xy": vin["tgt_xy"], "tgt_mask": vin["tgt_mask"],
           "init": vin["init"]}
    ver = {k: v.cpu().numpy() for k, v in ver.items()}
    graph = dict(zip(("poses", "node_mask", "idx_i", "idx_j", "z", "omega",
                      "edge_mask"), (t.numpy() for t in office)))
    split_cfg, split_frames = _dist_split_inputs()
    t0 = time.perf_counter()
    handle = pdist.start(jobs.run, 2, [
        ("slam", (full, frames[:DIST_FRAMES], "cuda"), {}),
        ("verify", (full, ver, "cuda"), {}),
        ("optimize", (graph, "cuda"), {}),
        ("slam_halves", (split_cfg, split_frames, "cuda"), {}),
    ], backend="gloo", device="cuda")
    try:
        # (d)'s one-device run, while the ranks start
        fe_one = FrontEnd(split_cfg, device)
        for fr in split_frames:
            fe_one.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
        ranks = handle.result()
    finally:
        handle.close()
    spawn_s = time.perf_counter() - t0
    (b0, v0, (o0, _), h0), (b1, v1, (o1, _), h1) = ranks
    m = DIST_FRAMES
    gap, gap_deg = _trajectory_gap(b0["poses"], main[:m])
    for r, b in enumerate((b0, b1)):
        print(f"[dist] (b) rank {r} of 2, gloo on one card: {m} frames in "
              f"{b['seconds']:.2f} s = {m / b['seconds']:.2f} frames/s; "
              f"launches by wrapper {b['wrappers']}; host copies "
              f"{b['copies']}", flush=True)
    print(f"[dist] (b) both ranks' trajectories bitwise equal: "
          f"{b0['poses'].tobytes() == b1['poses'].tobytes()}; largest pose "
          f"gap to [main]'s first {m} frames {gap:.4g} m, {gap_deg:.4g} deg; "
          f"the two ranks took {spawn_s:.1f} s from spawn to join",
          flush=True)
    _require(b0["poses"].shape == (m, 3) and np.isfinite(b0["poses"]).all(),
             f"[dist] (b) {m} finite poses")
    _require(b0["poses"].tobytes() == b1["poses"].tobytes()
             and b0["covs"].tobytes() == b1["covs"].tobytes(),
             "[dist] (b) both ranks' trajectories bitwise equal")
    for b in (b0, b1):
        for w in ("ndt_score_grad_hess", "ndt_scores", "nn_sq_dists"):
            _require(b["wrappers"][w] > 0, f"[dist] (b) {w} launched")

    one = pack_verify_out(verify_candidates(
        full, vin["src"].xy, vin["src"].mask, vin["tgt_xy"],
        vin["tgt_mask"], vin["init"])).cpu().numpy()
    vgap = float(np.abs(v0[:, :3] - one[:, :3]).max())
    pcg, _ = optimize_pcg(office._replace(**{
        f: getattr(office, f).to(device) for f in office._fields}))
    pcg = pcg.cpu().numpy()
    ogap = float(np.hypot(*(o0[:, :2] - pcg[:, :2]).T).max())
    print(f"[dist] (c) make_sharded_verify on 2 ranks: accepted "
          f"{(v0[:, 6] == 1.0).tolist()} (one device "
          f"{(one[:, 6] == 1.0).tolist()}), relative poses within "
          f"{vgap:.3g}; make_sharded_optimize of [loop]'s final graph "
          f"({int(office.node_mask.sum())} nodes, "
          f"{int(office.edge_mask.sum())} edges) within {ogap:.3g} m of "
          f"optimize_pcg", flush=True)
    _require(v0.tobytes() == v1.tobytes() and o0.tobytes() == o1.tobytes(),
             "[dist] (c) both ranks hold the same rows and poses")
    _require(np.array_equal(v0[:, 6], one[:, 6]),
             "[dist] (c) sharded verify: accepted equal")
    _require(ogap <= DIST_PGO_TOL_M,
             f"[dist] (c) sharded PCG within {DIST_PGO_TOL_M} m")
    wrappers_d = _check_dist_split(h0, h1, fe_one, split_frames)
    return wrappers_a, [b0["wrappers"], b1["wrappers"]], wrappers_d


def _dist_split_inputs():
    """[dist] (d)'s config and simulated frames."""
    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.io.simulate import simulate_sequence

    return (SlamConfig.small(**DIST_SPLIT_KW),
            simulate_sequence(n_frames=DIST_SPLIT_FRAMES, beams=181, seed=3))


def _check_dist_split(r0, r1, fe, frames):
    """[dist] (d) (see the module docstring): the two ranks' results of
    `jobs.slam_halves` against one device's FrontEnd `fe` over the same
    frames. Returns each rank's launches by wrapper."""
    from ndt_slam_tpu_torch.metrics import ate_rmse

    one = fe.get_poses()
    m = DIST_SPLIT_FRAMES
    for r, b in enumerate((r0, r1)):
        live = b["live"]
        print(f"[dist] (d) rank {r} of 2, gloo on one card: {m} simulated "
              f"frames in {b['seconds']:.2f} s; live points of its source "
              f"shard (256 slots) from frame 1 on: min {int(live[:, 0].min())}"
              f", max {int(live[:, 0].max())}; of its target shard (512 "
              f"slots): min {int(live[:, 1].min())}, max "
              f"{int(live[:, 1].max())}; launches by wrapper {b['wrappers']};"
              f" host copies {b['copies']}", flush=True)
        _require(live.shape == (m - 1, 2) and (live > 0).all(),
                 f"[dist] (d) rank {r}: its source and target shards hold "
                 f"live points from the second frame on")
        for w in ("ndt_score_grad_hess", "ndt_scores", "nn_sq_dists"):
            _require(b["wrappers"][w] > 0, f"[dist] (d) rank {r}: {w} "
                                           f"launched")
    _require(r0["poses"].shape == (m, 3) and np.isfinite(r0["poses"]).all(),
             f"[dist] (d) {m} finite poses")
    _require(r0["poses"].tobytes() == r1["poses"].tobytes()
             and r0["covs"].tobytes() == r1["covs"].tobytes()
             and r0["accept"] == r1["accept"],
             "[dist] (d) both ranks' trajectories bitwise equal")
    gap = np.hypot(r0["poses"][:, 0] - one[:, 0], r0["poses"][:, 1] - one[:, 1])
    _, gap_deg = _trajectory_gap(r0["poses"], one)
    true = np.asarray([fr.true_pose for fr in frames])
    ate, ate_one = ate_rmse(r0["poses"], true), ate_rmse(one, true)
    print(f"[dist] (d) both ranks bitwise equal; against one device on the "
          f"card: the first registration (frame 1) {gap[1]:.4g} m, frames "
          f"0-9 at most {gap[:10].max():.4g} m, frames 10-{m - 1} at most "
          f"{gap[10:].max():.4g} m ({gap_deg:.4g} deg over all); ATE against "
          f"the simulator's truth {ate:.6f} m (one device {ate_one:.6f} m); "
          f"accept equal {r0['accept'] == [bool(x.get('successful')) for x in fe.metrics]}"
          f" ({_nvidia_smi()})", flush=True)
    _require(gap[1] <= DIST_REGISTER_TOL_M,
             f"[dist] (d) the first registration within "
             f"{DIST_REGISTER_TOL_M} m of one device")
    _require(gap[:10].max() <= DIST_FRAMES_TOL_M,
             f"[dist] (d) frames 0-9 within {DIST_FRAMES_TOL_M} m of one "
             f"device")
    if gap[10:].max() > DIST_FRAMES_TOL_M:
        # a bistable frame parts two summation orders (ROADMAP queue 3):
        # the rest is held to the ATE band
        print(f"[dist] (d) frames 10-{m - 1} part by more than "
              f"{DIST_FRAMES_TOL_M} m; held to the ATE band instead",
              flush=True)
        _require(abs(ate - ate_one) <= BATCH_ATE_SLACK and ate < ATE_BOUND,
                 f"[dist] (d) ATE {ate} within {BATCH_ATE_SLACK} m of one "
                 f"device's {ate_one}")
    return [r0["wrappers"], r1["wrappers"]]


def _load_file(name, path):
    """A module from a file of this checkout (a CLI or a root file)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_register():
    """[register] cli/profile_register_torch.py in this process at its
    default operating point, the launch counts set to 0 just before and
    read just after: every row on the card, each kernel launched.
    Returns (launches by wrapper, the rows)."""
    from ndt_slam_tpu_torch.ndt import kernels

    prof = _load_file("profile_register_torch",
                      os.path.join(ROOT, "cli", "profile_register_torch.py"))
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    header, rows = prof.profile_rows("cuda", REGISTER_REPS)
    wrappers = kernels.wrapper_launch_counts()
    for line in prof.format_table(header, rows).splitlines():
        print(f"[register] {line}")
    print(f"[register] {time.perf_counter() - t0:.1f} s; launches by "
          f"wrapper {wrappers}", flush=True)
    for r in rows:
        _require(r["device"].startswith("cuda") and np.isfinite(r["us"])
                 and r["us"] > 0, f"[register] {r['name']} ran on the card")
    for w in ("ndt_score_grad_hess", "ndt_scores", "fitness_score",
              "ndt_newton"):
        _require(wrappers[w] > 0, f"[register] {w} launched")
    return wrappers, rows


def _check_entry():
    """[entry] `__graft_entry_torch__.entry("cuda")`'s step against the
    same step on `entry("cpu")`'s tensors (the plain twins), launch
    counts set to 0 just before the card's call and read after it; then
    `dryrun_multichip(2, "cuda")`. Returns (launches by wrapper of the
    step, each dry-run rank's)."""
    import torch
    from ndt_slam_tpu_torch.ndt import kernels

    graft = _load_file("graft_entry_torch",
                       os.path.join(ROOT, "__graft_entry_torch__.py"))
    fn, args = graft.entry("cuda")
    _, cpu_args = graft.entry("cpu")
    kernels.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    wrappers = kernels.wrapper_launch_counts()
    ref = fn(*cpu_args)
    got = {k: getattr(out, k).cpu().numpy() for k in out._fields}
    want = {k: getattr(ref, k).numpy() for k in ref._fields}
    dpose = max(float(np.abs(got[k][:2] - want[k][:2]).max())
                for k in ("est_pose", "fused_pose"))
    drad = max(float(np.abs(np.deg2rad(got[k][2] - want[k][2])))
               for k in ("est_pose", "fused_pose"))
    dcost = abs(float(got["cost"]) - float(want["cost"])) / abs(
        float(want["cost"]))
    dxy = float(np.abs(got["global_xy"] - want["global_xy"]).max())
    print(f"[entry] entry('cuda') against entry('cpu'), 541 of 2048 scan "
          f"slots, 8192-slot target, 96 x 96 window: successful "
          f"{bool(got['successful'])} / {bool(want['successful'])}, "
          f"iterations {int(got['iterations'])} / {int(want['iterations'])}"
          f", poses within {dpose:.3g} m and {drad:.3g} rad, cost "
          f"{float(got['cost']):.6g} (rel {dcost:.3g}), map-frame points "
          f"within {dxy:.3g} m; launches by wrapper {wrappers}", flush=True)
    _require(bool(got["successful"]) == bool(want["successful"])
             and int(got["iterations"]) == int(want["iterations"]),
             "[entry] successful and iterations equal")
    _require(dpose <= ENTRY_TOL and drad <= ENTRY_TOL
             and dcost <= ENTRY_TOL and dxy <= ENTRY_XY_TOL,
             f"[entry] poses within {ENTRY_TOL} m / rad, cost to rtol "
             f"{ENTRY_TOL}, points within {ENTRY_XY_TOL} m")
    for w in ("ndt_newton", "fitness_score"):
        _require(wrappers[w] > 0, f"[entry] {w} launched")
    t0 = time.perf_counter()
    ranks = graft.dryrun_multichip(2, "cuda")
    print(f"[entry] dryrun_multichip(2, 'cuda'): mesh (dp, pt) = "
          f"{ranks[0]['mesh']}, frame step, sequential step, sharded PCG "
          f"and sharded verify finite and bitwise equal on both ranks in "
          f"{time.perf_counter() - t0:.1f} s; fused pose "
          f"{ranks[0]['sequential_step'].fused_pose.tolist()}; launches by "
          f"wrapper a rank {[r['wrappers'] for r in ranks]}", flush=True)
    for r in ranks:
        for w in ("ndt_score_grad_hess", "ndt_scores", "nn_sq_dists"):
            _require(r["wrappers"][w] > 0, f"[entry] dry run: {w} launched")
    return wrappers, [r["wrappers"] for r in ranks]


def _check_tools(kept, fe_full, gt):
    """[tools] the JAX-free tools on the card's machine: eval_ate_torch
    (a fresh interpreter) on [main]'s poses_full.txt, the fixture
    generator's first frames, [main]'s map.pcd read back."""
    from ndt_slam_tpu_torch.io import pcd
    from ndt_slam_tpu_torch.metrics import ate_rmse

    poses = fe_full.get_poses()
    ate = ate_rmse(poses, gt[:len(poses)])
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "cli", "eval_ate_torch.py"),
         os.path.join(kept, "poses_full.txt"), GT],
        capture_output=True, text=True, check=True, timeout=120)
    line = json.loads(run.stdout.strip().splitlines()[-1])
    gen = _load_file("make_carmen_fixture_torch",
                     os.path.join(ROOT, "cli", "make_carmen_fixture_torch.py"))
    lines, _ = gen.generate(n_frames=5)
    with open(LOG) as f:
        f.readline()   # the comment header
        committed = [f.readline().rstrip("\n") for _ in range(5)]
    back = pcd.load_pcd(os.path.join(kept, "map.pcd"))
    gm = fe_full.pcmap.global_map()
    same_map = back.shape == gm.shape and np.allclose(back, gm, rtol=1e-5,
                                                      atol=1e-6)
    print(f"[tools] eval_ate_torch on [main]'s poses_full.txt: {line}; "
          f"[main]'s ATE {ate!r} m (gap {abs(line['ate_rmse_m'] - ate):.3g})"
          f"; make_carmen_fixture_torch.generate(n_frames=5) equals the "
          f"committed office_loop.clf lines: {lines == committed}; [main]'s "
          f"map.pcd ({pcd.writer()} writer) read back: {len(back)} points, "
          f"the map's within the format: {same_map}", flush=True)
    _require(line["frames"] == len(poses)
             and abs(line["ate_rmse_m"] - ate) <= TOOLS_ATE_TOL_M,
             f"[tools] eval_ate_torch gives [main]'s ATE to "
             f"{TOOLS_ATE_TOL_M} m")
    _require(lines == committed,
             "[tools] the fixture generator's first 5 frames equal the "
             "committed office_loop.clf")
    _require(same_map, "[tools] load_pcd reads [main]'s map.pcd back")


class _LineLog:
    """A stdout that keeps each complete line with the kernels' launch
    counts at the moment it was written."""

    def __init__(self):
        self._buf = ""
        self.lines = []

    def write(self, text):
        from ndt_slam_tpu_torch.ndt import kernels

        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((line, kernels.launch_counts()))
        return len(text)

    def flush(self):
        pass


def _check_bench(device):
    """[bench] bench_torch.main(["--quick"]) in this process, the launch
    counts set to 0 just before and read after each line: four `*_gpu`
    lines in order, each finite and above 0, each with the three kernels
    launched; the register line on the moment lattice; then
    `device_chain` on the card against the CPU twins for
    BENCH_CHAIN_FRAMES frames at `SlamConfig.small` capacities, and the
    device-to-host copies a frame of the chain at the bench's config.
    Returns the launches by wrapper of the four lines' run."""
    import contextlib
    import torch
    from ndt_slam_tpu_torch.io.simulate import simulate_sequence
    from ndt_slam_tpu_torch.ndt import kernels

    bench = _load_file("bench_torch", os.path.join(ROOT, "bench_torch.py"))
    log = _LineLog()
    kernels.reset_launch_counts()
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = bench.main(["--quick"])
    wall = time.perf_counter() - t0
    wrappers = kernels.wrapper_launch_counts()
    _require(rc == 0, "[bench] bench_torch.main(['--quick']) exits 0")
    _require(len(log.lines) == len(BENCH_LINES),
             f"[bench] {len(BENCH_LINES)} lines, got {len(log.lines)}")
    for (text, counts), name in zip(log.lines, BENCH_LINES):
        line = json.loads(text)
        delta = {k: counts[k] - before[k] for k in counts}
        before = counts
        print(f"[bench] {text}; launches {delta}", flush=True)
        _require(line["metric"] == f"{name}_gpu"
                 and np.isfinite(line["value"]) and line["value"] > 0,
                 f"[bench] {name}_gpu finite and above 0")
        _require(delta["newton"] > 0 and delta["nn"] > 0,
                 f"[bench] the Newton kernel and kernel 3 launched in "
                 f"{name}")
    print(f"[bench] the four lines in {wall:.1f} s; launches by wrapper "
          f"{wrappers} ({_nvidia_smi()})", flush=True)

    log = _LineLog()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(log):
        rc = bench.main(["--register-only", "--quick",
                         "--ndt-incremental-grid", "1"])
    counts = kernels.launch_counts()
    _require(rc == 0 and len(log.lines) == 1,
             "[bench] the register line on the lattice exits 0, one line")
    line = json.loads(log.lines[0][0])
    print(f"[bench] --ndt-incremental-grid 1: {log.lines[0][0]}; launches "
          f"{counts}", flush=True)
    _require(line["metric"] == f"{BENCH_LINES[0]}_gpu"
             and np.isfinite(line["value"]) and line["value"] > 0
             and counts["newton"] > 0 and counts["nn"] > 0,
             "[bench] the lattice's register line finite, above 0, the "
             "Newton kernel and kernel 3 launched")

    # the register line's step is [register]'s full step: the Newton
    # iterations a call over each one's odometry variants, and one call's
    # median milliseconds by CUDA events
    reg = bench.register_config()
    for n, who in ((10, "the bench's --quick"),
                   (REGISTER_REPS + 2, "[register]'s")):
        inp = bench.register_inputs(reg, device, variants=n)
        step = bench.register_step(reg, inp)
        its = [int(step(o).iterations) for o in inp["odos"]]
        ms = _time_ms(lambda: step(inp["odos"][0]))
        print(f"[bench] register step over {who} {n} variants: iterations "
              f"{its}; {ms:.3f} ms a call (median of 20, the first "
              f"variant)", flush=True)

    args = bench._parser().parse_args([])
    small = bench.pipeline_config(args, small=True)
    frames = simulate_sequence(n_frames=BENCH_CHAIN_FRAMES,
                               beams=bench.BEAMS, seed=4)
    on_card, _, tgt_card = bench.device_chain(small, frames, device)
    on_cpu, _, tgt_cpu = bench.device_chain(small, frames,
                                            torch.device("cpu"))
    a, b = on_card[:, :3].cpu().numpy(), on_cpu[:, :3].numpy()
    dxy = float(np.abs(a[:, :2] - b[:, :2]).max())
    dth = float(np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0).max())
    n_card, n_cpu = int(tgt_card.mask.sum()), int(tgt_cpu.mask.sum())
    full = bench.pipeline_config(args)
    chain = simulate_sequence(n_frames=BENCH_D2H_FRAMES, beams=bench.BEAMS,
                              seed=4)
    outs = []
    dev = _device_events(
        lambda: outs.append(bench.device_chain(full, chain, device)[0]), 1)
    d2h = sum("memcpy dtoh" in e.name.lower() for e in dev)
    iters = outs[-1][:, 14].cpu().numpy()   # small(): iterations
    print(f"[bench] device_chain, {BENCH_CHAIN_FRAMES} frames at the small "
          f"capacities, card vs CPU twins: max {dxy:.3g} m, {dth:.3g} deg, "
          f"last target {n_card} points against {n_cpu}; "
          f"at the bench's config {d2h / BENCH_D2H_FRAMES:g} device-to-host "
          f"copies and {len(dev) / BENCH_D2H_FRAMES:g} device operations a "
          f"frame over {BENCH_D2H_FRAMES} frames, Newton iterations "
          f"{iters.astype(int).tolist()}", flush=True)
    _require(np.isfinite(a).all() and dxy <= BENCH_CHAIN_M
             and dth <= BENCH_CHAIN_DEG,
             f"[bench] device_chain on the card within {BENCH_CHAIN_M} m "
             f"and {BENCH_CHAIN_DEG} deg of the CPU twins")
    _require(abs(n_card - n_cpu) <= BENCH_CHAIN_COUNT * n_cpu,
             f"[bench] device_chain's last target on the card within "
             f"{BENCH_CHAIN_COUNT:.0%} of the CPU twins' point count")
    return wrappers


def _check_scaling():
    """[scaling] cli/bench_scaling_torch.py's three workloads as one rank
    on the card (nccl), SCALING_REPS timed calls each, and verify as two
    ranks sharing the card over gloo: accepted equal to one rank's.
    Returns the one-rank run's launches by wrapper, the three workloads
    together."""
    from ndt_slam_tpu_torch.ndt import kernels

    tool = _load_file("bench_scaling_torch",
                      os.path.join(ROOT, "cli", "bench_scaling_torch.py"))
    t0 = time.perf_counter()
    rows = tool.run_rows(1, tool.WORKLOADS, SCALING_REPS, SCALING_BATCH,
                         device="cuda")
    two, = tool.run_rows(2, ["verify"], SCALING_REPS, SCALING_BATCH,
                         device="cuda", backend="gloo")
    card = _nvidia_smi()
    wrappers = {}
    for r in rows + [two]:
        key = next(k for k in ("accepted", "iterations", "converged")
                   if k in r)
        unit = "frame steps/s" if r["workload"] == "seqstep" \
            else "candidates/s"
        print(f"[scaling] {r['workload']}, {r['devices']} rank(s) on the "
              f"card ({'nccl' if r is not two else 'gloo'}), batch "
              f"{r['batch']}: {r['pairs_per_sec']:.2f} {unit} "
              f"({r['sec_per_batch'] * 1e3:.2f} ms a call), {key} "
              f"{r[key]}; launches by wrapper a rank {r['launches']} "
              f"({card})", flush=True)
        for w in r["launches"]:
            counts = {k: sum(w[f.__name__] for f in fns)
                      for k, fns in kernels.WRAPPERS.items()}
            solved = (counts["newton"] > 0
                      or min(counts["sgh"], counts["score_many"]) > 0)
            _require(solved and counts["nn"] > 0,
                     f"[scaling] {r['workload']}: the solve's kernels and "
                     f"kernel 3 launched")
    for r in rows:
        for k, v in r["launches"][0].items():
            wrappers[k] = wrappers.get(k, 0) + v
    print(f"[scaling] {time.perf_counter() - t0:.1f} s; two ranks' verify "
          f"accepted {two['accepted']}, one rank's {rows[0]['accepted']}",
          flush=True)
    _require(two["accepted"] == rows[0]["accepted"],
             "[scaling] two ranks' verify accepts what one rank's does")
    return wrappers


def _row_launches(name, wrappers):
    """A kernels-line row's launches in a run counted by wrapper: a
    variant's own wrapper, a kernel's wrappers together (as
    `kernels.launch_counts` adds them)."""
    from ndt_slam_tpu_torch.ndt import kernels

    if name in PIPELINE_WRAPPERS:
        return wrappers[PIPELINE_WRAPPERS[name]]
    return sum(wrappers[f.__name__] for f in kernels.WRAPPERS[name])


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

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phase):
        now = time.perf_counter()
        print(f"[time] {phase}: {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

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
    scenes = _scenes(device, full, frames)
    rows = _check_kernels(cfg, scenes)
    event_us, device_us = _empty_launch_us()
    print(f"[launch] an empty kernel: {event_us:.2f} us from before its "
          f"launch to its end (CUDA events, median of 50), {device_us:.2f} "
          f"us of device time (profiler)", flush=True)
    lap("device, build, kernels")

    # 4. the main paths at the default capacities, every frame: the full
    # rebuild (what -1 resolves to on cuda) and the incremental lattice
    kept = tempfile.TemporaryDirectory()    # [main]'s outputs for [tools]
    fe_full, counts_full = _run_main_path("main", frames, gt, full, device,
                                          keep=kept.name)
    fe, counts = _run_main_path("main-inc", frames, gt, inc, device)
    _require(fe.incremental_grid and fe.n_grid_fallbacks == 0,
             "[main-inc] ran on the lattice and no window escaped it")
    for row in rows:
        row["launches"] = counts_full[row["name"]]
        row["launches_lattice"] = counts[row["name"]]
    lap("main, main-inc")

    _check_lattice(inc, frames, device)

    # one fetch a frame on either path: the lattice path adds no
    # device-to-host copy
    d2h_inc, ops_inc, esc = _d2h_copies_per_frame(inc, frames, device)
    d2h_full, ops_full, _ = _d2h_copies_per_frame(full, frames, device)
    print(f"[fetch] frames 40-59: {d2h_inc:g} device-to-host copies and "
          f"{ops_inc:g} device operations a frame on the lattice path, "
          f"{d2h_full:g} and {ops_full:g} with the full rebuild", flush=True)
    _require(esc == 0 and d2h_inc <= d2h_full,
             "the lattice path adds no device-to-host copy to the frame")

    # an escape: a lattice no wider than the window
    off30 = run_slam(frames, full.replace(end_frame=30), device).get_poses()
    escape = inc.replace(end_frame=30, grid_mom_cells=192)
    fe_esc = run_slam(frames, escape, device)
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
    lap("lattice, fetch, escape, reference")

    # 5. loop closure, all 500 frames on the full rebuild, verify
    # resolved at once and then a check late; what a correction costs
    loop = full.replace(loop_enable=True)
    fps_off = len(fe_full.pose_history) / fe_full.metrics[-1]["wall_s"]
    fe_loop, counts_loop, wrappers_loop, closed = _run_loop_path(
        "loop", frames, gt, loop, device, fps_off)
    for row in rows:
        row["launches_loop"] = counts_loop[row["name"]]
    office = _office_graph(fe_loop.backend)
    _rewrite_cost(fe_loop)
    rewrite_err = _check_rewrite_nn(fe_loop)
    lap("loop")

    # 6. the loop-closure verifier on the [main] run's keyframes, the
    # kernel variants it runs against their twins at its shapes, and the
    # pose-graph solvers on the card against the CPU
    vin = _verify_inputs(cfg, frames, gt, fe_full, device)
    rows += _loop_closure_phases(vin, scenes["synthetic"], office)
    for row in rows:
        if row["name"] in VARIANT_WRAPPERS:
            row["launches_loop"] = wrappers_loop[VARIANT_WRAPPERS[row["name"]]]
        if row["name"] == "nn_batched":
            row["max_abs_err"] = max(row["max_abs_err"], rewrite_err)
    lap("variants, verify, pgo (child process)")

    # 7. determinism on both grid paths: frames 0-29 twice; resume on the
    # lattice path: a checkpoint after frame 14 and the run continued from
    # the loaded file; bitwise equal poses
    short = inc.replace(end_frame=DETERMINISM_FRAMES)
    a = _check_determinism(frames, device,
                           {"full rebuild": full, "lattice": inc})["lattice"]
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
    _require(c.shape == (DETERMINISM_FRAMES, 3) and c.tobytes() == a.tobytes(),
             "a run resumed from the checkpoint of frame 14 gives the "
             "uninterrupted run's poses bit for bit")
    print(f"[resume] checkpoint after frame 14 ({size} bytes), frames 15-29 "
          f"from the loaded file: poses and lattice bitwise equal",
          flush=True)
    lap("determinism, resume")
    # and with loops on, through the first correction
    _check_loop_determinism(frames, device, loop, closed)
    lap("determinism, resume with loops")

    # 8. this slice's main path, the lockstep batch runner, and the suite
    # through the port's CLI
    row, counts_batch, wrappers_batch = _check_batch(fe_full, device)
    row["launches"] = wrappers_batch["fitness_score_batched"]
    for r in rows:
        r["launches_batch"] = (
            wrappers_batch[VARIANT_WRAPPERS[r["name"]]]
            if r["name"] in VARIANT_WRAPPERS else counts_batch[r["name"]])
    row["launches_batch"] = row["launches"]
    rows.append(row)
    lap("batch")
    _check_suite()
    lap("suite")

    # 9. the pipelined front end, each run against its synchronous run
    # above, and 10. the gather engine
    counts_pipe, wrappers_pipe = _check_pipeline(
        frames, gt, device,
        {"main": (full, fe_full), "main-inc": (inc, fe),
         "escape": (escape, fe_esc), "loop": (loop, fe_loop)}, d2h_full)
    for r in rows:
        r["launches_pipeline"] = (
            wrappers_pipe[PIPELINE_WRAPPERS[r["name"]]]
            if r["name"] in PIPELINE_WRAPPERS else counts_pipe[r["name"]])
    lap("pipeline")
    _check_gather(frames, gt, device, full, fe_full, vin)
    lap("gather")

    # 11. the multi-rank runners
    dist_a, dist_b, dist_d = _check_dist(frames, gt, full, fe_full, vin,
                                         office, device)
    for r in rows:
        r["launches_dist"] = _row_launches(r["name"], dist_a)
        r["launches_dist_ranks"] = [_row_launches(r["name"], w)
                                    for w in dist_b]
    lap("dist")

    # 12. the register profile, 13. the entry points, 14. the tools
    reg, _ = _check_register()
    lap("register")
    entry, dryrun = _check_entry()
    lap("entry")
    _check_tools(kept.name, fe_full, gt)
    kept.cleanup()
    lap("tools")

    # 15. the bench, 16. the scaling report's workloads
    bench_w = _check_bench(device)
    lap("bench")
    scaling_w = _check_scaling()
    lap("scaling")
    for r in rows:
        r["launches_dist_split"] = [_row_launches(r["name"], w)
                                    for w in dist_d]
        r["launches_register"] = _row_launches(r["name"], reg)
        r["launches_entry"] = _row_launches(r["name"], entry)
        r["launches_dryrun"] = [_row_launches(r["name"], w) for w in dryrun]
        r["launches_bench"] = _row_launches(r["name"], bench_w)
        r["launches_scaling"] = _row_launches(r["name"], scaling_w)

    print(f"[time] {time.perf_counter() - t_start:.1f} s from the device "
          f"check to here", flush=True)
    print(json.dumps({"kernels": rows}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--loop-closure":
        sys.exit(_loop_closure_child(sys.argv[2]))
    sys.exit(main())
