"""One run of one cell of the benchmark (see `run.py` and PERF.md).

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own that the harness finds by
the name `BENCHMARK.json` gives it:

    configs/<config>.json     the SlamConfig settings, the driver
    workloads/<cell>.json     the logs, the jobs, the warm-up, the traced
                              span, the judge's sample and limits
    drivers/<driver>.py       warmup(run), window(run)
    metrics/<metric>.py       read(ctx) -> number or None
    traffic/worlds/<world>.py the worlds of the generator

`run_cell` is the whole run on any device (the CPU tests call it at
tiny sizes); `main` is the command, which insists on the cards the cell
asks for."""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np

BANNED = ("jax", "jaxlib", "flax", "ndt_slam_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def banned_modules() -> list:
    """Loaded modules whose top-level name is a banned one, whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def _reader(root: str, name: str) -> Callable:
    path = os.path.join(root, "slambench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"slambench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a driver and the judge see of a run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Context:
    """What a metric reader sees: the run, its window, its set-up time,
    its trace (traced runs) and the judge's work counts."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def stage_ms_per_scan(self, *stages) -> Optional[float]:
        w = self.window
        if not w.stage_scans or not any(s in w.stage_ms for s in stages):
            return None
        return sum(w.stage_ms.get(s, 0.0) for s in stages) / w.stage_scans

    def traced_scans(self) -> int:
        """Scans handed over in the traced span (every row of a tick)."""
        return len(self.followed_rows()) * self.run.tap.traced_frames

    def followed_rows(self) -> list:
        return [j for j in self.window.jobs if j.index == 0]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _snapshots(work: dict, seed: int) -> set:
    """Frames of the window's first job whose targets are compared: its
    first frame after the set-up's (frame 1 without a prefix) and a
    sample drawn from the seed."""
    job = work["jobs"][0]
    first = max(1, int(job.get("prefix", 0)))
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), 2]))
    pool = np.arange(first + 1, int(job["frames"]))
    k = min(int(work["judge"]["targets"]), len(pool))
    return {first} | {int(v) for v in rng.choice(pool, size=k,
                                                 replace=False)}


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def host_state() -> str:
    """The load average and the clock of the cores this process may use,
    as the kernel reports them."""
    cores = sorted(os.sched_getaffinity(0))
    mhz = {}
    try:
        with open("/proc/cpuinfo") as f:
            cpu = None
            for line in f:
                if line.startswith("processor"):
                    cpu = int(line.split(":")[1])
                elif line.startswith("cpu MHz") and cpu in cores:
                    mhz[cpu] = float(line.split(":")[1])
    except OSError:
        pass
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    clock = " ".join(f"{c}:{mhz[c]:.0f}" for c in cores if c in mhz)
    return f"cores {cores}, MHz {clock or 'unread'}, load {load}"


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", system: str = "program",
             t_start: Optional[float] = None, say=print) -> dict:
    """One run of a cell; returns the result line's object. `say`
    prints the earlier lines."""
    import torch

    from slambench import system as systems
    from slambench.reference.judge import judge
    from slambench.tap import Tap
    from slambench.traffic.generator import make_log
    from slambench.yardstick import trace as ytrace
    from slambench.yardstick.stats import ate_rmse, percentile

    t_start = time.perf_counter() if t_start is None else t_start
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    config = read_json(os.path.join(root, cfg_entry["file"]))
    work = read_json(os.path.join(root, "slambench", "workloads",
                                  workload + ".json"))
    dev = torch.device(device)

    t0 = time.perf_counter()
    logs = {spec["name"]: make_log(spec, seed, i)
            for i, spec in enumerate(work["logs"])}
    gen_s = time.perf_counter() - t0
    sizes = ", ".join(f"{k}: {len(v.scans)} frames" for k, v in logs.items())
    say(f"[traffic] {sizes} generated in {gen_s:.3f} s (seed {seed})")

    sut = systems.load(system)
    cfg = sut.SlamConfig.from_dict(config["slam"])
    tap = Tap(trace, work["trace"], _snapshots(work, seed),
              os.path.join(root, "build", "slambench", "trace.json"))
    run = Run(root=root, cell=cell, config=config, work=work, system=sut,
              cfg=cfg, logs=logs, device=dev, seconds=float(seconds),
              seed=seed, trace=trace, tap=tap)
    driver = importlib.import_module(f"slambench.drivers.{config['driver']}")
    marks = (ytrace.marking(sut.StageTimer, tap.watched) if trace
             else contextlib.nullcontext())
    with marks:
        warm = driver.warmup(run)
        setup_s = time.perf_counter() - t_start
        say(f"[setup] {setup_s:.3f} s to the first timed scan, warm-up "
            f"{warm}")
        say(f"[host] before the window: {host_state()}")
        window = driver.window(run)
    say(f"[host] after the window: {host_state()}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    window.trace = tap.read() if trace else None
    run.base = None   # the program's state goes before the reference runs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    limits = work["judge"]["limits"]
    t0 = time.perf_counter()
    verdict = judge(run, window, list(limits))
    judge_s = time.perf_counter() - t0
    for line in verdict.notes:
        say(f"[judge] {line}")
    say(f"[judge] {verdict.judged} registrations judged in {judge_s:.3f} s")

    jobs = window.jobs
    recs = [r for j in jobs for r in j.records if not r.get("bootstrap")]
    accept = (sum(bool(r["successful"]) for r in recs) / len(recs)
              if recs else float("nan"))
    for j in jobs:
        n = j.first + j.done
        ate = ate_rmse(j.poses[:n], logs[j.log].gt[j.start:j.start + n])
        say(f"[job] {j.index}.{j.row} {j.log}[{j.start + j.first}:"
            f"{j.start + n}] "
            f"{'complete' if j.complete else 'cut at the window close'}: "
            f"ATE {ate:.4f} m, {len(j.edge_log)} loops accepted, "
            f"{len(j.corrections)} corrections")
    lat = sorted(window.latencies_s)
    if lat:
        say("[latency] ms at percentiles 50 90 95 99 100: " + " ".join(
            f"{percentile(lat, q) * 1e3:.3f}" for q in (50, 90, 95, 99, 100)))
    say(f"[window] {window.scans} scans in {window.seconds:.3f} s, "
        f"{sum(j.complete for j in jobs)} jobs complete, accept rate "
        f"{accept:.4f}, loops accepted {sum(len(j.edge_log) for j in jobs)}, "
        f"corrections {sum(len(j.corrections) for j in jobs)}")

    ctx = Context(run=run, window=window, setup_s=setup_s, judge=verdict,
                  cfg=cfg)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if not _applies(m, workload):
            continue
        value = _reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks = {name: {"value": verdict.numbers.get(name, math.inf),
                     "limit": float(lim)} for name, lim in limits.items()}
    correct = (verdict.judged > 0 and
               all(c["value"] <= c["limit"] for c in checks.values()))
    if dev.type == "cuda":
        dinfo = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                 "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    else:
        dinfo = {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0}
    out = {"correct": bool(correct), "attempted": window.scans,
           "failed": window.scans - sum(j.done for j in jobs),
           "metrics": metrics, "device": dinfo}
    if window.trace is not None:
        tr = window.trace
        dinfo["busy_s"] = tr.busy_us() * 1e-6
        dinfo["window_s"] = (tr.window_us[1] - tr.window_us[0]) * 1e-6
        by_stage = {k: round(v * 1e-6, 6)
                    for k, v in tr.device_us_by_stage().items()}
        say(f"[trace] {len(tr.ops)} device operations over "
            f"{tap.traced_frames} traced frames, edges kept: "
            f"{tr.edges_kept}, device seconds by stage {by_stage}")
        by_name = {}
        for op in tr.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + \
                (op.end_us - op.start_us) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(tr.idle_gaps_by_stage().items(),
                      key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                            "idle_gaps": [[k, v] for k, v in idle]}
    out["checks"] = checks
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the "
                                 "benchmark once on this machine's cards.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None,
                    help="run the output check's control in the "
                         "program's place (not a benchmark run)")
    args = ap.parse_args(argv)
    root = os.path.dirname(HERE)

    import torch

    torch.set_num_threads(1)
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this benchmark runs on CUDA cards: {chips} asked for, "
              f"{have} available", file=sys.stderr)
        return 2
    print(f"[device] {_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda",
                   args.control or "program", t_start)
    found = banned_modules()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0
