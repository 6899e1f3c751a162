"""The profiler session of a traced run and the reading of its trace.

A session is padded: `SPINS` spin kernels on the stream before the
profiled scans and after them, and `EDGE_S` of host time at both ends,
since the profiler has been seen to drop the device events at a
session's edges. The device window is the time between the end of the
leading spins and the start of the trailing ones; a session that kept
no spin on one side lost its edge, and the window then falls back to
the span of the events it kept (`Trace.edges_kept` says which).

While a session is open, every stage mark of the program's StageTimer
also leaves an annotation `slambench.mark:<stage>` in the trace, so that
each device operation can be given to the stage whose host interval
launched it (by the correlation of the operation with its launch)."""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

from slambench.yardstick.stats import gaps, union_length

SPINS = 8              # spin kernels on each side of the profiled scans
SPIN_CYCLES = 100_000  # their length: about 50 us at 1980 MHz
EDGE_S = 0.05          # host time at each end of a session
MARK = "slambench.mark:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start_us: float
    end_us: float
    launch_us: Optional[float]   # host time of its launch, if correlated


class Trace(NamedTuple):
    ops: List[DeviceOp]          # inside the window, spins left out
    window_us: tuple             # (start, end) on the device timeline
    edges_kept: bool
    marks: List[tuple]           # (host time, stage) of each stage mark

    def stage_of(self, host_us: float) -> Optional[str]:
        """The stage whose host interval holds host_us: the stage of the
        first mark at or after it."""
        lo, hi = 0, len(self.marks)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.marks[mid][0] < host_us:
                lo = mid + 1
            else:
                hi = mid
        return self.marks[lo][1] if lo < len(self.marks) else None

    def device_us_by_stage(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            if op.launch_us is not None:
                out[self.stage_of(op.launch_us) or "?"] += \
                    op.end_us - op.start_us
        return dict(out)

    def busy_us(self) -> float:
        return union_length([(op.start_us, op.end_us) for op in self.ops])

    def idle_gaps_by_stage(self) -> Dict[str, float]:
        """Seconds of device idle time, by the stage the host was in when
        each idle stretch began."""
        out: Dict[str, float] = defaultdict(float)
        for a, b in gaps([(op.start_us, op.end_us) for op in self.ops],
                         *self.window_us):
            out[self.stage_of(a) or "?"] += (b - a) * 1e-6
        return dict(out)


@contextlib.contextmanager
def marking(timer_cls, watched):
    """Within the block, a `timer_cls.mark(name)` of the timer that
    `watched()` returns also leaves the annotation
    `slambench.mark:<name>` in the open profiler session. Entered before
    the system is built, so that bound marks handed around (the back
    end's) are the annotating ones too."""
    import torch

    orig = timer_cls.mark

    def mark(self, name):
        orig(self, name)
        if self is watched():
            with torch.profiler.record_function(MARK + name):
                pass

    timer_cls.mark = mark
    try:
        yield
    finally:
        timer_cls.mark = orig


class Session:
    """An open padded profiler session: `start()`, the scans, `stop()`,
    then `read(path)`."""

    def __init__(self):
        self._prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(EDGE_S)
        for _ in range(SPINS):
            torch.cuda._sleep(SPIN_CYCLES)

    def stop(self):
        import torch

        for _ in range(SPINS):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        self._prof.__exit__(None, None, None)

    def read(self, path: str) -> Trace:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._prof.export_chrome_trace(path)
        trace = read_chrome_trace(path)
        os.remove(path)
        return trace


def read_chrome_trace(path: str) -> Trace:
    """The device operations, window and stage marks of a padded
    session's Chrome trace (plain or gzip JSON)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return parse_events(events)


def parse_events(events) -> Trace:
    launch: Dict[int, float] = {}
    device, marks = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = args.get("correlation")
            if corr is not None:
                launch[int(corr)] = float(e["ts"])
        elif e.get("name", "").startswith(MARK):
            marks.append((float(e["ts"]), e["name"][len(MARK):]))
    marks.sort()
    spins = sorted(float(e["ts"]) for e in device
                   if "spin_kernel" in e.get("name", ""))
    inner = [e for e in device if "spin_kernel" not in e.get("name", "")]
    ops = []
    for e in inner:
        corr = (e.get("args") or {}).get("correlation")
        a = float(e["ts"])
        ops.append(DeviceOp(e.get("name", ""), e["cat"], a,
                            a + float(e.get("dur", 0.0)),
                            launch.get(int(corr)) if corr is not None
                            else None))
    ops.sort(key=lambda op: op.start_us)
    first = ops[0].start_us if ops else 0.0
    last = max((op.end_us for op in ops), default=0.0)
    lead = [t for t in spins if t < first]
    trail = [t for t in spins if t > last]
    spin_end = {float(e["ts"]): float(e["ts"]) + float(e.get("dur", 0.0))
                for e in device if "spin_kernel" in e.get("name", "")}
    lo = spin_end[lead[-1]] if lead else first
    hi = trail[0] if trail else last
    return Trace(ops, (lo, hi), bool(lead) and bool(trail), marks)
