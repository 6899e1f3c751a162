"""One robot's log mapped scan by scan by the synchronous front end
(`FrontEnd(cfg, device).process`), as a closed loop: each scan is handed
over when the last one's record has returned. Jobs run back to back; a
job's `finalize` counts in the window.

A job may have a `prefix`: its first frames are mapped once in set-up
by the system under test (the map a robot already holds when it starts
its next lap), and every job of the window continues from a copy of
that front end, made inside the window, over the rest of its frames."""

from __future__ import annotations

import copy
import time

from slambench.record import Job, Window


def _frames(run, spec):
    log = run.logs[spec["log"]]
    a, n = int(spec["start"]), int(spec["frames"])
    return log.scans[a:a + n], log.odo[a:a + n]


def _copy(run, fe):
    """A copy of a front end between frames, with a fresh stage timer
    (its CUDA events are not copied)."""
    return copy.deepcopy(fe, memo={id(fe.timer): run.system.StageTimer(
        fe.device)})


def _drive(fe, frames, odo, k, job):
    n_corr = fe.n_corrections
    rec = fe.process(frames[k], odo[k])
    job.records.append(rec)
    if fe.n_corrections != n_corr:
        job.corrections.append((k, list(fe.pose_history)))
    return rec


def warmup(run) -> dict:
    """Map the job's prefix with the system under test (kept as
    `run.base`, its records as `run.prefix`), then drive a throwaway
    front end (a copy of the prefix's, else a fresh one) through the
    traffic's warm-up slices of the job's frames: the kernels built,
    every map-step variant touched and, where the slices revisit, a
    verify, a solve and a map rewrite run."""
    spec = run.work["jobs"][0]
    frames, odo = _frames(run, spec)
    fe = run.system.FrontEnd(run.cfg, run.device)
    fe.warmup()
    run.base = run.prefix = None
    first = int(spec.get("prefix", 0))
    if first:
        run.prefix = Job(-1, 0, spec["log"], int(spec["start"]),
                         int(spec["frames"]))
        for k in range(first):
            _drive(fe, frames, odo, k, run.prefix)
        fe.timer.resolve(wait=True)
        run.base = fe
        fe = _copy(run, fe)
    n = 0
    for a, b in run.work["warmup"]:
        for k in range(a, b):
            fe.process(frames[k], odo[k])
            n += 1
    fe.finalize()
    run.sync()
    be = getattr(fe, "backend", None)
    return {"prefix": first, "frames": n, "corrections": fe.n_corrections,
            "loops_accepted": be.loops_accepted if be is not None else 0}


def window(run) -> Window:
    specs = run.work["jobs"]
    tap = run.tap
    jobs, lat, totals = [], [], {}
    scans = 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    t_last = t0
    while True:
        spec = specs[len(jobs) % len(specs)]
        first = int(spec.get("prefix", 0))
        job = Job(len(jobs), 0, spec["log"], int(spec["start"]),
                  int(spec["frames"]), first)
        jobs.append(job)
        fe = (_copy(run, run.base) if first
              else run.system.FrontEnd(run.cfg, run.device))
        frames, odo = _frames(run, spec)
        cut = False
        for k in range(first, job.length):
            if time.perf_counter() >= deadline:
                cut = True
                break
            tap.before(job.index, k, fe.timer)
            if tap.snapshot_due(job.index, k):
                t = fe.pcmap.registration_target()
                job.targets[k] = (t.xy.clone(), t.mask.clone())
            ta = time.perf_counter()
            _drive(fe, frames, odo, k, job)
            t_last = time.perf_counter()
            lat.append(t_last - ta)
            scans += 1
        if job.index == 0:
            tap.end()
        if not cut:
            n_corr = fe.n_corrections
            fe.finalize()
            t_last = time.perf_counter()
            if fe.n_corrections != n_corr:
                job.corrections.append((job.length - 1,
                                        list(fe.pose_history)))
            job.complete = True
        if job.done == 0:
            jobs.pop()
            break
        fe.timer.resolve(wait=True)
        for name, ms in fe.timer.ms.items():
            totals[name] = totals.get(name, 0.0) + ms
        job.take(fe)
        del fe
        if cut:
            break
    for name, ms in tap.excluded_ms.items():
        totals[name] = totals.get(name, 0.0) - ms
    return Window(scans=scans, seconds=t_last - t0, latencies_s=lat,
                  stage_ms=totals, stage_scans=scans - tap.traced_frames,
                  jobs=jobs)
