"""A fleet's logs mapped together by the program's lockstep batch runner
(`BatchFrontEnd(cfg, B, device).process_batch`), as a closed loop: each
tick hands over one scan of every row once the last tick's records have
returned.

Each of the traffic's `jobs` is one row: a segment of one of its logs.
Every row runs one job, and every row starts at tick 0, so that a row's
frame number is the tick. A row whose segment ends idles (its entry is
None) and starts no second job. Latency is a tick's; scans count
row by row. The stage totals are the runner's tick stages, and its
counters (`BatchFrontEnd.counts()`, where the program has them) are
left on the window as `counts`.

Under the control (`--control bf16`) each row's reference front end is
advanced one frame a tick in the runner's place; that run only sets the
output check's limits."""

from __future__ import annotations

import time

from slambench.record import Job, Window


class _Rows:
    """The control's front ends driven as the lockstep's rows."""

    def __init__(self, run, n: int):
        self.frontends = [run.system.FrontEnd(run.cfg, run.device)
                          for _ in range(n)]
        self.timer = run.system.StageTimer(run.device)

    def process_batch(self, scans, odos):
        return [None if s is None else fe.process(s, o)
                for fe, s, o in zip(self.frontends, scans, odos)]

    def stacked_target(self, i):
        return None

    def finalize(self):
        for fe in self.frontends:
            fe.finalize()


def _runner(run):
    n = int(run.config["rows"])
    if len(run.work["jobs"]) != n:
        raise ValueError(f"{len(run.work['jobs'])} jobs in the traffic for "
                         f"the configuration's {n} rows")
    if run.system.name != "program":
        return _Rows(run, n)
    from ndt_slam_tpu_torch.pipeline.batch_runner import BatchFrontEnd
    return BatchFrontEnd(run.cfg, n, run.device)


def _segments(run):
    """Each row's (scans, odometry) as its log holds them."""
    out = []
    for spec in run.work["jobs"]:
        log = run.logs[spec["log"]]
        a, n = int(spec["start"]), int(spec["frames"])
        out.append((log.scans[a:a + n], log.odo[a:a + n]))
    return out


def _tick(bfe, rows, k):
    live = [k < len(scans) for scans, _ in rows]
    return bfe.process_batch(
        [scans[k] if ok else None for (scans, _), ok in zip(rows, live)],
        [odo[k] if ok else None for (_, odo), ok in zip(rows, live)])


def warmup(run) -> dict:
    """Drive a throwaway runner over the traffic's warm-up slices of
    every row: the kernels built, the map-step variants touched once
    (`FrontEnd.warmup`), then the batched step, the handed-back rows'
    path and the stack's re-init as the slices reach them."""
    run.base = run.prefix = None
    rows = _segments(run)
    if run.system.name != "program":
        return {"rows": len(rows), "ticks": 0}
    bfe = _runner(run)
    bfe.frontends[0].warmup()
    n = 0
    for a, b in run.work["warmup"]:
        for k in range(a, b):
            _tick(bfe, rows, k)
            n += 1
    bfe.finalize()
    run.sync()
    return {"rows": len(rows), "ticks": n,
            "counts": bfe.counts() if hasattr(bfe, "counts") else None}


def window(run) -> Window:
    tap = run.tap
    rows = _segments(run)
    jobs = [Job(0, r, spec["log"], int(spec["start"]), int(spec["frames"]))
            for r, spec in enumerate(run.work["jobs"])]
    lat = []
    scans = traced = 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    bfe = _runner(run)
    t_last = time.perf_counter()
    k = 0
    while time.perf_counter() < deadline:
        live = [k < job.length for job in jobs]
        if not any(live):
            break
        tap.before(0, k, bfe.timer)
        if tap.snapshot_due(0, k):
            for i, job in enumerate(jobs):
                if live[i]:
                    t = (bfe.stacked_target(i)
                         or bfe.frontends[i].pcmap.registration_target())
                    job.targets[k] = (t.xy.clone(), t.mask.clone())
        ta = time.perf_counter()
        recs = _tick(bfe, rows, k)
        t_last = time.perf_counter()
        lat.append(t_last - ta)
        n = 0
        for job, rec in zip(jobs, recs):
            if rec is not None:
                job.records.append(rec)
                n += 1
        scans += n
        if tap.trace and tap.start <= k < tap.stop:
            traced += n
        k += 1
    tap.end()
    bfe.finalize()
    for job, fe in zip(jobs, bfe.frontends):
        job.complete = job.done == job.length
        job.take(fe)
    totals = dict(bfe.timer.ms)
    for name, ms in tap.excluded_ms.items():
        totals[name] = totals.get(name, 0.0) - ms
    w = Window(scans=scans, seconds=t_last - t0, latencies_s=lat,
               stage_ms=totals, stage_scans=scans - traced, jobs=jobs)
    w.counts = bfe.counts() if hasattr(bfe, "counts") else None
    stages = {name: round(ms, 3) for name, ms in totals.items()}
    print(f"[lockstep] {len(jobs)} rows, {k} ticks, counts {w.counts}, "
          f"stage ms outside the traced span {stages}", flush=True)
    return w
