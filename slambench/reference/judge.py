"""The judge: the outputs of a window held against the reference.

Two runs of this SLAM system part for good at a bistable frame (a
registration whose two nearest optima score alike), so the reference
follows the system under test frame by frame: it keeps its own map and
graph, built from the log's scans at the poses the system reported. At
a judged frame it registers the scan itself, from the reported previous
pose and covariance against its own target, and compares the fused
pose, the covariance and the accept flag; at a snapshot frame it
compares its own target with the one the system's frame met; at a
judged check it verifies its own candidates and compares the edges
accepted there; at a judged correction it solves its own graph (the
reported poses and edges) and compares the corrected trajectory. Then it
takes the reported pose, covariance, edges and corrected trajectory and
goes on, so that a fork at one frame spoils no later one.

Judged are the first frame of the window, every frame whose map step
closes a submap or that follows a close or a correction, and a sample
drawn from the seed. A frame of a later job is held to the reference's
answer at the same frame of the followed job: the jobs repeat the log
from the same start."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from slambench.reference.cloud import nn_sq
from slambench.reference.frontend import RefFrontEnd, config
from slambench.reference.geometry import wrap_deg
from slambench.yardstick.stats import percentile

NEAR_M = 1e-3        # a target point with a counterpart this close agrees
OFF_M = 0.05         # a registration farther off than this is counted


class Verdict:
    """The numbers of a judged window: the widest gap of each kind, the
    median and the 90th percentile of the per-frame and per-edge gaps
    (`<name>_p50`, `<name>_p90`) and the counts."""

    def __init__(self):
        self.numbers: Dict[str, float] = {}
        self.frames: Dict[str, List[float]] = {}
        self.notes: List[str] = []
        self.counts: Dict[tuple, tuple] = {}
        self.judged = 0
        self.checks = 0

    def worst(self, name: str, value: float):
        v = float(value)
        self.numbers[name] = max(self.numbers.get(name, 0.0),
                                 math.inf if math.isnan(v) else v)

    def add(self, name: str, value: float = 1.0):
        self.numbers[name] = self.numbers.get(name, 0.0) + value

    def frame(self, name: str, value: float):
        self.worst(name, value)
        self.frames.setdefault(name, []).append(
            math.inf if math.isnan(value) else float(value))

    def finish(self):
        for name, vals in self.frames.items():
            self.numbers[name + "_p50"] = percentile(vals, 50.0)
            self.numbers[name + "_p90"] = percentile(vals, 90.0)


def _pick(rng, items: List[int], k: int) -> set:
    items = sorted(set(items))
    if k >= len(items):
        return set(items)
    return set(int(v) for v in rng.choice(items, size=k, replace=False))


def judge(run, window, names) -> Verdict:
    """Hold the window's jobs against the reference. `names`: the
    numbers this cell compares (the keys of its limits)."""
    spec = run.work["judge"]
    cfg = config(run.config["slam"])
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(run.seed) % (1 << 64), 1]))
    v = Verdict()
    for name in names:
        v.numbers[name] = 0.0
    traced = set(range(run.tap.start, run.tap.stop)) if run.trace else set()
    answers = {}
    for job in window.jobs:
        if job.index == 0:
            answers = _follow(run, cfg, job, spec, rng, traced, v)
    for job in window.jobs:
        if job.index == 0:
            continue
        for k, ref in answers.items():
            if job.record(k) is not None:
                _compare_frame(v, job, k, ref)
    v.finish()
    v.notes.append("numbers " + ", ".join(
        f"{k} {x:.6g}" for k, x in sorted(v.numbers.items())))
    return v


def _follow(run, cfg, job, spec, rng, traced, v) -> dict:
    log = run.logs[job.log]
    f = RefFrontEnd(cfg, run.device)
    first = job.first
    pre = run.prefix if first else None
    n = first + job.done
    rec_of = (lambda k: pre.records[k] if k < first
              else job.records[k - first])
    judged = {first} | _pick(rng, list(range(first, n)), int(spec["frames"]))
    edges = {}
    for e in job.loop_edges:
        edges.setdefault(int(e[1]), []).append(e)
    accepted = {}
    for e in job.edge_log:
        accepted.setdefault(int(e["sid_new"]), {})[int(e["sid_old"])] = \
            np.asarray(e["z_rad"], np.float64)
    corr = dict((pre.corrections if pre is not None else [])
                + job.corrections)
    mine_corr = [k for k in corr if k >= first]
    solve = _pick(rng, mine_corr, max(1, round(
        spec.get("corrections", 0.0) * len(mine_corr))))
    check_share = float(spec.get("checks", 0.0))
    with_candidates = special = 0
    answers = {}
    spent = dict(register=0.0, map=0.0, check=0.0, solve=0.0, rewrite=0.0)
    clock = time.perf_counter
    for k in range(n):
        rec = rec_of(k)
        scan = f.scan(log.scans[job.start + k])
        odo = log.odo[job.start + k]
        fused = np.asarray(rec["fused_pose"], np.float32)
        if k in traced:
            v.counts[(job.row, k)] = f.counts(scan)
        if k in job.targets:
            _compare_target(v, f.map.target(), job.targets[k])
        if k == 0:
            ref = (np.asarray(odo, np.float64), np.zeros((3, 3)), True)
        elif k >= first and (k in judged or f.map.closes_next(fused)):
            t0 = clock()
            r = f.register(scan, odo)
            ref = (r.fused, r.cov, r.accept)
            spent["register"] += clock() - t0
        else:
            ref = None
        if ref is not None and k >= first:
            answers[k] = ref
            _compare_frame(v, job, k, ref)
        closes = k > 0 and f.map.closes_next(fused)
        t0 = clock()
        f.commit(k, scan, odo, fused, job.covs[k])
        spent["map"] += clock() - t0
        t0 = clock()
        if f.check_due():
            cand = f.graph.candidates(fused, k)
            with_candidates += bool(cand) and k >= first
            if k >= first and cand and rng.random() < check_share:
                mine = f.graph.check(k, fused, scan, cand)
                _compare_check(v, {s: z for s, (z, _) in mine.items()},
                               accepted.get(k, {}))
            f.graph.loops += [(int(i), int(j), np.asarray(z, np.float32),
                               np.asarray(om, np.float32))
                              for i, j, z, om in edges.get(k, [])]
        spent["check"] += clock() - t0
        if k in corr:
            poses = np.asarray(corr[k], np.float32)
            t0 = clock()
            if k in solve:
                mine = f.graph.solve()
                d = np.hypot(*(mine[:, :2] - poses[:, :2]).T)
                v.worst("correction_gap_m", d.max())
                v.notes.append(f"correction at frame {k}: {len(poses)} "
                               f"nodes, largest gap {d.max():.6g} m")
            spent["solve"] += clock() - t0
            t0 = clock()
            f.correct(poses)
            spent["rewrite"] += clock() - t0
        if (closes or k in corr) and first <= k + 1 < n and \
                k + 1 not in judged:
            judged.add(k + 1)
            special += 1
    v.notes.append(f"followed {n} frames ({first} mapped in set-up), "
                   f"judged {len(answers)} registrations ({special} after "
                   f"a close or a correction), {len(job.targets)} targets, "
                   f"{v.checks} of {with_candidates} checks with "
                   f"candidates, {len(solve & set(mine_corr))} of "
                   f"{len(mine_corr)} corrections; seconds " + ", ".join(
                       f"{k} {x:.3f}" for k, x in spent.items()))
    return answers


def _compare_frame(v: Verdict, job, k: int, ref: tuple):
    rec = job.record(k)
    fused, cov, accept = ref
    p = np.asarray(rec["fused_pose"], np.float64)
    gap = math.hypot(p[0] - fused[0], p[1] - fused[1])
    v.frame("pose_gap_m", gap)
    v.frame("pose_gap_deg", abs(wrap_deg(p[2] - fused[2])))
    c = np.asarray(job.covs[k], np.float64)
    v.frame("cov_gap", np.linalg.norm(c - cov)
            / max(np.linalg.norm(cov), 1e-12))
    v.add("accept_mismatches", float(bool(rec["successful"]) != accept))
    v.add("frames_off_5cm", float(not gap <= OFF_M))
    v.judged += 1


def _compare_target(v: Verdict, ref: torch.Tensor, prog: tuple):
    """The share of points, on either side, with no counterpart on the
    other within NEAR_M (the worse side), and the gap in their counts."""
    xy, mask = prog
    mine = xy[mask].to(ref.device)
    n_p, n_r = len(mine), len(ref)
    v.worst("target_count_gap", abs(n_p - n_r) / max(n_r, 1))
    if not n_p or not n_r:
        v.worst("target_miss_share", float(n_p != n_r))
        return
    near = NEAR_M * NEAR_M
    miss = max(float((nn_sq(mine, ref) > near).double().mean()),
               float((nn_sq(ref, mine) > near).double().mean()))
    v.worst("target_miss_share", miss)


def _compare_check(v: Verdict, mine: dict, prog: dict):
    """The edges of one check: the gap between the relative poses of
    each edge both sides accepted, and the count of edges only one side
    accepted."""
    v.checks += 1
    v.add("loop_set_gap", len(set(mine) ^ set(prog)))
    for s in set(mine) & set(prog):
        d = np.asarray(mine[s], np.float64) - prog[s]
        v.frame("loop_edge_gap_m", math.hypot(d[0], d[1]))
