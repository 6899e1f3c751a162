"""Statistics of the benchmark's numbers."""

from __future__ import annotations

import math
import statistics
from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of values by the nearest rank: the
    smallest value with at least q % of the values at or below it, so it
    is always one of the values measured."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[rank - 1])


def quartile_spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (`statistics.quantiles(values, n=4)`)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def ate_rmse(est: np.ndarray, true: np.ndarray) -> float:
    """Absolute trajectory error: RMSE of positions after the SE(2)
    alignment (rotation and translation, no scale) of est onto true."""
    e = np.asarray(est, dtype=np.float64)[:, :2]
    t = np.asarray(true, dtype=np.float64)[:, :2]
    if e.shape != t.shape or len(e) == 0:
        raise ValueError(f"trajectory shapes differ: {e.shape} vs {t.shape}")
    if len(e) >= 2:
        mu_e, mu_t = e.mean(0), t.mean(0)
        E, T = e - mu_e, t - mu_t
        U, _s, Vt = np.linalg.svd(E.T @ T)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, d]) @ U.T
        e = (R @ E.T).T + mu_t
    return float(np.sqrt(((e - t) ** 2).sum(axis=1).mean()))


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]
