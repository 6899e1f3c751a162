"""Evaluation and per-frame records: ATE, RPE and JSONL writers."""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np

from ndt_slam_tpu_torch.core.angles import wrap_deg


def ate_rmse(est_poses: np.ndarray, true_poses: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE over positions), with optional
    SE(2) Umeyama alignment (rotation+translation, no scale)."""
    e = np.asarray(est_poses, dtype=np.float64)[:, :2]
    t = np.asarray(true_poses, dtype=np.float64)[:, :2]
    if e.shape != t.shape or len(e) == 0:
        raise ValueError(f"trajectory shapes differ: {e.shape} vs {t.shape}")
    if align and len(e) >= 2:
        mu_e, mu_t = e.mean(0), t.mean(0)
        E, T = e - mu_e, t - mu_t
        H = E.T @ T
        U, _S, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        D = np.diag([1.0, d])
        R = Vt.T @ D @ U.T
        e = (R @ E.T).T + mu_t
    d = e - t
    return float(np.sqrt((d ** 2).sum(axis=1).mean()))


def rpe_rmse(est_poses: np.ndarray, true_poses: np.ndarray,
             delta: int = 1) -> tuple[float, float]:
    """Relative pose error over `delta`-frame intervals.
    Returns (trans RMSE [m], rot RMSE [deg])."""
    e = np.asarray(est_poses, dtype=np.float64)
    t = np.asarray(true_poses, dtype=np.float64)
    n = len(e) - delta
    if n <= 0 or e.shape != t.shape:
        raise ValueError(f"need more than {delta} poses of one shape: "
                         f"{e.shape} vs {t.shape}")
    errs_t, errs_r = [], []
    for i in range(n):
        de = _rel(e[i], e[i + delta])
        dt = _rel(t[i], t[i + delta])
        errs_t.append(np.hypot(de[0] - dt[0], de[1] - dt[1]))
        errs_r.append(abs(wrap_deg(de[2] - dt[2])))
    return (
        float(np.sqrt(np.mean(np.square(errs_t)))),
        float(np.sqrt(np.mean(np.square(errs_r)))),
    )


def _rel(a, b):
    """Pose b in the frame of pose a (deg)."""
    c, s = np.cos(np.radians(a[2])), np.sin(np.radians(a[2]))
    dx, dy = b[0] - a[0], b[1] - a[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy,
                     float(wrap_deg(b[2] - a[2]))])


class JsonlWriter:
    """One JSON record a line; `append` keeps what the file holds (a
    resumed run goes on writing where the interrupted one stopped)."""

    def __init__(self, path: Optional[str], append: bool = False):
        self.path = path
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a" if append else "w") if path else None

    def write(self, rec: dict):
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


def write_jsonl(path: str, records: Iterable[dict]):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
