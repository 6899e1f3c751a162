"""CARMEN log reader (FLASER / ROBOTLASER1 lines), numpy only.

The same parser as `ndt_slam_tpu.io.carmen`: one frame per laser line,
ranges to sensor-frame points, the LASER pose (x y theta) as the
frame's odometry with the heading in degrees. FLASER carries no
geometry header, so `num_readings` beams spanning `fov_rad` are
assumed, beam 0 at -fov/2; ROBOTLASER1 declares its own. Ranges at or
beyond `max_range` (or below 0.05 m) are dropped.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ndt_slam_tpu_torch.io.tsukuba import LogFrame


def _points_from_ranges(
    r: np.ndarray, angles: np.ndarray, max_range: float
) -> np.ndarray:
    ok = (r > 0.05) & (r < max_range)
    return np.stack(
        [r[ok] * np.cos(angles[ok]), r[ok] * np.sin(angles[ok])],
        axis=1,
    ).astype(np.float32)


def read_carmen_log(
    path: str,
    max_range: float = 50.0,
    fov_rad: float = np.pi,
    max_frames: Optional[int] = None,
) -> List[LogFrame]:
    """Parse FLASER / ROBOTLASER1 lines into LogFrames (one per scan)."""
    frames: List[LogFrame] = []
    sid = 0
    with open(path, "r") as f:
        for line in f:
            if max_frames is not None and sid >= max_frames:
                break
            if line.startswith("FLASER"):
                tok = line.split()
                n = int(tok[1])
                if len(tok) < 2 + n + 6:
                    continue  # truncated line
                r = np.asarray(tok[2:2 + n], dtype=np.float64)
                x, y, th = (float(v) for v in tok[2 + n:5 + n])
                angles = (
                    -fov_rad / 2.0 + fov_rad * np.arange(n) / max(n - 1, 1)
                )
                cutoff = max_range
            elif line.startswith("ROBOTLASER1"):
                tok = line.split()
                start_angle = float(tok[2])
                ang_res = float(tok[4])
                sensor_max = float(tok[5])
                n = int(tok[8])
                if len(tok) < 9 + n + 1:
                    continue
                r = np.asarray(tok[9:9 + n], dtype=np.float64)
                n_rem = int(tok[9 + n])
                base = 10 + n + n_rem
                if len(tok) < base + 6:
                    continue
                x, y, th = (float(v) for v in tok[base:base + 3])
                angles = start_angle + ang_res * np.arange(n)
                cutoff = min(max_range, sensor_max - 1e-3)
            else:
                continue
            pts = _points_from_ranges(r, angles, cutoff)
            frames.append(LogFrame(
                stamp=sid,
                odo_pose=np.array(
                    [x, y, np.degrees(th)], dtype=np.float32
                ),
                scan_xy=pts,
            ))
            sid += 1
    return frames


def read_carmen_gt(path: str) -> np.ndarray:
    """Ground-truth companion file: one "tx ty theta_deg" per frame."""
    poses = np.loadtxt(path, dtype=np.float64)
    if poses.ndim == 1:
        poses = poses[None, :]
    if poses.shape[1] != 3:
        raise ValueError(f"{path}: expected 3 columns, got {poses.shape}")
    return poses
