"""Poses, point transforms and scan resampling of the reference.

A pose is (x, y, heading in degrees), as the program's records give it.
The configuration states float32: points are stored in float32, and the
arithmetic that decides a discrete outcome (which voxel or cell a point
falls in) is done on those float32 values; everything else is float64.
Written from the semantics of the upstream front end (hibikid39/ndt_slam
`ScanMatcher`/`PoseFuser`), not from the program's code."""

from __future__ import annotations

import math

import numpy as np
import torch


def wrap_deg(a):
    """Angle(s) in degrees wrapped to [-180, 180)."""
    return (a + 180.0) % 360.0 - 180.0


def wrap_rad(a):
    return (a + math.pi) % (2.0 * math.pi) - math.pi


def motion(cur, prev) -> np.ndarray:
    """cur relative to prev, in prev's frame (float64, degrees)."""
    cur = np.asarray(cur, np.float64)
    prev = np.asarray(prev, np.float64)
    d = cur[:2] - prev[:2]
    c, s = math.cos(math.radians(prev[2])), math.sin(math.radians(prev[2]))
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     wrap_deg(cur[2] - prev[2])])


def compose(last, mot) -> np.ndarray:
    """The motion `mot` (in last's frame) applied after `last`."""
    last = np.asarray(last, np.float64)
    mot = np.asarray(mot, np.float64)
    c, s = math.cos(math.radians(last[2])), math.sin(math.radians(last[2]))
    return np.array([c * mot[0] - s * mot[1] + last[0],
                     s * mot[0] + c * mot[1] + last[1],
                     wrap_deg(last[2] + mot[2])])


def to_map(pose_deg, xy: torch.Tensor) -> torch.Tensor:
    """Sensor-frame points [..., N, 2] (float32) into the map frame of
    `pose_deg`, computed in float64 and stored as float32."""
    p = np.asarray(pose_deg, np.float64)
    c, s = math.cos(math.radians(p[2])), math.sin(math.radians(p[2]))
    x = xy[..., 0].double()
    y = xy[..., 1].double()
    return torch.stack([c * x - s * y + p[0], s * x + c * y + p[1]],
                       -1).float()


def resample(xy: np.ndarray, space: float, thre: float,
             cap: int) -> np.ndarray:
    """Arc-length resampling of a scan polyline: a point every `space`
    metres along it, a gap of `thre` or more kept as a jump (the point
    after it is kept as measured); at most `cap` points (float32)."""
    pts = np.asarray(xy, np.float64).reshape(-1, 2)
    if not len(pts):
        return np.zeros((0, 2), np.float32)
    out = [pts[0]]
    last = pts[0]
    run = 0.0
    i = 1
    while i < len(pts):
        seg = pts[i] - last
        length = math.hypot(seg[0], seg[1])
        if run + length < space:          # too close: skip the point
            run += length
            last = pts[i]
            i += 1
        elif run + length >= thre:        # a jump: keep the point itself
            out.append(pts[i])
            last = pts[i]
            run = 0.0
            i += 1
        else:                             # place a point on the segment
            last = last + seg * ((space - run) / length)
            out.append(last)
            run = 0.0
    return np.asarray(out, np.float32)[:cap]
