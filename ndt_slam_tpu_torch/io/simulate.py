"""Synthetic 2D LiDAR world simulator, numpy only.

Raycast scans of a segment world from a smooth trajectory, plus
drifting odometry, so that tests and benchmarks can measure ATE against
exact ground truth. The same generator as `ndt_slam_tpu.io.simulate`:
one seed gives the same frames in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

import numpy as np

from ndt_slam_tpu_torch.core.angles import wrap_deg


@dataclass
class World:
    """Segment soup: each wall is (x1, y1, x2, y2)."""
    segments: np.ndarray  # [M,4]
    movers: List["Mover"] = field(default_factory=list)

    def segments_at(self, t: float) -> np.ndarray:
        segs = [self.segments]
        for m in self.movers:
            segs.append(m.segments_at(t))
        return np.concatenate(segs, axis=0)


@dataclass
class Mover:
    """A moving square obstacle (exercises dynamic-object removal)."""
    start: np.ndarray      # [2]
    velocity: np.ndarray   # [2] per frame
    size: float = 0.6
    t_on: float = 0.0
    t_off: float = 1e9

    def segments_at(self, t: float) -> np.ndarray:
        if not (self.t_on <= t < self.t_off):
            return np.zeros((0, 4))
        c = self.start + self.velocity * t
        h = self.size / 2.0
        x0, y0, x1, y1 = c[0] - h, c[1] - h, c[0] + h, c[1] + h
        return np.array(
            [[x0, y0, x1, y0], [x1, y0, x1, y1],
             [x1, y1, x0, y1], [x0, y1, x0, y0]]
        )


def _rect(x0, y0, x1, y1):
    return [
        [x0, y0, x1, y0], [x1, y0, x1, y1],
        [x1, y1, x0, y1], [x0, y1, x0, y0],
    ]


def default_world() -> World:
    """Rooms + partial walls + pillars: enough structure that NDT
    registration is well-conditioned in every direction. All interior
    geometry stays clear of the default figure-eight trajectory band
    (|x| <= 4.6, |y| <= 1.8)."""
    segs = []
    segs += _rect(-8.0, -6.0, 8.0, 6.0)            # outer walls
    segs += _rect(-2.5, -6.0, -2.0, -2.5)          # wall with doorway
    segs += _rect(2.0, 2.5, 2.5, 6.0)
    segs += _rect(-6.0, 2.5, -5.0, 3.5)            # pillars
    segs += _rect(5.0, -4.5, 6.0, -3.5)
    segs += _rect(-6.5, -4.5, -5.5, -3.5)
    segs += _rect(5.5, 3.0, 6.5, 4.0)
    return World(segments=np.asarray(segs, dtype=np.float64))


def raycast(world_segs: np.ndarray, origin: np.ndarray, angles: np.ndarray,
            max_range: float = 25.0) -> np.ndarray:
    """Vectorized segment raycast. Returns ranges [B] (inf if no hit)."""
    ox, oy = origin
    dx = np.cos(angles)[:, None]                   # [B,1]
    dy = np.sin(angles)[:, None]
    x1, y1, x2, y2 = (world_segs[:, i][None, :] for i in range(4))  # [1,M]
    ex, ey = x2 - x1, y2 - y1
    denom = dx * ey - dy * ex                      # [B,M]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ((x1 - ox) * ey - (y1 - oy) * ex) / denom     # ray param
        u = ((x1 - ox) * dy - (y1 - oy) * dx) / denom     # segment param
    hit = (np.abs(denom) > 1e-12) & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    r = t.min(axis=1)
    return np.where(r <= max_range, r, np.inf)


class Frame(NamedTuple):
    sid: int
    true_pose: np.ndarray   # [3] deg
    odo_pose: np.ndarray    # [3] deg (drifting)
    scan_xy: np.ndarray     # [n,2] sensor frame


def _figure_eight(n: int, scale=4.5):
    """Smooth closed trajectory with heading along the tangent."""
    s = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = scale * np.sin(s)
    y = 0.75 * scale * np.sin(s) * np.cos(s)
    th = np.degrees(np.arctan2(np.gradient(y), np.gradient(x)))
    return np.stack([x, y, th], axis=1)


def simulate_sequence(
    n_frames: int = 120,
    beams: int = 541,
    fov_deg: float = 270.0,
    noise_range: float = 0.01,
    odo_noise_v: float = 0.02,
    odo_noise_w: float = 0.5,
    seed: int = 0,
    world: World | None = None,
    trajectory: np.ndarray | None = None,
    max_range: float = 25.0,
) -> List[Frame]:
    """Generate frames with ground truth, drifting odometry, and scans.

    Odometry drift: per-frame relative motion perturbed by Gaussian
    noise proportional to the motion (plus a small floor), integrated —
    the classic dead-reckoning error model.
    """
    rng = np.random.default_rng(seed)
    w = world or default_world()
    traj = trajectory if trajectory is not None else _figure_eight(n_frames)
    if traj.shape[0] < n_frames:
        raise ValueError(f"trajectory has {traj.shape[0]} poses, "
                         f"{n_frames} frames asked for")

    rel_angles = np.radians(
        np.linspace(-fov_deg / 2.0, fov_deg / 2.0, beams)
    )
    frames: List[Frame] = []
    odo = traj[0].astype(np.float64).copy()
    for i in range(n_frames):
        tp = traj[i]
        segs = w.segments_at(float(i))
        th_rad = np.radians(tp[2])
        r = raycast(segs, tp[:2], rel_angles + th_rad, max_range)
        ok = np.isfinite(r)
        rr = r[ok] + noise_range * rng.standard_normal(ok.sum())
        a = rel_angles[ok]
        scan = np.stack([rr * np.cos(a), rr * np.sin(a)], axis=1)

        if i > 0:
            # true relative motion in previous true frame
            p_prev, p_cur = traj[i - 1], traj[i]
            c, s = np.cos(np.radians(p_prev[2])), np.sin(np.radians(p_prev[2]))
            dxw = p_cur[0] - p_prev[0]
            dyw = p_cur[1] - p_prev[1]
            mx = c * dxw + s * dyw
            my = -s * dxw + c * dyw
            mth = float(wrap_deg(p_cur[2] - p_prev[2]))
            # corrupt
            d = np.hypot(mx, my)
            mx += rng.standard_normal() * (odo_noise_v * d + 1e-4)
            my += rng.standard_normal() * (odo_noise_v * d + 1e-4)
            mth += rng.standard_normal() * (odo_noise_w * abs(mth) / 57.3 + 0.02)
            # integrate onto odo pose
            co, so = np.cos(np.radians(odo[2])), np.sin(np.radians(odo[2]))
            odo = np.array([
                odo[0] + co * mx - so * my,
                odo[1] + so * mx + co * my,
                float(wrap_deg(odo[2] + mth)),
            ])
        frames.append(Frame(
            sid=i,
            true_pose=tp.astype(np.float32),
            odo_pose=odo.astype(np.float32).copy(),
            scan_xy=scan.astype(np.float32),
        ))
    return frames
