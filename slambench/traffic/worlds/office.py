"""The 26 x 20 m office ring of the CARMEN-format fixtures: outer walls,
an inner block with two doorways, interior texture seen through them,
alcoves and corner pillars; the path is the corridor's rounded-rectangle
centre line, counter-clockwise, wrapping past one lap (~68 m a lap)."""

from __future__ import annotations

import numpy as np

from slambench.traffic.generator import rect, wall, wrap_deg


def segments() -> np.ndarray:
    segs = []
    segs += rect(0.0, 0.0, 26.0, 20.0)          # outer walls
    # inner block with two doorway gaps (south wall split, west wall split)
    segs += wall(5.0, 5.0, 11.0, 5.0)           # south, gap 11..12.5
    segs += wall(12.5, 5.0, 21.0, 5.0)
    segs += wall(21.0, 5.0, 21.0, 15.0)         # east
    segs += wall(21.0, 15.0, 5.0, 15.0)         # north
    segs += wall(5.0, 15.0, 5.0, 11.0)          # west, gap 11..9.5
    segs += wall(5.0, 9.5, 5.0, 5.0)
    # interior texture visible through the doorways
    segs += rect(9.0, 8.0, 10.0, 9.0)
    segs += rect(15.0, 10.5, 16.5, 11.5)
    # alcoves in the outer wall (break corridor symmetry)
    segs += wall(7.0, 0.0, 7.0, 1.0)
    segs += wall(7.0, 1.0, 9.0, 1.0)
    segs += wall(9.0, 1.0, 9.0, 0.0)
    segs += wall(26.0, 8.0, 25.0, 8.0)
    segs += wall(25.0, 8.0, 25.0, 12.0)
    segs += wall(25.0, 12.0, 26.0, 12.0)
    segs += wall(14.0, 20.0, 14.0, 18.8)
    segs += wall(0.0, 6.0, 1.2, 6.0)
    # pillars in the corridor corners
    segs += rect(2.3, 17.0, 2.9, 17.6)
    segs += rect(23.0, 2.4, 23.6, 3.0)
    segs += rect(12.2, 2.0, 12.8, 2.6)
    return np.asarray(segs, dtype=np.float64)


def path(n: int, step: float = 0.2) -> np.ndarray:
    """Rounded-rectangle centre line of the corridor, heading along the
    tangent: [n,3] (tx, ty, theta_deg)."""
    x0, y0, x1, y1, r = 2.5, 2.5, 23.5, 17.5, 1.5
    Lx = (x1 - x0) - 2 * r
    Ly = (y1 - y0) - 2 * r
    qa = 0.5 * np.pi * r
    total = 2 * Lx + 2 * Ly + 4 * qa

    def at(s):
        s = s % total
        if s < Lx:                                   # bottom straight ->
            return (x0 + r + s, y0, 0.0)
        s -= Lx
        if s < qa:                                   # corner at (x1-r, y0+r)
            a = s / r
            cx, cy = x1 - r, y0 + r
            return (cx + r * np.sin(a), cy - r * np.cos(a), np.degrees(a))
        s -= qa
        if s < Ly:                                   # right straight ^
            return (x1, y0 + r + s, 90.0)
        s -= Ly
        if s < qa:
            a = s / r
            cx, cy = x1 - r, y1 - r
            return (cx + r * np.cos(a), cy + r * np.sin(a),
                    90.0 + np.degrees(a))
        s -= qa
        if s < Lx:                                   # top straight <-
            return (x1 - r - s, y1, 180.0)
        s -= Lx
        if s < qa:
            a = s / r
            cx, cy = x0 + r, y1 - r
            return (cx - r * np.sin(a), cy + r * np.cos(a),
                    180.0 + np.degrees(a))
        s -= qa
        if s < Ly:                                   # left straight v
            return (x0, y1 - r - s, 270.0)
        s -= Ly
        a = s / r                                    # corner back to start
        cx, cy = x0 + r, y0 + r
        return (cx - r * np.cos(a), cy - r * np.sin(a), 270.0 + np.degrees(a))

    out = np.array([at(i * step) for i in range(n)], dtype=np.float64)
    out[:, 2] = [wrap_deg(v) for v in out[:, 2]]
    return out


def movers_at(frame: int, n_movers: int) -> list:
    if n_movers:
        raise ValueError("the office world has no movers")
    return []
