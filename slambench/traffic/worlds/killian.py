"""The 60 x 40 m two-ring corridor building of the CARMEN-format
fixtures (MIT-Killian class): 4 m corridors whose walls carry door
alcoves at seeded intervals (the world's own seed, 21, fixed), corner
pillars, and up to three people walking to and fro along corridor
lines. The path is the fixtures' nested tour (~630 m, ~3170 frames at
0.2 m): ring A counter-clockwise, ring B, ring A clockwise, the outer
lap, park."""

from __future__ import annotations

import numpy as np

from slambench.traffic.generator import rect, wrap_deg

WORLD_SEED = 21


def _wall_with_alcoves(x0, y0, x1, y1, rng, inward, every=(4.0, 8.0),
                       depth=(0.5, 1.1), width=(0.8, 1.6)):
    """An axis-aligned wall broken by door-alcove notches at random
    intervals; `inward` is the unit normal the notch recedes along."""
    segs = []
    p0 = np.array([x0, y0], float)
    p1 = np.array([x1, y1], float)
    L = float(np.hypot(*(p1 - p0)))
    u = (p1 - p0) / L
    nrm = np.asarray(inward, float)
    s = float(rng.uniform(*every))
    last = 0.0
    while s + width[1] < L:
        w = float(rng.uniform(*width))
        d = float(rng.uniform(*depth))
        a = p0 + u * s
        b = p0 + u * (s + w)
        segs.append([*(p0 + u * last), *a])           # wall up to notch
        segs.append([*a, *(a + nrm * d)])              # notch side
        segs.append([*(a + nrm * d), *(b + nrm * d)])  # notch back
        segs.append([*(b + nrm * d), *b])              # notch side
        last = s + w
        s += w + float(rng.uniform(*every))
    segs.append([*(p0 + u * last), *p1])
    return segs


def segments() -> np.ndarray:
    rng = np.random.default_rng(WORLD_SEED)
    segs = []
    # outer shell (notches recede outward, away from the corridor)
    segs += _wall_with_alcoves(0, 0, 60, 0, rng, (0, -1))
    segs += _wall_with_alcoves(60, 0, 60, 40, rng, (1, 0))
    segs += _wall_with_alcoves(60, 40, 0, 40, rng, (0, 1))
    segs += _wall_with_alcoves(0, 40, 0, 0, rng, (-1, 0))
    # west block (4,4)-(28,36); notches recede into the block
    segs += _wall_with_alcoves(4, 4, 28, 4, rng, (0, 1))
    segs += _wall_with_alcoves(28, 4, 28, 36, rng, (-1, 0))
    segs += _wall_with_alcoves(28, 36, 4, 36, rng, (0, -1))
    segs += _wall_with_alcoves(4, 36, 4, 4, rng, (1, 0))
    # east block (32,4)-(56,36)
    segs += _wall_with_alcoves(32, 4, 56, 4, rng, (0, 1))
    segs += _wall_with_alcoves(56, 4, 56, 36, rng, (-1, 0))
    segs += _wall_with_alcoves(56, 36, 32, 36, rng, (0, -1))
    segs += _wall_with_alcoves(32, 36, 32, 4, rng, (1, 0))
    # corner pillars hugging corridor walls, off the driven centre lines
    for (px, py) in [(28.7, 16.0), (31.3, 28.0), (14.0, 39.3), (46.0, 0.7)]:
        segs += rect(px - 0.25, py - 0.25, px + 0.25, py + 0.25)
    return np.asarray(segs, dtype=np.float64)


def _rounded_waypoint_path(waypoints, r: float, step: float) -> np.ndarray:
    """Uniform-step samples [n,3] (x, y, theta_deg) along an axis-aligned
    polyline with quarter-circle fillets at the corners."""
    pieces = []
    W = [np.asarray(w, float) for w in waypoints]
    cursor = W[0]
    for k in range(1, len(W) - 1):
        u = W[k] - W[k - 1]; u /= np.hypot(*u)
        v = W[k + 1] - W[k]; v /= np.hypot(*v)
        cross = u[0] * v[1] - u[1] * v[0]
        if abs(cross) < 1e-9:          # collinear: no corner here
            continue
        a = W[k] - u * r               # fillet tangent points (90 deg)
        b = W[k] + v * r
        c = a + np.array([-u[1], u[0]]) * r * np.sign(cross)
        pieces.append(("line", cursor, a))
        a0 = np.arctan2(*(a - c)[::-1])
        a1 = a0 + np.sign(cross) * np.pi / 2.0
        pieces.append(("arc", c, a0, a1, np.sign(cross)))
        cursor = b
    pieces.append(("line", cursor, W[-1]))

    out = []
    carry = 0.0
    for p in pieces:
        if p[0] == "line":
            _, a, b = p
            L = float(np.hypot(*(b - a)))
            if L < 1e-9:
                continue
            u = (b - a) / L
            th = np.degrees(np.arctan2(u[1], u[0]))
            s = carry
            while s < L:
                q = a + u * s
                out.append((q[0], q[1], th))
                s += step
            carry = s - L
        else:
            _, c, a0, a1, sign = p
            L = abs(a1 - a0) * r
            s = carry
            while s < L:
                ang = a0 + sign * s / r
                q = c + r * np.array([np.cos(ang), np.sin(ang)])
                th = np.degrees(ang + sign * np.pi / 2.0)
                out.append((q[0], q[1], th))
                s += step
            carry = s - L
    arr = np.asarray(out, dtype=np.float64)
    arr[:, 2] = [wrap_deg(v) for v in arr[:, 2]]
    return arr


def path(n: int, step: float = 0.2) -> np.ndarray:
    """The first n poses of the tour (all of it for n = 0)."""
    W = [(10, 2), (30, 2), (30, 38), (2, 38), (2, 2),      # ring A ccw
         (30, 2), (58, 2), (58, 38), (30, 38), (30, 2),    # ring B ccw
         (2, 2), (2, 38), (30, 38), (30, 2),               # ring A cw
         (2, 2), (2, 38), (58, 38), (58, 2), (2, 2),       # outer cw
         (2, 20)]                                          # park
    tour = _rounded_waypoint_path(W, r=1.5, step=step)
    if n > len(tour):
        raise ValueError(f"{n} frames asked of a {len(tour)}-frame tour")
    return tour[:n] if n else tour


def movers_at(frame: int, n_movers: int) -> list:
    """Walls of the moving people (0.4 m squares walking a triangle wave
    along corridor lines) at a frame."""
    routes = [
        ((12.0, 3.0), (20.0, 3.0), 0.13),    # bottom corridor, west
        ((29.0, 10.0), (29.0, 25.0), 0.11),  # middle corridor
        ((35.0, 37.0), (50.0, 37.0), 0.17),  # top corridor, east
    ]
    if n_movers > len(routes):
        raise ValueError(f"at most {len(routes)} movers")
    segs = []
    for (a, b, speed) in routes[:n_movers]:
        a = np.asarray(a); b = np.asarray(b)
        L = float(np.hypot(*(b - a)))
        s = (frame * speed) % (2 * L)
        s = s if s <= L else 2 * L - s
        p = a + (b - a) * (s / L)
        segs += rect(p[0] - 0.2, p[1] - 0.2, p[0] + 0.2, p[1] + 0.2)
    return segs
