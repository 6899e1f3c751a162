#!/usr/bin/env python
"""Generate the committed CARMEN-format fixtures without JAX.

The counterpart of cli/make_carmen_fixture.py on the PyTorch package's
`core.angles.wrap_deg` and `io.simulate.raycast`: the same worlds,
trajectories, sensor and odometry models, the same numpy generator
draws in the same order and the same float formatting, so it writes the
committed files byte for byte:

  python cli/make_carmen_fixture_torch.py        # tests/data/office_loop.{clf,gt}
  python cli/make_carmen_fixture_torch.py --layout killian --frames 800 \
      --format robotlaser1 --name killian_robot
  python cli/make_carmen_fixture_torch.py --layout killian --frames 800 \
      --movers 3 --name killian_movers
  python cli/make_carmen_fixture_torch.py --layout killian --frames 0 \
      --name killian

Outputs (deterministic, seed pinned): <name>.clf, FLASER or ROBOTLASER1
lines under one comment header, and <name>.gt, the ground-truth
"tx ty theta_deg" of each frame.

World: a 26 x 20 m office ring (outer walls + inner block) with
doorway gaps, alcoves, and pillars; the robot drives ~1.4 laps of the
corridor at 0.2 m/frame, so the tail revisits the start (loop-closure
material). Odometry = integrated noisy relative motion with a small
systematic heading bias — the classic dead-reckoning drift model.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from ndt_slam_tpu_torch.core.angles import wrap_deg  # noqa: E402
from ndt_slam_tpu_torch.io.simulate import raycast  # noqa: E402

NO_ECHO = 81.90  # classic SICK out-of-range sentinel


def _rect(x0, y0, x1, y1):
    return [
        [x0, y0, x1, y0], [x1, y0, x1, y1],
        [x1, y1, x0, y1], [x0, y1, x0, y0],
    ]


def _wall(x0, y0, x1, y1):
    return [[x0, y0, x1, y1]]


def office_world() -> np.ndarray:
    """Segment soup [M,4] of the office ring."""
    segs = []
    segs += _rect(0.0, 0.0, 26.0, 20.0)          # outer walls
    # inner block with two doorway gaps (south wall split, west wall split)
    segs += _wall(5.0, 5.0, 11.0, 5.0)           # south, gap 11..12.5
    segs += _wall(12.5, 5.0, 21.0, 5.0)
    segs += _wall(21.0, 5.0, 21.0, 15.0)         # east
    segs += _wall(21.0, 15.0, 5.0, 15.0)         # north
    segs += _wall(5.0, 15.0, 5.0, 11.0)          # west, gap 11..9.5
    segs += _wall(5.0, 9.5, 5.0, 5.0)
    # interior texture visible through the doorways
    segs += _rect(9.0, 8.0, 10.0, 9.0)
    segs += _rect(15.0, 10.5, 16.5, 11.5)
    # alcoves in the outer wall (break corridor symmetry)
    segs += _wall(7.0, 0.0, 7.0, 1.0)
    segs += _wall(7.0, 1.0, 9.0, 1.0)
    segs += _wall(9.0, 1.0, 9.0, 0.0)
    segs += _wall(26.0, 8.0, 25.0, 8.0)
    segs += _wall(25.0, 8.0, 25.0, 12.0)
    segs += _wall(25.0, 12.0, 26.0, 12.0)
    segs += _wall(14.0, 20.0, 14.0, 18.8)
    segs += _wall(0.0, 6.0, 1.2, 6.0)
    # pillars in the corridor corners
    segs += _rect(2.3, 17.0, 2.9, 17.6)
    segs += _rect(23.0, 2.4, 23.6, 3.0)
    segs += _rect(12.2, 2.0, 12.8, 2.6)
    return np.asarray(segs, dtype=np.float64)


def loop_trajectory(n: int, step: float = 0.2) -> np.ndarray:
    """Rounded-rectangle centerline of the corridor, heading along the
    tangent. Returns [n,3] (tx, ty, theta_deg); wraps past one lap."""
    x0, y0, x1, y1, r = 2.5, 2.5, 23.5, 17.5, 1.5
    # piecewise: 4 straights + 4 quarter arcs, counter-clockwise from
    # (x0+r, y0) heading +x.
    Lx = (x1 - x0) - 2 * r
    Ly = (y1 - y0) - 2 * r
    qa = 0.5 * np.pi * r
    lens = [Lx, qa, Ly, qa, Lx, qa, Ly, qa]
    total = sum(lens)

    def at(s):
        s = s % total
        # segment walk
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


# ---------------------------------------------------------------------------
# MIT-Killian-class layout: a 60 x 40 m two-ring corridor building
# (BASELINE.json configs 4-5 name MIT-Killian-scale trajectories; the
# real logs are unreachable offline, so this fixture reproduces their
# failure modes: long corridors with translational near-symmetry,
# nested loops, thousands of frames, multi-revisit corridors).
# ---------------------------------------------------------------------------

def _wall_with_alcoves(x0, y0, x1, y1, rng, inward, every=(4.0, 8.0),
                       depth=(0.5, 1.1), width=(0.8, 1.6)):
    """An axis-aligned wall broken by door-alcove notches at random
    intervals — the symmetry-breaking features long corridors need for
    NDT to observe along-corridor translation. `inward` = unit normal
    (into the wall / away from the corridor) the notch recedes along."""
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
        segs.append([*(p0 + u * last), *a])        # wall up to notch
        segs.append([*a, *(a + nrm * d)])           # notch side
        segs.append([*(a + nrm * d), *(b + nrm * d)])  # notch back
        segs.append([*(b + nrm * d), *b])           # notch side
        last = s + w
        s += w + float(rng.uniform(*every))
    segs.append([*(p0 + u * last), *p1])
    return segs


def killian_world(seed: int = 21) -> np.ndarray:
    """Segment soup of the two-ring corridor building. Corridors are
    4 m wide; every corridor wall carries alcove notches; a few
    pillars sit in corridor corners."""
    rng = np.random.default_rng(seed)
    segs = []
    # outer shell (notches recede OUTWARD, away from the corridor)
    segs += _wall_with_alcoves(0, 0, 60, 0, rng, (0, -1))
    segs += _wall_with_alcoves(60, 0, 60, 40, rng, (1, 0))
    segs += _wall_with_alcoves(60, 40, 0, 40, rng, (0, 1))
    segs += _wall_with_alcoves(0, 40, 0, 0, rng, (-1, 0))
    # west block (4,4)-(28,36); notches recede INTO the block
    segs += _wall_with_alcoves(4, 4, 28, 4, rng, (0, 1))
    segs += _wall_with_alcoves(28, 4, 28, 36, rng, (-1, 0))
    segs += _wall_with_alcoves(28, 36, 4, 36, rng, (0, -1))
    segs += _wall_with_alcoves(4, 36, 4, 4, rng, (1, 0))
    # east block (32,4)-(56,36)
    segs += _wall_with_alcoves(32, 4, 56, 4, rng, (0, 1))
    segs += _wall_with_alcoves(56, 4, 56, 36, rng, (-1, 0))
    segs += _wall_with_alcoves(56, 36, 32, 36, rng, (0, -1))
    segs += _wall_with_alcoves(32, 36, 32, 4, rng, (1, 0))
    # corner pillars (0.5 m squares) hugging corridor walls — off the
    # 2-m-offset centerlines the trajectory drives
    for (px, py) in [(28.7, 16.0), (31.3, 28.0),
                     (14.0, 39.3), (46.0, 0.7)]:
        segs += _rect(px - 0.25, py - 0.25, px + 0.25, py + 0.25)
    return np.asarray(segs, dtype=np.float64)


def rounded_waypoint_path(waypoints, r: float = 1.5, step: float = 0.2):
    """Uniform-step samples [n,3] (x, y, theta_deg) along an
    axis-aligned polyline with quarter-circle fillets at the corners —
    heading follows the path tangent (no instantaneous turns)."""
    pieces = []  # ("line", a, b) | ("arc", center, a0, a1, sign)
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


def killian_trajectory(step: float = 0.2) -> np.ndarray:
    """Nested multi-loop plan over the two-ring building (~630 m,
    ~3170 frames at 0.2 m): ring A CCW, ring B CCW, ring A CW
    (opposite direction), full outer lap — the west corridor is
    traversed 3x, the bottom 5x, the middle 3x, in mixed directions.
    Every turn is a +-90 deg fillet (no reversals)."""
    W = [(10, 2), (30, 2), (30, 38), (2, 38), (2, 2),      # ring A ccw
         (30, 2), (58, 2), (58, 38), (30, 38), (30, 2),    # ring B ccw
         (2, 2), (2, 38), (30, 38), (30, 2),               # ring A cw
         (2, 2), (2, 38), (58, 38), (58, 2), (2, 2),       # outer cw
         (2, 20)]                                          # park
    return rounded_waypoint_path(W, r=1.5, step=step)


def _movers_at(i: int, n_movers: int):
    """Segment soup of moving obstacles (0.4 m squares oscillating
    along corridor lines) at frame i — the dynamic-object material for
    remove_moving. Deterministic in i."""
    routes = [
        ((12.0, 3.0), (20.0, 3.0), 0.13),    # bottom corridor, west
        ((29.0, 10.0), (29.0, 25.0), 0.11),  # middle corridor
        ((35.0, 37.0), (50.0, 37.0), 0.17),  # top corridor, east
    ]
    segs = []
    for (a, b, speed) in routes[:n_movers]:
        a = np.asarray(a); b = np.asarray(b)
        L = float(np.hypot(*(b - a)))
        # triangle-wave position along the route
        s = (i * speed) % (2 * L)
        s = s if s <= L else 2 * L - s
        p = a + (b - a) * (s / L)
        segs += _rect(p[0] - 0.2, p[1] - 0.2, p[0] + 0.2, p[1] + 0.2)
    return segs


def generate(
    n_frames: int = 500,
    beams: int = 180,
    seed: int = 7,
    noise_range: float = 0.01,
    odo_noise_v: float = 0.04,
    odo_noise_w: float = 1.2,
    odo_bias_w_deg: float = 0.02,   # systematic heading drift per frame
    max_range: float = 30.0,
    dt: float = 0.5,
    layout: str = "office",
    fmt: str = "flaser",
    n_movers: int = 0,
):
    rng = np.random.default_rng(seed)
    if layout == "killian":
        segs = killian_world()
        traj = killian_trajectory()
        if n_frames:
            traj = traj[:n_frames]
        n_frames = len(traj)
    else:
        segs = office_world()
        traj = loop_trajectory(n_frames)
    fov = np.pi
    rel_angles = -fov / 2.0 + fov * np.arange(beams) / (beams - 1)

    gt = traj.copy()
    odo = traj[0].copy()
    lines = []
    gt_lines = []
    for i in range(n_frames):
        tp = traj[i]
        th_rad = np.radians(tp[2])
        world = segs
        if n_movers:
            world = np.concatenate(
                [segs, np.asarray(_movers_at(i, n_movers))], axis=0
            )
        r = raycast(world, tp[:2], rel_angles + th_rad, max_range)
        r = r + noise_range * rng.standard_normal(beams)
        r = np.where(np.isfinite(r) & (r < max_range), r, NO_ECHO)

        if i > 0:
            p_prev, p_cur = traj[i - 1], traj[i]
            c, s = (np.cos(np.radians(p_prev[2])),
                    np.sin(np.radians(p_prev[2])))
            dxw, dyw = p_cur[0] - p_prev[0], p_cur[1] - p_prev[1]
            mx = c * dxw + s * dyw
            my = -s * dxw + c * dyw
            mth = float(wrap_deg(p_cur[2] - p_prev[2]))
            d = float(np.hypot(mx, my))
            mx += rng.standard_normal() * (odo_noise_v * d + 1e-4)
            my += rng.standard_normal() * (odo_noise_v * d + 1e-4)
            mth += (rng.standard_normal()
                    * (odo_noise_w * abs(mth) / 57.3 + 0.03)
                    + odo_bias_w_deg)
            co, so = np.cos(np.radians(odo[2])), np.sin(np.radians(odo[2]))
            odo = np.array([
                odo[0] + co * mx - so * my,
                odo[1] + so * mx + co * my,
                float(wrap_deg(odo[2] + mth)),
            ])

        ts = i * dt
        rs = " ".join(f"{v:.3f}" for v in r)
        ox, oy, oth = odo[0], odo[1], np.radians(odo[2])
        if fmt == "robotlaser1":
            # header: laser_type start_angle fov angular_res max_range
            #         accuracy remission_mode; then ranges,
            #         num_remissions, laser pose, odom pose, velocities
            #         + safety fields, timestamp host log_ts
            res = fov / (beams - 1)
            lines.append(
                f"ROBOTLASER1 0 {-fov / 2.0:.6f} {fov:.6f} {res:.6f} "
                f"{NO_ECHO:.2f} 0.010 0 {beams} {rs} 0 "
                f"{ox:.6f} {oy:.6f} {oth:.6f} "
                f"{ox:.6f} {oy:.6f} {oth:.6f} "
                f"0 0 0 0 0 {ts:.6f} simhost {ts:.6f}"
            )
        else:
            lines.append(
                f"FLASER {beams} {rs} "
                f"{ox:.6f} {oy:.6f} {oth:.6f} {ox:.6f} {oy:.6f} {oth:.6f} "
                f"{ts:.6f} simhost {ts:.6f}"
            )
        gt_lines.append(f"{gt[i, 0]:.6f} {gt[i, 1]:.6f} {gt[i, 2]:.6f}")
    return lines, gt_lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "data"))
    ap.add_argument("--frames", type=int, default=500,
                    help="frame count (0 with --layout killian = the "
                         "full ~3100-frame plan)")
    ap.add_argument("--name", default="office_loop")
    ap.add_argument("--layout", choices=["office", "killian"],
                    default="office")
    ap.add_argument("--format", dest="fmt",
                    choices=["flaser", "robotlaser1"], default="flaser")
    ap.add_argument("--movers", type=int, default=0,
                    help="number of moving obstacles (0-3)")
    ap.add_argument("--odo-bias", type=float, default=0.02,
                    help="systematic heading drift per frame [deg]")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    lines, gt_lines = generate(
        n_frames=args.frames, layout=args.layout, fmt=args.fmt,
        n_movers=args.movers, odo_bias_w_deg=args.odo_bias,
    )
    clf = os.path.join(args.out_dir, args.name + ".clf")
    gt = os.path.join(args.out_dir, args.name + ".gt")
    with open(clf, "w") as f:
        f.write("# CARMEN-format fixture (see cli/make_carmen_fixture.py)\n")
        f.write("\n".join(lines) + "\n")
    with open(gt, "w") as f:
        f.write("\n".join(gt_lines) + "\n")
    print(f"wrote {clf} ({len(lines)} frames) and {gt}")


if __name__ == "__main__":
    main()
