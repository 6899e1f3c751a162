"""The one generator of the benchmark's traffic: simulated 2D laser logs
in the format of the public Radish/CARMEN logs.

A frozen copy of the repository's fixture generator (the sensor model,
the odometry model and their seeded draws in the same order), so that
`fixture_lines` writes the committed `tests/data/office_loop.clf` byte
for byte at its seed. A traffic file (`workloads/<cell>.json`) names a
world (`worlds/<world>.py`) and the parameters below; `make_log` gives
the frames as a reader of the log would get them: ranges as logged (3
decimals), the laser pose as logged (6 decimals), ranges at or beyond
the cutoff dropped. The seed draws the range noise and the odometry
noise; the worlds and paths do not depend on it."""

from __future__ import annotations

import importlib
from typing import List, NamedTuple

import numpy as np

NO_ECHO = 81.90       # classic SICK out-of-range sentinel
CHUNK_FRAMES = 64     # frames raycast in one block


def wrap_deg(a):
    """Wrap angle(s) in degrees to [-180, 180)."""
    return (a + 180.0) % 360.0 - 180.0


def rect(x0, y0, x1, y1):
    return [
        [x0, y0, x1, y0], [x1, y0, x1, y1],
        [x1, y1, x0, y1], [x0, y1, x0, y0],
    ]


def wall(x0, y0, x1, y1):
    return [[x0, y0, x1, y1]]


def world(name: str):
    """The world module `worlds/<name>.py`."""
    return importlib.import_module(f"slambench.traffic.worlds.{name}")


def raycast(segs: np.ndarray, origins: np.ndarray, angles: np.ndarray,
            max_range: float) -> np.ndarray:
    """Ranges [F,B] of rays from origins [F,2] at angles [F,B] against
    the walls segs [M,4] (inf where nothing is hit within max_range);
    each element the same arithmetic as one ray alone."""
    ox, oy = origins[:, 0:1, None], origins[:, 1:2, None]
    dx = np.cos(angles)[..., None]                 # [F,B,1]
    dy = np.sin(angles)[..., None]
    x1, y1, x2, y2 = (segs[:, i][None, None, :] for i in range(4))
    ex, ey = x2 - x1, y2 - y1
    denom = dx * ey - dy * ex                      # [F,B,M]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ((x1 - ox) * ey - (y1 - oy) * ex) / denom
        u = ((x1 - ox) * dy - (y1 - oy) * dx) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    r = np.where(hit, t, np.inf).min(axis=-1)
    return np.where(r <= max_range, r, np.inf)


def _ranges(mod, traj, rel_angles, n_movers, max_range):
    """True ranges [n, beams] of every frame, static walls in blocks,
    the movers frame by frame (the minimum over all walls either way)."""
    segs = mod.segments()
    ang = rel_angles[None, :] + np.radians(traj[:, 2])[:, None]
    out = np.empty(ang.shape)
    for a in range(0, len(traj), CHUNK_FRAMES):
        b = min(a + CHUNK_FRAMES, len(traj))
        out[a:b] = raycast(segs, traj[a:b, :2], ang[a:b], max_range)
    for i in range(len(traj) if n_movers else 0):
        m = np.asarray(mod.movers_at(i, n_movers), dtype=np.float64)
        out[i] = np.minimum(out[i], raycast(m, traj[i:i + 1, :2],
                                            ang[i:i + 1], max_range)[0])
    return out


def log_lines(world_name: str, n_frames: int, rng, beams: int = 180,
              fov_deg: float = 180.0, noise_range: float = 0.01,
              odo_noise_v: float = 0.04, odo_noise_w: float = 1.2,
              odo_bias_w_deg: float = 0.02, max_range: float = 30.0,
              step: float = 0.2, dt: float = 0.5, n_movers: int = 0):
    """(FLASER lines, ground-truth lines) of a log of n_frames frames."""
    mod = world(world_name)
    traj = mod.path(n_frames, step)
    fov = np.radians(fov_deg)
    rel_angles = -fov / 2.0 + fov * np.arange(beams) / (beams - 1)
    true_r = _ranges(mod, traj, rel_angles, n_movers, max_range)

    odo = traj[0].copy()
    lines, gt_lines = [], []
    for i in range(len(traj)):
        r = true_r[i] + noise_range * rng.standard_normal(beams)
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
        lines.append(
            f"FLASER {beams} {rs} "
            f"{ox:.6f} {oy:.6f} {oth:.6f} {ox:.6f} {oy:.6f} {oth:.6f} "
            f"{ts:.6f} simhost {ts:.6f}"
        )
        gt_lines.append(f"{traj[i, 0]:.6f} {traj[i, 1]:.6f} {traj[i, 2]:.6f}")
    return lines, gt_lines


class Log(NamedTuple):
    scans: List[np.ndarray]   # [n_i, 2] float32 sensor-frame points
    odo: np.ndarray           # [n, 3] float32 laser pose, degrees
    gt: np.ndarray            # [n, 3] float64 true pose, degrees


def parse_lines(lines, gt_lines, fov_deg: float = 180.0,
                cutoff: float = 50.0) -> Log:
    """The frames a CARMEN reader gets from FLASER lines: beams over the
    field of view from -fov/2, ranges in (0.05, cutoff) kept."""
    fov = np.radians(fov_deg)
    scans, odo = [], []
    for line in lines:
        tok = line.split()
        n = int(tok[1])
        r = np.asarray(tok[2:2 + n], dtype=np.float64)
        x, y, th = (float(v) for v in tok[2 + n:5 + n])
        angles = -fov / 2.0 + fov * np.arange(n) / max(n - 1, 1)
        ok = (r > 0.05) & (r < cutoff)
        scans.append(np.stack([r[ok] * np.cos(angles[ok]),
                               r[ok] * np.sin(angles[ok])],
                              axis=1).astype(np.float32))
        odo.append([x, y, np.degrees(th)])
    gt = np.asarray([[float(v) for v in g.split()] for g in gt_lines])
    return Log(scans, np.asarray(odo, dtype=np.float32), gt)


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one log of a run: the run's seed (any integer)
    and the log's index in the traffic file."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), int(stream)]))


def make_log(spec: dict, seed: int, stream: int) -> Log:
    """One log of a traffic file's `logs` list, drawn from the seed."""
    kw = {k: v for k, v in spec.items() if k not in ("name", "world",
                                                     "frames")}
    lines, gt_lines = log_lines(spec["world"], spec["frames"],
                                seed_rng(seed, stream), **kw)
    return parse_lines(lines, gt_lines, spec.get("fov_deg", 180.0))


def fixture_lines(world_name: str = "office", n_frames: int = 500,
                  seed: int = 7, n_movers: int = 0):
    """The committed fixture's text (header, lines) at its own seed."""
    lines, gt_lines = log_lines(world_name, n_frames,
                                np.random.default_rng(seed),
                                n_movers=n_movers)
    clf = ("# CARMEN-format fixture (see cli/make_carmen_fixture.py)\n"
           + "\n".join(lines) + "\n")
    return clf, "\n".join(gt_lines) + "\n"
