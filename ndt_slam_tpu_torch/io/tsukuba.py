"""Reader and writer of the reference's own sensor-log format.

    4 free-text header lines, then per frame, whitespace-separated:
      stamp x y theta_deg image_name
      n_front  x1 y1 x2 y2 ... xn yn
      n_left   ...            (kept only if sidelidar)
      n_right  ...            (kept only if sidelidar)

The stream is tokenized as a whole, so newlines inside a frame do not
matter. The left and right blocks are always consumed and included only
when `sidelidar` is true. The same parser as `ndt_slam_tpu.io.tsukuba`.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class LogFrame(NamedTuple):
    stamp: int
    odo_pose: np.ndarray   # [3] (tx, ty, theta_deg)
    scan_xy: np.ndarray    # [n,2] sensor frame


def read_tsukuba_log(path: str, sidelidar: bool = False) -> List[LogFrame]:
    with open(path, "r") as f:
        for _ in range(4):
            f.readline()
        tokens = f.read().split()

    frames: List[LogFrame] = []
    i = 0
    n_tok = len(tokens)

    def take(k):
        nonlocal i
        out = tokens[i:i + k]
        i += k
        return out

    while i < n_tok:
        try:
            stamp = int(float(tokens[i])); i += 1
            tx, ty, th = (float(v) for v in take(3))
            i += 1  # image name
            pts = []
            for block in range(3):
                n = int(float(tokens[i])); i += 1
                blk = np.asarray([float(v) for v in take(2 * n)],
                                 dtype=np.float32).reshape(n, 2)
                if block == 0 or sidelidar:
                    pts.append(blk)
        except (IndexError, ValueError):
            break  # a truncated tail ends the log
        scan = (np.concatenate(pts, axis=0)
                if pts else np.zeros((0, 2), np.float32))
        frames.append(LogFrame(
            stamp=stamp,
            odo_pose=np.array([tx, ty, th], dtype=np.float32),
            scan_xy=scan,
        ))
    return frames


def write_tsukuba_log(path: str, frames,
                      header: str = "ndt_slam_tpu_torch synthetic log",
                      side_split: float = 0.0):
    """Write frames in the reference format.

    side_split=0 puts every point in the front block (left and right
    written empty). With side_split=s in (0, 0.5), the first and last
    s-fractions of each scan go to the left and right blocks instead: a
    sidelidar=False reader must parse past them and keep only the front
    block.
    """
    with open(path, "w") as f:
        for _ in range(4):
            f.write(header + "\n")
        for fr in frames:
            p = fr.odo_pose
            f.write(f"{fr.sid if hasattr(fr, 'sid') else fr.stamp} "
                    f"{p[0]} {p[1]} {p[2]} img.png\n")
            xy = fr.scan_xy
            k = int(round(side_split * len(xy))) if side_split else 0
            left = xy[:k]
            right = xy[len(xy) - k:] if k else xy[:0]
            front = xy[k:len(xy) - k] if k else xy
            for blk in (front, left, right):
                f.write(str(len(blk)))
                for a, b in blk:
                    f.write(f" {a} {b}")
                f.write(" ")
        f.write("\n")
