"""ASCII PCD export and import: 2D points written as XYZ with z = 0.

`save_pcd` writes through the native writer of csrc/libndtslam.so
(`io.native.save_pcd`: 6 significant digits a coordinate) where the
library loads, and through numpy (6 decimals) where it does not: the
order and the two formats of `ndt_slam_tpu.io.pcd.save_pcd`, so the two
packages write the same bytes on the same points. `writer()` names the
one that runs.
"""

from __future__ import annotations

import numpy as np

from ndt_slam_tpu_torch.io import native

_HEADER = """# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS x y z
SIZE 4 4 4
TYPE F F F
COUNT 1 1 1
WIDTH {n}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {n}
DATA ascii
"""


def writer() -> str:
    """"native" or "numpy": the writer `save_pcd` takes."""
    return "native" if native.available() else "numpy"


def save_pcd(path: str, xy: np.ndarray):
    if native.available():
        try:
            native.save_pcd(path, np.asarray(xy))
            return
        except OSError:     # the native write failed: numpy, as JAX's
            pass
    _save_pcd_py(path, xy)


def _save_pcd_py(path: str, xy: np.ndarray):
    xy = np.asarray(xy, dtype=np.float32).reshape(-1, 2)
    with open(path, "w") as f:
        f.write(_HEADER.format(n=xy.shape[0]))
        for x, y in xy:
            f.write(f"{x:.6f} {y:.6f} 0\n")


def load_pcd(path: str) -> np.ndarray:
    """The [n,2] float32 points of an ASCII PCD file (z dropped)."""
    pts = []
    with open(path) as f:
        data = False
        for line in f:
            if data:
                v = line.split()
                if len(v) >= 2:
                    pts.append([float(v[0]), float(v[1])])
            elif line.startswith("DATA"):
                data = True
    return np.asarray(pts, dtype=np.float32).reshape(-1, 2)
