"""ctypes binding of the native host runtime (csrc/libndtslam.so at the
repository root: log parsing, scan resampling, PCD export in C++, with
no framework dependency).

Nothing here falls back in silence. `available()` says whether the
library loaded and `status()` how (found, built with `make -C csrc`, or
why not); every other entry point raises `RuntimeError` without the
library. Callers that have a numpy alternative choose by `available()`
and report which one ran.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import List, Optional

import numpy as np

from ndt_slam_tpu_torch.io.tsukuba import LogFrame

_CSRC = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "csrc"))
_LIB_PATH = os.path.join(_CSRC, "libndtslam.so")


@functools.lru_cache(maxsize=1)
def _load() -> tuple[Optional[ctypes.CDLL], str]:
    """(library or None, how it went). Tried once a process; the library
    is built with make only when the file is absent."""
    how = "found"
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _CSRC], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            return None, f"absent and `make -C csrc` failed: {e!r}"
        how = "built with `make -C csrc`"
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        return None, f"{how} but not loadable: {e}"

    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ndt_resample.restype = ctypes.c_int
    lib.ndt_resample.argtypes = [
        f32p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        f32p, ctypes.c_int,
    ]
    lib.ndt_tsukuba_parse.restype = ctypes.c_int64
    lib.ndt_tsukuba_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ndt_tsukuba_counts.restype = ctypes.c_int
    lib.ndt_tsukuba_counts.argtypes = [ctypes.c_int64, i64p, i64p]
    lib.ndt_tsukuba_fill.restype = ctypes.c_int
    lib.ndt_tsukuba_fill.argtypes = [ctypes.c_int64, i64p, f32p, i64p, f32p]
    lib.ndt_tsukuba_free.restype = None
    lib.ndt_tsukuba_free.argtypes = [ctypes.c_int64]
    lib.ndt_write_pcd.restype = ctypes.c_int
    lib.ndt_write_pcd.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
    lib.ndt_carmen_parse.restype = ctypes.c_int64
    lib.ndt_carmen_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
    ]
    return lib, f"{how} and loaded"


def available() -> bool:
    return _load()[0] is not None


def status() -> str:
    """One phrase on csrc/libndtslam.so for a log line or a summary."""
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib, how = _load()
    if lib is None:
        raise RuntimeError(f"csrc/libndtslam.so is not available ({how})")
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def resample_points(
    xy: np.ndarray, space: float = 0.05, space_thre: float = 0.25
) -> np.ndarray:
    """Native arc-length resampler: the walk of
    `pre.resample.resample_points_np` on a float32 [n,2] input, in
    double precision, emitting float32."""
    lib = _lib()
    xy = np.ascontiguousarray(xy, dtype=np.float32).reshape(-1, 2)
    n = xy.shape[0]
    # at most one inserted point per step of `space` along the path
    cap = max(16, 4 * n + 16)
    out = np.empty((cap, 2), dtype=np.float32)
    m = lib.ndt_resample(_f32p(xy), n, space, space_thre, _f32p(out), cap)
    return out[:m].copy()


def _frames_of_handle(lib, h: int) -> List[LogFrame]:
    """Drain a parsed log (the counts / fill / free protocol both
    parsers share) into LogFrames."""
    try:
        n_frames = np.zeros(1, np.int64)
        n_pts = np.zeros(1, np.int64)
        lib.ndt_tsukuba_counts(h, _i64p(n_frames), _i64p(n_pts))
        nf, npts = int(n_frames[0]), int(n_pts[0])
        stamps = np.zeros(nf, np.int64)
        poses = np.zeros((nf, 3), np.float32)
        offsets = np.zeros(nf + 1, np.int64)
        pts = np.zeros((npts, 2), np.float32)
        lib.ndt_tsukuba_fill(
            h, _i64p(stamps), _f32p(poses), _i64p(offsets), _f32p(pts)
        )
    finally:
        lib.ndt_tsukuba_free(h)
    return [
        LogFrame(
            stamp=int(stamps[i]),
            odo_pose=poses[i].copy(),
            scan_xy=pts[offsets[i]:offsets[i + 1]].copy(),
        )
        for i in range(nf)
    ]


def read_tsukuba_log(path: str, sidelidar: bool = False) -> List[LogFrame]:
    """Native parser of the reference's log format
    (`io.tsukuba.read_tsukuba_log` is the numpy one)."""
    lib = _lib()
    h = lib.ndt_tsukuba_parse(path.encode(), int(sidelidar))
    if h < 0:
        raise FileNotFoundError(path)
    return _frames_of_handle(lib, h)


def read_carmen_log(
    path: str,
    max_range: float = 50.0,
    fov_rad: float = np.pi,
    max_frames: Optional[int] = None,
) -> List[LogFrame]:
    """Native CARMEN parser, FLASER and ROBOTLASER1 lines
    (`io.carmen.read_carmen_log` is the numpy one)."""
    lib = _lib()
    h = lib.ndt_carmen_parse(
        path.encode(), float(max_range), float(fov_rad),
        -1 if max_frames is None else int(max_frames),
    )
    if h < 0:
        raise FileNotFoundError(path)
    return _frames_of_handle(lib, h)


def save_pcd(path: str, xy: np.ndarray) -> None:
    """Native ASCII PCD writer: the header and layout of the numpy
    writer, with 6 significant digits a coordinate where that one writes
    6 decimals (`io.pcd.save_pcd` takes this one where it loads)."""
    lib = _lib()
    xy = np.ascontiguousarray(xy, dtype=np.float32).reshape(-1, 2)
    rc = lib.ndt_write_pcd(path.encode(), _f32p(xy), xy.shape[0])
    if rc != 0:
        raise OSError(f"ndt_write_pcd failed for {path}")
