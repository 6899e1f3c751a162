"""The port's host modules against the JAX package's: the reference's log
format (write, read, the side blocks), the simulator (array-equal for one
seed), RPE, the JSONL writers, and the ctypes binding of
csrc/libndtslam.so (the native resampler, parsers and PCD writer against
their numpy twins, bit for bit; skipped with a reason where the library
does not load), and the PCD files: both packages' `save_pcd` write the
same bytes with the native writer and on the numpy fallback, and
`load_pcd` reads them back as the JAX package's does."""

import json
import os

import numpy as np
import pytest

from ndt_slam_tpu.io import native as j_native
from ndt_slam_tpu.io.pcd import load_pcd as j_load_pcd
from ndt_slam_tpu.io.pcd import save_pcd as j_save_pcd
from ndt_slam_tpu.io.simulate import simulate_sequence as j_simulate
from ndt_slam_tpu.io.tsukuba import (
    read_tsukuba_log as j_read_tsukuba_log,
    write_tsukuba_log as j_write_tsukuba_log,
)
from ndt_slam_tpu.metrics import rpe_rmse as j_rpe_rmse

from ndt_slam_tpu_torch.io import native
from ndt_slam_tpu_torch.io.carmen import read_carmen_log
from ndt_slam_tpu_torch.io import pcd
from ndt_slam_tpu_torch.io.pcd import _save_pcd_py, load_pcd, save_pcd
from ndt_slam_tpu_torch.io.simulate import (
    Mover, default_world, raycast, simulate_sequence,
)
from ndt_slam_tpu_torch.io.tsukuba import (
    LogFrame, read_tsukuba_log, write_tsukuba_log,
)
from ndt_slam_tpu_torch.metrics import JsonlWriter, rpe_rmse, write_jsonl
from ndt_slam_tpu_torch.pre.resample import resample_points_np

ROOT = os.path.join(os.path.dirname(__file__), "..")
LOG = os.path.join(ROOT, "tests", "data", "office_loop.clf")


def _assert_frames_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert int(x.stamp) == int(y.stamp)
        np.testing.assert_array_equal(x.odo_pose, y.odo_pose)
        np.testing.assert_array_equal(x.scan_xy, y.scan_xy)
        assert x.scan_xy.dtype == y.scan_xy.dtype == np.float32


@pytest.fixture
def need_native():
    if not native.available():
        pytest.skip(f"csrc/libndtslam.so: {native.status()}")


def test_simulate_sequence_equals_jax():
    a = simulate_sequence(n_frames=12, beams=181, seed=3)
    b = j_simulate(n_frames=12, beams=181, seed=3)
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        assert x.sid == y.sid
        np.testing.assert_array_equal(x.true_pose, y.true_pose)
        np.testing.assert_array_equal(x.odo_pose, y.odo_pose)
        np.testing.assert_array_equal(x.scan_xy, y.scan_xy)
    with pytest.raises(ValueError, match="trajectory"):
        simulate_sequence(n_frames=5, trajectory=np.zeros((3, 3)))


def test_simulator_world_and_movers():
    w = default_world()
    r = raycast(w.segments, np.zeros(2), np.radians([0.0, 90.0, 180.0]))
    np.testing.assert_allclose(r, [8.0, 6.0, 8.0], atol=1e-9)
    w.movers.append(Mover(start=np.array([3.0, 0.0]),
                          velocity=np.array([0.1, 0.0]), t_on=2, t_off=4))
    assert len(w.segments_at(0.0)) == len(w.segments)
    assert len(w.segments_at(3.0)) == len(w.segments) + 4
    hit = raycast(w.segments_at(3.0), np.zeros(2), np.array([0.0]))
    np.testing.assert_allclose(hit, [3.0], atol=1e-9)   # 3.3 - 0.3


@pytest.mark.parametrize("side_split", [0.0, 0.2])
def test_tsukuba_round_trip_and_jax_reader(tmp_path, side_split):
    frames = simulate_sequence(n_frames=4, beams=91, seed=1)
    path, jpath = str(tmp_path / "log.txt"), str(tmp_path / "jlog.txt")
    write_tsukuba_log(path, frames, side_split=side_split)
    j_write_tsukuba_log(jpath, frames, header="ndt_slam_tpu_torch synthetic "
                                              "log", side_split=side_split)
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    for side in (False, True):
        got = read_tsukuba_log(path, sidelidar=side)
        _assert_frames_equal(got, j_read_tsukuba_log(path, sidelidar=side))
        assert isinstance(got[0], LogFrame)
        for fr, src in zip(got, frames):
            assert fr.stamp == src.sid
            np.testing.assert_array_equal(fr.odo_pose, src.odo_pose)
            n, k = len(src.scan_xy), int(round(side_split * len(src.scan_xy)))
            if side or not k:
                # front block, then left, then right: a reordering
                want = np.concatenate([src.scan_xy[k:n - k], src.scan_xy[:k],
                                       src.scan_xy[n - k:]]) if k \
                    else src.scan_xy
            else:
                want = src.scan_xy[k:n - k]
            np.testing.assert_array_equal(fr.scan_xy, want)
    # a truncated tail ends the log at the last whole frame
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[:int(len(text) * 0.7)])
    assert 1 <= len(read_tsukuba_log(path)) < 4


def test_rpe_rmse_matches_jax():
    rng = np.random.default_rng(2)
    true = np.cumsum(rng.uniform(-0.2, 0.3, (40, 3)) * [1, 1, 20], axis=0)
    est = true + rng.normal(0, 0.02, (40, 3)) * [1, 1, 10]
    for delta in (1, 5):
        got, want = rpe_rmse(est, true, delta), j_rpe_rmse(est, true, delta)
        assert got == want and got[0] > 0 and got[1] > 0
    assert rpe_rmse(true, true) == (0.0, 0.0)
    with pytest.raises(ValueError):
        rpe_rmse(est[:1], true[:1])


def test_jsonl_writers(tmp_path):
    path = str(tmp_path / "sub" / "m.jsonl")
    w = JsonlWriter(path)
    w.write({"sid": 0})
    w.close()
    w = JsonlWriter(path, append=True)
    w.write({"sid": 1})
    w.close()
    with open(path) as f:
        assert [json.loads(x) for x in f] == [{"sid": 0}, {"sid": 1}]
    JsonlWriter(path).close()                 # truncates without append
    assert os.path.getsize(path) == 0
    write_jsonl(path, [{"a": 1}, {"b": [2, 3]}])
    with open(path) as f:
        assert [json.loads(x) for x in f] == [{"a": 1}, {"b": [2, 3]}]
    JsonlWriter(None).write({"dropped": True})    # no path: a no-op


def test_native_resampler_equals_numpy_on_office_loop(need_native):
    """The resampler the front end takes where the library loads gives
    the numpy one's points bit for bit on every office_loop scan."""
    frames = read_carmen_log(LOG)
    assert len(frames) == 500
    for fr in frames:
        a = native.resample_points(fr.scan_xy, 0.05, 0.25)
        b = resample_points_np(fr.scan_xy, 0.05, 0.25)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert native.resample_points(np.zeros((0, 2), np.float32)).shape == (0, 2)


def test_native_parsers_equal_numpy(need_native, tmp_path):
    _assert_frames_equal(native.read_carmen_log(LOG, max_frames=60),
                         read_carmen_log(LOG, max_frames=60))
    frames = simulate_sequence(n_frames=3, beams=91, seed=1)
    path = str(tmp_path / "log.txt")
    write_tsukuba_log(path, frames, side_split=0.2)
    for side in (False, True):
        _assert_frames_equal(native.read_tsukuba_log(path, sidelidar=side),
                             read_tsukuba_log(path, sidelidar=side))
    with pytest.raises(FileNotFoundError):
        native.read_tsukuba_log(str(tmp_path / "missing.txt"))


def test_native_pcd_matches_python(need_native, tmp_path):
    """The same header and points; the native writer keeps 6 significant
    digits where the Python one keeps 6 decimals."""
    xy = np.random.default_rng(4).uniform(-30, 30, (200, 2)).astype(np.float32)
    a, b = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    native.save_pcd(a, xy)
    _save_pcd_py(b, xy)
    with open(a) as f, open(b) as g:
        la, lb = f.read().splitlines(), g.read().splitlines()
    assert la[:11] == lb[:11] and la[10] == "DATA ascii"
    assert len(la) == len(lb) == 211
    pa = np.array([x.split() for x in la[11:]], dtype=np.float64)
    pb = np.array([x.split() for x in lb[11:]], dtype=np.float64)
    np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pb[:, :2], xy, atol=1e-6)


def test_native_status_is_reported():
    assert isinstance(native.available(), bool)
    assert ("loaded" in native.status()) == native.available()


# awkward values: 6 significant digits and 6 decimals part on each
PCD_POINTS = np.concatenate([
    np.array([[12.345678, -0.0001234], [3.5, 101.25], [0.0, -7e-7]],
             np.float32),
    np.random.default_rng(5).uniform(-40, 40, (60, 2)).astype(np.float32),
])


def _pcd_writers(monkeypatch, writer):
    """Route both packages' `save_pcd` to `writer`: "native" (the
    library, as both take it where it loads) or "numpy" (the port told
    the library is absent, the JAX package's native call failing)."""
    if writer == "native":
        if not native.available():
            pytest.skip(f"csrc/libndtslam.so: {native.status()}")
        return

    def fail(path, xy):
        raise OSError("native writer made to fail")

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(j_native, "save_pcd", fail)


@pytest.mark.parametrize("writer", ["native", "numpy"])
def test_save_pcd_writes_the_jax_packages_bytes(tmp_path, monkeypatch,
                                                writer):
    _pcd_writers(monkeypatch, writer)
    assert pcd.writer() == writer
    a, b = tmp_path / "port.pcd", tmp_path / "jax.pcd"
    save_pcd(str(a), PCD_POINTS)
    j_save_pcd(str(b), PCD_POINTS)
    assert a.read_bytes() == b.read_bytes()
    lines = a.read_text().splitlines()
    assert lines[10] == "DATA ascii" and len(lines) == 11 + len(PCD_POINTS)
    assert lines[11] == ("12.3457 -0.0001234 0" if writer == "native"
                         else "12.345678 -0.000123 0")


@pytest.mark.parametrize("writer", ["native", "numpy"])
def test_load_pcd_reads_back_what_save_pcd_writes(tmp_path, monkeypatch,
                                                  writer):
    """Within the format (6 significant digits, or 6 decimals) and the
    float32 the file is read into, and equal to the JAX package's
    `load_pcd` of the same file."""
    _pcd_writers(monkeypatch, writer)
    path = str(tmp_path / "map.pcd")
    save_pcd(path, PCD_POINTS)
    back = load_pcd(path)
    assert back.dtype == np.float32 and back.shape == PCD_POINTS.shape
    np.testing.assert_array_equal(back, j_load_pcd(path))
    if writer == "native":
        np.testing.assert_allclose(back, PCD_POINTS, rtol=5.1e-6, atol=0)
    else:
        np.testing.assert_allclose(back, PCD_POINTS, rtol=1.2e-7, atol=5e-7)


def test_load_pcd_matches_jax_on_an_empty_and_a_ragged_file(tmp_path):
    empty = str(tmp_path / "empty.pcd")
    save_pcd(empty, np.zeros((0, 2), np.float32))
    assert load_pcd(empty).shape == (0, 2)
    np.testing.assert_array_equal(load_pcd(empty), j_load_pcd(empty))
    ragged = tmp_path / "ragged.pcd"
    ragged.write_text("VERSION 0.7\nDATA ascii\n1.5 2.5 0\n\n7\n-3 4\n")
    np.testing.assert_array_equal(load_pcd(str(ragged)),
                                  j_load_pcd(str(ragged)))
    np.testing.assert_array_equal(load_pcd(str(ragged)),
                                  [[1.5, 2.5], [-3.0, 4.0]])
