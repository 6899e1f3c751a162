"""The port's host modules against the JAX package's: the reference's log
format (write, read, the side blocks), the simulator (array-equal for one
seed), RPE, the JSONL writers, and the ctypes binding of
csrc/libndtslam.so (the native resampler, parsers and PCD writer against
their numpy twins, bit for bit; skipped with a reason where the library
does not load)."""

import json
import os

import numpy as np
import pytest

from ndt_slam_tpu.io.simulate import simulate_sequence as j_simulate
from ndt_slam_tpu.io.tsukuba import (
    read_tsukuba_log as j_read_tsukuba_log,
    write_tsukuba_log as j_write_tsukuba_log,
)
from ndt_slam_tpu.metrics import rpe_rmse as j_rpe_rmse

from ndt_slam_tpu_torch.io import native
from ndt_slam_tpu_torch.io.carmen import read_carmen_log
from ndt_slam_tpu_torch.io.pcd import save_pcd
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
    save_pcd(b, xy)
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
