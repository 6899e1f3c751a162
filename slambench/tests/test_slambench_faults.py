"""The output check at a tiny size on the CPU: a sound run is correct,
and the control and each fault the cells can have make it come out
false under the cells' own limits (those of robot.office_revisit). The
chip's look and the window's length are the only parts of a run left
out."""

import math

import numpy as np
import pytest
import torch

from slambench.harness import run_cell
from slambench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


def _run(root, system="program", seconds=6.0):
    return run_cell(root, "tinyrobot.lap", 2**31 + 77, seconds, False, "cpu",
                    system, say=lambda *_: None)


def _failed(out):
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_sound_run_is_correct(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_bf16_control_is_not_correct(root):
    out = _run(root, system="bf16")
    assert not out["correct"]
    assert "target_miss_share" in _failed(out)


def test_map_left_unchanged(root, monkeypatch):
    """A map step that returns its state unchanged."""
    from ndt_slam_tpu_torch.mapping.pointcloud_map import PointCloudMap
    orig = PointCloudMap.add_points
    calls = []

    def stale(self, scan, make_target=True):
        calls.append(1)
        if len(calls) <= 6:        # the first frames still enter the map
            return orig(self, scan, make_target)

    monkeypatch.setattr(PointCloudMap, "add_points", stale)
    out = _run(root)
    assert not out["correct"]
    assert "target_count_gap" in _failed(out)


def test_pose_altered_where_produced(root, monkeypatch):
    """The fused pose altered by 0.1 m in the frame's fetched row."""
    from ndt_slam_tpu_torch.pipeline.frontend import FrameResult
    orig = FrameResult.small

    def altered(self):
        s = orig(self)
        return s + torch.nn.functional.pad(
            torch.tensor([0.1]), (0, s.shape[-1] - 1)).to(s)

    monkeypatch.setattr(FrameResult, "small", altered)
    out = _run(root)
    assert not out["correct"]
    assert "target_miss_share" in _failed(out)


def test_stale_pose_on_submap_closes(root, monkeypatch):
    """A fault on a few frames only: the frame whose map step closes a
    submap reports the last frame's pose."""
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd
    orig = FrontEnd._finish_frame
    hit = []

    def stale(self, out, small, *rest, **kw):
        pm = self.pcmap
        last = pm.get_last_pose()
        step = math.hypot(small[0] - last[0], small[1] - last[1])
        if pm.atd + step - pm.submaps[-1].atd_s >= self.cfg.submap_sep_thre:
            small = small.copy()
            small[0:3] = np.asarray(last, np.float32)
            hit.append(self.cnt)
        return orig(self, out, small, *rest, **kw)

    monkeypatch.setattr(FrontEnd, "_finish_frame", stale)
    out = _run(root)
    assert hit
    assert not out["correct"]
    assert "frames_off_5cm" in _failed(out)


def test_loop_edge_altered_where_measured(root, monkeypatch):
    """The relative pose of every verified candidate altered by 0.1 m
    where the verification produces it."""
    from ndt_slam_tpu_torch.graph import backend
    orig = backend.verify_candidates

    def altered(*args, **kw):
        out = orig(*args, **kw)
        rel = out.rel_pose_rad.clone()
        rel[:, 0] += 0.1
        return out._replace(rel_pose_rad=rel)

    monkeypatch.setattr(backend, "verify_candidates", altered)
    out = _run(root, seconds=12.0)
    assert not out["correct"]
    assert "loop_edge_gap_m_p50" in _failed(out)
