"""The port's keyframe store (ndt_slam_tpu_torch.graph.keyframes)
against the JAX package's, on a simulated loop.

Both stores are fed the same sequence the way the JAX back end feeds
them (a keyframe every `loop_keyframe_skip` frames, the cumulative
position variance of the chain model beside it) and asked for
candidates at every `loop_check_skip`-th frame: the candidate lists
equal, with the drift-aware radius (`loop_drift_gain` 3) and without it
(0); a keyframe cap small enough to decimate several times leaves the
same keyframes; `update_poses` and a shape mismatch behave alike.
"""

import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.graph.keyframes import KeyframeStore as JKeyframeStore
from ndt_slam_tpu.io.simulate import simulate_sequence

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.graph import KeyframeStore

torch.set_num_threads(2)

SLOTS = 256


@pytest.fixture(scope="module")
def loop():
    """A 120-frame circle with drifting odometry; the odometry poses
    stand in for the fused ones, a growing variance for the chain's."""
    s = np.linspace(0, 2 * np.pi, 120)
    x, y = 4.0 * np.sin(s), 4.0 * (1 - np.cos(s))
    th = np.degrees(np.arctan2(np.gradient(y), np.gradient(x)))
    frames = simulate_sequence(n_frames=120, beams=91, seed=5,
                               trajectory=np.stack([x, y, th], axis=1),
                               odo_noise_v=0.2, odo_noise_w=4.0)
    pos_var = np.cumsum(np.full(120, 2.5e-3))
    return frames, pos_var


@pytest.mark.parametrize("gain,max_kf", [(3.0, 4096), (0.0, 4096),
                                         (3.0, 8)])
def test_store_matches_jax(loop, gain, max_kf):
    frames, pos_var = loop
    kw = dict(loop_drift_gain=gain, max_keyframes=max_kf, loop_radius=1.0,
              loop_min_frame_gap=30, loop_keyframe_skip=3,
              loop_check_skip=3, max_scan_points=SLOTS)
    jstore = JKeyframeStore(JSlamConfig.small(**kw))
    store = KeyframeStore(SlamConfig.small(**kw))
    skip = kw["loop_keyframe_skip"]
    found = 0
    decimated = False
    for i, f in enumerate(frames):
        pose = np.asarray(f.odo_pose, np.float32)
        if i % skip == 0:
            n_before = len(store)
            jstore.add(i, pose, j_pad(f.scan_xy, SLOTS), pos_var=pos_var[i])
            store.add(i, pose, pad_points(f.scan_xy, SLOTS, "cpu"),
                      pos_var=pos_var[i])
            decimated |= len(store) <= n_before
        if i % kw["loop_check_skip"] == 0:
            want = jstore.candidates(pose, i, max_candidates=4,
                                     cur_pos_var=pos_var[i])
            got = store.candidates(pose, i, max_candidates=4,
                                   cur_pos_var=pos_var[i])
            assert got == want, (i, got, want)
            found += len(got)
    assert store.sids == jstore.sids and len(store) == len(jstore)
    for a, b in zip(store.poses_deg, jstore.poses_deg):
        np.testing.assert_array_equal(a, b)
    assert store.pos_var == jstore.pos_var
    for k, sid in enumerate(store.sids):
        f = frames[sid]
        np.testing.assert_array_equal(
            store.scan_xy[k].numpy(), np.asarray(jstore.scan_xy[k]))
        assert store.scan_mask[k].dtype == torch.bool
        assert int(store.scan_mask[k].sum()) == min(len(f.scan_xy), SLOTS)
    if max_kf < 4096:
        assert decimated and len(store) <= max_kf
    else:
        assert found > 0        # the loop's revisit offered candidates


def test_update_poses_and_one_capacity():
    cfg = dict(max_scan_points=16)
    jstore = JKeyframeStore(JSlamConfig.small(**cfg))
    store = KeyframeStore(SlamConfig.small(**cfg))
    rng = np.random.default_rng(1)
    for sid in (0, 5, 10):
        pose = rng.uniform(-1, 1, 3).astype(np.float32)
        pts = rng.uniform(-3, 3, (12, 2)).astype(np.float32)
        jstore.add(sid, pose, j_pad(pts, 16))
        store.add(sid, pose, pad_points(pts, 16, "cpu"))
    new = rng.uniform(-1, 1, (11, 3)).astype(np.float32)
    rows = {0: 3, 10: 7}
    jstore.update_poses(new, rows.get)
    store.update_poses(new, rows.get)
    for a, b in zip(store.poses_deg, jstore.poses_deg):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(store.poses_deg[0], new[3])
    with pytest.raises(ValueError, match="shape"):
        store.add(15, new[0], pad_points(np.zeros((3, 2)), 32, "cpu"))
