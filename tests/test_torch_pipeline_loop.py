"""The port's pipelined front end with loop closure on, against its
synchronous front end, on the CPU: bit for bit.

The scene is tests/test_torch_loop.py's: 30 frames of a drifting circle
at the small capacities, keyframes and checks every 2 frames, where
loops close at frames 26 and 28 (two corrections). The synchronous run
goes from frame 0 and saves a checkpoint after frame 23, before the
first loop is accepted; the pipelined front end (depth 4) loads it and
runs frames 24-29, so both corrections, and the verifications that find
their edges, happen on the pipelined path. A correction lands inside a
chunk, so the chunk's later frames are replayed. Poses,
covariances, the loop edges, the graph's node poses, the global map and
the records are equal.
"""

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd
from ndt_slam_tpu_torch.pipeline.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

torch.set_num_threads(2)
N, CUT = 30, 24
KW = dict(end_frame=10_000, loop_enable=True, loop_min_frame_gap=15,
          loop_radius=3.0, loop_score_thre=0.02, loop_keyframe_skip=2,
          loop_check_skip=2, loop_max_candidates=2, loop_coarse_starts=3,
          pgo_iterations=10, ndt_max_active_cells=192,
          max_submap_points=4096, max_local_map_points=8192,
          ndt_trans_eps=1e-4, ndt_max_iterations=80, pipeline_depth=4)


def _circle(n, radius=4.0):
    s = np.linspace(0, 2 * np.pi, n)
    x, y = radius * np.sin(s), radius * (1 - np.cos(s))
    th = np.degrees(np.arctan2(np.gradient(y), np.gradient(x)))
    return np.stack([x, y, th], axis=1)


def test_pipelined_matches_sync_with_loop_corrections(tmp_path):
    frames = simulate_sequence(n_frames=N, beams=181, seed=7,
                               trajectory=_circle(N), odo_noise_v=0.10,
                               odo_noise_w=2.5)
    cfg = SlamConfig.small(**KW)
    sync = FrontEnd(cfg, "cpu")
    ckpt = str(tmp_path / "state.npz")
    for i, fr in enumerate(frames):
        sync.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
        if i + 1 == CUT:
            save_checkpoint(sync, ckpt)
    sync.finalize()
    assert not any(m.get("loop_closed") for m in sync.metrics[:CUT])

    pipe = load_checkpoint(ckpt, "cpu", cfg)
    assert isinstance(pipe, PipelinedFrontEnd) and pipe.depth == 4
    recs = []
    for fr in frames[CUT:]:
        recs.extend(pipe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid))
    recs.extend(pipe.drain())
    pipe.finalize()

    assert sync.n_corrections == pipe.n_corrections == 2
    assert pipe.backend.loops_accepted == sync.backend.loops_accepted == 3
    assert pipe.n_replayed >= 1
    np.testing.assert_array_equal(pipe.get_poses(), sync.get_poses())
    np.testing.assert_array_equal(np.stack(pipe.cov_history),
                                  np.stack(sync.cov_history))
    np.testing.assert_array_equal(np.stack(pipe.backend.node_poses_rad),
                                  np.stack(sync.backend.node_poses_rad))
    assert [e[:2] for e in pipe.backend.loop_edges] == \
        [e[:2] for e in sync.backend.loop_edges]
    for a, b in zip(pipe.backend.loop_edges, sync.backend.loop_edges):
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_array_equal(pipe.pcmap.global_map(),
                                  sync.pcmap.global_map())
    assert pipe.pcmap.remake_stats == sync.pcmap.remake_stats
    assert [r["sid"] for r in recs] == [m["sid"] for m in sync.metrics[CUT:]]
    assert pipe.metrics == sync.metrics
