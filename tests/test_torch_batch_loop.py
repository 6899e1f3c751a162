"""The lockstep batch runner with loop closure on, on the CPU: the
port's batch against the port's sequential run.

The scene is `test_torch_loop.py`'s drifting circle (30 simulated
frames of 181 beams, odometry noise 0.10 m / 2.5 deg) at its config.
Its solves are ill-conditioned from frame 3 on (up to 80 Newton
iterations), so two runs whose sums differ in order part early: the
JAX package's own batch and sequential runs of the first 16 frames are
0.09 m apart at frame 3 and 0.35 m at frame 11, the port's alike. So,
as `test_torch_loop.py` does between the packages, both runs continue
one checkpoint, the sequential run's state after frame 25 (back end
included): the loop then closes at frames 26 and 28 (3 edges, 2
corrections) in both. The same sequence sits in both rows of the batch,
so corrections fire for both slots in one tick, and each slot's stacked
map goes stale and is stacked again from its rewritten map. Held to: the
same edges, `loops_accepted` and `n_corrections` as the sequential
continuation, every pose within 0.05 m and 0.3 deg of it, the two rows
bit for bit equal.
"""

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.pipeline.batch_runner import BatchFrontEnd
from ndt_slam_tpu_torch.pipeline.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

torch.set_num_threads(2)
N, CUT = 30, 25
KW = dict(end_frame=10_000, loop_enable=True, loop_min_frame_gap=15,
          loop_radius=3.0, loop_score_thre=0.02, loop_keyframe_skip=2,
          loop_check_skip=2, loop_max_candidates=2, loop_coarse_starts=3,
          pgo_iterations=10, ndt_max_active_cells=192,
          max_submap_points=4096, max_local_map_points=8192,
          ndt_trans_eps=1e-4, ndt_max_iterations=80)


def _circle(n, radius=4.0):
    s = np.linspace(0, 2 * np.pi, n)
    x, y = radius * np.sin(s), radius * (1 - np.cos(s))
    th = np.degrees(np.arctan2(np.gradient(y), np.gradient(x)))
    return np.stack([x, y, th], axis=1)


def test_batch_with_loops_matches_sequential(tmp_path):
    frames = simulate_sequence(n_frames=N, beams=181, seed=7,
                               trajectory=_circle(N), odo_noise_v=0.10,
                               odo_noise_w=2.5)
    cfg = SlamConfig.small(**KW)
    seq = FrontEnd(cfg, "cpu")
    for fr in frames[:CUT]:
        seq.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    ckpt = str(tmp_path / "cut.npz")
    save_checkpoint(seq, ckpt)
    for fr in frames[CUT:]:
        seq.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    seq.finalize()
    assert seq.backend.loops_accepted == 3 and seq.n_corrections == 2

    bfe = BatchFrontEnd(cfg, 2, "cpu", frontends=[
        load_checkpoint(ckpt, "cpu", cfg) for _ in range(2)])
    for fr in frames[CUT:]:
        recs = bfe.process_batch([fr.scan_xy] * 2, [fr.odo_pose] * 2,
                                 [fr.sid] * 2)
        assert all(r is not None and "bootstrap" not in r for r in recs)
    bfe.finalize()
    a, b = bfe.frontends
    assert a.get_poses().tobytes() == b.get_poses().tobytes()
    for fe in (a, b):
        assert fe.backend.loops_accepted == seq.backend.loops_accepted
        assert fe.n_corrections == seq.n_corrections
        assert [(e["sid_old"], e["sid_new"]) for e in fe.backend.edge_log] \
            == [(e["sid_old"], e["sid_new"]) for e in seq.backend.edge_log]
        assert fe.pcmap.remake_stats == seq.pcmap.remake_stats
        p, q = fe.get_poses(), seq.get_poses()
        assert p.shape == q.shape == (N, 3)
        assert np.hypot(p[:, 0] - q[:, 0], p[:, 1] - q[:, 1]).max() <= 0.05
        dth = np.abs((p[:, 2] - q[:, 2] + 180.0) % 360.0 - 180.0)
        assert dth.max() <= 0.3
        assert len(fe.pcmap.submaps) == len(seq.pcmap.submaps)
