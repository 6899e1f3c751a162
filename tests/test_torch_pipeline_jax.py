"""The port's pipelined front end against the JAX package's, on the CPU:
`simulate_sequence(20, beams=181, seed=3)` at `SlamConfig.small` with a
submap close every metre or so (`submap_sep_thre` 1.0), depth 4 on both
sides. `ndt_trans_eps` 1e-3 steps round the bistable frame of this
sequence (ROADMAP.md, faults found: at 1e-4 frame 10 has two optima
0.146 m apart). A 384-cell table holds every valid cell of the scene:
both packages give the trajectories of the default 2048 cells (a
256-cell table overflows, and the packages fork at frame 10 again). The
two packages must take the same speculation decisions (equal rollback
and replay counts, the same submaps) and land within the repo's
f32-noise bounds, 0.05 m and 0.3 deg, frame by frame.
"""

import numpy as np
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.io.simulate import simulate_sequence as j_simulate
from ndt_slam_tpu.pipeline.async_frontend import (
    PipelinedFrontEnd as JPipelinedFrontEnd,
)

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd

torch.set_num_threads(2)
KW = dict(end_frame=10_000, submap_sep_thre=1.0, ndt_trans_eps=1e-3,
          ndt_max_active_cells=384)
DEPTH = 4


def _run(fe, frames):
    recs = []
    for fr in frames:
        recs.extend(fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid))
    recs.extend(fe.drain())
    fe.finalize()
    return recs


def test_pipelined_matches_jax_pipelined():
    frames = simulate_sequence(n_frames=20, beams=181, seed=3)
    j_frames = j_simulate(n_frames=20, beams=181, seed=3)
    np.testing.assert_array_equal(frames[7].scan_xy, j_frames[7].scan_xy)
    jfe = JPipelinedFrontEnd(JSlamConfig.small(**KW), depth=DEPTH)
    j_recs = _run(jfe, j_frames)
    fe = PipelinedFrontEnd(SlamConfig.small(**KW), "cpu", depth=DEPTH)
    recs = _run(fe, frames)

    assert fe.n_rollbacks == jfe.n_rollbacks >= 2
    assert fe.n_replayed == jfe.n_replayed
    assert len(fe.pcmap.submaps) == len(jfe.pcmap.submaps) >= 3
    assert [r["sid"] for r in recs] == [r["sid"] for r in j_recs]
    a, b = fe.get_poses(), np.stack(jfe.pose_history)
    assert a.shape == b.shape == (20, 3)
    dxy = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max()
    dth = np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0).max()
    print(f"pipelined, port vs JAX: {dxy:.3g} m, {dth:.3g} deg; "
          f"rollbacks {fe.n_rollbacks}, replayed {fe.n_replayed}")
    assert dxy <= 0.05 and dth <= 0.3
    assert [m["successful"] for m in fe.metrics] == \
        [m["successful"] for m in jfe.metrics]
