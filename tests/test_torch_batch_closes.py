"""The port's lockstep batch against its own sequential runs across
submap closes, on the CPU.

`submap_sep_thre` 1.0 closes a submap every frame or two, so each close
hands the sequence's slot back to its `FrontEnd` (the per-sequence
path) and stacks it again after. The JAX package's batch runner is no
reference here: its own test of this case,
`tests/integration/test_batch_runner.py::test_batch_matches_sequential_across_submap_closes`,
fails on this tree (ROADMAP.md, "Known issues"). So the port's batch is
held to the port's sequential run of each log: every pose within
0.05 m and 0.3 deg, the accept decisions and the submap counts equal, at
least 3 submaps, at the reference batch test's tight convergence
(`ndt_trans_eps` 1e-4, 80 iterations; the scenes fill at most 155
cells, so the table is cut to 256). Two lockstep runs give the same
bits.
"""

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.pipeline.batch_runner import run_slam_batch
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

torch.set_num_threads(2)
CFG = SlamConfig.small(end_frame=10_000, ndt_trans_eps=1e-4,
                       ndt_max_iterations=80, ndt_max_active_cells=256,
                       submap_sep_thre=1.0)


def test_batch_matches_sequential_across_submap_closes():
    seqs = [simulate_sequence(n_frames=14, beams=181, seed=s)
            for s in (3, 9)]
    fes_b = run_slam_batch(seqs, CFG, "cpu")
    for seq, fb in zip(seqs, fes_b):
        fe = FrontEnd(CFG, "cpu")
        for fr in seq:
            fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
        fe.finalize()
        assert len(fe.pcmap.submaps) >= 3
        assert len(fb.pcmap.submaps) == len(fe.pcmap.submaps)
        a, b = fb.get_poses(), fe.get_poses()
        assert a.shape == b.shape == (14, 3)
        assert np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max() <= 0.05
        dth = np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0)
        assert dth.max() <= 0.3
        assert [m["successful"] for m in fb.metrics] == \
            [m["successful"] for m in fe.metrics]
        # the maps hold the same clouds: per submap, the processed
        # clouds within 5 % in size (a lost or doubled scan is ~50 %)
        for sa, sb in zip(fb.pcmap.submaps, fe.pcmap.submaps):
            ca, cb = int(sa.cloud().mask.sum()), int(sb.cloud().mask.sum())
            assert abs(ca - cb) <= 0.05 * max(ca, cb) + 2, (ca, cb)


def test_two_lockstep_runs_are_bitwise_equal():
    seqs = [simulate_sequence(n_frames=8, beams=181, seed=s)
            for s in (3, 9)]
    a = run_slam_batch(seqs, CFG, "cpu")
    b = run_slam_batch(seqs, CFG, "cpu")
    for x, y in zip(a, b):
        assert x.get_poses().tobytes() == y.get_poses().tobytes()
        assert torch.equal(x.pcmap.registration_target().xy,
                           y.pcmap.registration_target().xy)
