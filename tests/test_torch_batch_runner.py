"""The lockstep batch runner on the CPU: `run_slam_batch` of the port
against the JAX package's lockstep run and against the port's own
sequential runs.

Convergence is tight (`ndt_trans_eps` 1e-4, 80 iterations), as in the
reference's `tests/integration/test_batch_runner.py::_cfg`: at the
default 1 cm stop the row-axis solve and the single-pose solve (whose
plain twins sum in other orders) stop up to 0.4 mm apart, and the map
feedback carries that on. The scenes fill at most 155 cells, so the
table is cut to 256 (same results, a quarter of the CPU time).

- the scenario of the reference's `test_batch_matches_sequential`
  (2 x 14 simulated frames, seeds 3 and 11): every pose within 0.05 m
  and 0.3 deg of JAX's lockstep run, the accept decisions and the
  submap counts equal;
- uneven lengths (12 and 7 frames): the exhausted sequence idles;
- a batch row's checkpoint resumed by a sequential `FrontEnd`, held to
  the row's own continuation in the lockstep run.

The port's batch against its sequential run across submap closes is in
`test_torch_batch_closes.py`, so that each file stays short.
"""

import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.io.simulate import simulate_sequence as j_simulate
from ndt_slam_tpu.pipeline.batch_runner import (
    run_slam_batch as j_run_slam_batch,
)

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.pipeline.batch_runner import (
    BatchFrontEnd, run_slam_batch,
)
from ndt_slam_tpu_torch.pipeline.checkpoint import (
    load_checkpoint, save_checkpoint,
)

torch.set_num_threads(2)
KW = dict(end_frame=10_000, ndt_trans_eps=1e-4, ndt_max_iterations=80,
          ndt_max_active_cells=256)
CFG = SlamConfig.small(**KW)
SEEDS = (3, 11)


def _gap(a, b):
    """(largest position gap in m, largest heading gap in deg)."""
    d = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1])
    dth = np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0)
    return float(d.max()), float(dth.max())


@pytest.fixture(scope="module")
def runs():
    seqs = [simulate_sequence(n_frames=14, beams=181, seed=s)
            for s in SEEDS]
    ours = run_slam_batch(seqs, CFG, "cpu")
    theirs = j_run_slam_batch(
        [j_simulate(n_frames=14, beams=181, seed=s) for s in SEEDS],
        JSlamConfig.small(**KW))
    return seqs, ours, theirs


def test_batch_matches_jax_lockstep(runs):
    _, ours, theirs = runs
    for fe, jfe in zip(ours, theirs):
        a, b = fe.get_poses(), jfe.get_poses()
        assert a.shape == b.shape == (14, 3)
        d, dth = _gap(a, b)
        assert d <= 0.05 and dth <= 0.3, (d, dth)
        assert [m["successful"] for m in fe.metrics] == \
            [bool(m["successful"]) for m in jfe.metrics]
        assert len(fe.pcmap.submaps) == len(jfe.pcmap.submaps)


def test_uneven_lengths():
    seqs = [simulate_sequence(n_frames=12, beams=181, seed=3),
            simulate_sequence(n_frames=7, beams=181, seed=5)]
    fes = run_slam_batch(seqs, CFG, "cpu")
    assert [len(fe.pose_history) for fe in fes] == [12, 7]
    for fe in fes:
        assert np.isfinite(fe.get_poses()).all()


def test_batch_row_checkpoint_resumes_sequentially(runs, tmp_path):
    """Rows stopped after frame 8 and checkpointed; each file loaded into
    a sequential FrontEnd that runs frames 8-13: within 0.05 m / 0.3
    deg of the lockstep run's frames 8-13, the same accept decisions."""
    seqs, ours, _ = runs
    bfe = BatchFrontEnd(CFG, len(seqs), "cpu")
    for t in range(8):
        bfe.process_batch([s[t].scan_xy for s in seqs],
                          [s[t].odo_pose for s in seqs],
                          [s[t].sid for s in seqs])
    bfe.finalize()
    for k, (seq, fe_b) in enumerate(zip(seqs, bfe.frontends)):
        path = str(tmp_path / f"row{k}.npz")
        save_checkpoint(fe_b, path)
        fe = load_checkpoint(path, "cpu", CFG)
        assert fe.cnt == 8 and not fe._defer_map
        np.testing.assert_array_equal(fe.get_poses(), fe_b.get_poses())
        torch.testing.assert_close(fe.pcmap.last_scan.xy,
                                   fe_b.pcmap.last_scan.xy, rtol=0, atol=0)
        for fr in seq[8:]:
            fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
        d, dth = _gap(fe.get_poses()[8:], ours[k].get_poses()[8:])
        assert d <= 0.05 and dth <= 0.3, (d, dth)
        assert [m["successful"] for m in fe.metrics] == \
            [m["successful"] for m in ours[k].metrics]
