"""The port's pipelined front end (`PipelinedFrontEnd`) against its
synchronous `FrontEnd`, on the CPU: bit for bit.

Mirrors tests/integration/test_async_pipeline.py and
tests/unit/test_incremental_grid.py::test_pipelined_incremental_bit_exact_vs_sync
on simulated frames at the small capacities (a 256-cell table keeps
the CPU twins quick): poses, covariances, `successful`, the
submap count, the global map and the order of the records' sids are
equal, through pure speculation, submap closes (rolled back and redone
through the close path), the lattice with closes, and lattice escapes
(rolled back and replayed on the full rebuild). Also: a checkpoint
saved with frames in flight drains them and resumes bit for bit, the
runner's pipelined branch writes the synchronous records (`wall_s`
aside), and a rollback snapshot's tensors are never written in place.
"""

import json

import numpy as np
import pytest
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.pipeline.async_frontend import PipelinedFrontEnd
from ndt_slam_tpu_torch.pipeline.batch_runner import BatchFrontEnd
from ndt_slam_tpu_torch.pipeline.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd
from ndt_slam_tpu_torch.pipeline.runner import run_slam

torch.set_num_threads(2)

BASE = dict(end_frame=10_000, ndt_max_active_cells=256)
# name: (config overrides, frames, simulator seed, depth)
CASES = {
    # sep_thre beyond the whole trajectory: pure speculation
    "no_rollback": (dict(submap_sep_thre=1000.0), 12, 3, 4),
    # a close every frame or two, each landing inside a chunk
    "submap_closes": (dict(submap_sep_thre=1.0), 12, 3, 4),
    # the lattice is part of the snapshot
    "lattice_closes": (dict(ndt_incremental_grid=1, submap_sep_thre=2.0),
                       12, 5, 6),
    # a lattice no wider than the window: windows escape
    "lattice_escape": (dict(ndt_incremental_grid=1, grid_mom_cells=96),
                       8, 3, 4),
}


def _cfg(name, **kw):
    return SlamConfig.small(**BASE, **CASES[name][0], **kw)


def _frames(name):
    _, n, seed, _ = CASES[name]
    return simulate_sequence(n_frames=n, beams=181, seed=seed)


_SYNC = {}


def _sync(name):
    """The synchronous run of a case, once per module."""
    if name not in _SYNC:
        fe = FrontEnd(_cfg(name), "cpu")
        for fr in _frames(name):
            fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
        fe.finalize()
        _SYNC[name] = fe
    return _SYNC[name]


def _pipelined(name):
    fe = PipelinedFrontEnd(_cfg(name), "cpu", depth=CASES[name][3])
    recs = []
    for fr in _frames(name):
        recs.extend(fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid))
    recs.extend(fe.drain())
    fe.finalize()
    return fe, recs


def _assert_same(sync, pipe, recs=None):
    np.testing.assert_array_equal(sync.get_poses(), pipe.get_poses())
    np.testing.assert_array_equal(np.stack(sync.cov_history),
                                  np.stack(pipe.cov_history))
    assert [m.get("successful") for m in sync.metrics] == \
        [m.get("successful") for m in pipe.metrics]
    assert len(sync.pcmap.submaps) == len(pipe.pcmap.submaps)
    np.testing.assert_array_equal(sync.pcmap.global_map(),
                                  pipe.pcmap.global_map())
    if recs is not None:
        # one record a frame, in order
        assert [r["sid"] for r in recs] == [m["sid"] for m in sync.metrics]


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_matches_sync(name):
    sync = _sync(name)
    pipe, recs = _pipelined(name)
    _assert_same(sync, pipe, recs)
    assert pipe.n_grid_fallbacks == sync.n_grid_fallbacks
    if name == "no_rollback":
        assert pipe.n_rollbacks == pipe.n_replayed == 0
    elif name == "lattice_escape":
        assert sync.n_grid_fallbacks > 0 and pipe.n_replayed > 0
    else:
        assert len(sync.pcmap.submaps) >= 3 and pipe.n_rollbacks >= 2
    if name.startswith("lattice"):
        assert pipe.incremental_grid


def test_checkpoint_with_frames_in_flight_drains_and_resumes(tmp_path):
    """Saved with frames in flight: the save drains them; the file loads
    into a pipelined front end (the config's depth on the CPU) that
    continues bit for bit."""
    name = "no_rollback"
    frames = _frames(name)
    cfg = _cfg(name, pipeline_depth=8)
    assert cfg.resolved_pipeline_depth("cpu") == 8
    fe = PipelinedFrontEnd(cfg, "cpu")
    assert fe.depth == 8
    for fr in frames[:7]:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    assert fe._queue
    path = str(tmp_path / "state.npz")
    save_checkpoint(fe, path)
    assert not fe._queue and len(fe.pose_history) == 7
    loaded = load_checkpoint(path, "cpu", cfg)
    assert isinstance(loaded, PipelinedFrontEnd) and loaded.cnt == 7
    for fr in frames[7:]:
        loaded.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    loaded.finalize()
    _assert_same(_sync(name), loaded)


def test_runner_pipelined_branch_writes_the_sync_records(tmp_path):
    name = "submap_closes"
    path = tmp_path / "metrics.jsonl"
    fe = run_slam(_frames(name), _cfg(name, pipeline_depth=4), "cpu",
                  metrics_path=str(path))
    assert isinstance(fe, PipelinedFrontEnd) and fe.n_rollbacks >= 2
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    walls = [r.pop("wall_s") for r in recs]
    assert walls == sorted(walls)
    sync = _sync(name)
    assert recs == json.loads(json.dumps(sync.metrics))
    _assert_same(sync, fe)
    # depth 0 (the CPU's auto) keeps the synchronous front end
    assert type(run_slam(_frames(name)[:2], _cfg(name), "cpu")) is FrontEnd


def test_snapshot_tensors_keep_their_version():
    """No speculative append writes a tensor a snapshot holds; a write in
    place is caught at the restore. Batch mode is refused."""
    cfg = _cfg("no_rollback", ndt_incremental_grid=1, grid_mom_cells=400)
    fe = PipelinedFrontEnd(cfg, "cpu", depth=100)
    for fr in _frames("no_rollback")[:6]:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    assert len(fe._queue) == 5
    held = [v for e in fe._queue for v in e.snapshot[1]]
    assert len(held) > 20
    assert all(t._version == v for t, v in held)
    fe._restore_snapshot(fe._queue[2].snapshot)
    last = fe._queue[-1].snapshot
    state = last[0]
    assert state[5] is not None        # the lattice is held too
    state[0].xy.add_(0.0)              # the open submap's buffer
    with pytest.raises(RuntimeError, match="written in place"):
        fe._restore_snapshot(last)
    with pytest.raises(ValueError, match="batch mode"):
        BatchFrontEnd(cfg, 1, "cpu", frontends=[fe])
