"""The port's multi-rank sequential loop
(`ndt_slam_tpu_torch.pipeline.dist_runner`) on two gloo ranks of the
CPU.

One module fixture spawns the two ranks once and runs
`parallel/jobs.slam` twice and `jobs.broadcast`: ten simulated frames
(`simulate_sequence(n_frames=10, beams=181, seed=3)`, held by rank 0
only, every frame broadcast) through `run_slam_distributed`, the
synchronous front end and the pipelined one at depth 4, then one
`broadcast_frame` round trip. Held, as tests/distributed/
test_multiprocess.py holds the JAX package: both ranks' trajectories
bitwise equal; the pipelined run bitwise equal to the synchronous one;
the run within 5e-4 m (and 0.03 deg) of the port's single-device
`FrontEnd` at `ndt_trans_eps` 1e-4; within 0.05 m / 0.3 deg of the JAX
package's `run_slam_distributed` over two of its virtual devices (two
packages, f32 iteration chaos: its own multi-process bar); the frame
received equal to the frame sent.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.pipeline.dist_runner import (
    run_slam_distributed as j_run_slam_distributed,
)

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.parallel import jobs, start
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

torch.set_num_threads(2)

# the simulator's 181 beams fill well under 256 cells of the table; a
# 2048-point target, so that the second rank's half of it holds points
# from the second frame on (as its half of the 512 source slots does)
KW = dict(end_frame=10_000, ndt_trans_eps=1e-4, ndt_max_iterations=80,
          ndt_max_active_cells=256, max_local_map_points=2048)
CFG = SlamConfig.small(**KW)
FRAMES = simulate_sequence(n_frames=10, beams=181, seed=3)
PROBE = 3


@pytest.fixture(scope="module")
def started():
    handle = start(jobs.run, 2, [
        ("slam", (CFG.replace(pipeline_depth=0), FRAMES), {}),
        ("slam", (CFG.replace(pipeline_depth=4), FRAMES), {}),
        ("broadcast", (FRAMES[PROBE], 4 * CFG.max_scan_points), {})])
    yield handle
    handle.close()


@pytest.fixture(scope="module")
def single():
    """The port's single-device front end over the same frames (made
    while the ranks run)."""
    fe = FrontEnd(CFG, "cpu")
    for fr in FRAMES:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    return fe


@pytest.fixture(scope="module")
def jax_poses():
    jcfg = JSlamConfig.small(**KW)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pt",))
    return j_run_slam_distributed(FRAMES, jcfg, mesh=mesh).get_poses()


@pytest.fixture(scope="module")
def ranks(started, single, jax_poses):
    out = []
    for sync, pipe, (scan, odo) in started.result():
        out.append({"poses": sync["poses"], "covs": sync["covs"],
                    "accept": sync["accept"], "poses_pipe": pipe["poses"],
                    "covs_pipe": pipe["covs"], "scan": scan, "odo": odo})
    return out


def _close(a, b, pos_tol, ang_tol):
    assert a.shape == b.shape
    assert np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max() <= pos_tol
    d = np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0)
    assert d.max() <= ang_tol, d.max()


def test_both_ranks_bitwise_equal(ranks):
    r0, r1 = ranks
    for k in ("poses", "covs", "poses_pipe", "covs_pipe"):
        assert r0[k].shape == (10, 3) or r0[k].shape == (10, 3, 3)
        assert r0[k].tobytes() == r1[k].tobytes(), k
    assert r0["accept"] == r1["accept"]


def test_pipelined_equals_synchronous_bit_for_bit(ranks):
    for r in ranks:
        assert r["poses_pipe"].tobytes() == r["poses"].tobytes()
        assert r["covs_pipe"].tobytes() == r["covs"].tobytes()


def test_second_halves_hold_points(single):
    """The target of the last frame reaches into the second rank's half
    (the buffers fill from the front)."""
    mask = single.pcmap.registration_target().mask
    assert mask[CFG.max_local_map_points // 2:].any()


def test_matches_the_single_device_front_end(ranks, single):
    _close(ranks[0]["poses"], single.get_poses(), 5e-4, 0.03)
    assert ranks[0]["accept"] == [bool(m.get("successful"))
                                  for m in single.metrics]


def test_matches_jax_distributed_loop(ranks, jax_poses):
    _close(ranks[0]["poses"], jax_poses, 0.05, 0.3)


def test_broadcast_frame_round_trip(ranks):
    fr = FRAMES[PROBE]
    for r in ranks:
        assert r["scan"].dtype == np.float32 and r["odo"].dtype == np.float32
        np.testing.assert_array_equal(r["scan"],
                                      np.asarray(fr.scan_xy, np.float32))
        np.testing.assert_array_equal(r["odo"],
                                      np.asarray(fr.odo_pose, np.float32))
