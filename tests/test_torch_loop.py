"""The loop-closure slice of the port on the CPU: the front end with
`loop_enable`, the verifier, the pose graph and the map rewrite,
against the JAX package.

The scene is tests/integration/test_loop_closure.py's drifting circle
(`_circle`, odometry noise 0.10 m / 2.5 deg), cut to 30 frames of 181
beams at `SlamConfig.small` with a 192-cell table (the scene fills
at most 169 cells) and 4096/8192-point
map buffers, keyframes and checks every 2 frames, a 15-frame gap, 2
candidates a check and 3 coarse starts (with the defaults, 4 and 5,
the same edges are accepted at twice the CPU time): the loop closes at
frames 26 and 28 (3 edges, 2 corrections). Convergence
is tight (`ndt_trans_eps` 1e-4, 80 iterations) so that the packages'
front ends stop where they agree.

The two front ends fork on this sequence all the same: run from frame
0, both accept the same three edges with the same costs, but frame 25
lands 0.15 m / 2.3 deg apart (8 against 13 Newton iterations: two
optima, as ROADMAP.md notes for a bistable frame). So the packages are
compared from shared state, the checkpoint of frame 25 (back-end state
included): JAX loads the port's file, writes it again in its own
writer and continues; the port continues JAX's file; each is held to
the other's continuation: the same edges, `loops_accepted` and
`n_corrections` equal, every pose within 0.05 m / 0.3 deg (measured:
0.9 mm / 0.008 deg). Then, for the port alone: a resume from its own
checkpoint equals its straight run bit for bit (two map rewrites after
the resume); the ATE with loops is below the ATE without (no
correction runs before frame 26, so the run without loops continues the
front-end half of the frame-25 checkpoint with loops off: measured bit
for bit equal to a run without loops from frame 0, at a fifth of its
CPU time); the
asynchronous verify (`loop_verify_async=1`) accepts the same edges and
lands within the reference test's bound of the synchronous run. One
JAX compile of each program (module fixture).
"""

import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.pipeline.checkpoint import (
    load_checkpoint as j_load_checkpoint, save_checkpoint as j_save_checkpoint,
)
from ndt_slam_tpu.pipeline.frontend import FrontEnd as JFrontEnd

from ndt_slam_tpu_torch import convert
from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.metrics import ate_rmse
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


def _step(fe, frames):
    for fr in frames:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    fe.finalize()


def _gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    dxy = float(np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max())
    dth = float(np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0).max())
    return dxy, dth


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    frames = simulate_sequence(n_frames=N, beams=181, seed=7,
                               trajectory=_circle(N), odo_noise_v=0.10,
                               odo_noise_w=2.5)
    cfg, jcfg = SlamConfig.small(**KW), JSlamConfig.small(**KW)
    out = dict(frames=frames, cfg=cfg, tmp=tmp,
               true=np.asarray([f.true_pose for f in frames]))

    fe = FrontEnd(cfg, "cpu")
    _step(fe, frames[:CUT])
    out["ckpt"] = str(tmp / "port.npz")
    save_checkpoint(fe, out["ckpt"])
    _step(fe, frames[CUT:])
    out["fe"] = fe

    # JAX reads the port's file, writes its own, and continues
    jfe = j_load_checkpoint(out["ckpt"], jcfg)
    out["jckpt"] = str(tmp / "jax.npz")
    j_save_checkpoint(jfe, out["jckpt"])
    _step(jfe, frames[CUT:])
    out["jfe"] = jfe
    return out


def _same_backend_counts(a, b):
    assert a.backend.loops_accepted == b.backend.loops_accepted
    assert a.n_corrections == b.n_corrections
    assert len(a.backend.loop_edges) == len(b.backend.loop_edges)
    assert [(e["sid_old"], e["sid_new"]) for e in a.backend.edge_log] == \
        [(e["sid_old"], e["sid_new"]) for e in b.backend.edge_log]


def test_loop_closes_in_the_slice(runs):
    fe = runs["fe"]
    assert fe.backend.loops_accepted == 3 and fe.n_corrections == 2
    assert fe.pcmap.remake_stats["calls"] == fe.n_corrections
    assert len(fe.pose_history) == N
    assert len(fe.backend.node_sids) == N
    assert len(fe.backend.odom_edges) == N - 1


def test_port_continues_jax_checkpoint_as_jax_does(runs):
    fe = load_checkpoint(runs["jckpt"], "cpu", runs["cfg"])
    assert fe.cnt == CUT and len(fe.backend.node_sids) == CUT
    assert fe.backend.keyframes.sids == list(range(0, CUT, 2))
    _step(fe, runs["frames"][CUT:])
    jfe = runs["jfe"]
    _same_backend_counts(fe, jfe)
    dxy, dth = _gap(fe.get_poses(), jfe.get_poses())
    print(f"the port continuing JAX's checkpoint of frame {CUT}: "
          f"{dxy:.3g} m, {dth:.3g} deg from JAX's continuation")
    assert dxy <= 0.05 and dth <= 0.3


def test_jax_continues_port_checkpoint_as_the_port_does(runs):
    jfe, fe = runs["jfe"], runs["fe"]
    _same_backend_counts(jfe, fe)
    dxy, dth = _gap(jfe.get_poses(), fe.get_poses())
    print(f"JAX continuing the port's checkpoint of frame {CUT}: "
          f"{dxy:.3g} m, {dth:.3g} deg from the port's own continuation")
    assert dxy <= 0.05 and dth <= 0.3


def test_resume_with_loops_is_exact(runs):
    fe = load_checkpoint(runs["ckpt"], "cpu")
    _step(fe, runs["frames"][CUT:])
    full = runs["fe"]
    assert fe.n_corrections == full.n_corrections >= 1
    np.testing.assert_array_equal(fe.get_poses(), full.get_poses())
    np.testing.assert_array_equal(np.stack(fe.backend.node_poses_rad),
                                  np.stack(full.backend.node_poses_rad))
    for a, b in zip(fe.backend.loop_edges, full.backend.loop_edges):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_array_equal(fe.pcmap.global_map(),
                                  full.pcmap.global_map())


def test_loops_lower_the_ate(runs):
    arrays, meta = convert.read_checkpoint(runs["ckpt"])
    front = {k: v for k, v in arrays.items()
             if not k.startswith(convert._BACKEND_PREFIXES)}
    fe = runs["fe"]
    assert not any(m.get("loop_closed") for m in fe.metrics[:CUT])
    off_fe = convert.frontend_from_state(
        front, {**meta, "backend": None}, "cpu",
        runs["cfg"].replace(loop_enable=False))
    _step(off_fe, runs["frames"][CUT:])
    off = off_fe.get_poses()
    true = runs["true"]
    ate_on = ate_rmse(fe.get_poses(), true, align=False)
    ate_off = ate_rmse(off, true, align=False)
    print(f"ATE with loops {ate_on:.4f} m, without {ate_off:.4f} m")
    assert ate_on < ate_off


def test_async_verify_matches_sync(runs):
    cfg = runs["cfg"].replace(loop_verify_async=1)
    fe = load_checkpoint(runs["ckpt"], "cpu", cfg, strict=False)
    assert fe.backend.verify_async
    _step(fe, runs["frames"][CUT:])
    sync = runs["fe"]
    assert fe.backend.loops_accepted == sync.backend.loops_accepted
    assert fe.n_corrections >= 1 and fe.backend._inflight is None
    true = runs["true"]
    ate_a = ate_rmse(fe.get_poses(), true, align=False)
    ate_s = ate_rmse(sync.get_poses(), true, align=False)
    print(f"ATE async {ate_a:.4f} m, sync {ate_s:.4f} m")
    assert ate_a < 1.5 * ate_s + 0.05
    assert fe.backend.t_optimize > 0.0
