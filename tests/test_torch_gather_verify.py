"""The gather engine's row axis where the port's callers use it, against
the JAX package on the CPU: the loop-closure verifier and one tick of
the lockstep runner with `ndt_engine = "gather"`.

- `verify_candidates` against JAX's on two of the four scenes of
  tests/test_torch_verify.py (its configuration, the gather engine,
  `ndt_trans_eps` 1e-4 so that the solves stop where they agree), both
  scenes' candidates in one batch (they share the scan; one JAX compile
  and run): `accepted` equal, relative poses within 1e-4 (m, rad), no
  window kernel launched;
- one lockstep tick (`frontend._registration_step` over rows, B = 2)
  against JAX's `vmap` of the step: 0.05 m / 0.3 deg, `successful`
  equal, each row the sequential step's fused pose bit for bit.
The engine's rows against JAX's `vmap`s and row by row:
tests/test_torch_gather_rows.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.graph.loop_closure import verify_candidates as j_verify
from ndt_slam_tpu.io.simulate import simulate_sequence as j_simulate
from ndt_slam_tpu.pipeline.frontend import (
    _registration_step as j_registration_step,
)

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PAD_COORD, pad_points
from ndt_slam_tpu_torch.graph.loop_closure import verify_candidates
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.pipeline.frontend import _registration_step
from ndt_slam_tpu_torch.pre.resample import resample_points_np

torch.set_num_threads(2)

CPU = torch.device("cpu")

# tests/test_torch_verify.py's scenes and configuration, convergence
# pinned
SLOTS, B = 640, 4
VCFG = dict(grid_cells_x=128, grid_cells_y=128, max_scan_points=SLOTS,
            max_submap_points=16384, max_local_map_points=32768,
            end_frame=10_000, loop_enable=True, loop_min_frame_gap=30,
            loop_radius=3.0, loop_score_thre=0.02, loop_keyframe_skip=3,
            loop_check_skip=3, pgo_iterations=10, ndt_engine="gather",
            ndt_trans_eps=1e-4)


def _verify_scenes():
    scan = j_simulate(n_frames=2, beams=541, seed=3,
                      noise_range=0.01)[0].scan_xy
    large = np.zeros((B, 3), np.float32)
    large[0] = [0.5, -0.4, np.deg2rad(5.0)]
    both = np.zeros((B, 3), np.float32)
    both[0] = [0.4, -0.3, np.deg2rad(4.0)]
    return {"large_offset": (scan, large), "both_overlaps": (scan, both)}


VSCENES = _verify_scenes()


def _batch():
    """Both scenes' candidates in one batch of 2B rows (they share the
    scan; rows are independent in either package)."""
    scan = next(iter(VSCENES.values()))[0]
    init = np.concatenate([VSCENES[n][1] for n in sorted(VSCENES)])
    return scan, init


@pytest.fixture(scope="module")
def jax_verify():
    """JAX's verifier on both scenes in one call (one compile, one run)."""
    cfg = JSlamConfig.small(**VCFG)
    assert cfg.resolved_ndt_engine == "gather"
    scan, init = _batch()
    p = j_pad(scan, SLOTS)
    n = init.shape[0]
    res = j_verify(cfg, p.xy, p.mask,
                   jnp.broadcast_to(p.xy, (n,) + p.xy.shape),
                   jnp.broadcast_to(p.mask, (n,) + p.mask.shape),
                   jnp.asarray(init))
    return {k: np.asarray(v) for k, v in res._asdict().items()}


@pytest.fixture(scope="module")
def port_verify():
    cfg = SlamConfig.small(**VCFG)
    assert cfg.resolved_ndt_engine == "gather"
    scan, init = _batch()
    p = pad_points(scan, SLOTS, CPU)
    n = init.shape[0]
    kernels.reset_launch_counts()
    out = verify_candidates(
        cfg, p.xy, p.mask, p.xy[None].expand(n, -1, -1).contiguous(),
        p.mask[None].expand(n, -1).contiguous(), torch.from_numpy(init))
    assert kernels.launch_counts() == {"sgh": 0, "score_many": 0, "nn": 0,
                                       "newton": 0, "fuse": 0}
    return {k: v.numpy() for k, v in out._asdict().items()}


@pytest.mark.parametrize("k", range(len(VSCENES)))
def test_verify_gather_matches_jax(jax_verify, port_verify, k):
    """Scene k: rows k*B .. k*B+B-1 of the batch."""
    rows = slice(k * B, (k + 1) * B)
    got, want = port_verify, jax_verify
    np.testing.assert_array_equal(got["accepted"][rows],
                                  want["accepted"][rows])
    assert got["accepted"][rows][0]
    np.testing.assert_allclose(got["rel_pose_rad"][rows],
                               want["rel_pose_rad"][rows], atol=1e-4)


# one lockstep tick
TKW = dict(end_frame=10_000, ndt_trans_eps=1e-5, ndt_max_iterations=80,
           ndt_engine="gather")
TCFG = SlamConfig.small(**TKW)


def _pad(xy, cap):
    out = np.full((cap, 2), PAD_COORD, np.float32)
    n = min(len(xy), cap)
    out[:n] = xy[:n]
    return out, np.arange(cap) < n


def _to_map(pose_deg, xy):
    th = np.deg2rad(pose_deg[2])
    c, s = np.cos(th), np.sin(th)
    return np.stack([c * xy[:, 0] - s * xy[:, 1] + pose_deg[0],
                     s * xy[:, 0] + c * xy[:, 1] + pose_deg[1]],
                    axis=1).astype(np.float32)


def _tick_row(seed, k=4):
    """Frame k of a simulated sequence against the scans of frames k-1
    and k+1 at their true poses (tests/test_torch_batch_step.py)."""
    fr = simulate_sequence(n_frames=14, beams=181, seed=seed)
    rs = lambda f: resample_points_np(f.scan_xy, TCFG.resample_space,
                                      TCFG.resample_space_thre)
    scan, mask = _pad(rs(fr[k]), TCFG.max_scan_points)
    local, local_mask = _pad(np.concatenate([
        _to_map(fr[j].true_pose, rs(fr[j])) for j in (k - 1, k + 1)]),
        TCFG.max_local_map_points)
    return (scan, mask, np.asarray(fr[k].odo_pose, np.float32),
            np.asarray(fr[k - 1].odo_pose, np.float32),
            np.asarray(fr[k - 1].true_pose, np.float32),
            np.diag([1e-3, 1e-3, 1e-4]).astype(np.float32), local,
            local_mask)


def test_lockstep_tick_gather_matches_jax_vmap():
    rows = [_tick_row(3), _tick_row(11)]
    args = [np.stack([r[j] for r in rows]) for j in range(8)]
    jcfg = JSlamConfig.small(**TKW)
    step = jax.jit(jax.vmap(
        lambda *a: j_registration_step.__wrapped__(jcfg, *a)))
    want = jax.device_get(step(*[jnp.asarray(a) for a in args]))
    got = _registration_step(TCFG, *[torch.from_numpy(a) for a in args])
    assert got.small().shape == (2, 24)
    np.testing.assert_array_equal(got.successful.numpy(),
                                  np.asarray(want.successful))
    assert got.successful.all()
    for name in ("est_pose", "fused_pose"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert np.hypot(*(a[:, :2] - b[:, :2]).T).max() <= 0.05
        assert np.abs(a[:, 2] - b[:, 2]).max() <= 0.3
    # each row, as the sequential gather step computes it alone
    for r in range(2):
        one = _registration_step(TCFG, *[torch.from_numpy(a[r])
                                         for a in args])
        assert torch.equal(got.fused_pose[r], one.fused_pose)
