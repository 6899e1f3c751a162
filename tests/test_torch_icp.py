"""The port's trimmed ICP (ndt_slam_tpu_torch.ndt.icp) and the argmin
twin of its nearest-neighbour pass, on the CPU.

`icp_refine` runs over a batch axis; the JAX package's runs one pose.
Both take the nearest target of each source point, but JAX as a matmul
(|s|^2 + |t|^2 - 2 s.t at Precision.HIGHEST) and the port in the
difference form, so they are held by result, not index by index: pose
within 1e-3 m / 0.01 deg, `matched_frac` within 2 points of the valid
ones, `mean_sq_err` within 1e-4 m^2, on a simulated pair of scans at
three initial offsets in one batched call.

`fitness.nn_argmin` (the argmin form's twin) is held to a plain numpy
argmin and to hand-made ties, NaNs and masks: the lowest index among
equal distances across chunk borders, a NaN winning and the lowest NaN
index kept, a masked slot never chosen, index 0 where there is nothing
to choose, and its distances equal to `nn_sq_dists` bit for bit. The
kernel against this twin on the card: tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.io.simulate import simulate_sequence
from ndt_slam_tpu.ndt.icp import icp_refine as j_icp_refine

from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.ndt.fitness import BIG, nn_argmin, nn_sq_dists
from ndt_slam_tpu_torch.ndt.icp import icp_refine

torch.set_num_threads(2)

CPU = torch.device("cpu")
SLOTS = 640
OFFSETS = np.array([[0.05, -0.03, np.deg2rad(1.0)],
                    [0.12, 0.08, np.deg2rad(-2.5)],
                    [-0.15, 0.10, np.deg2rad(3.0)]], np.float32)


def test_icp_refine_matches_jax():
    frames = simulate_sequence(n_frames=2, beams=541, seed=3,
                               noise_range=0.01)
    src_np, tgt_np = frames[1].scan_xy, frames[0].scan_xy
    t0, t1 = frames[0].true_pose, frames[1].true_pose
    th = np.deg2rad(t0[2])
    d = t1[:2] - t0[:2]
    true_rel = np.array([np.cos(th) * d[0] + np.sin(th) * d[1],
                         -np.sin(th) * d[0] + np.cos(th) * d[1],
                         np.deg2rad(t1[2] - t0[2])], np.float32)
    init = true_rel[None, :] + OFFSETS

    j_src, j_tgt = j_pad(src_np, SLOTS), j_pad(tgt_np, SLOTS)
    run = jax.jit(lambda p: j_icp_refine(p, j_src.xy, j_src.mask, j_tgt.xy,
                                         j_tgt.mask))
    want = [run(jnp.asarray(p)) for p in init]

    src, tgt = pad_points(src_np, SLOTS, CPU), pad_points(tgt_np, SLOTS, CPU)
    b = len(init)
    got = icp_refine(torch.from_numpy(init), src.xy, src.mask,
                     tgt.xy[None].expand(b, -1, -1).contiguous(),
                     tgt.mask[None].expand(b, -1).contiguous())
    assert kernels.launch_counts() == {"sgh": 0, "score_many": 0, "nn": 0,
                                       "newton": 0, "fuse": 0}
    n_valid = int(src.mask.sum())
    for k, w in enumerate(want):
        pose = got.pose_rad[k].numpy()
        np.testing.assert_allclose(pose[:2], np.asarray(w.pose_rad)[:2],
                                   atol=1e-3)
        assert abs(np.rad2deg(pose[2] - float(w.pose_rad[2]))) <= 0.01
        assert abs(float(got.matched_frac[k]) - float(w.matched_frac)) \
            <= 2.0 / n_valid
        assert abs(float(got.mean_sq_err[k]) - float(w.mean_sq_err)) <= 1e-4
        # ICP pulled every start onto the scans' relative pose
        np.testing.assert_allclose(pose[:2], true_rel[:2], atol=0.02)
        assert float(got.matched_frac[k]) > 0.9


def _numpy_argmin(src, sm, tgt, tm):
    """Brute force in float32, the difference form: the lowest live
    index at the least distance."""
    d = ((src[:, :, None, 0] - tgt[:, None, :, 0]) ** 2
         + (src[:, :, None, 1] - tgt[:, None, :, 1]) ** 2).astype(np.float32)
    d = np.where(tm[:, None, :], d, np.inf)
    idx = np.argmin(d, axis=-1)
    idx = np.where(sm & tm.any(axis=-1)[:, None], idx, 0)
    return idx.astype(np.int32)


@pytest.mark.parametrize("chunk", [5, 4096])
def test_argmin_twin_equals_brute_force_with_many_ties(chunk):
    """Points on an integer lattice: most sources have several targets
    at the same distance, some of them in other chunks."""
    rng = np.random.default_rng(12)
    src = rng.integers(-4, 5, (3, 40, 2)).astype(np.float32) + 0.5
    tgt = rng.integers(-4, 5, (3, 33, 2)).astype(np.float32)
    sm = rng.uniform(size=(3, 40)) < 0.8
    tm = rng.uniform(size=(3, 33)) < 0.6
    tm[2] = False                                  # a row without targets
    args = [torch.from_numpy(a) for a in (src, sm, tgt, tm)]
    d2, idx = nn_argmin(*args, chunk=chunk)
    assert idx.dtype == torch.int32 and idx.shape == (3, 40)
    np.testing.assert_array_equal(idx.numpy(), _numpy_argmin(src, sm, tgt, tm))
    assert torch.equal(d2, nn_sq_dists(*args))
    for r in range(3):
        assert torch.equal(d2[r], nn_sq_dists(*(a[r] for a in args)))
    assert (d2[2] == BIG).all() and (idx[2] == 0).all()
    assert (d2[~args[1]] == BIG).all() and (idx[~args[1]] == 0).all()
    # the wrapper takes the twin for CPU tensors
    assert all(torch.equal(a, b) for a, b in
               zip(kernels.nn_argmin(*args), nn_argmin(*args)))


def _one(src, sm, tgt, tm, chunk=3):
    d2, idx = nn_argmin(torch.tensor([src], dtype=torch.float32),
                        torch.tensor([sm]),
                        torch.tensor([tgt], dtype=torch.float32),
                        torch.tensor([tm]), chunk=chunk)
    return d2[0], idx[0]


def test_argmin_twin_ties_masks_and_far_targets():
    far = 2.0e6                         # squared distance 4e12 > 1e12
    tgt = [[9.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0],
           [1.0, 0.0], [far, 0.0]]
    src = [[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [5.0, 5.0]]
    tm = [True, True, True, True, True, True, True]
    d2, idx = _one(src, [True, True, True, False], tgt, tm)
    # four targets at 1: the lowest index; a duplicate at 5 loses to 1
    assert idx.tolist()[:3] == [1, 1, 3] and d2.tolist()[:3] == [1.0, 0.0, 0.0]
    assert float(d2[3]) == float(np.float32(BIG)) and int(idx[3]) == 0
    # the nearest slot masked: the next one wins; a tie across chunks
    d2, idx = _one(src[:1], [True], tgt, [True, False, False, True, True,
                                          True, True])
    assert int(idx[0]) == 3 and float(d2[0]) == 1.0
    # only a target farther than 1e12: its index, the distance capped
    d2, idx = _one(src[:1], [True], tgt, [False] * 6 + [True])
    assert int(idx[0]) == 6 and float(d2[0]) == float(np.float32(BIG))
    # no live target: index 0, 1e12
    d2, idx = _one(src[:1], [True], tgt, [False] * 7)
    assert int(idx[0]) == 0 and float(d2[0]) == float(np.float32(BIG))


def test_argmin_twin_carries_nan():
    tgt = [[1.0, 0.0], [0.5, 0.0], [float("nan"), 0.0], [0.1, 0.0],
           [0.0, float("nan")], [2.0, 0.0]]
    src = [[0.0, 0.0], [float("nan"), 1.0]]
    live = [True] * 6
    d2, idx = _one(src, [True, True], tgt, live)
    # a live NaN target: NaN wins, the lowest NaN index is kept
    assert bool(torch.isnan(d2).all()) and idx.tolist() == [2, 0]
    # masked NaN targets are never met
    d2, idx = _one(src, [True, True], tgt,
                   [True, True, False, True, False, True])
    assert float(d2[0]) == float(np.float32(0.1) ** 2) and int(idx[0]) == 3
    # a NaN source: NaN against every target, the first live one named
    assert bool(torch.isnan(d2[1])) and int(idx[1]) == 0
    d2, idx = _one(src[1:], [True], tgt, [False, True, False, True, False,
                                          True])
    assert bool(torch.isnan(d2[0])) and int(idx[0]) == 1
