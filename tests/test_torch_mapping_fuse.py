"""Parity of the PyTorch port's mapping, fusion, pose algebra, point
buffers and config (ndt_slam_tpu_torch) with the JAX package, on the
CPU. Seeded numpy inputs go through both packages; where the two take
the same operations in the same order the outputs must be bit-equal
(voxel filter, buffers, the per-frame map update), elsewhere the
tolerance is stated at the assertion."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core import pose2 as j_pose2
from ndt_slam_tpu.core.points import (
    PointBuffer as JPointBuffer, concat_buffers as j_concat_buffers,
    pad_points as j_pad,
)
from ndt_slam_tpu.fuse.ekf import gate_and_fuse as j_gate_and_fuse
from ndt_slam_tpu.mapping.dynamic import (
    occupancy_diff_mask as j_occupancy_diff_mask,
    process_interior_scan as j_process_interior_scan,
)
from ndt_slam_tpu.mapping.pointcloud_map import (
    _add_scan_and_target as j_add_scan_and_target,
)
from ndt_slam_tpu.mapping.voxel import voxel_filter as j_voxel_filter

from ndt_slam_tpu_torch.config import LATTICE_AUTO_ON_CUDA, SlamConfig
from ndt_slam_tpu_torch.core import pose2
from ndt_slam_tpu_torch.core.points import (
    PointBuffer, concat_buffers, pad_points,
)
from ndt_slam_tpu_torch.fuse.ekf import gate_and_fuse
from ndt_slam_tpu_torch.mapping.dynamic import (
    occupancy_diff_mask, process_interior_scan,
)
from ndt_slam_tpu_torch.mapping.pointcloud_map import _add_scan_and_target
from ndt_slam_tpu_torch.mapping.voxel import voxel_filter

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _bufs(xy, cap, mask_keep=None):
    """The same masked buffer in both packages."""
    j = j_pad(xy, cap)
    t = pad_points(xy, cap, CPU)
    if mask_keep is not None:
        j = JPointBuffer(j.xy, j.mask & jnp.asarray(mask_keep))
        t = PointBuffer(t.xy, t.mask & torch.from_numpy(mask_keep))
    return j, t


def _assert_buf_equal(t: PointBuffer, j):
    np.testing.assert_array_equal(_np(t.mask), _np(j.mask))
    np.testing.assert_array_equal(_np(t.xy), _np(j.xy))


def _wall_scan(rng, n, shift=(0.0, 0.0)):
    """Points on a few wall segments with noise (a submap-like cloud)."""
    a = np.array([[-3.0, -2.0], [-3.0, 2.0], [2.0, -2.0]])
    b = np.array([[3.0, -2.0], [3.0, 2.5], [2.0, 2.0]])
    seg = rng.integers(0, 3, size=n)
    t = rng.uniform(0, 1, size=(n, 1))
    p = a[seg] + t * (b[seg] - a[seg]) + 0.01 * rng.standard_normal((n, 2))
    return (p + np.asarray(shift)).astype(np.float32)


def test_config_round_trips_jax_dict():
    d = JSlamConfig.small(end_frame=40).to_dict()
    cfg = SlamConfig.from_dict(d)
    assert cfg.to_dict() == d
    assert SlamConfig() == SlamConfig.from_dict(JSlamConfig().to_dict())
    assert [f.name for f in dataclasses.fields(SlamConfig)] == \
        [f.name for f in dataclasses.fields(JSlamConfig)]
    with pytest.raises(ValueError, match="unknown config keys"):
        SlamConfig.from_dict({"no_such_key": 1})
    assert not cfg.resolved_ndt_incremental_grid("cpu")
    assert cfg.resolved_ndt_incremental_grid("cuda") is LATTICE_AUTO_ON_CUDA
    assert cfg.replace(ndt_incremental_grid=1) \
        .resolved_ndt_incremental_grid("cpu")
    assert not cfg.replace(ndt_incremental_grid=1, ndt_target_filtered=True) \
        .resolved_ndt_incremental_grid("cuda")
    for kw in (dict(), dict(grid_mom_cells=100), dict(grid_mom_cells=40),
               dict(submap_sep_thre=3.3, ndt_resolution=0.25)):
        assert cfg.replace(**kw).resolved_grid_mom_cells == \
            JSlamConfig.small(**kw).resolved_grid_mom_cells
    assert SlamConfig().resolved_grid_mom_cells == 286
    assert cfg.resolved_pipeline_depth("cpu") == 0
    assert cfg.resolved_ndt_engine == "compact"
    assert cfg.replace(ndt_engine="gather").resolved_ndt_engine == "gather"


def test_pose_algebra_matches_jax():
    rng = np.random.default_rng(0)
    a = (rng.uniform(-20, 20, (64, 3)) * [1, 1, 9]).astype(np.float32)
    b = (rng.uniform(-20, 20, (64, 3)) * [1, 1, 9]).astype(np.float32)
    pts = rng.uniform(-10, 10, (64, 2)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (pose2.cal_motion(ta, tb), j_pose2.cal_motion(a, b)),
        (pose2.cal_pred_pose(ta, tb), j_pose2.cal_pred_pose(a, b)),
        (pose2.cal_global_motion(ta, tb), j_pose2.cal_global_motion(a, b)),
        (pose2.global_points(ta[0], torch.from_numpy(pts)),
         j_pose2.global_points(a[0], pts)),
        (pose2.pose_rad_to_deg(pose2.pose_deg_to_rad(ta)),
         j_pose2.pose_rad_to_deg(j_pose2.pose_deg_to_rad(a))),
    ]
    for got, want in pairs:
        # f32 ulps of sin/cos at angles up to ~180 deg and map-scale values
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


def test_concat_buffers_matches_jax():
    rng = np.random.default_rng(1)
    ja, ta = _bufs(rng.uniform(-5, 5, (20, 2)), 32, rng.uniform(size=32) < .7)
    jb, tb = _bufs(rng.uniform(-5, 5, (30, 2)), 40, rng.uniform(size=40) < .7)
    _assert_buf_equal(concat_buffers(ta, tb, 48), j_concat_buffers(ja, jb, 48))


@pytest.mark.parametrize("leaf", [0.05, 0.3])
def test_voxel_filter_bit_equal_to_jax(leaf):
    rng = np.random.default_rng(2)
    xy = _wall_scan(rng, 900)
    keep = rng.uniform(size=1024) < 0.9
    j, t = _bufs(xy, 1024, keep)
    got, want = voxel_filter(t, leaf), j_voxel_filter(j, leaf)
    assert int(got.mask.sum()) > 10
    _assert_buf_equal(got, want)


def test_occupancy_diff_matches_jax():
    rng = np.random.default_rng(3)
    jb, tb = _bufs(_wall_scan(rng, 400), 512)
    jt, tt = _bufs(np.concatenate([_wall_scan(rng, 300),
                                   rng.uniform(-4, 4, (50, 2))]), 512)
    got = occupancy_diff_mask(tb.xy, tb.mask, tt.xy, tt.mask, 0.05)
    want = j_occupancy_diff_mask(jb.xy, jb.mask, jt.xy, jt.mask, 0.05)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert 0 < int(got.sum()) < 350


def test_process_interior_scan_matches_jax():
    rng = np.random.default_rng(4)
    mover = np.array([[0.5, 0.5], [0.52, 0.51], [0.55, 0.49]])
    jp, tp = _bufs(_wall_scan(rng, 400), 512)
    jc, tc = _bufs(np.concatenate([_wall_scan(rng, 400), mover]), 512)
    jn, tn = _bufs(_wall_scan(rng, 400), 512)
    got = process_interior_scan(tp, tc, tn, 0.05, 0.2)
    want = j_process_interior_scan(jp, jc, jn, 0.05, 0.2)
    _assert_buf_equal(got, want)
    kept = int(got.mask.sum())
    assert 0 < kept < 403


FLAGS = [
    # append_scan, do_interior, include_newest, has_prev, filtered
    (True, False, True, False, False),
    (False, True, True, True, False),
    (False, True, True, True, True),
    (True, False, False, True, False),
]


@pytest.mark.parametrize("flags", FLAGS)
def test_add_scan_and_target_matches_jax(flags):
    append_scan, do_interior, include_newest, has_prev, filtered = flags
    rng = np.random.default_rng(5)
    proc_np = _wall_scan(rng, 1500)
    jproc, tproc = _bufs(proc_np, 4096)
    jra, tra = _bufs(_wall_scan(rng, 300), 512)
    jrb, trb = _bufs(_wall_scan(rng, 300, (0.02, 0.0)), 512)
    jsc, tsc = _bufs(np.concatenate([_wall_scan(rng, 300, (0.04, 0.0)),
                                     [[0.3, 0.3], [0.31, 0.3]]]), 512)
    if has_prev:
        jpv, tpv = _bufs(_wall_scan(rng, 2000, (-1.0, 0.0)), 4096)
    else:
        jpv, tpv = JPointBuffer.empty(1), PointBuffer.empty(1, CPU)
    kw = dict(append_scan=append_scan, do_interior=do_interior,
              include_newest=include_newest, has_prev=has_prev,
              filtered=filtered, cap_sub=4096, cap_local=8192,
              resol=0.05, thre=0.2, leaf=0.05)
    proc, count, target = _add_scan_and_target(
        tproc, torch.tensor(1500, dtype=torch.int32), tra, trb, tsc, tpv, **kw)
    jproc2, jcount, jtarget = j_add_scan_and_target(
        jproc, jnp.int32(1500), jra, jrb, jsc, jpv, **kw)
    assert int(count) == int(jcount) > 1500
    _assert_buf_equal(proc, jproc2)
    _assert_buf_equal(target, jtarget)


def _ekf_case(kind):
    """(pred, est, hessian, cost, odo_motion, last_pose, last_cov)."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    evals = {"degenerate": [2e-3, 50.0, 400.0],
             "conditioned": [30.0, 80.0, 500.0],
             "reject": [30.0, 80.0, 500.0]}[kind]
    H = (q * np.asarray(evals)) @ q.T
    pred = np.array([3.0, -2.0, 40.0])
    est = pred + [0.05, -0.03, 0.8]
    cost = 2.0 if kind == "reject" else 0.05
    motion = np.array([0.2, 0.01, 1.5])
    last = np.array([2.8, -2.0, 38.5])
    cov = np.diag([1e-3, 2e-3, 5e-4]) + 1e-4
    return [np.asarray(v, np.float32) for v in
            (pred, est, H, cost, motion, last, cov)]


@pytest.mark.parametrize("kind", ["degenerate", "conditioned", "reject"])
def test_gate_and_fuse_matches_jax(kind):
    """Eigenvector signs may differ between the packages; the fused pose
    and covariance depend only on the sign-free projections."""
    args = _ekf_case(kind)
    cfg, jcfg = SlamConfig(), JSlamConfig()
    fused, cov, accept = gate_and_fuse(
        cfg, *[torch.from_numpy(np.asarray(a)) for a in args])
    jf, jc, ja = j_gate_and_fuse(jcfg, *[jnp.asarray(a) for a in args])
    assert bool(accept) == bool(ja) == (kind != "reject")
    np.testing.assert_allclose(_np(fused), _np(jf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(cov), _np(jc), rtol=1e-4, atol=1e-8)
    if kind == "degenerate":
        # without the projection both packages fuse along the weak
        # direction too, and land elsewhere
        f0, _, _ = gate_and_fuse(
            cfg.replace(fuse_degenerate_ratio=0.0),
            *[torch.from_numpy(np.asarray(a)) for a in args])
        jf0, _, _ = j_gate_and_fuse(
            jcfg.replace(fuse_degenerate_ratio=0.0),
            *[jnp.asarray(a) for a in args])
        np.testing.assert_allclose(_np(f0), _np(jf0), rtol=1e-5, atol=1e-5)
        assert np.abs(_np(f0) - _np(fused)).max() > 1e-3
