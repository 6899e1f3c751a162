"""The port's map rewrite after a loop closure
(`PointCloudMap.remake_maps`) on the CPU, on the scenes of
tests/unit/test_mapping.py:192-274: a map grown as the front end grows
it (12 frames, a submap every ~3), then a correction that moves only
the tail.

- incremental against the full rebuild (negative thresholds), with and
  without dynamic-object removal: closed clouds, the open cloud and the
  registration target equal, and the incremental path keeps at least
  one submap;
- against JAX's `remake_maps` on the same recorded scans and corrected
  poses: every buffer equal to 1e-6 (masks exactly), `remake_stats`
  equal, the moment lattice invalidated and the cached target dropped;
- the rebuilt map keeps growing as a map built with the corrected poses
  from the start (through a submap close);
- the rebuild after a checkpoint load, when the device scan cache is
  empty, equals the one with the cache.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import (
    PAD_COORD as J_PAD, PointBuffer as JPointBuffer, pad_points as j_pad,
)
from ndt_slam_tpu.core.pose2 import global_points as j_global_points
from ndt_slam_tpu.mapping import PointCloudMap as JPointCloudMap

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PAD_COORD, PointBuffer, pad_points
from ndt_slam_tpu_torch.core.pose2 import global_points
from ndt_slam_tpu_torch.mapping.pointcloud_map import PointCloudMap

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _walk(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(np.array([0.45 * i, 0.02 * i, 2.0 * i], np.float32),
             rng.standard_normal((35, 2)).astype(np.float32) * 0.8)
            for i in range(n)]


def _grow(pm, pose, local, padded=True):
    buf = pad_points(local, pm.cfg.max_scan_points, CPU)
    g = global_points(torch.from_numpy(pose), buf.xy)
    pm.add_pose(pose)
    pm.add_points(PointBuffer(torch.where(buf.mask[:, None], g, PAD_COORD),
                              buf.mask))
    pm.set_last_pose(pose)
    pm.record_local_scan(local, padded=buf if padded else None)


def _j_grow(pm, pose, local):
    buf = j_pad(local, pm.cfg.max_scan_points)
    g = j_global_points(jnp.asarray(pose), buf.xy)
    pm.add_pose(pose)
    pm.add_points(JPointBuffer(jnp.where(buf.mask[:, None], g, J_PAD),
                               buf.mask), make_target=True)
    pm.set_last_pose(pose)
    pm.record_local_scan(local)


def _map(cfg, n=12, padded=True):
    pm = PointCloudMap(cfg, CPU)
    for pose, local in _walk(n):
        _grow(pm, pose, local, padded)
    return pm


def _corrected(pm):
    new = np.stack(pm.poses).astype(np.float32)
    new[8:, 0] += 0.3          # the correction moves only the tail
    new[8:, 2] += 1.5
    return new


def _np(buf):
    return np.asarray(buf.xy), np.asarray(buf.mask)


def _same(a, b, atol=0.0):
    (ax, am), (bx, bm) = _np(a), _np(b)
    np.testing.assert_array_equal(am, bm)
    np.testing.assert_allclose(ax[am], bx[bm], atol=atol, rtol=0)


def _kw(remove_moving):
    return dict(submap_sep_thre=1.5, remove_moving=remove_moving)


@pytest.mark.parametrize("remove_moving", [True, False])
def test_incremental_matches_full_rebuild(remove_moving):
    cfg = SlamConfig.small(**_kw(remove_moving))
    inc, full = _map(cfg), _map(cfg)
    assert len(inc.submaps) >= 3
    new = _corrected(inc)
    inc.remake_maps(new)
    full.remake_maps(new, thresh_trans=-1.0, thresh_rot=-1.0)
    assert full.remake_stats["kept"] == 0
    assert inc.remake_stats["kept"] >= 1 and inc.remake_stats["rebuilt"] >= 1
    assert len(inc.submaps) == len(full.submaps)
    for sa, sb in zip(inc.submaps[:-1], full.submaps[:-1]):
        assert (sa.cnt_s, sa.cnt_e) == (sb.cnt_s, sb.cnt_e)
        _same(sa.final_cloud, sb.final_cloud)
    _same(inc.submaps[-1].cloud(), full.submaps[-1].cloud())
    _same(inc.registration_target(), full.registration_target())
    assert abs(inc.atd - full.atd) < 1e-5


@pytest.mark.parametrize("remove_moving", [True, False])
def test_remake_matches_jax(remove_moving):
    cfg = SlamConfig.small(**_kw(remove_moving), ndt_incremental_grid=1)
    jcfg = JSlamConfig.small(**_kw(remove_moving), ndt_incremental_grid=1)
    pm = _map(cfg)
    jpm = JPointCloudMap(jcfg)
    for pose, local in _walk(12):
        _j_grow(jpm, pose, local)
    pm.mom_state()
    assert pm._mom_valid
    new = _corrected(pm)
    pm.remake_maps(new)
    jpm.remake_maps(new)
    assert pm.remake_stats == jpm.remake_stats
    assert not pm._mom_valid and pm._cached_target is None
    assert len(pm.submaps) == len(jpm.submaps) >= 3
    for sa, sb in zip(pm.submaps, jpm.submaps):
        assert (sa.cnt_s, sa.cnt_e, sa.n_scans) == (sb.cnt_s, sb.cnt_e,
                                                    sb.n_scans)
        assert abs(sa.atd_s - sb.atd_s) < 1e-5
        assert int(sa.proc_count) == int(sb.proc_count)
        _same(sa.proc, sb.proc, 1e-6)
        assert len(sa.raw) == len(sb.raw)
        for ra, rb in zip(sa.raw, sb.raw):
            _same(ra, rb, 1e-6)
        if sb.final_cloud is not None:
            _same(sa.final_cloud, sb.final_cloud, 1e-6)
    _same(pm.registration_target(), jpm.registration_target(), 1e-6)
    np.testing.assert_array_equal(pm.last_pose, jpm.last_pose)
    assert abs(pm.atd - jpm.atd) < 1e-5


def test_rebuilt_map_keeps_growing():
    cfg = SlamConfig.small(**_kw(True))
    pm = _map(cfg, n=10)
    new = np.stack(pm.poses).astype(np.float32)
    new[:, 0] += 0.1            # everything moves: every submap rebuilds
    pm.remake_maps(new)
    ref = PointCloudMap(cfg, CPU)
    for pose, (_, local) in zip(new, _walk(10)):
        _grow(ref, pose, local)
    rng = np.random.default_rng(99)
    for j in range(3):          # crosses a submap close
        pose = new[-1] + np.array([0.45 * (j + 1), 0.0, 0.0], np.float32)
        local = rng.standard_normal((35, 2)).astype(np.float32) * 0.8
        for m in (pm, ref):
            _grow(m, pose, local)
    assert len(pm.submaps) == len(ref.submaps)
    _same(pm.registration_target(), ref.registration_target(), 1e-6)


def test_rebuild_pads_missing_device_scans():
    """After a checkpoint load the device scan cache holds None for the
    restored frames: the rewrite pads and uploads them, equal to the
    rewrite of a map that cached them."""
    cfg = SlamConfig.small(**_kw(True))
    cached, bare = _map(cfg), _map(cfg, padded=False)
    assert all(d is None for d in bare.local_scans_dev)
    new = _corrected(cached)
    cached.remake_maps(new)
    bare.remake_maps(new)
    _same(cached.registration_target(), bare.registration_target())
    assert bare.local_scans_dev[-1] is not None
