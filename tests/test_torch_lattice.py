"""The incremental NDT moment lattice of the port against the JAX package
on the CPU: the same seeded arrays through `moments_abs`,
`lattice_anchor` and `window_grid_from_lattice` of both (counts exact,
sums rtol 1e-5; `valid` identical, `mean` atol 1e-4, `inv_cov` rtol 2e-3
/ atol 2e-2, the bar of tests/unit/test_incremental_grid.py), the map's
running lattice over a 12-scan sequence (buffers bit-equal, lattice rtol
1e-5), and the front end as a whole on 20 simulated frames: port against
JAX pose by pose within 0.05 m / 0.3 deg, the port's lattice path against
its full rebuild within 0.02 m / 0.2 deg, the proc-overflow rule and the
escape hatch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import (
    PointBuffer as JPointBuffer, pad_points as j_pad,
)
from ndt_slam_tpu.io.simulate import simulate_sequence as j_simulate
from ndt_slam_tpu.mapping.pointcloud_map import (
    PointCloudMap as JPointCloudMap, _rebuild_mom as j_rebuild_mom,
)
from ndt_slam_tpu.ndt import grid as j_grid
from ndt_slam_tpu.pipeline.frontend import FrontEnd as JFrontEnd

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PointBuffer, pad_points
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.mapping.pointcloud_map import (
    PointCloudMap, _rebuild_mom,
)
from ndt_slam_tpu_torch.ndt import grid
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

torch.set_num_threads(2)
CPU = torch.device("cpu")
RES = 0.3


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _clouds():
    """Two masked clouds (stand-ins for the previous submap's closed
    cloud and the proc buffer) and a window center."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-6.0, 6.0, (4000, 2)).astype(np.float32)
    b = rng.uniform(-5.0, 7.0, (3000, 2)).astype(np.float32)
    am = rng.random(4000) < 0.9
    bm = rng.random(3000) < 0.9
    return a, am, b, bm, np.array([0.7, -0.4], np.float32)


def _both_lattices(B):
    a, am, b, bm, center = _clouds()
    j_anchor = j_grid.lattice_anchor(jnp.asarray(center), B, RES)
    anchor = grid.lattice_anchor(torch.from_numpy(center), B, RES)
    j_mom = (j_grid.moments_abs(jnp.asarray(a), jnp.asarray(am), j_anchor,
                                B, B, RES)
             + j_grid.moments_abs(jnp.asarray(b), jnp.asarray(bm), j_anchor,
                                  B, B, RES))
    mom = (grid.moments_abs(torch.from_numpy(a), torch.from_numpy(am),
                            anchor, B, B, RES)
           + grid.moments_abs(torch.from_numpy(b), torch.from_numpy(bm),
                              anchor, B, B, RES))
    return (mom, anchor), (j_mom, j_anchor)


def _assert_mom_close(mom, j_mom):
    mom, j_mom = _np(mom), _np(j_mom)
    np.testing.assert_array_equal(mom[:, 0], j_mom[:, 0])     # counts
    np.testing.assert_allclose(mom, j_mom, rtol=1e-5, atol=1e-6)


def _assert_grid_close(g, jg):
    valid = _np(g.valid)
    np.testing.assert_array_equal(valid, _np(jg.valid))
    assert valid.sum() > 50
    np.testing.assert_allclose(_np(g.origin), _np(jg.origin), atol=1e-6)
    np.testing.assert_allclose(_np(g.mean)[valid], _np(jg.mean)[valid],
                               atol=1e-4)
    np.testing.assert_allclose(_np(g.inv_cov)[valid],
                               _np(jg.inv_cov)[valid], rtol=2e-3, atol=2e-2)


def test_moments_abs_and_anchor_match_jax():
    (mom, anchor), (j_mom, j_anchor) = _both_lattices(96)
    assert anchor.dtype == torch.int32
    np.testing.assert_array_equal(_np(anchor), _np(j_anchor))
    assert mom.shape == (96 * 96, 6)
    assert 6000 < float(mom[:, 0].sum()) <= 7000
    _assert_mom_close(mom, j_mom)


@pytest.mark.parametrize("with_extra", [False, True])
def test_window_grid_from_lattice_matches_jax(with_extra):
    B, n = 96, 64
    (mom, anchor), (j_mom, j_anchor) = _both_lattices(B)
    a, am, b, bm, center = _clouds()
    fa = grid.lattice_anchor(torch.from_numpy(center), n, RES)
    j_fa = j_grid.lattice_anchor(jnp.asarray(center), n, RES)
    extra = j_extra = None
    pts, msk = np.concatenate([a, b]), np.concatenate([am, bm])
    if with_extra:
        rng = np.random.default_rng(1)
        e = rng.uniform(-4.0, 4.0, (500, 2)).astype(np.float32)
        em = rng.random(500) < 0.8
        extra = grid.moments_abs(torch.from_numpy(e), torch.from_numpy(em),
                                 fa, n, n, RES)
        j_extra = j_grid.moments_abs(jnp.asarray(e), jnp.asarray(em), j_fa,
                                     n, n, RES)
        _assert_mom_close(extra, j_extra)
        pts, msk = np.concatenate([pts, e]), np.concatenate([msk, em])
    g, ok = grid.window_grid_from_lattice(mom, anchor, B, B, fa, n, n, RES,
                                          extra=extra, min_pts=3)
    jg, j_ok = j_grid.window_grid_from_lattice(
        j_mom, j_anchor, B, B, j_fa, n, n, RES, extra=j_extra, min_pts=3)
    assert bool(ok) and bool(j_ok)
    _assert_grid_close(g, jg)
    # and against the port's own full rebuild over the same points
    full = grid.build_grid(torch.from_numpy(pts), torch.from_numpy(msk),
                           torch.from_numpy(center), n, n, RES, min_pts=3)
    _assert_grid_close(g, full)


@pytest.mark.parametrize("shift", [(-40, 3), (5, 40), (17, -1)])
def test_window_out_of_range_is_flagged_and_clamped(shift):
    """A window that does not fit the lattice: in_range is False and the
    window is the one `jax.lax.dynamic_slice` clamps to."""
    B, n = 96, 64
    (mom, anchor), (j_mom, j_anchor) = _both_lattices(B)
    fa = anchor + torch.tensor(shift, dtype=torch.int32)
    j_fa = j_anchor + jnp.asarray(shift, jnp.int32)
    g, ok = grid.window_grid_from_lattice(mom, anchor, B, B, fa, n, n, RES,
                                          min_pts=3)
    jg, j_ok = j_grid.window_grid_from_lattice(
        j_mom, j_anchor, B, B, j_fa, n, n, RES, min_pts=3)
    assert ok.dtype == torch.bool and not bool(ok) and not bool(j_ok)
    np.testing.assert_array_equal(_np(g.valid), _np(jg.valid))
    assert _np(g.valid).sum() > 50


def _wall_scan(rng, n, shift):
    a = np.array([[-3.0, -2.0], [-3.0, 2.0], [2.0, -2.0]])
    b = np.array([[3.0, -2.0], [3.0, 2.5], [2.0, 2.0]])
    seg = rng.integers(0, 3, size=n)
    t = rng.uniform(0, 1, size=(n, 1))
    p = a[seg] + t * (b[seg] - a[seg]) + 0.01 * rng.standard_normal((n, 2))
    return (p + np.asarray(shift)).astype(np.float32)


@pytest.mark.parametrize("remove_moving", [True, False])
def test_map_lattice_matches_jax_over_a_sequence(remove_moving):
    """12 map-frame scans through both packages' PointCloudMap with the
    lattice on, across a submap close: `_add_scan_target_mom` keeps the
    buffers bit-equal and the lattice within rtol 1e-5 of JAX's, and the
    running lattice equals `_rebuild_mom` of the same state."""
    kw = dict(max_scan_points=256, max_submap_points=2048,
              max_local_map_points=4096, grid_cells_x=32, grid_cells_y=32,
              submap_sep_thre=1.0, ndt_incremental_grid=1,
              remove_moving=remove_moving)
    cfg, jcfg = SlamConfig(**kw), JSlamConfig(**kw)
    B = cfg.resolved_grid_mom_cells
    assert B == jcfg.resolved_grid_mom_cells == 32 + 2 * 17
    pm, jpm = PointCloudMap(cfg, CPU), JPointCloudMap(jcfg)
    rng = np.random.default_rng(5)
    checked = 0
    for i in range(12):
        pose = np.array([0.15 * i, 0.02 * i, 0.0], np.float32)
        xy = _wall_scan(rng, 200, pose[:2])
        pm.add_pose(pose)
        jpm.add_pose(pose)
        pm.add_points(pad_points(xy, 256, CPU))
        jpm.add_points(j_pad(xy, 256), make_target=True)
        cur, jcur = pm.submaps[-1], jpm.submaps[-1]
        assert len(pm.submaps) == len(jpm.submaps)
        assert int(cur.proc_count) == int(jcur.proc_count)
        np.testing.assert_array_equal(_np(cur.proc.mask), _np(jcur.proc.mask))
        np.testing.assert_array_equal(_np(cur.proc.xy), _np(jcur.proc.xy))
        assert pm._mom_valid == jpm._mom_valid
        if not pm._mom_valid:
            continue          # just closed a submap: rebuilt on next use
        (mom, anchor), (j_mom, j_anchor) = pm.mom_state(), jpm.mom_state()
        np.testing.assert_array_equal(_np(anchor), _np(j_anchor))
        _assert_mom_close(mom, j_mom)
        t, jt = pm.registration_target(), jpm.registration_target()
        np.testing.assert_array_equal(_np(t.xy), _np(jt.xy))
        has_prev = len(pm.submaps) >= 2
        prev = (pm.submaps[-2].final_cloud if has_prev
                else PointBuffer.empty(1, CPU))
        rebuilt = _rebuild_mom(prev, cur.proc, anchor, mom_cells=B,
                               grid_res=cfg.ndt_resolution,
                               has_prev=has_prev)
        _assert_mom_close(mom, rebuilt)
        jprev = (jpm.submaps[-2].final_cloud if has_prev
                 else JPointBuffer.empty(1))
        _assert_mom_close(rebuilt, j_rebuild_mom(
            jprev, jcur.proc, j_anchor, mom_cells=B,
            grid_res=jcfg.ndt_resolution, has_prev=has_prev))
        checked += 1
    assert len(pm.submaps) >= 2 and checked >= 8
    assert float(pm.mom_state()[0][:, 0].sum()) > 100


# ---- the slice: the front end with the lattice on -------------------------

# tight convergence, so that the lattice path and the full rebuild are
# compared at converged optima (as tests/unit/test_incremental_grid.py
# does); a 512-cell table keeps the CPU twins quick. Not that file's
# ndt_trans_eps=1e-4: there frame 10 of this sequence, the first after a
# submap close, has two optima 0.146 m apart, and states 0.7 mm apart
# (port and JAX, either path) fall into different ones, while either
# package continued from the other's checkpoint of frame 9 reproduces
# the other's frame 10.
TIGHT = dict(end_frame=10_000, ndt_trans_eps=1e-3, ndt_max_iterations=80,
             ndt_max_active_cells=512)


def _run(fe, frames):
    for fr in frames:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    return np.stack(fe.pose_history)


def _gap(a, b):
    d = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1])
    dth = np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0)
    return float(d.max()), float(dth.max())


@pytest.fixture(scope="module")
def slice_runs():
    """20 simulated frames: JAX with the lattice on, the port with it
    on and off."""
    frames = simulate_sequence(n_frames=20, beams=181, seed=3)
    j_frames = j_simulate(n_frames=20, beams=181, seed=3)
    jfe = JFrontEnd(JSlamConfig.small(ndt_incremental_grid=1, **TIGHT))
    on = FrontEnd(SlamConfig.small(ndt_incremental_grid=1, **TIGHT), CPU)
    off = FrontEnd(SlamConfig.small(ndt_incremental_grid=0, **TIGHT), CPU)
    return dict(frames=frames, jax=_run(jfe, j_frames), on=_run(on, frames),
                off=_run(off, frames), jfe=jfe, fe_on=on, fe_off=off)


def test_slice_lattice_on_matches_jax(slice_runs):
    r = slice_runs
    assert r["fe_on"].incremental_grid and not r["fe_off"].incremental_grid
    assert r["on"].shape == r["jax"].shape == (20, 3)
    d, dth = _gap(r["on"], r["jax"])
    print(f"port vs JAX, lattice on, 20 frames: {d:.3g} m, {dth:.3g} deg")
    assert d <= 0.05 and dth <= 0.3, (d, dth)
    assert r["fe_on"].n_grid_fallbacks == r["jfe"].n_grid_fallbacks == 0
    assert len(r["fe_on"].pcmap.submaps) == len(r["jfe"].pcmap.submaps) >= 2
    assert [m["successful"] for m in r["fe_on"].metrics] == \
        [m["successful"] for m in r["jfe"].metrics]


def test_slice_lattice_on_matches_full_rebuild(slice_runs):
    r = slice_runs
    d, dth = _gap(r["on"], r["off"])
    print(f"port, lattice on vs off, 20 frames: {d:.3g} m, {dth:.3g} deg")
    assert d < 0.02 and dth < 0.2, (d, dth)
    assert len(r["fe_on"].pcmap.submaps) == len(r["fe_off"].pcmap.submaps)
    assert r["fe_on"].n_grid_fallbacks == 0
    # the frame's one fetch carries grid_ok as its 24th value
    assert r["fe_on"].pcmap._mom_valid and not r["fe_off"].pcmap._mom_valid


def test_slice_lattice_after_proc_overflow():
    """Once the submap's proc buffer is full, the target drops the
    newest scan's overflow; the fresh moments must drop the same points
    (rank among the valid ones >= remaining capacity)."""
    kw = dict(max_submap_points=1024, submap_sep_thre=50.0, **TIGHT)
    frames = simulate_sequence(n_frames=12, beams=361, seed=3)
    on = FrontEnd(SlamConfig.small(ndt_incremental_grid=1, **kw), CPU)
    off = FrontEnd(SlamConfig.small(ndt_incremental_grid=0, **kw), CPU)
    a, b = _run(on, frames), _run(off, frames)
    assert int(off.pcmap.submaps[-1].proc_count) >= 1024
    assert int(on.pcmap.submaps[-1].proc_count) >= 1024
    d, _ = _gap(a, b)
    assert d < 0.02, d
    assert on.n_grid_fallbacks == 0


def test_slice_escape_falls_back_to_full_rebuild(slice_runs):
    """A lattice no wider than the window makes windows escape; the
    front end sees grid_ok == 0 in the frame's fetch, redoes the frame
    through the full rebuild and tracks the full-rebuild trajectory."""
    frames = slice_runs["frames"][:10]
    fe = FrontEnd(SlamConfig.small(ndt_incremental_grid=1, grid_mom_cells=96,
                                   **TIGHT), CPU)
    got = _run(fe, frames)
    assert fe.n_grid_fallbacks > 0
    assert not fe._force_full_grid        # re-armed after the redone frame
    d, _ = _gap(got, slice_runs["off"][:10])
    assert d < 0.02, d


def test_lattice_is_off_under_filtered_target():
    cfg = SlamConfig.small(ndt_incremental_grid=1, ndt_target_filtered=True)
    fe = FrontEnd(cfg, CPU)
    assert not fe.incremental_grid and not fe.pcmap.incremental_grid
    assert not FrontEnd(SlamConfig.small(), CPU).incremental_grid   # -1, cpu
