"""The gather engine (`ndt_slam_tpu_torch.ndt.score`, `ndt_engine =
"gather"`) against the JAX package's `ndt/score.py`, on the CPU.

The same seeded room scans make both packages' dense window grids. The
port's score, gradient, Hessian and matched count are held to the
kernel bar of ROADMAP.md (E rtol 1e-5; grad rtol 1e-4 / atol 1e-3;
Hessian rtol 1e-3 / atol 0.05; matched exact) on JAX's grid carried
over and on the port's own; the line-search scores to rtol 1e-5
against JAX's `vmap`; `align` on the gather engine against JAX's; and
the first 15 office_loop frames of `SlamConfig.small(ndt_engine=
"gather")` through the port's runner against JAX's front end, frame by
frame within 0.05 m and 0.3 deg; its row axis runs (held to JAX's
`vmap`s in tests/test_torch_gather_rows.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.io.carmen import read_carmen_log as j_read_carmen_log
from ndt_slam_tpu.ndt import score as j_score
from ndt_slam_tpu.ndt.grid import build_grid as j_build_grid
from ndt_slam_tpu.ndt.solve import align as j_align
from ndt_slam_tpu.pipeline.frontend import FrontEnd as JFrontEnd

from ndt_slam_tpu_torch import convert
from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.graph.loop_closure import verify_candidates
from ndt_slam_tpu_torch.io.carmen import read_carmen_log
from ndt_slam_tpu_torch.ndt import score
from ndt_slam_tpu_torch.ndt.compact import compact_grid, stack_grids
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.solve import align
from ndt_slam_tpu_torch.pipeline.batch_runner import BatchFrontEnd
from ndt_slam_tpu_torch.pipeline.runner import run_slam

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
LOG = os.path.join(ROOT, "tests", "data", "office_loop.clf")
NX = NY = 64
RES = 0.3
MIN_PTS = 3
N_SLICE = 15
CPU = torch.device("cpu")
POSES = [(0.08, -0.04, 0.03), (0.0, 0.0, 0.0), (-0.2, 0.15, -0.1)]


def _room_scan(n, pose=(0.0, 0.0, 0.0), noise=0.0, seed=0):
    """Ray-cast scan of a 10 m x 8 m room from `pose`, sensor frame."""
    rng = np.random.default_rng(seed)
    tx, ty, th = pose
    a = np.linspace(-np.pi, np.pi, n, endpoint=False)
    wa = a + th
    dx, dy = np.cos(wa), np.sin(wa)
    with np.errstate(divide="ignore"):
        ts = np.stack([(5.0 - tx) / dx, (-5.0 - tx) / dx,
                       (4.0 - ty) / dy, (-4.0 - ty) / dy])
    ts = np.where(ts > 0, ts, np.inf).min(axis=0)
    t = ts + noise * rng.standard_normal(n)
    return np.stack([t * np.cos(a), t * np.sin(a)], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    tgt_np = _room_scan(720, noise=0.01)
    src_np = _room_scan(360, pose=(0.1, -0.06, 0.05), noise=0.01, seed=3)
    d1, d2 = score.gauss_constants(RES, 0.55)
    j_tgt, j_src = j_pad(tgt_np, 2048), j_pad(src_np, 512)
    j_grid = j_build_grid(j_tgt.xy, j_tgt.mask, jnp.zeros(2, jnp.float32),
                          NX, NY, RES, min_pts=MIN_PTS)
    tgt, src = pad_points(tgt_np, 2048, CPU), pad_points(src_np, 512, CPU)
    own = build_grid(tgt.xy, tgt.mask, torch.zeros(2), NX, NY, RES,
                     min_pts=MIN_PTS)
    return dict(d1=d1, d2=d2, j_src=j_src, j_grid=j_grid, src=src,
                grids={"jax grid": convert.ndt_grid(j_grid, CPU),
                       "port grid": own})


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("which", ["jax grid", "port grid"])
@pytest.mark.parametrize("pose", POSES)
def test_gather_sgh_matches_jax(scene, which, pose):
    d1, d2 = scene["d1"], scene["d2"]
    src = scene["src"]
    E, g, H, m = score.ndt_score_grad_hess(
        torch.tensor(pose, dtype=torch.float32), src.xy, src.mask,
        scene["grids"][which], d1, d2, 1)
    E0, g0, H0, m0 = j_score.ndt_score_grad_hess(
        jnp.array(pose, jnp.float32), scene["j_src"].xy, scene["j_src"].mask,
        scene["j_grid"], d1, d2, 1)
    assert float(m) == float(m0) > 100
    np.testing.assert_allclose(float(E), float(E0), rtol=1e-5)
    np.testing.assert_allclose(_np(g), _np(g0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(H), _np(H0), rtol=1e-3, atol=0.05)
    np.testing.assert_array_equal(_np(H), _np(H).T)


@pytest.mark.parametrize("radius", [1, 2])
def test_gather_cells_match_jax(scene, radius):
    """The neighbour gather itself: the same cells, bit for bit, in the
    JAX package's offset order."""
    rng = np.random.default_rng(1)
    cx = rng.integers(-3, NX + 3, size=200).astype(np.int32)
    cy = rng.integers(-3, NY + 3, size=200).astype(np.int32)
    got = score._gather_cells(scene["grids"]["jax grid"],
                              torch.from_numpy(cx).long(),
                              torch.from_numpy(cy).long(), radius)
    want = j_score._gather_cells(scene["j_grid"], jnp.asarray(cx),
                                 jnp.asarray(cy), radius)
    assert got[0].shape == (200, (2 * radius + 1) ** 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_gather_line_search_scores_match_jax(scene):
    """The 12 candidates of an iteration in one call, against JAX's
    `vmap` of `ndt_negative_score`; a single pose gives a 0-dim E."""
    d1, d2 = scene["d1"], scene["d2"]
    base = np.array([0.08, -0.04, 0.03], np.float32)
    poses = (base[None, :] + np.linspace(-0.03, 0.03, 12)[:, None]
             * np.array([1.0, -0.5, 0.3])).astype(np.float32)
    src = scene["src"]
    grid = scene["grids"]["jax grid"]
    got = score.ndt_negative_score(torch.from_numpy(poses), src.xy, src.mask,
                                   grid, d1, d2, 1)
    want = jax.vmap(lambda p: j_score.ndt_negative_score(
        p, scene["j_src"].xy, scene["j_src"].mask, scene["j_grid"], d1, d2,
        1))(jnp.asarray(poses))
    assert got.shape == (12,)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
    one = score.ndt_negative_score(torch.from_numpy(poses[3]), src.xy,
                                   src.mask, grid, d1, d2, 1)
    assert one.dim() == 0
    np.testing.assert_allclose(float(one), float(want[3]), rtol=1e-5)


def test_align_gather_matches_jax(scene):
    d1, d2 = scene["d1"], scene["d2"]
    src = scene["src"]
    kw = dict(max_iterations=35, step_size=0.1, trans_eps=0.01, radius=1)
    res = align(torch.zeros(3), src.xy, src.mask, scene["grids"]["jax grid"],
                d1, d2, **kw)
    j = j_align(jnp.zeros(3, jnp.float32), scene["j_src"].xy,
                scene["j_src"].mask, scene["j_grid"], d1, d2, **kw)
    np.testing.assert_allclose(_np(res.pose_rad), _np(j.pose_rad), atol=1e-4)
    assert int(res.iterations) == int(j.iterations) > 1
    assert bool(res.converged) and bool(j.converged)
    assert float(res.matched) == float(j.matched)
    np.testing.assert_allclose(float(res.objective), float(j.objective),
                               rtol=1e-4)
    np.testing.assert_allclose(_np(res.pose_rad), [0.1, -0.06, 0.05],
                               atol=0.02)


def test_gather_slice_matches_jax_frame_by_frame():
    """15 office_loop frames at the small config with the gather engine:
    the port's runner against JAX's front end."""
    jcfg = JSlamConfig.small(end_frame=N_SLICE, ndt_engine="gather")
    assert jcfg.resolved_ndt_engine == "gather"
    jfe = JFrontEnd(jcfg)
    for fr in j_read_carmen_log(LOG, max_frames=N_SLICE):
        jfe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
    cfg = SlamConfig.small(end_frame=N_SLICE, ndt_engine="gather")
    fe = run_slam(read_carmen_log(LOG, max_frames=N_SLICE), cfg, "cpu")
    a, b = fe.get_poses(), jfe.get_poses()
    assert a.shape == b.shape == (N_SLICE, 3)
    dxy = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max()
    dth = np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0).max()
    print(f"gather engine, {N_SLICE} office_loop frames, port vs JAX: "
          f"{dxy:.3g} m, {dth:.3g} deg")
    assert dxy <= 0.05 and dth <= 0.3
    assert all(m["successful"] for m in fe.metrics)


def test_gather_engine_resolves_and_the_row_axis_raises(scene):
    """The engine resolves; its row axis runs where the JAX package vmaps
    (align over rows on a stacked window, the verifier, the lockstep
    runner) and raises only for rows without a grid index."""
    cfg = SlamConfig.small(ndt_engine="gather")
    assert cfg.resolved_ndt_engine == "gather"
    assert SlamConfig.small().resolved_ndt_engine == "compact"
    with pytest.raises(ValueError):
        SlamConfig.small(ndt_engine="dense").resolved_ndt_engine
    src = scene["src"]
    grid = scene["grids"]["port grid"]
    with pytest.raises(ValueError, match="grid index"):
        align(torch.zeros(2, 3), src.xy, src.mask, grid, scene["d1"],
              scene["d2"])
    stacked = grid._replace(**{f: torch.stack([getattr(grid, f)] * 2)
                               for f in ("origin", "mean", "inv_cov",
                                         "valid")})
    rows = align(torch.zeros(2, 3), src.xy, src.mask, stacked, scene["d1"],
                 scene["d2"], grid_index=torch.arange(2, dtype=torch.int32))
    one = align(torch.zeros(3), src.xy, src.mask, grid, scene["d1"],
                scene["d2"])
    assert rows.pose_rad.shape == (2, 3)
    assert torch.equal(rows.pose_rad[0], rows.pose_rad[1])
    np.testing.assert_allclose(rows.pose_rad[0].numpy(),
                               one.pose_rad.numpy(), atol=1e-4)
    out = verify_candidates(cfg, src.xy, src.mask, src.xy[None],
                            src.mask[None], torch.zeros(1, 3))
    assert out.accepted.shape == (1,)
    assert float(out.rel_pose_rad.abs().max()) < 1e-3   # itself, at 0
    assert len(BatchFrontEnd(cfg, 2, CPU).frontends) == 2
    # the compact engine's row axis is untouched
    gs = stack_grids([compact_grid(grid, 512)] * 2)
    rows = align(torch.zeros(2, 3), src.xy, src.mask, gs, scene["d1"],
                 scene["d2"], grid_index=torch.arange(2, dtype=torch.int32))
    assert rows.pose_rad.shape == (2, 3)
