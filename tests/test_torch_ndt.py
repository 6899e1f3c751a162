"""Parity of the PyTorch port's NDT core (ndt_slam_tpu_torch.ndt) with
the JAX package, on the CPU (and the pose, point-buffer and device-count
helpers the package shares with it).

The same seeded numpy inputs go through the JAX function and its port.
On the CPU the port's kernel wrappers run their plain twins; the JAX
side runs its compact engine and, for the kernels, the Pallas kernels
in interpret mode at the sizes of tests/unit/test_pallas_kernels.py
(N = K = 512). Tolerances are the ROADMAP parity bar: E rtol 1e-5,
grad rtol 1e-4 / atol 1e-3, Hessian rtol 1e-3 / atol 0.05, matched
exact; NN distances atol 2e-5 (the JAX CPU engine takes the matmul
form, the port the difference form). The kernels against their twins
on the card: tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndt_slam_tpu.core import pose2 as j_pose2
from ndt_slam_tpu.core.points import PointBuffer as JPointBuffer
from ndt_slam_tpu.core.points import from_host_list as j_from_host_list
from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.core.points import sanitize as j_sanitize
from ndt_slam_tpu.ndt import pallas_kernels as pk
from ndt_slam_tpu.ndt.compact import (
    compact_grid as j_compact_grid,
    ndt_score_grad_hess_compact as j_sgh,
)
from ndt_slam_tpu.ndt.fitness import fitness_score as j_fitness
from ndt_slam_tpu.ndt.fitness import nn_sq_dists as j_nn
from ndt_slam_tpu.ndt.grid import build_grid as j_build_grid
from ndt_slam_tpu.ndt.score import gauss_constants as j_gauss
from ndt_slam_tpu.ndt.solve import align as j_align

from ndt_slam_tpu_torch import convert
from ndt_slam_tpu_torch.core import pose2
from ndt_slam_tpu_torch.core.points import (
    PointBuffer, from_host_list, pad_points, sanitize,
)
from ndt_slam_tpu_torch.parallel.dist import (
    global_device_count, local_device_count,
)
from ndt_slam_tpu_torch.core.segment import segment_sum
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.ndt.compact import (
    compact_grid, ndt_score_grad_hess_compact,
)
from ndt_slam_tpu_torch.ndt.fitness import fitness_score, nn_sq_dists
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.score import gauss_constants
from ndt_slam_tpu_torch.ndt.solve import align

torch.set_num_threads(2)

NX = NY = 64
RES = 0.3
MIN_PTS = 3
K = 512
CPU = torch.device("cpu")


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
    """Target map, source scan, both packages' grids and tables."""
    tgt_np = _room_scan(720, noise=0.01)
    src_np = _room_scan(360, pose=(0.1, -0.06, 0.05), noise=0.01, seed=3)
    d1, d2 = j_gauss(RES, 0.55)
    j_tgt, j_src = j_pad(tgt_np, 2048), j_pad(src_np, 512)
    j_grid = j_build_grid(j_tgt.xy, j_tgt.mask, jnp.zeros(2, jnp.float32),
                          NX, NY, RES, min_pts=MIN_PTS)
    j_cg = j_compact_grid(j_grid, K)
    tgt, src = pad_points(tgt_np, 2048, CPU), pad_points(src_np, 512, CPU)
    grid = build_grid(tgt.xy, tgt.mask, torch.zeros(2), NX, NY, RES,
                      min_pts=MIN_PTS)
    return dict(d1=d1, d2=d2, j_tgt=j_tgt, j_src=j_src, j_grid=j_grid,
                j_cg=j_cg, tgt=tgt, src=src, grid=grid,
                cg=compact_grid(grid, K))


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def test_gauss_constants_match_jax():
    assert gauss_constants(RES, 0.55) == j_gauss(RES, 0.55)


def test_segment_sum_matches_numpy():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((300, 3)).astype(np.float32)
    seg = rng.integers(0, 11, size=300)       # id 10 is dropped
    got = segment_sum(torch.from_numpy(rows), torch.from_numpy(seg), 10)
    want = np.zeros((10, 3), np.float64)
    np.add.at(want, seg[seg < 10], rows[seg < 10])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_build_grid_matches_jax(scene):
    g, j = scene["grid"], scene["j_grid"]
    np.testing.assert_array_equal(_np(g.origin), _np(j.origin))
    np.testing.assert_array_equal(_np(g.valid), _np(j.valid))
    assert int(g.valid.sum()) > 50
    np.testing.assert_allclose(_np(g.mean), _np(j.mean), rtol=1e-6,
                               atol=1e-6)
    # inverse covariances reach ~1e4 (wall cells are thin): f32 relative
    np.testing.assert_allclose(_np(g.inv_cov), _np(j.inv_cov), rtol=1e-4,
                               atol=1e-3)


def test_compact_grid_matches_jax(scene):
    cg, j = scene["cg"], scene["j_cg"]
    for f in ("kx", "ky", "valid"):
        np.testing.assert_array_equal(_np(getattr(cg, f)), _np(getattr(j, f)))
    for f in ("mx", "my"):
        np.testing.assert_allclose(_np(getattr(cg, f)), _np(getattr(j, f)),
                                   rtol=1e-6, atol=1e-6)
    for f in ("b00", "b01", "b11"):
        np.testing.assert_allclose(_np(getattr(cg, f)), _np(getattr(j, f)),
                                   rtol=1e-4, atol=1e-3)


def test_compact_of_converted_jax_grid_is_jax_table(scene):
    """convert.ndt_grid carries a JAX grid over; compacting it in the
    port gives the JAX table bit for bit."""
    cg = compact_grid(convert.ndt_grid(scene["j_grid"], CPU), K)
    for f in ("kx", "ky", "mx", "my", "b00", "b01", "b11", "valid"):
        np.testing.assert_array_equal(_np(getattr(cg, f)),
                                      _np(getattr(scene["j_cg"], f)))


def test_compact_grid_overflow_keeps_first_cells(scene):
    """Capacity below the valid count: the first cells in id order."""
    cg = compact_grid(scene["grid"], 16)
    j = j_compact_grid(scene["j_grid"], 16)
    np.testing.assert_array_equal(_np(cg.kx), _np(j.kx))
    np.testing.assert_array_equal(_np(cg.ky), _np(j.ky))
    assert bool(cg.valid.all())


@pytest.mark.parametrize("reference", ["compact", "pallas"])
@pytest.mark.parametrize("pose", [(0.08, -0.04, 0.03), (0.0, 0.0, 0.0)])
def test_sgh_twin_matches_jax(scene, reference, pose):
    """kernels.ndt_score_grad_hess (its twin on the CPU) vs the JAX
    compact engine and the interpret-mode Pallas kernel, on one table."""
    d1, d2, j_cg, j_src = scene["d1"], scene["d2"], scene["j_cg"], \
        scene["j_src"]
    cg = convert.compact_grid(j_cg, CPU)
    src = scene["src"]
    E, g, H, m = kernels.ndt_score_grad_hess(
        torch.tensor(pose, dtype=torch.float32), src.xy, src.mask, cg,
        d1, d2, 1)
    jp = jnp.array(pose, jnp.float32)
    ref = j_sgh if reference == "compact" else pk.ndt_score_grad_hess_pallas
    E0, g0, H0, m0 = ref(jp, j_src.xy, j_src.mask, j_cg, d1, d2, 1)
    np.testing.assert_allclose(float(E), float(E0), rtol=1e-5)
    assert float(m) == float(m0)
    np.testing.assert_allclose(_np(g), _np(g0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(H), _np(H0), rtol=1e-3, atol=0.05)
    np.testing.assert_array_equal(_np(H), _np(H).T)


def test_sgh_on_port_grid_matches_jax(scene):
    """End to end through the port's own grid and table."""
    d1, d2 = scene["d1"], scene["d2"]
    pose = (0.08, -0.04, 0.03)
    src = scene["src"]
    E, g, H, m = ndt_score_grad_hess_compact(
        torch.tensor(pose), src.xy, src.mask, scene["cg"], d1, d2, 1)
    E0, g0, H0, m0 = j_sgh(jnp.array(pose, jnp.float32), scene["j_src"].xy,
                           scene["j_src"].mask, scene["j_cg"], d1, d2, 1)
    assert float(m) == float(m0)
    np.testing.assert_allclose(float(E), float(E0), rtol=1e-5)
    np.testing.assert_allclose(_np(g), _np(g0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(H), _np(H0), rtol=1e-3, atol=0.05)


def test_score_many_twin_matches_pallas(scene):
    """kernels.ndt_scores (its twin on the CPU) vs ndt_scores_pallas."""
    d1, d2 = scene["d1"], scene["d2"]
    base = np.array([0.08, -0.04, 0.03], np.float32)
    poses = (base[None, :] + np.linspace(-0.03, 0.03, 12)[:, None]
             * np.array([1.0, -0.5, 0.3])).astype(np.float32)
    cg = convert.compact_grid(scene["j_cg"], CPU)
    src = scene["src"]
    got = kernels.ndt_scores(torch.from_numpy(poses), src.xy, src.mask, cg,
                             d1, d2, 1)
    want = pk.ndt_scores_pallas(jnp.asarray(poses), scene["j_src"].xy,
                                scene["j_src"].mask, scene["j_cg"], d1, d2, 1)
    assert got.shape == (12,)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)


@pytest.mark.parametrize("reference", ["nn_sq_dists", "nn_sq_dists_pallas"])
def test_nn_twin_matches_jax(scene, reference):
    rng = np.random.default_rng(5)
    src_np = rng.uniform(-5, 5, size=(300, 2)).astype(np.float32)
    tm = rng.uniform(size=2048) < 0.8
    j_s = j_pad(src_np, 512)
    j_t = scene["j_tgt"]
    j_tm = j_t.mask & jnp.asarray(tm)
    ref = j_nn if reference == "nn_sq_dists" else pk.nn_sq_dists_pallas
    want = ref(j_s.xy, j_s.mask, j_t.xy, j_tm)
    s = pad_points(src_np, 512, CPU)
    t = scene["tgt"]
    got = kernels.nn_sq_dists(s.xy, s.mask, t.xy, t.mask & torch.from_numpy(tm))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)
    assert (_np(got)[300:] == np.float32(1e12)).all()


def test_fitness_matches_jax_and_empty_cases(scene):
    rng = np.random.default_rng(6)
    src_np = rng.uniform(-5, 5, size=(200, 2)).astype(np.float32)
    j_s, j_t = j_pad(src_np, 512), scene["j_tgt"]
    s, t = pad_points(src_np, 512, CPU), scene["tgt"]
    got = fitness_score(s.xy, s.mask, t.xy, t.mask)
    want = j_fitness(j_s.xy, j_s.mask, j_t.xy, j_t.mask)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=2e-5)
    # no valid target, and no valid source: 1e12 on both sides
    no_t = fitness_score(s.xy, s.mask, t.xy, torch.zeros_like(t.mask))
    big = float(np.float32(1e12))
    assert float(no_t) == float(j_fitness(j_s.xy, j_s.mask, j_t.xy,
                                          jnp.zeros_like(j_t.mask))) == big
    no_s = fitness_score(s.xy, torch.zeros_like(s.mask), t.xy, t.mask)
    assert float(no_s) == big
    assert (nn_sq_dists(s.xy, s.mask, t.xy, torch.zeros_like(t.mask))
            == big).all()


def test_align_matches_jax(scene):
    d1, d2 = scene["d1"], scene["d2"]
    src = scene["src"]
    res = align(torch.zeros(3), src.xy, src.mask, scene["cg"], d1, d2,
                max_iterations=35, step_size=0.1, trans_eps=0.01, radius=1)
    j = j_align(jnp.zeros(3, jnp.float32), scene["j_src"].xy,
                scene["j_src"].mask, scene["j_cg"], d1, d2,
                max_iterations=35, step_size=0.1, trans_eps=0.01, radius=1)
    np.testing.assert_allclose(_np(res.pose_rad), _np(j.pose_rad), atol=1e-4)
    assert int(res.iterations) == int(j.iterations) > 1
    assert bool(res.converged) and bool(j.converged)
    assert float(res.matched) == float(j.matched)
    np.testing.assert_allclose(float(res.objective), float(j.objective),
                               rtol=1e-4)
    # the solve recovers the source's true pose
    np.testing.assert_allclose(_np(res.pose_rad), [0.1, -0.06, 0.05],
                               atol=0.02)


def test_align_empty_source_is_not_converged(scene):
    src = pad_points(np.zeros((0, 2)), 64, CPU)
    res = align(torch.zeros(3), src.xy, src.mask, scene["cg"], scene["d1"],
                scene["d2"])
    assert not bool(res.converged)
    assert torch.isfinite(res.pose_rad).all()


def test_wrappers_take_the_twin_only_on_cpu(scene):
    """CPU tensors never touch the kernel library; other devices raise."""
    kernels.reset_launch_counts()
    src = scene["src"]
    kernels.ndt_score_grad_hess(torch.zeros(3), src.xy, src.mask,
                                scene["cg"], scene["d1"], scene["d2"])
    kernels.nn_sq_dists(src.xy, src.mask, src.xy, src.mask)
    assert kernels.launch_counts() == {"sgh": 0, "score_many": 0, "nn": 0,
                                       "newton": 0, "fuse": 0}
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="no NDT kernel route"):
        kernels.nn_sq_dists(meta, meta[:, 0] > 0, meta, meta[:, 0] > 0)


def test_pose_helpers_match_jax():
    """`rot2` over a batch of headings, `relative_points` of points of a
    scan's reach into batched poses and `distance`, to 1e-6 (f32 sine
    and cosine may part by an ulp, so the coordinates stay within a few
    metres)."""
    rng = np.random.default_rng(6)
    th = rng.uniform(-720.0, 720.0, (4, 5)).astype(np.float32)
    pose = np.concatenate([rng.uniform(-3, 3, (7, 2)),
                           rng.uniform(-180, 180, (7, 1))],
                          axis=1).astype(np.float32)
    pts = rng.uniform(-5, 5, (7, 50, 2)).astype(np.float32)
    got = pose2.rot2(torch.from_numpy(th)).numpy()
    assert got.shape == (4, 5, 2, 2)
    np.testing.assert_allclose(got, np.asarray(j_pose2.rot2(jnp.asarray(th))),
                               rtol=1e-6, atol=1e-6)
    got = pose2.relative_points(torch.from_numpy(pose),
                                torch.from_numpy(pts)).numpy()
    want = np.asarray(j_pose2.relative_points(jnp.asarray(pose),
                                              jnp.asarray(pts)))
    assert got.shape == pts.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # a map point taken into the pose's frame and back is itself
    back = pose2.global_points(torch.from_numpy(pose),
                               torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, pts, atol=2e-6)
    np.testing.assert_allclose(pose2.distance(torch.from_numpy(pose)).numpy(),
                               np.asarray(j_pose2.distance(jnp.asarray(pose))),
                               rtol=1e-6, atol=1e-6)


def test_point_buffer_helpers_match_jax():
    """`sanitize` puts the sentinel in every masked slot (one buffer and
    a [B] batch); `from_host_list` pads a host list as the JAX package
    does, on the device it is given."""
    rng = np.random.default_rng(7)
    xy = rng.uniform(-10, 10, (3, 40, 2)).astype(np.float32)
    mask = rng.random((3, 40)) < 0.6
    got = sanitize(PointBuffer(torch.from_numpy(xy), torch.from_numpy(mask)))
    for b in range(3):
        want = j_sanitize(JPointBuffer(jnp.asarray(xy[b]), jnp.asarray(mask[b])))
        np.testing.assert_array_equal(got.xy[b].numpy(), np.asarray(want.xy))
        np.testing.assert_array_equal(got.mask[b].numpy(),
                                      np.asarray(want.mask))
    pts = rng.uniform(-5, 5, (23, 2)).tolist()
    for cap in (16, 64):
        got = from_host_list(pts, cap, CPU)
        want = j_from_host_list(pts, cap)
        assert got.xy.device == CPU and got.capacity == cap
        np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_device_counts_on_the_cpu():
    """One process a device: without a card one device here, and without
    a process group the global count is the local one."""
    assert not torch.distributed.is_initialized()
    assert local_device_count() == (torch.cuda.device_count()
                                    if torch.cuda.is_available() else 1)
    assert global_device_count() == local_device_count()
