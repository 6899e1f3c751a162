"""The port's sharded registration (`ndt_slam_tpu_torch.parallel`) on two
gloo ranks of the CPU, against the port's single-device path and the
JAX package's sharded functions on two of its virtual CPU devices.

One module fixture spawns the two ranks once (`parallel.dist.spawn`,
a file store) and runs `parallel/jobs.registration` on both meshes the
JAX tests use, (dp, pt) = (1, 2) and (2, 1): the single-pair register,
the batch register and the frame step, and the three fitness layouts.
The scene is tests/distributed/test_sharded_register.py's (room scans,
a 64 x 64 grid, `ndt_trans_eps` 1e-4 so that the optimum is pinned),
in 1024 target and 512 source slots, so that each rank's shard holds
live points. Bars, from those tests: register
5e-5 against the single device and against JAX's sharded register;
frame step 5e-3 (deg / m) against the single-device step and JAX's; the
fitness layouts rtol 1e-5 of the plain fitness; every output bitwise
the same on both ranks. JAX's functions run on its (1, 2) mesh only, one
compile each: its layouts differ by summation order alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.parallel import (
    make_batch_register as j_make_batch_register,
    make_mesh as j_make_mesh,
    make_sharded_frame_step as j_make_frame_step,
    make_sharded_register as j_make_sharded_register,
)

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core import pose2
from ndt_slam_tpu_torch.core.points import PointBuffer, pad_points
from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
from ndt_slam_tpu_torch.ndt.compact import compact_grid
from ndt_slam_tpu_torch.ndt.fitness import fitness_score
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.score import gauss_constants
from ndt_slam_tpu_torch.ndt.solve import align
from ndt_slam_tpu_torch.parallel import jobs, start
from ndt_slam_tpu_torch.pipeline.frontend import _registration_step

torch.set_num_threads(2)

CPU = torch.device("cpu")
# table capacity: above the valid cells of these grids (checked below),
# so nothing is dropped, and small enough for the CPU twins
CELLS = 256
# buffer capacities: the live points (720 target, 360 source, packed at
# the front) reach into the second rank's half, so both ranks' partial
# sums hold points
TGT_SLOTS, SRC_SLOTS = 1024, 512
KW = dict(grid_cells_x=64, grid_cells_y=64, ndt_min_points_per_cell=3,
          ndt_max_iterations=80, ndt_trans_eps=1e-4,
          ndt_max_active_cells=CELLS)
CFG = SlamConfig(**KW)
POSES = [(0.03, 0.02, -0.03), (-0.02, 0.03, 0.04)]
ODO = np.array([0.09, -0.05, 2.6], np.float32)
COV = np.eye(3, dtype=np.float32) * 1e-4


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


def _pad(xy, n):
    p = pad_points(xy, n, CPU)
    return p.xy.numpy(), p.mask.numpy()


def _inputs():
    tgt, tgt_m = _pad(_room_scan(720), TGT_SLOTS)
    src, src_m = _pad(_room_scan(360, pose=(0.10, -0.06, 0.05), seed=3),
                      SRC_SLOTS)
    ntgt, ntgt_m = _pad(_room_scan(720, noise=0.01), TGT_SLOTS)
    rows = [_pad(_room_scan(360, pose=p, noise=0.01, seed=i), SRC_SLOTS)
            for i, p in enumerate(POSES)]
    f = voxel_filter(PointBuffer(torch.from_numpy(src),
                                 torch.from_numpy(src_m)),
                     CFG.source_leaf_size)
    fsrc, fsrc_m = f.xy.numpy(), f.mask.numpy()
    b = len(POSES)
    rep = lambda a: np.ascontiguousarray(np.broadcast_to(a, (b,) + a.shape))
    return {
        "src_xy": src, "src_mask": src_m, "tgt_xy": tgt, "tgt_mask": tgt_m,
        "init": np.zeros(3, np.float32), "center": np.zeros(2, np.float32),
        "src_b": np.stack([r[0] for r in rows]),
        "src_mask_b": np.stack([r[1] for r in rows]),
        "tgt_b": rep(ntgt), "tgt_mask_b": rep(ntgt_m),
        "init_b": np.zeros((b, 3), np.float32),
        "center_b": np.zeros((b, 2), np.float32),
        "fsrc_b": rep(fsrc), "fsrc_mask_b": rep(fsrc_m),
        "ftgt_b": rep(tgt), "ftgt_mask_b": rep(tgt_m),
        "odo_b": rep(ODO), "prev_b": np.zeros((b, 3), np.float32),
        "last_b": np.zeros((b, 3), np.float32), "cov_b": rep(COV),
        "fit_src": src, "fit_src_mask": src_m,
    }


INP = _inputs()


@pytest.fixture(scope="module")
def started():
    """The two ranks running `jobs.registration`, started once."""
    handle = start(jobs.registration, 2, CFG, INP)
    yield handle
    handle.close()


@pytest.fixture(scope="module")
def ranks(started, refs):
    """Both ranks' results (the references are made while they run)."""
    return started.result()


def _single(src, src_m, tgt, tgt_m, init):
    """The port's single-device registration (compact engine)."""
    grid = build_grid(torch.from_numpy(tgt), torch.from_numpy(tgt_m),
                      torch.zeros(2), 64, 64, CFG.ndt_resolution, min_pts=3)
    d1, d2 = gauss_constants(CFG.ndt_resolution, CFG.ndt_outlier_ratio)
    return align(torch.from_numpy(init), torch.from_numpy(src),
                 torch.from_numpy(src_m),
                 compact_grid(grid, CFG.ndt_max_active_cells), d1, d2,
                 max_iterations=80, step_size=CFG.ndt_step_size,
                 trans_eps=1e-4, radius=1)


def _same(a, b):
    """Bitwise equal nested results."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return a == b


def test_both_shards_hold_points():
    for k in ("tgt_xy", "src_xy", "fit_src"):
        mask = INP["tgt_mask" if k == "tgt_xy" else "src_mask"]
        half = mask.shape[0] // 2
        assert mask[:half].any() and mask[half:].any(), k
    fsrc = INP["fsrc_mask_b"][0]
    assert fsrc[:SRC_SLOTS // 2].any() and fsrc[SRC_SLOTS // 2:].any()


def test_table_holds_every_valid_cell():
    for xy, mask in ((INP["tgt_xy"], INP["tgt_mask"]),
                     (INP["tgt_b"][0], INP["tgt_mask_b"][0])):
        g = build_grid(torch.from_numpy(xy), torch.from_numpy(mask),
                       torch.zeros(2), 64, 64, CFG.ndt_resolution, min_pts=3)
        assert 0 < int(g.valid.sum()) < CELLS


def test_both_ranks_bitwise_equal(ranks):
    r0, r1 = ranks
    assert _same(r0[(1, 2)], r1[(1, 2)])
    # (2, 1): one register on every rank, a batch row each
    for key in ("register",):
        assert _same(r0[(2, 1)][key], r1[(2, 1)][key])
    assert list(r0[(2, 1)]["rows"]) == [0] and list(r1[(2, 1)]["rows"]) == [1]


@pytest.fixture(scope="module")
def refs():
    """The references, once: the port's single device (register, each
    batch row, the production frame step) and JAX's three sharded
    functions on its (dp, pt) = (1, 2) mesh (one compile each)."""
    f32 = lambda k: torch.from_numpy(INP[k][0])
    mesh = j_make_mesh(2, dp=1)
    jcfg = JSlamConfig(**KW)
    arrays = lambda *ks: [jnp.asarray(INP[k]) for k in ks]
    return {
        "register": _single(INP["src_xy"], INP["src_mask"], INP["tgt_xy"],
                            INP["tgt_mask"], INP["init"]),
        "rows": [_single(INP["src_b"][b], INP["src_mask_b"][b],
                         INP["tgt_b"][b], INP["tgt_mask_b"][b],
                         INP["init_b"][b]) for b in range(len(POSES))],
        "step": _registration_step(
            CFG, torch.from_numpy(INP["src_xy"]),
            torch.from_numpy(INP["src_mask"]), f32("odo_b"), f32("prev_b"),
            f32("last_b"), f32("cov_b"), torch.from_numpy(INP["tgt_xy"]),
            torch.from_numpy(INP["tgt_mask"])),
        "j_register": j_make_sharded_register(mesh, jcfg)(*arrays(
            "src_xy", "src_mask", "tgt_xy", "tgt_mask", "init", "center")),
        "j_batch": j_make_batch_register(mesh, jcfg)(*arrays(
            "src_b", "src_mask_b", "tgt_b", "tgt_mask_b", "init_b",
            "center_b")),
        "j_step": j_make_frame_step(mesh, jcfg)(*arrays(
            "fsrc_b", "fsrc_mask_b", "ftgt_b", "ftgt_mask_b", "odo_b",
            "prev_b", "last_b", "cov_b")),
    }


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)])
def test_sharded_register_matches_single_device_and_jax(ranks, refs, layout):
    got = ranks[0][layout]["register"]
    ref, j = refs["register"], refs["j_register"]
    np.testing.assert_allclose(got.pose_rad, ref.pose_rad.numpy(), atol=5e-5)
    np.testing.assert_allclose(got.pose_rad, np.asarray(j.pose_rad),
                               atol=5e-5)
    assert bool(got.converged) and int(got.iterations) > 1
    assert np.hypot(got.pose_rad[0] - 0.10, got.pose_rad[1] + 0.06) < 2e-3
    assert abs(got.pose_rad[2] - 0.05) < 2e-3
    # the cost: the single device's fitness at the sharded pose
    pose = torch.from_numpy(got.pose_rad)
    pose_deg = torch.stack([pose[0], pose[1], torch.rad2deg(pose[2])])
    src = pose2.global_points(pose_deg, torch.from_numpy(INP["src_xy"]))
    fit = fitness_score(src, torch.from_numpy(INP["src_mask"]),
                        torch.from_numpy(INP["tgt_xy"]),
                        torch.from_numpy(INP["tgt_mask"]))
    np.testing.assert_allclose(float(got.cost), float(fit), rtol=1e-5)


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)])
def test_batch_register_rows(ranks, refs, layout):
    """Each row against its own single-device registration and JAX's
    batch register."""
    seen = set()
    for r in ranks:
        res = r[layout]
        for i, row in enumerate(res["rows"]):
            seen.add(int(row))
            est = res["batch"].pose_rad[i]
            assert bool(res["batch"].converged[i])
            np.testing.assert_allclose(
                est, refs["rows"][row].pose_rad.numpy(), atol=5e-5)
            np.testing.assert_allclose(
                est, np.asarray(refs["j_batch"].pose_rad[row]), atol=5e-5)
            p = POSES[row]
            assert np.hypot(est[0] - p[0], est[1] - p[1]) < 2e-2
    assert seen == {0, 1}


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)])
def test_frame_step_matches_production_step(ranks, refs, layout):
    """The sharded frame step against the single-device production step
    and JAX's sharded frame step (5e-3 deg / m, as JAX's own test)."""
    ref, j = refs["step"], refs["j_step"]
    assert bool(ref.successful)
    seen = set()
    for r in ranks:
        res = r[layout]
        out = res["frame_step"]
        for i, row in enumerate(res["rows"]):
            seen.add(int(row))
            assert bool(out.successful[i]) == bool(ref.successful)
            for name in ("est_pose", "fused_pose"):
                got = getattr(out, name)[i]
                np.testing.assert_allclose(
                    got, getattr(ref, name).numpy(), atol=5e-3)
                np.testing.assert_allclose(
                    got, np.asarray(getattr(j, name)[row]), atol=5e-3)
            np.testing.assert_allclose(out.cov[i], ref.cov.numpy(),
                                       rtol=5e-3, atol=1e-9)
            np.testing.assert_allclose(out.cov[i], np.asarray(j.cov[row]),
                                       rtol=5e-3, atol=1e-9)
            np.testing.assert_allclose(float(out.cost[i]), float(ref.cost),
                                       rtol=1e-3, atol=1e-7)
    assert seen == {0, 1}


@pytest.mark.parametrize("mode", ["sources", "targets", "both"])
def test_fitness_layouts_agree(ranks, mode):
    plain = float(fitness_score(*(torch.from_numpy(INP[k]) for k in (
        "fit_src", "fit_src_mask", "tgt_xy", "tgt_mask"))))
    got = ranks[0][(1, 2)]["fitness"][mode]
    np.testing.assert_allclose(got, plain, rtol=1e-5)
    assert got == ranks[1][(1, 2)]["fitness"][mode]
