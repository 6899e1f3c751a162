"""One tick of the lockstep batch runner's device work on the CPU, the
port against the JAX package's `vmap`s:

- the batched registration step (`frontend._registration_step` over
  rows) against `jax.vmap(_registration_step.__wrapped__)` at
  `SlamConfig.small`, B = 3 with row 1 idle (the JAX runner's dummy
  row): est and fused poses within 1e-4 m and 1e-4 rad, `successful`
  and iterations equal, cost rtol 1e-4. Convergence is tight
  (`ndt_trans_eps` 1e-5, 80 iterations), so the solves stop where they
  agree: the poses then land 1.5e-6 m apart (f32 summation order) and
  the costs, a mean of squared distances of about 0.0023 m^2, 8.7e-5
  apart relative (at the reference batch test's 1e-4 stop one row
  stops an iteration early at 1.7e-4);
- the batched map step (`_add_scan_and_target` over [B, ...] buffers)
  against JAX's `vmap` of it for two flag sets: buffers within 1e-6,
  masks and counts equal;
- the batched fitness twin against JAX's `vmap` of `fitness_score`
  (rtol 1e-5), and each of its rows against the single twin, bit for
  bit;
- a permutation of the rows permutes the step's outputs bit for bit.

The scenes are simulated scans (`io.simulate`), each row's target the
scans of the frames before and after it placed at their true poses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import PointBuffer as JPointBuffer
from ndt_slam_tpu.mapping.pointcloud_map import (
    _add_scan_and_target as j_add_scan_and_target,
)
from ndt_slam_tpu.ndt.fitness import fitness_score as j_fitness_score
from ndt_slam_tpu.pipeline.frontend import (
    _registration_step as j_registration_step,
)

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PAD_COORD, PointBuffer
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.mapping.pointcloud_map import _add_scan_and_target
from ndt_slam_tpu_torch.ndt.fitness import fitness_score_plain
from ndt_slam_tpu_torch.ndt.kernels import fitness_score_batched
from ndt_slam_tpu_torch.pipeline.frontend import _registration_step
from ndt_slam_tpu_torch.pre.resample import resample_points_np

torch.set_num_threads(2)
# the scenes fill 75 cells of the 256-cell table
KW = dict(end_frame=10_000, ndt_trans_eps=1e-5, ndt_max_iterations=80,
          ndt_max_active_cells=256)
CFG = SlamConfig.small(**KW)
S, L = CFG.max_scan_points, CFG.max_local_map_points


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


def _row(seed, k=4):
    """Frame k of a simulated sequence against the scans of frames k-1
    and k+1 placed at their true poses: (scan, mask, odo, prev_odo,
    last_pose, last_cov, local, local_mask) as host arrays."""
    fr = simulate_sequence(n_frames=14, beams=181, seed=seed)
    rs = lambda f: resample_points_np(f.scan_xy, CFG.resample_space,
                                      CFG.resample_space_thre)
    scan, mask = _pad(rs(fr[k]), S)
    local, local_mask = _pad(np.concatenate([
        _to_map(fr[j].true_pose, rs(fr[j])) for j in (k - 1, k + 1)]), L)
    last = np.asarray(fr[k - 1].true_pose, np.float32)
    cov = np.diag([1e-3, 1e-3, 1e-4]).astype(np.float32)
    return (scan, mask, np.asarray(fr[k].odo_pose, np.float32),
            np.asarray(fr[k - 1].odo_pose, np.float32), last, cov, local,
            local_mask)


def _idle():
    """The JAX runner's dummy row (`batch_runner.py:60-70`)."""
    return (np.full((S, 2), PAD_COORD, np.float32), np.zeros(S, bool),
            np.zeros(3, np.float32), np.zeros(3, np.float32),
            np.zeros(3, np.float32), np.eye(3, dtype=np.float32) * 1e-4,
            np.full((L, 2), PAD_COORD, np.float32), np.zeros(L, bool))


@pytest.fixture(scope="module")
def tick():
    rows = [_row(3), _idle(), _row(11)]
    args = [np.stack([r[j] for r in rows]) for j in range(8)]
    jcfg = JSlamConfig.small(**KW)
    step = jax.jit(jax.vmap(
        lambda *a: j_registration_step.__wrapped__(jcfg, *a)))
    want = jax.device_get(step(*[jnp.asarray(a) for a in args]))
    got = _registration_step(CFG, *[torch.from_numpy(a) for a in args])
    return args, want, got


def test_registration_step_matches_jax_vmap(tick):
    _, want, got = tick
    assert got.small().shape == (3, 24)
    np.testing.assert_array_equal(got.successful.numpy(),
                                  np.asarray(want.successful))
    assert bool(got.successful[0]) and bool(got.successful[2])
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    for name in ("est_pose", "fused_pose"):
        a = getattr(got, name).numpy()[[0, 2]]
        b = np.asarray(getattr(want, name))[[0, 2]]
        np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-4)
        np.testing.assert_allclose(np.deg2rad(a[:, 2] - b[:, 2]), 0.0,
                                   atol=1e-4)
    np.testing.assert_allclose(got.cost.numpy()[[0, 2]],
                               np.asarray(want.cost)[[0, 2]], rtol=1e-4)
    np.testing.assert_allclose(got.global_xy.numpy()[[0, 2]],
                               np.asarray(want.global_xy)[[0, 2]], atol=2e-4)
    # the idle row: nothing matched, the odometry propagation, finite
    assert int(got.matched[1]) == 0 and not bool(got.successful[1])
    assert np.isfinite(got.small().numpy()).all()


def test_rows_permute_bit_for_bit(tick):
    args, _, got = tick
    perm = [2, 0, 1]
    again = _registration_step(
        CFG, *[torch.from_numpy(np.ascontiguousarray(a[perm]))
               for a in args])
    for x, y in zip(got, again):
        assert torch.equal(x[perm], y)


def _map_inputs(rng, B=2):
    """Per row: a proc buffer with a prefix of points, the last two raw
    scans and the new scan (walls seen from nearby poses, with a few
    moving points), a previous closed cloud."""
    C = CFG.max_submap_points
    walls = rng.uniform(-8, 8, size=(400, 2)).astype(np.float32)

    def scan(shift, movers):
        p = walls[rng.choice(len(walls), 300, replace=False)]
        p = p + shift + 0.01 * rng.standard_normal(p.shape)
        p[:movers] += rng.uniform(-1, 1, size=(movers, 2))
        return _pad(p.astype(np.float32), S)

    out = {k: [] for k in ("proc", "count", "raw_a", "raw_b", "scan",
                           "prev")}
    for b in range(B):
        n = 1500 + 700 * b
        out["proc"].append(_pad(
            (walls[rng.integers(0, 400, n)]
             + 0.02 * rng.standard_normal((n, 2))).astype(np.float32), C))
        out["count"].append(np.int32(n))
        for k, sh in (("raw_a", 0.0), ("raw_b", 0.05), ("scan", 0.1)):
            out[k].append(scan(sh, 20 * (b + 1)))
        out["prev"].append(_pad(walls + 0.03, C))
    return {k: ([np.stack([x[0] for x in v]), np.stack([x[1] for x in v])]
                if k != "count" else np.stack(v)) for k, v in out.items()}


FLAGS = [
    dict(append_scan=False, do_interior=True, include_newest=True,
         has_prev=True, filtered=False),
    dict(append_scan=True, do_interior=False, include_newest=False,
         has_prev=False, filtered=True),
]


@pytest.mark.parametrize("flags", FLAGS, ids=["interior", "filtered"])
def test_map_step_matches_jax_vmap(flags):
    inp = _map_inputs(np.random.default_rng(5))
    fixed = dict(cap_sub=CFG.max_submap_points,
                 cap_local=CFG.max_local_map_points, resol=CFG.diff_resol,
                 thre=CFG.thre_neighbor, leaf=CFG.submap_leaf_size)
    names = ("proc", "count", "raw_a", "raw_b", "scan", "prev")
    t = [torch.from_numpy(inp[k]) if k == "count" else
         PointBuffer(*(torch.from_numpy(a) for a in inp[k])) for k in names]
    proc, count, target = _add_scan_and_target(*t, **flags, **fixed)

    j = [jnp.asarray(inp[k]) if k == "count" else
         JPointBuffer(*(jnp.asarray(a) for a in inp[k])) for k in names]
    fn = jax.vmap(lambda *a: j_add_scan_and_target.__wrapped__(
        *a, **flags, **fixed))
    jproc, jcount, jtarget = jax.device_get(jax.jit(fn)(*j))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    for ours, theirs in ((proc, jproc), (target, jtarget)):
        np.testing.assert_array_equal(ours.mask.numpy(),
                                      np.asarray(theirs.mask))
        np.testing.assert_allclose(ours.xy.numpy(), np.asarray(theirs.xy),
                                   atol=1e-6)
    # the pass did remove points: the movers are not all kept
    if flags["do_interior"]:
        assert int(count[0]) < 1500 + 300


def test_fitness_twin_matches_jax_vmap():
    rng = np.random.default_rng(7)
    B, N, M = 4, 300, 3000
    src = (rng.standard_normal((B, N, 2)) * 4).astype(np.float32)
    tgt = (rng.standard_normal((B, M, 2)) * 4).astype(np.float32)
    sm = rng.random((B, N)) < 0.6
    tm = rng.random((B, M)) < 0.4
    sm[2] = False          # no source: 1e12
    tm[3] = False          # no target: 1e12
    got = fitness_score_batched(*(torch.from_numpy(a)
                                  for a in (src, sm, tgt, tm)))
    want = jax.device_get(jax.vmap(j_fitness_score)(
        *(jnp.asarray(a) for a in (src, sm, tgt, tm))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for b in range(B):
        one = fitness_score_plain(*(torch.from_numpy(a[b])
                                    for a in (src, sm, tgt, tm)))
        assert torch.equal(got[b], one)


def test_split_map_update_matches_add_scan():
    """The lockstep runner's map step is `_add_scan_and_target` on the
    operands `fused_add_operands` names, with the flags
    `fused_add_flags` gives from host counters: a map fed through it
    (`add_points(make_target=True)`) holds the buffers and target of a
    map fed through `Submap.add_scan` (`make_target=False`), bit for
    bit, over the first submap's scans, the interior passes included."""
    from ndt_slam_tpu_torch.mapping.pointcloud_map import PointCloudMap

    rng = np.random.default_rng(9)
    walls = rng.uniform(-8, 8, size=(400, 2)).astype(np.float32)
    fused, plain = PointCloudMap(CFG, "cpu"), PointCloudMap(CFG, "cpu")
    for k in range(6):
        p = walls[rng.choice(400, 300, replace=False)] + 0.02 * k
        p[:15] += rng.uniform(-1, 1, size=(15, 2)).astype(np.float32)
        scan = PointBuffer(*(torch.from_numpy(a) for a in _pad(
            p.astype(np.float32), S)))
        pose = np.array([0.1 * k, 0.0, 0.0], np.float32)
        flags = fused.fused_add_flags()
        assert flags["do_interior"] == (k >= 2)
        for pm, make in ((fused, True), (plain, False)):
            pm.add_pose(pose)
            pm.add_points(scan, make_target=make)
        a, b = fused.registration_target(), plain.registration_target()
        assert torch.equal(a.xy, b.xy) and torch.equal(a.mask, b.mask)
        assert torch.equal(fused.submaps[-1].proc.xy,
                           plain.submaps[-1].proc.xy)
