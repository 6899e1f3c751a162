"""The port's CUDA kernels against their plain twins, on the card.

Needs a CUDA device and skips without one. Imports no JAX, so it runs
on a machine without it; `tests/conftest.py` imports JAX, so run it
there with `python -m pytest --noconftest tests/test_torch_kernels.py`.
Inputs are seeded numpy data at the main path's production shapes
(2048 source slots, a 2048-cell table, 131072 targets, 12 candidates);
tolerances are the ROADMAP parity bar, with matched exact. The two
window kernels also run with a 5x5 neighbourhood, an overflowed table, a
source partly off the grid window, an all-masked source, 3 poses at
once (sgh) and 40 candidates (score_many). The nearest-neighbour kernel
equals its twin bit for bit (the same f32 operations a pair, and a
minimum is exact in any order) over sizes, prefix and scattered masks,
mask views off the 16-byte grid, empty sides and NaN operands; its
fitness mean agrees to rtol 1e-6 (one sum in another order).

The loop-closure variants: the window kernels' grid axis (4 grids, 240
poses, a grid index a pose) against its gather twin `window_rows`, and
with one grid bit for bit against the single-grid call; the nearest-
neighbour kernel's batch axis and argmin form at the verifier's shapes
([4, 2048] against [4, 2048]) and at full load, distances bit for bit
and indices equal, over ties, NaNs and masks.

The lockstep batch's variant: the fitness mean with a batch axis at
[4, 2048] against [4, 131072], each row bit for bit the single call on
that row, the twin to rtol 1e-6, idle rows (no source, no target) and
one row.
"""

import numpy as np
import pytest
import torch

from ndt_slam_tpu_torch.core.points import PAD_COORD, pad_points
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.ndt.compact import (
    compact_grid, ndt_negative_score_compact, ndt_score_grad_hess_compact,
    point_features, stack_grids, window_rows,
)
from ndt_slam_tpu_torch.ndt.fitness import (
    BIG, fitness_score_plain, nn_argmin, nn_sq_dists,
)
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.score import gauss_constants


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    """Walls on 60 seeded segments: 131072 targets, a 2048-point source
    offset by a few cm, the 192x192 grid and its 2048-cell table."""
    rng = np.random.default_rng(11)
    a = rng.uniform(-20.0, 20.0, size=(60, 2))
    b = a + rng.uniform(-6.0, 6.0, size=(60, 2))

    def sample(n):
        seg = rng.integers(0, 60, size=n)
        t = rng.uniform(0.0, 1.0, size=(n, 1))
        return a[seg] + t * (b[seg] - a[seg]) \
            + 0.01 * rng.standard_normal((n, 2))

    tgt = pad_points(sample(131072), 131072, cuda)
    src = pad_points(sample(1800) + [0.05, -0.03], 2048, cuda)
    grid = build_grid(tgt.xy, tgt.mask, torch.zeros(2, device=cuda),
                      192, 192, 0.3, min_pts=6)
    d1, d2 = gauss_constants(0.3, 0.55)
    assert int(grid.valid.sum()) > 600
    return dict(tgt=tgt, src=src, cg=compact_grid(grid, 2048), d1=d1, d2=d2,
                small_cg=compact_grid(grid, 600),
                pose=torch.tensor([0.04, -0.02, 0.005], device=cuda))


def _np(x):
    return x.detach().cpu().numpy()


# case: (table, neighbourhood, pose offset, all source slots masked)
WINDOW_CASES = {
    "main_path": ("cg", 1, (0.0, 0.0, 0.0), False),
    "r2": ("cg", 2, (0.0, 0.0, 0.0), False),
    "overflowed_table": ("small_cg", 1, (0.0, 0.0, 0.0), False),
    "partly_outside": ("cg", 1, (9.0, -7.0, 0.3), False),
    "all_masked": ("cg", 1, (0.0, 0.0, 0.0), True),
}


def _check_sgh(got, want, masked):
    E, g, H, m = got
    E0, g0, H0, m0 = want
    assert float(m) == float(m0)
    if masked:
        assert float(m) == 0.0 and float(E) == 0.0
        assert torch.isfinite(g).all() and torch.isfinite(H).all()
    else:
        assert float(m0) > 100
    np.testing.assert_allclose(float(E), float(E0), rtol=1e-5)
    np.testing.assert_allclose(_np(g), _np(g0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(H), _np(H0), rtol=1e-3, atol=0.05)


@pytest.mark.parametrize("kernel,case", [
    *[(k, c) for k in ("sgh", "score_many") for c in WINDOW_CASES],
    ("nn", "main_path"),
])
def test_kernel_matches_twin_on_card(scene, kernel, case):
    src, d1, d2 = (scene[k] for k in ("src", "d1", "d2"))
    table, r, offset, masked = WINDOW_CASES[case]
    cg = scene[table]
    pose = scene["pose"] + torch.tensor(offset, device=src.xy.device)
    mask = torch.zeros_like(src.mask) if masked else src.mask
    if case == "partly_outside":
        _, _, fx, fy, _, _ = point_features(pose, src.xy, cg)
        off = mask & ((fx < 0) | (fx >= cg.nx) | (fy < 0) | (fy >= cg.ny))
        assert 20 < int(off.sum()) < int(mask.sum()) - 20
    before = kernels.launch_counts()[kernel]
    calls = 1
    if kernel == "sgh":
        # one pose, then three at once: the batch is the single calls
        one = kernels.ndt_score_grad_hess(pose, src.xy, mask, cg, d1, d2, r)
        _check_sgh(one, ndt_score_grad_hess_compact(pose, src.xy, mask, cg,
                                                    d1, d2, r), masked)
        poses = pose[None, :] + torch.tensor(
            [[0.0, 0.0, 0.0], [0.03, -0.02, 0.01], [-0.05, 0.04, -0.02]],
            device=pose.device)
        many = kernels.ndt_score_grad_hess(poses, src.xy, mask, cg, d1, d2, r)
        assert many[0].shape == (3,) and many[1].shape == (3, 3) \
            and many[2].shape == (3, 3, 3) and many[3].shape == (3,)
        for got, want in zip(many, one):
            assert torch.equal(got[0], want)
        for c in range(3):
            _check_sgh([x[c] for x in many], ndt_score_grad_hess_compact(
                poses[c], src.xy, mask, cg, d1, d2, r), masked)
        calls = 2
    elif kernel == "score_many":
        n_cand = 12 if case == "main_path" else 40
        poses = pose[None, :] + torch.linspace(
            -0.03, 0.03, n_cand, device=pose.device)[:, None]
        got = kernels.ndt_scores(poses, src.xy, mask, cg, d1, d2, r)
        want = torch.stack([ndt_negative_score_compact(
            p, src.xy, mask, cg, d1, d2, r) for p in poses])
        assert got.shape == (n_cand,)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
        if masked:
            assert (got == 0).all()
    else:
        t = scene["tgt"]
        smap = torch.where(src.mask[:, None], src.xy, PAD_COORD)
        got = kernels.nn_sq_dists(smap, src.mask, t.xy, t.mask)
        want = nn_sq_dists(smap, src.mask, t.xy, t.mask)
        assert _same(got, want)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[kernel] == before + calls


def _nn_inputs(device, n, m, masks, seed):
    """Seeded sources and targets in a 40 m square; `masks`: "prefix"
    (the first three quarters of the sources, the first third of the
    targets) or "scattered" (70 % and 5 % at random)."""
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(
        rng.uniform(-20, 20, (n, 2)).astype(np.float32)).to(device)
    tgt = torch.from_numpy(
        rng.uniform(-20, 20, (m, 2)).astype(np.float32)).to(device)
    if masks == "prefix":
        sm = torch.arange(n, device=device) < max(1, n * 3 // 4)
        tm = torch.arange(m, device=device) < max(1, m // 3)
    else:
        sm = torch.from_numpy(rng.uniform(size=n) < 0.7).to(device)
        tm = torch.from_numpy(rng.uniform(size=m) < 0.05).to(device)
    return src, sm, tgt, tm


def _same(a, b):
    """Equal bit for bit; a NaN equals a NaN whatever its payload."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _assert_nn_equals_twin(src, sm, tgt, tm):
    before = kernels.launch_counts()["nn"]
    got = kernels.nn_sq_dists(src, sm, tgt, tm)
    fit = kernels.fitness_score(src, sm, tgt, tm)
    torch.cuda.synchronize()
    want = nn_sq_dists(src, sm, tgt, tm)
    assert _same(got, want)
    np.testing.assert_allclose(
        fit.item(), fitness_score_plain(src, sm, tgt, tm).item(), rtol=1e-6)
    launched = 2 if src.shape[0] and tgt.shape[0] else 0
    assert kernels.launch_counts()["nn"] == before + launched
    return got, fit


@pytest.mark.parametrize("masks", ["prefix", "scattered"])
@pytest.mark.parametrize("n", [100, 2048])
@pytest.mark.parametrize("m", [1, 300, 131072])
def test_nn_equals_twin_bit_for_bit(cuda, m, n, masks):
    src, sm, tgt, tm = _nn_inputs(cuda, n, m, masks, seed=m + n)
    got, _ = _assert_nn_equals_twin(src, sm, tgt, tm)
    assert (got[~sm] == BIG).all()
    if bool(tm.any()):
        assert (got[sm] <= 3200.0).all()


@pytest.mark.parametrize("offset", [1, 2, 3, 7, 15, 16, 17])
def test_nn_takes_mask_views_off_the_16_byte_grid(cuda, offset):
    """A sliced mask such as `a.mask[:capacity]` or `mask[k:]` starts
    anywhere and ends anywhere: the kernel reads it byte by byte."""
    src, sm, tgt, tm = _nn_inputs(cuda, 300, 5000 + 33, "scattered", seed=9)
    end = 5000 + offset
    _assert_nn_equals_twin(src, sm, tgt[offset:end], tm[offset:end])


@pytest.mark.parametrize("case", [
    "no_target", "no_source", "one_empty_slot", "zero_targets",
    "nan_source", "inf_source", "nan_target", "masked_nan_target",
    "pads_at_1e8",
])
def test_nn_empty_sides_and_non_finite_operands(cuda, case):
    """The masks decide, not the coordinates: 1e12 (and a fitness of
    1e12) without a valid target or source; a NaN where the twin's
    minimum carries one, none from a masked slot."""
    src, sm, tgt, tm = _nn_inputs(cuda, 700, 3000, "scattered", seed=4)
    live_s = int(torch.nonzero(sm)[0])
    live_t, dead_t = int(torch.nonzero(tm)[0]), int(torch.nonzero(~tm)[0])
    if case == "no_target":
        tm = torch.zeros_like(tm)
    elif case == "no_source":
        sm = torch.zeros_like(sm)
    elif case == "one_empty_slot":
        tgt, tm = tgt[:1], torch.zeros_like(tm[:1])
    elif case == "zero_targets":
        tgt, tm = tgt[:0], tm[:0]
    elif case == "nan_source":
        src[live_s, 0] = float("nan")
    elif case == "inf_source":
        src[live_s, 1] = float("inf")
    elif case == "nan_target":
        tgt[live_t, 1] = float("nan")
    elif case == "masked_nan_target":
        tgt[dead_t, 0] = float("nan")
    elif case == "pads_at_1e8":
        src = torch.where(sm[:, None], src, PAD_COORD)
        tgt = torch.where(tm[:, None], tgt, PAD_COORD)
    got, fit = _assert_nn_equals_twin(src, sm, tgt, tm)
    if case in ("no_target", "no_source", "one_empty_slot", "zero_targets"):
        assert (got == BIG).all() and float(fit) == float(np.float32(BIG))
    elif case == "nan_source":
        assert bool(torch.isnan(got[live_s])) and bool(torch.isnan(fit))
        assert int(torch.isnan(got).sum()) == 1
    elif case == "nan_target":
        assert bool(torch.isnan(got[sm]).all()) and (got[~sm] == BIG).all()
    else:
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(fit))


def test_kernel_features_equal_the_twins_bit_for_bit(scene):
    """The window kernels compute px, py and the cell indices fx, fy
    themselves; they must be the twin's to the bit, or a point near a
    cell border is matched against other cells."""
    src, cg = scene["src"], scene["cg"]
    poses = scene["pose"][None, :] + torch.linspace(
        -3.0, 3.0, 40, device=src.xy.device)[:, None]
    got = kernels.kernel_point_features(poses, src.xy, cg)
    px, py, fx, fy, _, _ = point_features(poses, src.xy, cg)
    want = torch.stack((px, py, fx, fy), dim=-1)
    assert _same(got, want)


def test_kernel_rejects_a_bad_operand(scene):
    """A CUDA operand the kernel does not take raises; no twin runs."""
    src = scene["src"]
    with pytest.raises(ValueError, match="contiguous float32"):
        kernels.nn_sq_dists(src.xy.double(), src.mask, scene["tgt"].xy,
                            scene["tgt"].mask)
    with pytest.raises(ValueError, match="contiguous float32"):
        kernels.fitness_score(src.xy, src.mask, scene["tgt"].xy[::2],
                              scene["tgt"].mask[::2])
    with pytest.raises(ValueError, match="contiguous bool"):
        kernels.nn_sq_dists(src.xy, src.mask.to(torch.uint8),
                            scene["tgt"].xy, scene["tgt"].mask)
    with pytest.raises(ValueError, match="contiguous bool"):
        kernels.ndt_scores(scene["pose"][None, :], src.xy,
                           src.mask.to(torch.float32), scene["cg"],
                           scene["d1"], scene["d2"])
    with pytest.raises(ValueError, match="poses"):
        kernels.ndt_scores(scene["pose"].repeat(kernels.MAX_POSES + 1, 1),
                           src.xy, src.mask, scene["cg"], scene["d1"],
                           scene["d2"])


@pytest.mark.parametrize("kernel", ["sgh", "score_many"])
def test_kernel_rejects_a_table_without_window_index(scene, kernel):
    """A CompactGrid without table / cell_slot raises on the card."""
    src = scene["src"]
    bare = scene["cg"]._replace(cell_slot=None)
    fn = (kernels.ndt_score_grad_hess if kernel == "sgh"
          else kernels.ndt_scores)
    pose = scene["pose"] if kernel == "sgh" else scene["pose"][None, :]
    with pytest.raises(ValueError, match="no window index"):
        fn(pose, src.xy, src.mask, bare, scene["d1"], scene["d2"])


@pytest.fixture(scope="module")
def grids(scene):
    """Four 48x48 grids at 1.2 m (the verifier's coarse stage) around
    four centres of the scene's target, stacked, and 240 poses (20 rows
    of 12 line-search candidates), each on its row's grid."""
    cuda = scene["pose"].device
    tgt = scene["tgt"]
    centres = [(0.0, 0.0), (3.0, -2.0), (-4.0, 1.5), (1.0, 5.0)]
    cgs = [compact_grid(build_grid(tgt.xy, tgt.mask,
                                   torch.tensor(c, device=cuda), 48, 48, 1.2,
                                   min_pts=6), 2048) for c in centres]
    rng = np.random.default_rng(17)
    rows = torch.from_numpy(np.repeat(np.array(centres), 5, axis=0)
                            + rng.uniform(-0.6, 0.6, (20, 2))).float()
    rows = torch.cat([rows, torch.from_numpy(
        rng.uniform(-0.1, 0.1, (20, 1))).float()], dim=1)
    steps = torch.from_numpy(rng.uniform(-0.4, 0.4, (20, 12, 3))).float()
    poses = (rows[:, None, :] + steps).reshape(240, 3).to(cuda)
    gi = torch.arange(4, dtype=torch.int32).repeat_interleave(60).to(cuda)
    d1, d2 = gauss_constants(1.2, 0.55)
    return dict(cgs=cgs, gs=stack_grids(cgs), poses=poses, gi=gi, d1=d1,
                d2=d2)


@pytest.mark.parametrize("kernel", ["sgh", "score_many"])
def test_grid_axis_matches_twin_on_card(scene, grids, kernel):
    src, gs, poses, gi = scene["src"], grids["gs"], grids["poses"], \
        grids["gi"]
    d1, d2 = grids["d1"], grids["d2"]
    want = window_rows(poses, gi, src.xy, src.mask, gs, d1, d2)
    name = ("ndt_score_grad_hess_grids" if kernel == "sgh"
            else "ndt_scores_grids")
    before = kernels.wrapper_launch_counts()[name]
    if kernel == "sgh":
        E, g, H, m = kernels.ndt_score_grad_hess_grids(
            poses, gi, src.xy, src.mask, gs, d1, d2)
        torch.cuda.synchronize()
        assert torch.equal(m, want[:, 1]) and float(m.sum()) > 240 * 50
        np.testing.assert_allclose(_np(E), _np(want[:, 0]), rtol=1e-5)
        np.testing.assert_allclose(_np(g), _np(want[:, 2:5]), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(_np(H.reshape(-1, 9)),
                                   _np(want[:, 5:14]), rtol=1e-3, atol=0.05)
    else:
        got = kernels.ndt_scores_grids(poses, gi, src.xy, src.mask, gs, d1,
                                       d2)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got), _np(want[:, 0]), rtol=1e-5)
    assert kernels.wrapper_launch_counts()[name] == before + 1


def test_grid_axis_with_one_grid_gives_the_single_grid_bits(scene):
    """One grid (grid index 0 everywhere) is the single-grid call bit for
    bit; a source row per grid is the single-grid call on that row."""
    src, cg, d1, d2 = scene["src"], scene["cg"], scene["d1"], scene["d2"]
    cuda = src.xy.device
    poses = scene["pose"][None, :] + torch.linspace(
        -0.05, 0.05, 12, device=cuda)[:, None]
    zeros = torch.zeros(12, dtype=torch.int32, device=cuda)
    one = stack_grids([cg])
    got = kernels.ndt_score_grad_hess_grids(poses, zeros, src.xy, src.mask,
                                            one, d1, d2)
    want = kernels.ndt_score_grad_hess(poses, src.xy, src.mask, cg, d1, d2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(
        kernels.ndt_scores_grids(poses, zeros, src.xy, src.mask, one, d1, d2),
        kernels.ndt_scores(poses, src.xy, src.mask, cg, d1, d2))
    other = pad_points(_np(src.xy[:1500]) + 0.02, 2048, cuda)
    xy = torch.stack([src.xy, other.xy])
    mask = torch.stack([src.mask, other.mask])
    gi = torch.tensor([0, 1] * 6, dtype=torch.int32, device=cuda)
    rows = kernels.ndt_scores_grids(poses, gi, xy, mask,
                                    stack_grids([cg, cg]), d1, d2)
    assert torch.equal(rows[0::2], kernels.ndt_scores(
        poses[0::2].contiguous(), src.xy, src.mask, cg, d1, d2))
    assert torch.equal(rows[1::2], kernels.ndt_scores(
        poses[1::2].contiguous(), other.xy, other.mask, cg, d1, d2))


def _assert_argmin_equals_twin(src, sm, tgt, tm):
    before = kernels.wrapper_launch_counts()
    d2, idx = kernels.nn_argmin(src, sm, tgt, tm)
    dist = kernels.nn_sq_dists_batched(src, sm, tgt, tm)
    torch.cuda.synchronize()
    want_d2, want_idx = nn_argmin(src, sm, tgt, tm)
    assert _same(d2, want_d2) and _same(dist, want_d2)
    assert idx.dtype == torch.int32 and torch.equal(idx, want_idx)
    for b in range(src.shape[0]):
        assert _same(d2[b], nn_sq_dists(src[b], sm[b], tgt[b], tm[b]))
    after = kernels.wrapper_launch_counts()
    assert after["nn_argmin"] == before["nn_argmin"] + 1
    assert after["nn_sq_dists_batched"] == before["nn_sq_dists_batched"] + 1
    return d2, idx


@pytest.mark.parametrize("shape", [(4, 2048, 2048), (1, 2048, 131072),
                                   (3, 300, 5000)])
def test_nn_argmin_equals_twin(cuda, shape):
    b, n, m = shape
    rng = np.random.default_rng(n + m)
    src = torch.from_numpy(rng.uniform(-20, 20, (b, n, 2)).astype(
        np.float32)).to(cuda)
    tgt = torch.from_numpy(rng.uniform(-20, 20, (b, m, 2)).astype(
        np.float32)).to(cuda)
    if m == 131072:    # full load: every slot live
        sm = torch.ones((b, n), dtype=torch.bool, device=cuda)
        tm = torch.ones((b, m), dtype=torch.bool, device=cuda)
    else:
        sm = torch.from_numpy(rng.uniform(size=(b, n)) < 0.7).to(cuda)
        tm = torch.from_numpy(rng.uniform(size=(b, m)) < 0.4).to(cuda)
    _assert_argmin_equals_twin(src, sm, tgt, tm)


@pytest.mark.parametrize("case", [
    "lattice_ties", "duplicated_chunks", "no_target_row", "far_targets",
    "nan_source", "nan_target", "masked_nan_target",
])
def test_nn_argmin_ties_nan_and_masks(cuda, case):
    """Ties go to the lowest index whatever chunk or block holds them; a
    NaN wins and the lowest NaN index stays; masked slots never count;
    index 0 where nothing is chosen."""
    rng = np.random.default_rng(7)
    b, n, m = 3, 700, 3000
    src = rng.integers(-10, 11, (b, n, 2)).astype(np.float32) + 0.5
    tgt = rng.integers(-10, 11, (b, m, 2)).astype(np.float32)
    sm = rng.uniform(size=(b, n)) < 0.8
    tm = rng.uniform(size=(b, m)) < 0.5
    if case == "duplicated_chunks":   # every target again 1024 slots later
        tgt[:, 1024:2048] = tgt[:, :1024]
        tm[:, 1024:2048] = tm[:, :1024]
    elif case == "no_target_row":
        tm[1] = False
    elif case == "far_targets":       # farther than 1e12 from every source
        tgt = (np.abs(tgt) + 1.0) * 2.0e6
    elif case == "nan_source":
        src[0, np.nonzero(sm[0])[0][0], 0] = np.nan
    elif case in ("nan_target", "masked_nan_target"):
        live = case == "nan_target"
        hit = np.nonzero(tm[2] == live)[0]
        tgt[2, hit[5], 1] = np.nan
        tgt[2, hit[40], 0] = np.nan
    args = [torch.from_numpy(a).to(cuda) for a in (src, sm, tgt, tm)]
    d2, idx = _assert_argmin_equals_twin(*args)
    if case == "no_target_row":
        assert (d2[1] == BIG).all() and (idx[1] == 0).all()
    elif case == "far_targets":
        live = args[1]
        assert (d2[live] == BIG).all() and bool((idx[live] > 0).any())
    elif case == "nan_target":
        first = int(np.nonzero(tm[2])[0][np.nonzero(
            np.isnan(tgt[2, tm[2]]).any(axis=1))[0][0]])
        assert bool(torch.isnan(d2[2][args[1][2]]).all())
        assert bool((idx[2][args[1][2]] == first).all())
    elif case == "masked_nan_target":
        assert bool(torch.isfinite(d2).all())


def _fitness_batch(cuda, b, n=2048, m=131072, seed=21):
    """[b, n] sources against [b, m] targets: walls of their own a row,
    sources on them a few cm off, live prefixes of different lengths."""
    rng = np.random.default_rng(seed)
    tgt = (rng.uniform(-20, 20, (b, m, 2))).astype(np.float32)
    src = (tgt[:, :n] + rng.normal(0, 0.05, (b, n, 2))).astype(np.float32)
    sm = np.arange(n)[None] < rng.integers(50, n, (b, 1))
    tm = rng.random((b, m)) < rng.uniform(0.02, 0.9, (b, 1))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    return t(src), t(sm), t(tgt), t(tm)


@pytest.mark.parametrize("case", ["rows", "idle rows", "one row"])
def test_fitness_batched_equals_twin_and_single_calls(cuda, case):
    """`fitness_score_batched`: each row equal to `fitness_score` of that
    row alone bit for bit (the finish sums in an order of N only), and to
    the twin to rtol 1e-6 (one sum in another order); an idle row (no
    source, or no target) gives 1e12."""
    b = 1 if case == "one row" else 4
    src, sm, tgt, tm = _fitness_batch(cuda, b)
    if case == "idle rows":
        sm[1] = False
        tm[2] = False
    got = kernels.fitness_score_batched(src, sm, tgt, tm)
    want = fitness_score_plain(src, sm, tgt, tm)
    assert got.shape == (b,)
    for k in range(b):
        one = kernels.fitness_score(src[k], sm[k], tgt[k], tm[k])
        assert torch.equal(got[k].view(torch.int32), one.view(torch.int32))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    if case == "idle rows":
        assert _np(got)[1] == _np(got)[2] == np.float32(BIG)
