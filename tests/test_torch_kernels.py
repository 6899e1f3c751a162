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
"""

import numpy as np
import pytest
import torch

from ndt_slam_tpu_torch.core.points import PAD_COORD, pad_points
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.ndt.compact import (
    compact_grid, ndt_negative_score_compact, ndt_score_grad_hess_compact,
    point_features,
)
from ndt_slam_tpu_torch.ndt.fitness import (
    BIG, fitness_score_plain, nn_sq_dists,
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
        kernels.ndt_scores(scene["pose"].repeat(129, 1), src.xy, src.mask,
                           scene["cg"], scene["d1"], scene["d2"])


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
