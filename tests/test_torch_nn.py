"""The port's nearest-neighbour pass (ndt_slam_tpu_torch.ndt.fitness,
kernels.nn_sq_dists, kernels.fitness_score, mapping.dynamic) on the CPU.

Three things are held here:
- a plain-torch model of the CUDA kernel's scheme, written out below
  (target chunks dealt round-robin to the blocks of a source tile;
  each warp compacting its
  live targets; a tile without a live source leaving at once; block
  partials met by a finish step that reads only live sources), equals
  the twin `fitness.nn_sq_dists` bit for bit: every pair takes the same
  f32 operations and a minimum is exact in any order;
- the port's `nn_sq_dists` and `fitness_score` against the JAX
  package's `nn_sq_dists`, `fitness_score` and, in interpret mode,
  `nn_sq_dists_pallas` and `fitness_score_pallas`, on seeded numpy
  inputs: atol 2e-5 (the JAX engine takes the matmul form, the port the
  difference form), the 1e12 and NaN cases exactly;
- `keep_far_from_mask` against the JAX package's.
The kernel itself against the twin on the card:
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndt_slam_tpu.mapping.dynamic import keep_far_from_mask as j_keep_far
from ndt_slam_tpu.ndt import pallas_kernels as pk
from ndt_slam_tpu.ndt.fitness import fitness_score as j_fitness
from ndt_slam_tpu.ndt.fitness import nn_sq_dists as j_nn

from ndt_slam_tpu_torch.core.points import PAD_COORD
from ndt_slam_tpu_torch.mapping.dynamic import keep_far_from_mask
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.ndt.fitness import (
    BIG, fitness_score, fitness_score_plain, nn_sq_dists,
)

torch.set_num_threads(2)

THREADS = 128      # threads a block of the kernel
BIG32 = float(np.float32(BIG))


def _nan_min(a, b):
    """The twin's minimum: a NaN on either side wins."""
    return torch.where((b < a) | torch.isnan(b), b, a)


def _model_pairs(src, sm, tgt, tm, blocks, tile, chunk):
    """First launch: part [blocks, n] (NaN where the kernel writes
    nothing) and live [tiles, blocks]."""
    n, m = src.shape[0], tgt.shape[0]
    tiles, chunks = -(-n // tile), -(-m // chunk)
    part = torch.full((blocks, n), float("nan"))
    live = torch.zeros((tiles, blocks), dtype=torch.int32)
    for ti in range(tiles):
        rows = slice(ti * tile, min(n, (ti + 1) * tile))
        if not bool(sm[rows].any()):
            live[ti, :] = -1            # the tile leaves at once
            continue
        sx, sy = src[rows, 0:1], src[rows, 1:2]
        for b in range(blocks):
            best = torch.full((rows.stop - rows.start,), BIG)
            met = 0
            for c in range(b, chunks, blocks):
                # a thread reads chunk / THREADS neighbouring mask
                # bytes; its warp stages the live ones element-major,
                # then by lane
                j = c * chunk + torch.arange(chunk).reshape(
                    THREADS // 32, 32, chunk // THREADS)
                j = j.permute(0, 2, 1).reshape(-1)
                j = j[j < m]
                j = j[tm[j]]
                met += j.numel()
                if j.numel() == 0:
                    continue            # a chunk costs its mask bytes
                dx = sx - tgt[j, 0][None, :]
                dy = sy - tgt[j, 1][None, :]
                d2 = dx * dx + dy * dy
                for k in range(d2.shape[1]):      # the running minimum
                    best = _nan_min(best, d2[:, k])
            part[b, rows] = best
            live[ti, b] = met
    return part, live


def _model_finish(part, live, sm):
    """Second launch: d2 [n] and the fitness scalar. Reads the partials
    of live sources only."""
    n = sm.shape[0]
    best = torch.full((n,), BIG)
    on = torch.nonzero(sm)[:, 0]
    for b in range(part.shape[0]):
        best[on] = _nan_min(best[on], part[b, on])
    best = torch.where(best < 0, torch.zeros(()), best)
    d2 = torch.where(sm, best, torch.tensor(BIG))
    count = sm.sum(dtype=torch.float32)
    total = torch.zeros(())
    for i in on.tolist():                          # a fixed order
        total = total + d2[i]
    have_target = bool((live > 0).any())
    fit = total / torch.clamp(count, min=1.0)
    return d2, (fit if count > 0 and have_target else torch.tensor(BIG))


def _model(src, sm, tgt, tm, blocks=3):
    part, live = _model_pairs(src, sm, tgt, tm, blocks, kernels.NN_TILE,
                              kernels.NN_CHUNK)
    return _model_finish(part, live, sm)


def _inputs(n, m, n_live, masks, seed):
    """Seeded points in a 10 m square; sources a prefix of `n_live`;
    targets a prefix (a third), scattered (30 %), all or none."""
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.uniform(-5, 5, (n, 2)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(-5, 5, (m, 2)).astype(np.float32))
    sm = torch.arange(n) < n_live
    tm = {"prefix": torch.arange(m) < max(1, m // 3),
          "scattered": torch.from_numpy(rng.uniform(size=m) < 0.3),
          "all": torch.ones(m, dtype=torch.bool),
          "none": torch.zeros(m, dtype=torch.bool)}[masks]
    return src, sm, tgt, tm


def _same(a, b):
    """Equal bit for bit; a NaN equals a NaN whatever its payload."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


# case: (n, m, live sources, target mask, blocks)
MODEL_CASES = {
    "prefix": (300, 1500, 200, "prefix", 3),
    "scattered": (300, 1500, 200, "scattered", 3),
    "ragged_tail": (130, 1000, 130, "scattered", 2),
    "three_source_tiles": (600, 700, 520, "scattered", 2),
    "dead_source_tile": (600, 500, 100, "all", 2),
    "more_blocks_than_chunks": (100, 300, 100, "all", 5),
    "no_target": (100, 600, 80, "none", 2),
    "no_source": (100, 600, 0, "all", 2),
    "one_empty_slot": (100, 1, 60, "none", 1),
    "one_live_slot": (100, 1, 60, "all", 1),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_scheme_equals_twin_bit_for_bit(case):
    n, m, n_live, masks, blocks = MODEL_CASES[case]
    src, sm, tgt, tm = _inputs(n, m, n_live, masks, seed=len(case))
    d2, fit = _model(src, sm, tgt, tm, blocks)
    want = nn_sq_dists(src, sm, tgt, tm)
    assert _same(d2, want)
    np.testing.assert_allclose(
        float(fit), float(fitness_score_plain(src, sm, tgt, tm)), rtol=1e-6)
    if masks == "none" or n_live == 0:
        assert bool((d2 == BIG).all()) and float(fit) == BIG32
    else:
        assert bool((d2[sm] < 200.0).all()) and bool((d2[~sm] == BIG).all())


def test_kernel_scheme_ignores_pad_coordinates():
    """Masked slots sit at 1e8, a pad-to-pad distance is 0: the masks
    decide, nothing leans on pads being far."""
    src, sm, tgt, tm = _inputs(300, 900, 150, "scattered", seed=21)
    src = torch.where(sm[:, None], src, PAD_COORD)
    tgt = torch.where(tm[:, None], tgt, PAD_COORD)
    d2, _ = _model(src, sm, tgt, tm)
    assert _same(d2, nn_sq_dists(src, sm, tgt, tm))
    assert bool((d2[sm] < 200.0).all()) and bool((d2[~sm] == BIG).all())


@pytest.mark.parametrize("where", ["source", "target", "masked_target"])
def test_kernel_scheme_carries_nan_as_the_twin(where):
    src, sm, tgt, tm = _inputs(300, 900, 150, "scattered", seed=22)
    if where == "source":
        src[7, 0] = float("nan")
        src[9, 1] = float("inf")
    elif where == "target":
        tgt[int(torch.nonzero(tm)[3]), 1] = float("nan")
    else:
        tgt[int(torch.nonzero(~tm)[3]), 0] = float("nan")
    d2, fit = _model(src, sm, tgt, tm)
    want = nn_sq_dists(src, sm, tgt, tm)
    assert _same(d2, want)
    nans = int(torch.isnan(d2).sum())
    assert nans == {"source": 1, "target": 150, "masked_target": 0}[where]
    assert bool(torch.isnan(fit)) == (nans > 0)


def _to_jax(src, sm, tgt, tm):
    return (jnp.asarray(src.numpy()), jnp.asarray(sm.numpy()),
            jnp.asarray(tgt.numpy()), jnp.asarray(tm.numpy()))


JAX_NN = {"nn_sq_dists": j_nn, "nn_sq_dists_pallas": pk.nn_sq_dists_pallas}
JAX_FITNESS = {"fitness_score": j_fitness,
               "fitness_score_pallas": pk.fitness_score_pallas}


@pytest.mark.parametrize("masks", ["prefix", "scattered"])
@pytest.mark.parametrize("reference", sorted(JAX_NN))
def test_nn_sq_dists_matches_jax(reference, masks):
    src, sm, tgt, tm = _inputs(512, 2048, 300, masks, seed=31)
    got = kernels.nn_sq_dists(src, sm, tgt, tm)
    want = np.asarray(JAX_NN[reference](*_to_jax(src, sm, tgt, tm)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert (got.numpy()[300:] == np.float32(BIG)).all()


@pytest.mark.parametrize("reference", sorted(JAX_FITNESS))
def test_fitness_score_matches_jax(reference):
    src, sm, tgt, tm = _inputs(512, 2048, 300, "scattered", seed=32)
    ref = JAX_FITNESS[reference]
    got = fitness_score(src, sm, tgt, tm)
    assert got.shape == () and got.dtype == torch.float32
    want = float(ref(*_to_jax(src, sm, tgt, tm)))
    np.testing.assert_allclose(float(got), want, rtol=0, atol=2e-5)
    # no valid source, and no valid target: 1e12 on both sides
    for s_mask, t_mask in ((torch.zeros_like(sm), tm),
                           (sm, torch.zeros_like(tm))):
        got = fitness_score(src, s_mask, tgt, t_mask)
        want = float(ref(*_to_jax(src, s_mask, tgt, t_mask)))
        assert float(got) == want == BIG32


@pytest.mark.parametrize("reference", sorted(JAX_NN))
def test_nan_source_gives_nan_as_in_jax(reference):
    """A diverged registration hands the fitness a NaN source: its
    distance and the mean are NaN in the JAX package and in the port,
    and no other source is touched."""
    src, sm, tgt, tm = _inputs(512, 2048, 300, "scattered", seed=33)
    src[5] = float("nan")
    got = kernels.nn_sq_dists(src, sm, tgt, tm)
    want = np.asarray(JAX_NN[reference](*_to_jax(src, sm, tgt, tm)))
    assert np.isnan(want[5]) and bool(torch.isnan(got[5]))
    assert int(torch.isnan(got).sum()) == int(np.isnan(want).sum()) == 1
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=0, atol=2e-5)
    assert bool(torch.isnan(fitness_score(src, sm, tgt, tm)))
    assert np.isnan(float(j_fitness(*_to_jax(src, sm, tgt, tm))))
    # a masked NaN source is no NaN
    src[400] = float("nan")
    assert int(torch.isnan(kernels.nn_sq_dists(src, sm, tgt, tm)).sum()) == 1


@pytest.mark.parametrize("masks", ["scattered", "none"])
def test_keep_far_from_mask_matches_jax(masks):
    """The interior dynamic-removal pass hands a scattered candidate
    mask over real coordinates; with no candidate everything is kept."""
    pts, pm, _, _ = _inputs(512, 8, 400, "all", seed=34)
    rng = np.random.default_rng(35)
    cand = torch.from_numpy(rng.uniform(size=512) < 0.1) & pm
    if masks == "none":
        cand = torch.zeros_like(cand)
    cand_xy = torch.where(cand[:, None], pts, PAD_COORD)
    got = keep_far_from_mask(pts, pm, cand_xy, cand, 0.7)
    want = np.asarray(j_keep_far(*_to_jax(pts, pm, cand_xy, cand), 0.7))
    np.testing.assert_array_equal(got.numpy(), want)
    if masks == "none":
        assert bool((got == pm).all())
    else:
        assert not bool(got[cand].any()) and 0 < int(got.sum()) < 400


def test_both_entry_points_count_under_nn_and_take_the_twin_on_cpu():
    src, sm, tgt, tm = _inputs(64, 256, 50, "all", seed=36)
    kernels.reset_launch_counts()
    d2 = kernels.nn_sq_dists(src, sm, tgt, tm)
    fit = kernels.fitness_score(src, sm, tgt, tm)
    assert kernels.launch_counts() == {"sgh": 0, "score_many": 0, "nn": 0,
                                       "newton": 0, "fuse": 0}
    assert torch.equal(d2, nn_sq_dists(src, sm, tgt, tm))
    assert torch.equal(fit, fitness_score_plain(src, sm, tgt, tm))
    assert torch.equal(fit, fitness_score(src, sm, tgt, tm))
    kernels.fitness_score.launches += 2
    kernels.nn_sq_dists.launches += 3
    assert kernels.launch_counts()["nn"] == 5
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["nn"] == 0
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="no NDT kernel route"):
        kernels.fitness_score(meta, meta[:, 0] > 0, meta, meta[:, 0] > 0)
