"""The row axis of the port's Newton solve and the grid axis of its
window kernels, on the CPU.

`ndt.solve.align` over rows ([R,3] poses, row r against grid
`grid_index[r]` of a `compact.GridStack`) is what the loop-closure
verifier runs where the JAX package vmaps `align`. Held here:
- row by row, an R-row call equals bit for bit the calls of each row
  alone (rows do not leak into each other; a finished row stays
  masked), and agrees with the single-pose `align` on the [N,K] twin
  at a tight stop (matched pairs equal, pose within 1e-4);
- the grid-axis twin `compact.window_rows` against the [N,K] twin pose
  by pose, each pose on its own grid: matched exact, E / grad / H at
  the ROADMAP parity bar, with one shared source and with a source row
  per grid;
- `compact.stack_grids` against the grids it stacks.
The kernels themselves against the twin on the card:
tests/test_torch_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.ndt.compact import (
    compact_grid, ndt_score_grad_hess_compact, stack_grids, window_rows,
)
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.score import gauss_constants
from ndt_slam_tpu_torch.ndt.solve import align

torch.set_num_threads(2)

CPU = torch.device("cpu")
NX = NY = 48
RES = 0.3
K = 512


@pytest.fixture(scope="module")
def scene():
    """Seeded walls; three grids of one shape around three centres and
    a 400-point source in 512 slots."""
    rng = np.random.default_rng(21)
    a = rng.uniform(-9.0, 9.0, size=(25, 2))
    b = a + rng.uniform(-4.0, 4.0, size=(25, 2))

    def sample(n):
        seg = rng.integers(0, 25, size=n)
        t = rng.uniform(0.0, 1.0, size=(n, 1))
        return a[seg] + t * (b[seg] - a[seg]) \
            + 0.01 * rng.standard_normal((n, 2))

    tgt = pad_points(sample(9000), 9216, CPU)
    srcs = [pad_points(sample(400), 512, CPU) for _ in range(3)]
    centres = [(0.0, 0.0), (1.3, -0.7), (-2.0, 1.1)]
    cgs = [compact_grid(build_grid(tgt.xy, tgt.mask, torch.tensor(c), NX, NY,
                                   RES, min_pts=6), K) for c in centres]
    assert all(0 < int(cg.valid.sum()) < K for cg in cgs)
    d1, d2 = gauss_constants(RES, 0.55)
    return dict(cgs=cgs, gs=stack_grids(cgs), src=srcs[0], srcs=srcs,
                d1=d1, d2=d2)


def _poses(rng, n, spread):
    return torch.from_numpy(
        (rng.uniform(-1.0, 1.0, (n, 3)) * spread).astype(np.float32))


def test_stack_grids_stacks_the_grids(scene):
    cgs, gs = scene["cgs"], scene["gs"]
    assert gs.grids == 3 and gs.capacity == K
    assert (gs.nx, gs.ny, gs.resolution) == (NX, NY, RES)
    for g, cg in enumerate(cgs):
        assert torch.equal(gs.table[g], cg.table)
        assert torch.equal(gs.cell_slot[g], cg.cell_slot)
        assert torch.equal(gs.origin[g], cg.origin)
    with pytest.raises(ValueError, match="one shape"):
        stack_grids([cgs[0], compact_grid(
            build_grid(torch.zeros(4, 2), torch.ones(4, dtype=torch.bool),
                       torch.zeros(2), 32, 32, RES), K)])
    with pytest.raises(ValueError, match="window index"):
        stack_grids([cgs[0], cgs[1]._replace(cell_slot=None)])


def _assert_parity(got, want):
    """The ROADMAP parity bar, matched exact."""
    E, g, H, m = got
    E0, g0, H0, m0 = want
    assert float(m) == float(m0)
    np.testing.assert_allclose(float(E), float(E0), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(H.numpy(), H0.numpy(), rtol=1e-3, atol=0.05)


@pytest.mark.parametrize("sources", ["shared", "per_grid"])
def test_grid_axis_twin_equals_the_table_scan(scene, sources):
    """Every pose against its own grid: the gather twin of the grid axis
    against the [N,K] twin of that pose and grid."""
    rng = np.random.default_rng(3)
    gs, cgs, d1, d2 = scene["gs"], scene["cgs"], scene["d1"], scene["d2"]
    poses = _poses(rng, 24, np.array([1.5, 1.5, 0.3]))
    gi = torch.from_numpy(rng.integers(0, 3, 24).astype(np.int32))
    if sources == "shared":
        xy, mask = scene["src"].xy, scene["src"].mask
    else:
        xy = torch.stack([s.xy for s in scene["srcs"]])
        mask = torch.stack([s.mask for s in scene["srcs"]])
    rows = kernels.ndt_score_grad_hess_grids(poses, gi, xy, mask, gs, d1, d2)
    scores = kernels.ndt_scores_grids(poses, gi, xy, mask, gs, d1, d2)
    assert rows[0].shape == (24,) and rows[2].shape == (24, 3, 3)
    assert kernels.launch_counts() == {"sgh": 0, "score_many": 0, "nn": 0,
                                       "newton": 0, "fuse": 0}
    assert torch.equal(scores, rows[0])
    matched = 0
    for p in range(24):
        g = int(gi[p])
        src_xy, src_mask = (xy, mask) if sources == "shared" \
            else (xy[g], mask[g])
        want = ndt_score_grad_hess_compact(poses[p], src_xy, src_mask,
                                           cgs[g], d1, d2)
        _assert_parity([x[p] for x in rows], want)
        matched += float(want[3])
    assert matched > 24 * 50


def test_grid_axis_twin_radius_2_and_a_bad_grid_index(scene):
    gs, cgs, d1, d2 = scene["gs"], scene["cgs"], scene["d1"], scene["d2"]
    src = scene["src"]
    poses = torch.tensor([[0.1, -0.1, 0.05], [0.2, 0.0, -0.1],
                          [0.0, 0.3, 0.0]])
    gi = torch.tensor([2, 7, -1], dtype=torch.int32)
    out = window_rows(poses, gi, src.xy, src.mask, gs, d1, d2, radius=2)
    _assert_parity((out[0, 0], out[0, 2:5], out[0, 5:14].reshape(3, 3),
                    out[0, 1]),
                   ndt_score_grad_hess_compact(poses[0], src.xy, src.mask,
                                               cgs[2], d1, d2, 2))
    # a grid index outside [0, G) matches nothing, as on the card
    assert torch.equal(out[1:], torch.zeros_like(out[1:]))


def test_rows_equal_each_row_alone_and_the_single_pose_solve(scene):
    """Row by row an R-row solve equals each row's own one-row solve bit
    for bit, and the single-pose solve on the [N,K] twin to 1e-4 at a
    tight stop (at the default 1 cm the two sums' orders stop up to a
    few tenths of a millimetre apart)."""
    rng = np.random.default_rng(8)
    gs, cgs, d1, d2 = scene["gs"], scene["cgs"], scene["d1"], scene["d2"]
    src = scene["src"]
    tight = dict(max_iterations=60, trans_eps=1e-4)
    poses = _poses(rng, 6, np.array([0.25, 0.25, 0.05]))
    gi = torch.tensor([0, 1, 2, 2, 1, 0], dtype=torch.int32)
    res = align(poses, src.xy, src.mask, gs, d1, d2, grid_index=gi, **tight)
    assert res.pose_rad.shape == (6, 3) and res.iterations.shape == (6,)
    assert res.hessian.shape == (6, 3, 3) and bool(res.converged.all())
    # rows finished at different iterations: the early ones stayed masked
    assert len(set(res.iterations.tolist())) > 1
    for r in range(6):
        g = int(gi[r])
        alone = align(poses[r:r + 1], src.xy, src.mask, stack_grids([cgs[g]]),
                      d1, d2, grid_index=torch.zeros(1, dtype=torch.int32),
                      **tight)
        for got, want in zip(res, alone):
            assert torch.equal(got[r:r + 1], want)
        one = align(poses[r], src.xy, src.mask, cgs[g], d1, d2, **tight)
        assert float(res.matched[r]) == float(one.matched)
        np.testing.assert_allclose(res.pose_rad[r].numpy(),
                                   one.pose_rad.numpy(), atol=1e-4)


def test_rows_need_a_grid_stack(scene):
    src = scene["src"]
    with pytest.raises(ValueError, match="GridStack"):
        align(torch.zeros(2, 3), src.xy, src.mask, scene["cgs"][0],
              scene["d1"], scene["d2"])
