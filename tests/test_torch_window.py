"""The window index of the port's compact table, on the CPU.

The CUDA kernels of ndt_slam_tpu_torch.ndt.kernels do not scan the
table: they look the (2r+1)^2 cells around a point up through
`CompactGrid.cell_slot` and read them from `CompactGrid.table`. These
tests hold that index to the table it was built from, to the JAX
package's table on the same seeded numpy cloud, and hold a plain-torch
gather evaluation of (E, matched), written here in the kernels' visiting
order, to the [N,K] twin: matched exact, E to rtol 1e-5 (the same f32
terms summed in another order). The kernels themselves against the
twins on the card: tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.ndt.compact import compact_grid as j_compact_grid
from ndt_slam_tpu.ndt.grid import build_grid as j_build_grid

from ndt_slam_tpu_torch import convert
from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.ndt.compact import (
    compact_grid, ndt_score_grad_hess_compact, point_features,
)
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.score import gauss_constants

torch.set_num_threads(2)

NX = NY = 48            # a 14.4 m window centred on the origin
RES = 0.3
MIN_PTS = 3
K_FULL = NX * NY
K_SMALL = 300           # below the number of valid cells
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scene():
    """A seeded cloud that fills the window up to its edges and beyond,
    so cells at the border are valid, and a source scan of 500 points
    in 512 slots spread over the same area."""
    rng = np.random.default_rng(7)
    tgt_np = rng.uniform(-9.0, 9.0, size=(30000, 2)).astype(np.float32)
    src_np = rng.uniform(-7.0, 7.0, size=(500, 2)).astype(np.float32)
    tgt, src = pad_points(tgt_np, 32768, CPU), pad_points(src_np, 512, CPU)
    grid = build_grid(tgt.xy, tgt.mask, torch.zeros(2), NX, NY, RES,
                      min_pts=MIN_PTS)
    j_tgt = j_pad(tgt_np, 32768)
    j_grid = j_build_grid(j_tgt.xy, j_tgt.mask, jnp.zeros(2, jnp.float32),
                          NX, NY, RES, min_pts=MIN_PTS)
    d1, d2 = gauss_constants(RES, 0.55)
    assert int(grid.valid.sum()) > K_SMALL
    return dict(grid=grid, j_grid=j_grid, src=src, d1=d1, d2=d2,
                full=compact_grid(grid, K_FULL),
                small=compact_grid(grid, K_SMALL))


def _assert_inverts_table(cg):
    """cell_slot[kx*ny + ky] == k for every valid slot k, and nothing
    else is >= 0; the cell-major table repeats the columns."""
    slot = cg.cell_slot
    assert slot.dtype == torch.int32 and slot.shape == (cg.nx * cg.ny,)
    k = torch.nonzero(cg.valid)[:, 0]
    cell = (cg.kx[k] * cg.ny + cg.ky[k]).to(torch.int64)
    np.testing.assert_array_equal(slot[cell].numpy(), k.numpy())
    assert int((slot >= 0).sum()) == int(cg.valid.sum()) > 0
    assert cg.table.shape == (cg.capacity, 8) and cg.table.is_contiguous()
    for col, f in enumerate(("kx", "ky", "mx", "my", "b00", "b01", "b11")):
        np.testing.assert_array_equal(cg.table[:, col].numpy(),
                                      getattr(cg, f).numpy())
    np.testing.assert_array_equal(cg.table[:, 7].numpy() > 0,
                                  cg.valid.numpy())


def test_cell_slot_inverts_the_table(scene):
    _assert_inverts_table(scene["full"])


def test_cell_slot_with_overflowed_table_drops_cells(scene):
    """Capacity below the valid count: the dropped cells read -1."""
    cg, grid = scene["small"], scene["grid"]
    _assert_inverts_table(cg)
    assert int((cg.cell_slot >= 0).sum()) == K_SMALL < int(grid.valid.sum())
    dropped = grid.valid & (cg.cell_slot < 0)
    assert int(dropped.sum()) == int(grid.valid.sum()) - K_SMALL
    # the kept cells are the first in cell-id order
    assert int(torch.nonzero(dropped)[0]) > int(
        torch.nonzero(cg.cell_slot >= 0)[-1])


@pytest.mark.parametrize("capacity", [K_FULL, K_SMALL])
def test_converted_jax_table_gives_the_same_index(scene, capacity):
    """A table taken over from the JAX package gets its index by a
    scatter; it equals the port's own."""
    cg = convert.compact_grid(j_compact_grid(scene["j_grid"], capacity), CPU)
    _assert_inverts_table(cg)
    own = compact_grid(scene["grid"], capacity)
    np.testing.assert_array_equal(cg.cell_slot.numpy(),
                                  own.cell_slot.numpy())


def _gather_score(pose, xy, mask, cg, d1, d2, r):
    """(E, matched) by the kernels' route: each point visits the
    (2r+1)^2 cells around its own through cell_slot, dx outer and dy
    inner, both ascending; cells off the window or without a slot are
    skipped. Plain torch, one [N] pass per window offset."""
    px, py, fx, fy, _, _ = point_features(pose, xy, cg)
    live = (mask & (fx >= -r) & (fx <= cg.nx - 1 + r)
            & (fy >= -r) & (fy <= cg.ny - 1 + r))
    cx = torch.where(live, fx, 0.0).to(torch.int64)
    cy = torch.where(live, fy, 0.0).to(torch.int64)
    E = torch.zeros(())
    matched = torch.zeros(())
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            gx, gy = cx + dx, cy + dy
            inside = live & (gx >= 0) & (gx < cg.nx) & (gy >= 0) & (gy < cg.ny)
            cell = torch.where(inside, gx * cg.ny + gy, 0)
            slot = cg.cell_slot[cell].to(torch.int64)
            hit = inside & (slot >= 0)
            row = cg.table[torch.where(hit, slot, 0)]
            qx, qy = px - row[:, 2], py - row[:, 3]
            bqx = row[:, 4] * qx + row[:, 5] * qy
            bqy = row[:, 5] * qx + row[:, 6] * qy
            md = qx * bqx + qy * bqy
            e = torch.exp(-0.5 * d2 * torch.clamp(md, max=50.0 / d2))
            E = E + torch.sum(torch.where(hit, d1 * e, 0.0))
            matched = matched + hit.sum()
    return E, matched


CASES = {
    # name: (table, pose, all source slots masked)
    "inside": ("full", (0.05, -0.03, 0.02), False),
    "partly_outside": ("full", (2.5, -1.5, 0.4), False),
    "all_masked": ("full", (0.05, -0.03, 0.02), True),
    "overflowed_table": ("small", (0.05, -0.03, 0.02), False),
}


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_window_gather_equals_table_scan(scene, case, r):
    table, pose, masked = CASES[case]
    cg, src, d1, d2 = scene[table], scene["src"], scene["d1"], scene["d2"]
    mask = torch.zeros_like(src.mask) if masked else src.mask
    pose = torch.tensor(pose, dtype=torch.float32)
    E0, _, _, m0 = ndt_score_grad_hess_compact(pose, src.xy, mask, cg, d1,
                                               d2, r)
    E1, m1 = _gather_score(pose, src.xy, mask, cg, d1, d2, r)
    assert float(m1) == float(m0)
    np.testing.assert_allclose(float(E1), float(E0), rtol=1e-5)
    if masked:
        assert float(m0) == 0.0 and float(E1) == 0.0
        return
    assert float(m0) > 100
    _, _, fx, fy, _, _ = point_features(pose, src.xy, cg)
    off = src.mask & ((fx < 0) | (fx >= cg.nx) | (fy < 0) | (fy >= cg.ny))
    if case == "partly_outside":
        # some points lie off the window, some of those within r cells
        near = off & (fx >= -r) & (fx < cg.nx + r) & (fy >= -r) \
            & (fy < cg.ny + r)
        assert int(off.sum()) > 20 and int(near.sum()) > 0
    else:
        assert int(off.sum()) == 0
    if case == "overflowed_table":
        full = ndt_score_grad_hess_compact(pose, src.xy, mask, scene["full"],
                                           d1, d2, r)
        assert float(m0) < float(full[3])


def test_sgh_wrapper_batches_over_poses(scene):
    """[C,3] poses through the wrapper (its twin on the CPU) give the C
    single calls, stacked."""
    cg, src, d1, d2 = scene["full"], scene["src"], scene["d1"], scene["d2"]
    poses = torch.tensor([[0.05, -0.03, 0.02], [2.5, -1.5, 0.4],
                          [-0.2, 0.1, -0.05]])
    E, g, H, m = kernels.ndt_score_grad_hess(poses, src.xy, src.mask, cg,
                                             d1, d2, 1)
    assert E.shape == (3,) and g.shape == (3, 3) and H.shape == (3, 3, 3) \
        and m.shape == (3,)
    for c, pose in enumerate(poses):
        one = kernels.ndt_score_grad_hess(pose, src.xy, src.mask, cg, d1,
                                          d2, 1)
        for got, want in zip((E, g, H, m), one):
            np.testing.assert_array_equal(got[c].numpy(), want.numpy())
