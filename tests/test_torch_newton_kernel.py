"""The Newton kernel (`kernels.ndt_newton`, one launch for the whole
solve of `solve.align`) against the stepwise loop, and `align`'s route.

The card tests need a CUDA device and skip without one; they import no
JAX, so run them on the card with `python -m pytest --noconftest
tests/test_torch_newton_kernel.py`. Each feeds the same CUDA inputs to
`align` (which launches the kernel) and to the stepwise loop
(`solve._align_stepwise`, the kernel's plain twin, whose score calls
launch kernels 1 and 2): one pose against a `CompactGrid` at office_loop
frame 40, at an overflowed table and at a 288 x 288 window; 20
rows against a `GridStack` of 4 grids (the coarse ladder stage's shape);
an empty source, a pose that matches nothing, a NaN start and a row that
runs the full `max_iterations`; 2048 live source points. Every field
of `NDTResult` is equal bit for bit. The stepwise loop on CUDA tensors
scores through kernels 1 and 2, whose pair visit the Newton kernel
shares, so each case also runs the stepwise loop on CPU copies of the
inputs (the plain twins, which the CPU tests hold to the JAX package),
held to the bar of the CPU solve against the JAX one: iterations,
`converged` and `matched` equal, the pose within 1e-4 m / 1e-4 rad,
with one pose solved as a row on both sides (CPU and CUDA torch sum one
pose's matrix-vector product in other orders, and at the pushed office
frame that flips a line-search decision); and the kernel's E, Hessian
and matched at its final pose to the twins' score at that pose within
the kernel bars of ROADMAP.md (the twin's own final pose may lie a few
float32 steps away, which moves E by more), E with a floor of 1e-7 for
a pose whose points all lie deep in their Gaussians' tails.

The CPU tests hold the route: CPU tensors never reach the wrapper, CUDA
tensors (a tensor that reports a CUDA device) take it on a `CompactGrid`
or a `GridStack`, and the stepwise loop on an `NDTGrid` or with `axis`;
the counters start at 0 and reset.
"""

import os

import numpy as np
import pytest
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.ndt import kernels, solve
from ndt_slam_tpu_torch.ndt.compact import compact_grid, stack_grids
from ndt_slam_tpu_torch.ndt.grid import build_grid
from ndt_slam_tpu_torch.ndt.score import gauss_constants

LOG = os.path.join(os.path.dirname(__file__), "data", "office_loop.clf")
FIELDS = solve.NDTResult._fields


def _walls(rng, sizes, segs=40, half=12.0):
    """Point sets of the sizes given, each sampled from the same seeded
    wall segments with 1 cm of noise."""
    a = rng.uniform(-half, half, size=(segs, 2))
    b = a + rng.uniform(-5.0, 5.0, size=(segs, 2))
    out = []
    for n in sizes:
        seg = rng.integers(0, segs, size=n)
        t = rng.uniform(0.0, 1.0, size=(n, 1))
        out.append((a[seg] + t * (b[seg] - a[seg])
                    + 0.01 * rng.standard_normal((n, 2))).astype(np.float32))
    return out


def _problem(device, n_tgt=4000, n_src=300, cells=32, res=1.0, cap=512,
             seed=3):
    """A small seeded scene: target walls, a source of the same walls
    offset by a few cm, its grid and compact table."""
    rng = np.random.default_rng(seed)
    tgt_np, src_np = _walls(rng, (n_tgt, n_src))
    tgt = pad_points(tgt_np, n_tgt, device)
    src = pad_points(src_np + [0.05, -0.04], 512, device)
    grid = build_grid(tgt.xy, tgt.mask, torch.zeros(2, device=device),
                      cells, cells, res, min_pts=3)
    d1, d2 = gauss_constants(res, 0.55)
    return src, grid, compact_grid(grid, cap), d1, d2


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: `align`'s route is
    decided by `is_cuda`, the work under it runs on the CPU."""
    @property
    def is_cuda(self):
        return True


class _OneRank:
    """An `axis` of one rank: every sum is the tensor itself."""
    def sum(self, t):
        return t


def _fake_newton(calls):
    def run(poses, grid_index, xy, mask, grids, *args):
        calls.append(poses.shape[0])
        r = poses.shape[0]
        return (poses.clone(), torch.zeros(r, dtype=torch.int32),
                torch.ones(r, dtype=torch.bool), torch.zeros(r),
                torch.zeros(r, 3, 3), torch.zeros(r))
    return run


@pytest.mark.parametrize("rows", [False, True])
def test_cpu_tensors_never_reach_the_wrapper(monkeypatch, rows):
    src, grid, cg, d1, d2 = _problem("cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("the Newton wrapper was called on CPU tensors")
    monkeypatch.setattr(solve, "ndt_newton", refuse)
    kernels.reset_launch_counts()
    solve.reset_stepwise_count()
    pose = torch.tensor([0.02, -0.01, 0.01])
    if rows:
        res = solve.align(pose.expand(3, 3).contiguous(), src.xy, src.mask,
                          stack_grids([cg, cg]), d1, d2,
                          grid_index=torch.tensor([0, 1, 1],
                                                  dtype=torch.int32))
        assert res.pose_rad.shape == (3, 3) and res.iterations.shape == (3,)
    else:
        res = solve.align(pose, src.xy, src.mask, cg, d1, d2)
        assert res.pose_rad.shape == (3,) and res.hessian.shape == (3, 3)
    assert bool(res.converged.all()) and int(res.iterations.min()) >= 1
    assert kernels.launch_counts()["newton"] == 0
    assert solve.stepwise_cuda_calls() == 0


@pytest.mark.parametrize("case,kernel", [
    ("compact", True), ("stack_rows", True), ("ndt_grid", False),
    ("axis", False),
])
def test_route_on_card_tensors(monkeypatch, case, kernel):
    src, grid, cg, d1, d2 = _problem("cpu")
    calls = []
    monkeypatch.setattr(solve, "ndt_newton", _fake_newton(calls))
    solve.reset_stepwise_count()
    xy = src.xy.as_subclass(_OnCard)
    pose = torch.tensor([0.02, -0.01, 0.01])
    kw = {}
    target = cg
    if case == "stack_rows":
        pose = pose.expand(2, 3).contiguous()
        target = stack_grids([cg, cg])
        kw["grid_index"] = torch.tensor([1, 0], dtype=torch.int32)
    elif case == "ndt_grid":
        target = grid
    elif case == "axis":
        kw["axis"] = _OneRank()
    res = solve.align(pose, xy, src.mask, target, d1, d2, **kw)
    assert calls == ([pose.reshape(-1, 3).shape[0]] if kernel else [])
    assert solve.stepwise_cuda_calls() == (0 if kernel else 1)
    assert res.pose_rad.shape == pose.shape
    solve.reset_stepwise_count()
    assert solve.stepwise_cuda_calls() == 0


def test_counts_start_at_zero_and_reset():
    assert set(kernels.launch_counts()) == {"sgh", "score_many", "nn",
                                            "newton", "fuse"}
    assert kernels.WRAPPERS["newton"] == (kernels.ndt_newton,)
    kernels.ndt_newton.launches = 3
    solve._stepwise_cuda = 2
    assert kernels.launch_counts()["newton"] == 3
    assert kernels.wrapper_launch_counts()["ndt_newton"] == 3
    kernels.reset_launch_counts()
    solve.reset_stepwise_count()
    assert kernels.launch_counts() == {"sgh": 0, "score_many": 0, "nn": 0,
                                       "newton": 0, "fuse": 0}
    assert solve.stepwise_cuda_calls() == 0


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def office(cuda):
    """office_loop frame 40 against its real target, as the front end
    registers it: the voxel-filtered source, the predicted pose, the
    192 x 192 window and its 2048-cell table."""
    from ndt_slam_tpu_torch.core import pose2
    from ndt_slam_tpu_torch.io.carmen import read_carmen_log
    from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
    from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd
    from ndt_slam_tpu_torch.pre.resample import resample_points_np

    cfg = SlamConfig()
    frames = read_carmen_log(LOG, max_frames=41)
    fe = FrontEnd(cfg, cuda)
    for fr in frames[:40]:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
    fr = frames[40]
    rs = resample_points_np(fr.scan_xy, cfg.resample_space,
                            cfg.resample_space_thre)
    odo = torch.tensor(fr.odo_pose, device=cuda)
    prev = torch.tensor(fe.prev_odo, device=cuda)
    pred = pose2.cal_pred_pose(pose2.cal_motion(odo, prev),
                               fe._last_pose_dev)
    tgt = fe.pcmap.registration_target()
    grid = build_grid(tgt.xy, tgt.mask, pred[:2], cfg.grid_cells_x,
                      cfg.grid_cells_y, cfg.ndt_resolution,
                      min_pts=cfg.ndt_min_points_per_cell)
    src = voxel_filter(pad_points(rs, cfg.max_scan_points, cuda),
                       cfg.source_leaf_size)
    d1, d2 = gauss_constants(cfg.ndt_resolution, cfg.ndt_outlier_ratio)
    return dict(cfg=cfg, src=src, grid=grid, tgt=tgt, pred=pred,
                cg=compact_grid(grid, cfg.ndt_max_active_cells),
                pose=pose2.pose_deg_to_rad(pred), d1=d1, d2=d2)


def _kw(cfg, **over):
    kw = dict(max_iterations=cfg.ndt_max_iterations,
              step_size=cfg.ndt_step_size, trans_eps=cfg.ndt_trans_eps,
              radius=cfg.ndt_neighborhood)
    kw.update(over)
    return kw


def _cpu(x):
    """A tensor, a grid or None on the CPU."""
    if x is None or torch.is_tensor(x):
        return None if x is None else x.cpu()
    return type(x)(*(_cpu(f) if f is None or torch.is_tensor(f) else f
                     for f in x))


def _both(pose, src_xy, src_mask, grid, d1, d2, grid_index=None, **kw):
    """(kernel, stepwise, kernel in rows, CPU twin in rows, twins at the
    kernel's pose) of one solve: the kernel and the stepwise loop on the
    same CUDA inputs (the kernel's launch and the stepwise count
    checked); the kernel and the stepwise loop on CPU copies, both with
    rows (one pose as a row of a one-grid stack), where CPU and CUDA
    torch round the 3x3 solve alike (one pose's matrix-vector product
    sums in another order on each); the twins' (E, grad, Hessian,
    matched) at the kernel's final pose."""
    before = kernels.wrapper_launch_counts()
    solve.reset_stepwise_count()
    got = solve.align(pose, src_xy, src_mask, grid, d1, d2,
                      grid_index=grid_index, **kw)
    after = kernels.wrapper_launch_counts()
    assert after["ndt_newton"] == before["ndt_newton"] + 1
    assert all(after[k] == before[k] for k in after if k != "ndt_newton")
    assert solve.stepwise_cuda_calls() == 0
    args = (kw["max_iterations"], kw["step_size"], kw["trans_eps"],
            kw["radius"])
    want = solve._align_stepwise(pose, src_xy, src_mask, grid, d1, d2,
                                 *args, grid_index, None)
    at = got.pose_rad.cpu()
    xy_c, mask_c, grid_c = _cpu(src_xy), _cpu(src_mask), _cpu(grid)
    if grid_index is None:
        at_pose = kernels.ndt_score_grad_hess(at, xy_c, mask_c, grid_c, d1,
                                              d2, kw["radius"])
        grid, pose = stack_grids([grid]), pose[None]
        grid_index = torch.zeros(1, dtype=torch.int32, device=pose.device)
        rows = solve.align(pose, src_xy, src_mask, grid, d1, d2,
                           grid_index=grid_index, **kw)
    else:
        at_pose = kernels.ndt_score_grad_hess_grids(
            at, _cpu(grid_index), xy_c, mask_c, grid_c, d1, d2, kw["radius"])
        rows = got
    twin = solve._align_stepwise(_cpu(pose), xy_c, mask_c, _cpu(grid), d1,
                                 d2, *args, _cpu(grid_index), None)
    return got, want, rows, twin, at_pose


def _bits_equal(x, y):
    x, y = x.float(), y.float()
    return bool(((x.view(torch.int32) == y.view(torch.int32))
                 | (torch.isnan(x) & torch.isnan(y))).all())


def _check(got, want, rows, twin, at_pose):
    """Every field of the kernel's result bit for bit the stepwise
    loop's on the same CUDA inputs; in rows, against the CPU twin's
    solve, iterations, converged and matched equal and the pose within
    1e-4 m / 1e-4 rad; E, the Hessian and matched at the kernel's pose
    within the kernel bars of the twins' at that pose."""
    differ = {f: float((getattr(got, f).float() - getattr(want, f).float())
                       .abs().nan_to_num().max())
              for f in FIELDS
              if not _bits_equal(getattr(got, f), getattr(want, f))}
    E, _, H, m = at_pose
    dp = (rows.pose_rad.cpu() - twin.pose_rad).abs().nan_to_num()
    dE = ((got.objective.cpu() - E).abs() / E.abs().clamp(min=1e-30))
    print(f"[newton] iterations {got.iterations.tolist()}; not bit for bit: "
          f"{differ}; from the CPU twin: pose {float(dp.max()):.3g}, E at "
          f"the kernel's pose {float(dE.nan_to_num().max()):.3g} relative")
    assert differ == {}, differ
    for f in ("iterations", "converged"):
        assert torch.equal(getattr(rows, f).cpu(), getattr(twin, f)), f
    assert _bits_equal(rows.matched.cpu(), twin.matched)
    torch.testing.assert_close(rows.pose_rad.cpu(), twin.pose_rad, rtol=0,
                               atol=1e-4, equal_nan=True)
    assert _bits_equal(got.matched.cpu(), m)
    # E within rtol 1e-5, with a floor of 1e-7 that binds only where E
    # lies within 0.01 of zero: every point deep in its cell's Gaussian
    # tail (the edge rows' last row, 36 cm off, E = -0.00275), where a
    # term's float32 error is its exponent times eps. There (H100) the
    # kernel lies 8.9e-6 of E from the score in float64 and the CPU twin
    # 1.8e-5, 2.7e-5 from each other (7.3e-8)
    np.testing.assert_allclose(got.objective.cpu().numpy(), E.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.hessian.cpu().numpy(), H.numpy(),
                               rtol=1e-3, atol=0.05)


@pytest.mark.parametrize("table", ["main_path", "overflowed"])
@pytest.mark.parametrize("start", ["predicted", "pushed"])
def test_one_pose_office_frame(office, table, start):
    """From the predicted pose (one iteration), and pushed 15 cm and 1
    degree off it (several)."""
    cfg, src, d1, d2 = office["cfg"], office["src"], office["d1"], office["d2"]
    cg = office["cg"]
    if table == "overflowed":
        cg = compact_grid(office["grid"], int(cg.valid.sum()) // 2)
    pose = office["pose"]
    if start == "pushed":
        pose = pose + torch.tensor([0.12, -0.09, 0.0175], device=pose.device)
    got, want, *twin = _both(pose, src.xy, src.mask, cg, d1, d2, **_kw(cfg))
    assert bool(want.converged)
    assert float(want.matched) > (100 if table == "main_path" else 20)
    if start == "pushed":
        assert int(want.iterations) > 2
    _check(got, want, *twin)


def test_one_pose_larger_window(office):
    """A 288 x 288 window, half as wide again as the production one."""
    cfg, src, d1, d2 = office["cfg"], office["src"], office["d1"], office["d2"]
    tgt = office["tgt"]
    grid = build_grid(tgt.xy, tgt.mask, office["pred"][:2], 288, 288,
                      cfg.ndt_resolution, min_pts=cfg.ndt_min_points_per_cell)
    cg = compact_grid(grid, cfg.ndt_max_active_cells)
    got, want, *twin = _both(office["pose"], src.xy, src.mask, cg, d1, d2,
                            **_kw(cfg))
    assert bool(want.converged)
    _check(got, want, *twin)


def test_rows_on_a_grid_stack(office):
    """The coarse ladder stage's shape: 4 candidate grids at 4 x the
    resolution (48 x 48), 5 starts each, one shared source."""
    cfg, src, tgt = office["cfg"], office["src"], office["tgt"]
    mult = cfg.loop_stage_mults[0]
    res = cfg.ndt_resolution * mult
    centers = office["pred"][:2] + torch.tensor(
        [[0.0, 0.0], [0.8, -0.3], [-0.5, 0.6], [0.2, 0.9]],
        device=src.xy.device)
    gs = stack_grids([compact_grid(build_grid(
        tgt.xy, tgt.mask, c, cfg.grid_cells_x // mult,
        cfg.grid_cells_y // mult, res, min_pts=cfg.ndt_min_points_per_cell),
        cfg.ndt_max_active_cells) for c in centers])
    d1, d2 = gauss_constants(res, cfg.ndt_outlier_ratio)
    h = 0.5 * res
    offs = torch.tensor([[0, 0, 0], [h, 0, 0], [-h, 0, 0], [0, h, 0],
                         [0, -h, 0]], dtype=torch.float32,
                        device=src.xy.device)
    starts = (office["pose"][None, None, :] + offs[None]).expand(
        4, 5, 3).reshape(20, 3).contiguous()
    index = torch.arange(4, dtype=torch.int32,
                         device=src.xy.device).repeat_interleave(5)
    got, want, *twin = _both(starts, src.xy, src.mask, gs, d1, d2, index,
                            **_kw(cfg, step_size=cfg.ndt_step_size * mult,
                                  trans_eps=cfg.ndt_trans_eps * 2))
    assert bool(want.converged.any())
    _check(got, want, *twin)


def test_edge_rows(office):
    """One launch of four rows: an empty source row, a pose that
    matches nothing, a NaN start, a row that runs every iteration."""
    cfg, src, cg = office["cfg"], office["src"], office["cg"]
    d1, d2 = office["d1"], office["d2"]
    gs = stack_grids([cg, cg])
    xy = torch.stack([src.xy, src.xy]).contiguous()
    mask = torch.stack([torch.zeros_like(src.mask), src.mask]).contiguous()
    p = office["pose"]
    poses = torch.stack([
        p,                                                  # empty source
        p + torch.tensor([500.0, -400.0, 0.0], device=p.device),  # nothing
        torch.full_like(p, float("nan")),                   # NaN start
        p + torch.tensor([0.3, -0.2, 0.02], device=p.device),  # every step
    ]).contiguous()
    index = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device=p.device)
    # steps of at most 1 mm from 36 cm off: each one improves
    got, want, *twin = _both(poses, xy, mask, gs, d1, d2, index,
                            **_kw(cfg, max_iterations=8, step_size=1e-3,
                                  trans_eps=0.0))
    assert want.converged.tolist() == [False, False, False, True]
    assert float(want.matched[0]) == 0.0 and float(want.matched[1]) == 0.0
    assert bool(torch.isnan(want.pose_rad[2]).all())
    assert want.iterations.tolist() == [1, 1, 1, 8]
    _check(got, want, *twin)


def test_full_load(cuda):
    """2048 live source points in a 192 x 192 window at 0.3 m."""
    rng = np.random.default_rng(5)
    tgt_np, src_np = _walls(rng, (131072, 2048), segs=60, half=20.0)
    tgt = pad_points(tgt_np, 131072, cuda)
    src = pad_points(src_np + [0.05, -0.03], 2048, cuda)
    assert int(src.mask.sum()) == 2048
    cfg = SlamConfig()
    grid = build_grid(tgt.xy, tgt.mask, torch.zeros(2, device=cuda), 192,
                      192, 0.3, min_pts=6)
    cg = compact_grid(grid, 2048)
    d1, d2 = gauss_constants(0.3, 0.55)
    poses = torch.tensor([[0.0, 0.0, 0.0], [0.03, -0.02, 0.01]],
                         device=cuda)
    got, want, *twin = _both(poses, src.xy, src.mask, stack_grids([cg]), d1,
                            d2, torch.zeros(2, dtype=torch.int32, device=cuda),
                            **_kw(cfg))
    assert bool(want.converged.all()) and float(want.matched.min()) > 2048
    _check(got, want, *twin)
