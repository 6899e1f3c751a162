"""The gather engine over rows (`ndt_slam_tpu_torch.ndt.score` on a
stacked `NDTGrid`, `ndt_engine = "gather"`) against the JAX package's
`vmap`s, on the CPU.

Three room scenes give three dense windows, built by JAX and carried
over, stacked as the port's `build_grid` stacks B windows. Held:
- P poses against their windows (`grid_index`), with one source for all
  rows and with a source per window, against JAX's `vmap` of
  `ndt_score_grad_hess` / `ndt_negative_score` over (pose, window): the
  kernel bar of ROADMAP.md (E rtol 1e-5; grad rtol 1e-4 / atol 1e-3;
  Hessian rtol 1e-3 / atol 0.05; matched exact);
- each row bit for bit equal to the call with its pose and its window
  alone; each row of `align` over rows bit for bit its one-row solve,
  and within 1e-4 of the single-pose solve;
- `build_grid` over [B,L,2] rows: each window its own build's bits.
The verifier and the lockstep tick on the gather engine:
tests/test_torch_gather_verify.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.ndt import score as j_score
from ndt_slam_tpu.ndt.grid import NDTGrid as JNDTGrid
from ndt_slam_tpu.ndt.grid import build_grid as j_build_grid

from ndt_slam_tpu_torch import convert
from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.ndt import score
from ndt_slam_tpu_torch.ndt.grid import NDTGrid, build_grid
from ndt_slam_tpu_torch.ndt.solve import align

torch.set_num_threads(2)

CPU = torch.device("cpu")
NX = NY = 64
RES = 0.3
MIN_PTS = 3
TARGETS = [((0.0, 0.0, 0.0), 0), ((0.3, -0.2, 0.05), 1),
           ((-0.25, 0.1, -0.04), 2)]
POSES = np.array([[0.08, -0.04, 0.03], [0.0, 0.0, 0.0],
                  [-0.2, 0.15, -0.1], [0.3, -0.2, 0.02],
                  [-0.2, 0.1, -0.05]], np.float32)
GRID_INDEX = np.array([0, 0, 1, 1, 2], np.int32)


def _room_scan(n, pose=(0.0, 0.0, 0.0), noise=0.01, seed=0):
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


def _stack(grids):
    """Port grids of one shape -> a stacked NDTGrid."""
    g0 = grids[0]
    return NDTGrid(*(torch.stack([getattr(g, f) for g in grids])
                     for f in ("origin", "mean", "inv_cov", "valid")),
                   nx=g0.nx, ny=g0.ny, resolution=g0.resolution)


@pytest.fixture(scope="module")
def scene():
    d1, d2 = score.gauss_constants(RES, 0.55)
    j_grids, grids = [], []
    for pose, seed in TARGETS:
        t = j_pad(_room_scan(720, pose=pose, seed=seed), 2048)
        g = j_build_grid(t.xy, t.mask, jnp.zeros(2, jnp.float32), NX, NY,
                         RES, min_pts=MIN_PTS)
        j_grids.append(g)
        grids.append(convert.ndt_grid(g, CPU))
    srcs = [_room_scan(360, pose=(0.1, -0.06, 0.05), seed=3 + k)
            for k in range(3)]
    j_srcs = [j_pad(s, 512) for s in srcs]
    ports = [pad_points(s, 512, CPU) for s in srcs]
    return dict(
        d1=d1, d2=d2, grids=grids, stacked=_stack(grids),
        j_stacked=JNDTGrid(*(jnp.stack([getattr(g, f) for g in j_grids])
                             for f in ("origin", "mean", "inv_cov", "valid")),
                           nx=NX, ny=NY, resolution=RES),
        src=ports[0], srcs=(torch.stack([p.xy for p in ports]),
                            torch.stack([p.mask for p in ports])),
        j_src=j_srcs[0],
        j_srcs=(jnp.stack([s.xy for s in j_srcs]),
                jnp.stack([s.mask for s in j_srcs])))


_AXES = JNDTGrid(origin=0, mean=0, inv_cov=0, valid=0, nx=None, ny=None,
                 resolution=None)


def _jax_rows(sc, per_window: bool, derivs: bool):
    """JAX's `vmap` over (pose, window[, source]) of the gather engine."""
    fn = j_score.ndt_score_grad_hess if derivs else j_score.ndt_negative_score
    g = GRID_INDEX
    st = sc["j_stacked"]
    grids = st._replace(origin=st.origin[g], mean=st.mean[g],
                        inv_cov=st.inv_cov[g], valid=st.valid[g])
    if per_window:
        xy, mask = (a[g] for a in sc["j_srcs"])
        run = jax.vmap(lambda p, s, m, gr: fn(p, s, m, gr, sc["d1"],
                                               sc["d2"], 1),
                       in_axes=(0, 0, 0, _AXES))
        return run(jnp.asarray(POSES), xy, mask, grids)
    run = jax.vmap(lambda p, gr: fn(p, sc["j_src"].xy, sc["j_src"].mask,
                                    gr, sc["d1"], sc["d2"], 1),
                   in_axes=(0, _AXES))
    return run(jnp.asarray(POSES), grids)


def _port_rows(sc, per_window: bool, derivs: bool):
    xy, mask = sc["srcs"] if per_window else (sc["src"].xy, sc["src"].mask)
    fn = score.ndt_score_grad_hess if derivs else score.ndt_negative_score
    return fn(torch.from_numpy(POSES), xy, mask, sc["stacked"], sc["d1"],
              sc["d2"], 1, torch.from_numpy(GRID_INDEX))


@pytest.mark.parametrize("per_window", [False, True])
def test_rows_match_jax_vmap(scene, per_window):
    E, g, H, m = _port_rows(scene, per_window, True)
    E0, g0, H0, m0 = (np.asarray(a) for a in
                      _jax_rows(scene, per_window, True))
    assert E.shape == (5,) and H.shape == (5, 3, 3)
    np.testing.assert_array_equal(m.numpy(), m0)
    assert (m0 > 100).all()
    np.testing.assert_allclose(E.numpy(), E0, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g0, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(H.numpy(), H0, rtol=1e-3, atol=0.05)
    s = _port_rows(scene, per_window, False)
    np.testing.assert_allclose(s.numpy(),
                               np.asarray(_jax_rows(scene, per_window, False)),
                               rtol=1e-5)


@pytest.mark.parametrize("per_window", [False, True])
def test_each_row_equals_its_one_row_call(scene, per_window):
    rows = _port_rows(scene, per_window, True)
    scores = _port_rows(scene, per_window, False)
    for r, k in enumerate(GRID_INDEX):
        if per_window:
            xy, mask = scene["srcs"][0][k], scene["srcs"][1][k]
        else:
            xy, mask = scene["src"].xy, scene["src"].mask
        one = score.ndt_score_grad_hess(torch.from_numpy(POSES[r]), xy, mask,
                                        scene["grids"][k], scene["d1"],
                                        scene["d2"], 1)
        for a, b in zip(rows, one):
            assert torch.equal(a[r], b)
        e = score.ndt_negative_score(torch.from_numpy(POSES[r]), xy, mask,
                                     scene["grids"][k], scene["d1"],
                                     scene["d2"], 1)
        assert torch.equal(scores[r], e)


def test_align_rows_equal_one_row_solves(scene):
    """`align` over rows on the stacked window: each row bit for bit its
    own one-row solve (rows do not leak, a finished row stays masked),
    and the single-pose solve on its window to 1e-4 at a tight stop
    (the 3x3 algebra of one pose and of rows differ in operation
    order), matched pairs equal."""
    kw = dict(max_iterations=60, step_size=0.1, trans_eps=1e-4, radius=1)
    src = scene["src"]
    res = align(torch.from_numpy(POSES), src.xy, src.mask, scene["stacked"],
                scene["d1"], scene["d2"],
                grid_index=torch.from_numpy(GRID_INDEX), **kw)
    assert bool(res.converged.all())
    assert len(set(res.iterations.tolist())) > 1
    for r, k in enumerate(GRID_INDEX):
        alone = align(torch.from_numpy(POSES[r:r + 1]), src.xy, src.mask,
                      _stack([scene["grids"][k]]), scene["d1"], scene["d2"],
                      grid_index=torch.zeros(1, dtype=torch.int32), **kw)
        for got, want in zip(res, alone):
            assert torch.equal(got[r:r + 1], want)
        one = align(torch.from_numpy(POSES[r]), src.xy, src.mask,
                    scene["grids"][k], scene["d1"], scene["d2"], **kw)
        assert float(res.matched[r]) == float(one.matched)
        np.testing.assert_allclose(res.pose_rad[r].numpy(),
                                   one.pose_rad.numpy(), atol=1e-4)


def test_stacked_build_is_the_windows_build():
    """`build_grid` over [B,L,2] rows gives each window's own build."""
    tg = [pad_points(_room_scan(720, pose=p, seed=s), 2048, CPU)
          for p, s in TARGETS]
    centers = torch.tensor([[0.0, 0.0], [0.4, -0.3], [-1.0, 0.5]])
    st = build_grid(torch.stack([t.xy for t in tg]),
                    torch.stack([t.mask for t in tg]), centers, NX, NY, RES,
                    min_pts=MIN_PTS)
    for k, t in enumerate(tg):
        one = build_grid(t.xy, t.mask, centers[k], NX, NY, RES,
                         min_pts=MIN_PTS)
        for f in ("origin", "mean", "inv_cov", "valid"):
            assert torch.equal(getattr(st, f)[k], getattr(one, f))
