"""The port's pose graph (ndt_slam_tpu_torch.graph.pose_graph) against
the JAX package's on the CPU, on the scenes of
tests/unit/test_pose_graph.py.

- `edge_residual` to 1e-6, batched over edges;
- `optimize` on the drifted 40-node ring (one strong loop edge) and on
  the same ring with garbage in a masked edge slot: poses within 1e-4
  m / rad of JAX's, chi2 to rtol 1e-4, the ring's own claims (drift
  halved, node 0 held), and the masked slot changing nothing;
- `optimize_pcg` (block-Jacobi and segment preconditioner) against
  dense, as the reference test holds it, and against JAX's PCG;
- `optimize_hierarchical` on a 600-node ring, seg_len 32, against JAX;
- the step ladder from a large-residual start: the 512-node sweep with
  strong inter-row loops (the reference's `_sweep_fixture`), through
  the hierarchical solver, drift more than halved in both packages;
- the deterministic scatter: the same solve twice gives the same bits;
- the 4096-node sweep through both packages' hierarchical solvers (the
  reference's own bound, under 1 m from the truth), marked `slow`: the
  two solves take some 20 s on two cores, most of this file's budget.

Each JAX function compiles once per shape here (module fixture). The
gaps measured on this machine are printed (pytest -s).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.graph.pose_graph import (
    PoseGraph as JPoseGraph, edge_residual as j_edge_residual,
    optimize as j_optimize, optimize_hierarchical as j_hier,
    optimize_pcg as j_optimize_pcg,
)

from ndt_slam_tpu_torch.graph.pose_graph import (
    edge_residual, graph_from_numpy, optimize, optimize_hierarchical,
    optimize_pcg,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _se2_compose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1],
                     a[1] + s * b[0] + c * b[1], a[2] + b[2]])


def _se2_between(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy, b[2] - a[2]])


def _ring_arrays(n_nodes=40, drift=0.02, seed=0, max_nodes=64,
                 max_edges=128):
    """tests/unit/test_pose_graph.py's `_ring_graph` as host arrays:
    a circle, drifting odometry, one strong loop edge last -> first."""
    rng = np.random.default_rng(seed)
    dth = 2 * np.pi / n_nodes
    true = np.zeros((n_nodes, 3))
    for k in range(1, n_nodes):
        th = k * dth
        true[k] = [5.0 * np.sin(th), 5.0 * (1 - np.cos(th)), th]
    est = np.zeros((n_nodes, 3))
    edges = []
    for k in range(1, n_nodes):
        z = _se2_between(true[k - 1], true[k])
        est[k] = _se2_compose(est[k - 1],
                              z + rng.normal(0, drift, 3) * [1, 1, 0.5])
        edges.append((k - 1, k, z + rng.normal(0, drift * 0.2, 3), 1e2))
    edges.append((n_nodes - 1, 0, _se2_between(true[-1], true[0]), 1e4))
    a = dict(poses=np.zeros((max_nodes, 3), np.float32),
             node_mask=np.zeros(max_nodes, bool),
             idx_i=np.zeros(max_edges, np.int32),
             idx_j=np.zeros(max_edges, np.int32),
             z=np.zeros((max_edges, 3), np.float32),
             omega=np.zeros((max_edges, 3, 3), np.float32),
             edge_mask=np.zeros(max_edges, bool))
    a["poses"][:n_nodes] = est
    a["node_mask"][:n_nodes] = True
    for e, (i, j, z, w) in enumerate(edges):
        a["idx_i"][e], a["idx_j"][e], a["z"][e] = i, j, z
        a["omega"][e] = np.eye(3) * w
        a["edge_mask"][e] = True
    return a, true, est


def _masked_garbage(a):
    b = {k: v.copy() for k, v in a.items()}
    b["z"][100] = [50.0, -3.0, 2.0]
    b["omega"][100] = np.eye(3) * 1e6
    return b


def _jgraph(a):
    return JPoseGraph(
        poses_rad=jnp.asarray(a["poses"]), node_mask=jnp.asarray(a["node_mask"]),
        idx_i=jnp.asarray(a["idx_i"]), idx_j=jnp.asarray(a["idx_j"]),
        z_rad=jnp.asarray(a["z"]), omega=jnp.asarray(a["omega"]),
        edge_mask=jnp.asarray(a["edge_mask"]))


def _tgraph(a):
    return graph_from_numpy(a["poses"], a["node_mask"], a["idx_i"],
                            a["idx_j"], a["z"], a["omega"], a["edge_mask"],
                            CPU)


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def _sweep_fixture(n=4096, row_len=256, loop_stride=8, noise=0.005, seed=1):
    """tests/unit/test_pose_graph.py's boustrophedon sweep: odometry with
    drift plus inter-row loop closures."""
    rng = np.random.default_rng(seed)
    pts = []
    for r in range(n // row_len):
        xs = np.arange(row_len) * 0.5
        if r % 2:
            xs = xs[::-1]
        pts += [[x, r * 2.0] for x in xs]
    pts = np.array(pts, np.float32)
    head = np.zeros(n, np.float32)
    head[:-1] = np.arctan2(np.diff(pts[:, 1]), np.diff(pts[:, 0]))
    head[-1] = head[-2]
    gt = np.concatenate([pts, head[:, None]], 1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         _wrap(b[2] - a[2])], np.float32)

    chain_z = np.stack([rel(gt[i], gt[i + 1])
                        + rng.normal(0, noise, 3).astype(np.float32)
                        for i in range(n - 1)])
    chain_om = np.tile(np.eye(3, dtype=np.float32)[None] * 400, (n - 1, 1, 1))
    li, lj, lz = [], [], []
    for r in range(n // row_len - 1):
        for c in range(0, row_len, loop_stride):
            i = r * row_len + c
            j = (r + 1) * row_len + (row_len - 1 - c if r % 2 == 0 else c)
            li.append(i)
            lj.append(j)
            lz.append(rel(gt[i], gt[j]))
    li, lj, lz = np.array(li, np.int32), np.array(lj, np.int32), np.stack(lz)
    lom = np.tile(np.eye(3, dtype=np.float32)[None] * 400, (len(li), 1, 1))
    init = np.zeros_like(gt)
    init[0] = gt[0]
    for i in range(n - 1):
        z = chain_z[i]
        c, s = np.cos(init[i, 2]), np.sin(init[i, 2])
        init[i + 1] = [init[i, 0] + c * z[0] - s * z[1],
                       init[i, 1] + s * z[0] + c * z[1], init[i, 2] + z[2]]
    return gt, init, chain_z, chain_om, li, lj, lz, lom


def _big_ring(n=600, seed=4):
    """A drifted ring of n nodes (the chain, a loop edge every 50 nodes
    to the node across the ring, and the closing edge), as chain + loop
    arrays for the hierarchical solver."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([20 * np.sin(th), 20 * (1 - np.cos(th)),
                   _wrap(th)], 1).astype(np.float32)
    chain_z = np.stack([_se2_between(gt[k], gt[k + 1]) for k in range(n - 1)])
    chain_z = (chain_z + rng.normal(0, 0.01, chain_z.shape)
               * [1, 1, 0.3]).astype(np.float32)
    chain_om = np.tile(np.eye(3, dtype=np.float32)[None] * 100,
                       (n - 1, 1, 1))
    li = np.array([k for k in range(50, n, 50)] + [n - 1], np.int32)
    lj = np.array([(k + n // 2) % n for k in range(50, n, 50)] + [0],
                  np.int32)
    lz = np.stack([_se2_between(gt[i], gt[j]) for i, j in zip(li, lj)])
    lz[:, 2] = _wrap(lz[:, 2])
    lom = np.tile(np.eye(3, dtype=np.float32)[None] * 1e3, (len(li), 1, 1))
    init = np.zeros_like(gt)
    init[0] = gt[0]
    for k in range(n - 1):
        init[k + 1] = _se2_compose(init[k], chain_z[k])
    return gt, init, chain_z, chain_om, li, lj, lz.astype(np.float32), lom


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX solve of this file, one compile per shape."""
    ring, true, est = _ring_arrays()
    garbage = _masked_garbage(ring)
    out = {"ring": ring, "true": true, "est": est, "garbage": garbage}
    for name, a in (("ring", ring), ("garbage", garbage)):
        p, c = j_optimize(_jgraph(a), iterations=15)
        out[f"dense_{name}"] = (np.asarray(p), float(c))
    for seg in (0, 8):
        p, c = j_optimize_pcg(_jgraph(ring), iterations=15, cg_iters=512,
                              cg_tol=1e-8, precond_seg_len=seg)
        out[f"pcg_{seg}"] = (np.asarray(p), float(c))
    out["big"] = _big_ring()
    out["hier_big"] = j_hier(*out["big"][1:], seg_len=32)
    out["sweep"] = _sweep_fixture(n=512, row_len=128, loop_stride=4)
    out["hier_sweep"] = j_hier(*out["sweep"][1:], seg_len=32, cycles=2)
    return out


def _gap(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.abs(d[..., :2]).max()), float(np.abs(_wrap(d[..., 2])).max())


def test_edge_residual_matches_jax():
    rng = np.random.default_rng(0)
    pi = rng.normal(0, 3, (64, 3)).astype(np.float32)
    pj = rng.normal(0, 3, (64, 3)).astype(np.float32)
    z = rng.normal(0, 1, (64, 3)).astype(np.float32)
    want = np.stack([np.asarray(j_edge_residual(*map(jnp.asarray, t)))
                     for t in zip(pi, pj, z)])
    got = edge_residual(*map(torch.from_numpy, (pi, pj, z))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # and zero at the truth
    a = np.array([1.0, 2.0, 0.3], np.float32)
    b = np.array([2.5, 2.2, 0.9], np.float32)
    r = edge_residual(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(_se2_between(a, b).astype(np.float32)))
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("scene", ["ring", "garbage"])
def test_optimize_matches_jax(jax_runs, scene):
    n = len(jax_runs["true"])
    poses, chi2 = optimize(_tgraph(jax_runs[scene]), iterations=15)
    jp, jc = jax_runs[f"dense_{scene}"]
    dxy, dth = _gap(poses.numpy(), jp)
    print(f"optimize, {scene}: {dxy:.3g} m, {dth:.3g} rad, chi2 "
          f"{float(chi2):.6g} vs {jc:.6g}")
    assert dxy <= 1e-4 and dth <= 1e-4
    np.testing.assert_allclose(float(chi2), jc, rtol=1e-4)
    out, true, est = poses.numpy()[:n], jax_runs["true"], jax_runs["est"]
    before = np.linalg.norm(est[:, :2] - true[:, :2], axis=1).max()
    after = np.linalg.norm(out[:, :2] - true[:, :2], axis=1).max()
    assert after < 0.5 * before
    np.testing.assert_allclose(out[0], est[0], atol=1e-4)


def test_masked_slots_change_nothing(jax_runs):
    a, _ = optimize(_tgraph(jax_runs["ring"]), iterations=15)
    b, _ = optimize(_tgraph(jax_runs["garbage"]), iterations=15)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_optimize_repeats_bit_for_bit(jax_runs):
    g = _tgraph(jax_runs["ring"])
    a, ca = optimize(g, iterations=4)
    b, cb = optimize(g, iterations=4)
    assert torch.equal(a, b) and torch.equal(ca, cb)


@pytest.mark.parametrize("seg", [0, 8])
def test_pcg_matches_dense_and_jax(jax_runs, seg):
    n = len(jax_runs["true"])
    g = _tgraph(jax_runs["ring"])
    pd, cd = optimize(g, iterations=15)
    pp, cp = optimize_pcg(g, iterations=15, cg_iters=512, cg_tol=1e-8,
                          precond_seg_len=seg)
    assert float(cp) <= float(cd) * 1.2 + 1e-3
    true = jax_runs["true"]
    err_d = np.linalg.norm(pd.numpy()[:n, :2] - true[:, :2], axis=1).max()
    err_p = np.linalg.norm(pp.numpy()[:n, :2] - true[:, :2], axis=1).max()
    assert err_p <= err_d * 1.5 + 1e-3
    np.testing.assert_allclose(pp.numpy()[0], jax_runs["est"][0], atol=1e-4)
    jp, jc = jax_runs[f"pcg_{seg}"]
    dxy, dth = _gap(pp.numpy(), jp)
    print(f"optimize_pcg seg {seg}: {dxy:.3g} m, {dth:.3g} rad from JAX; "
          f"chi2 {float(cp):.6g} vs {jc:.6g}")
    assert dxy <= 1e-3 and dth <= 1e-3
    np.testing.assert_allclose(float(cp), jc, rtol=1e-3)


def test_hierarchical_ring_matches_jax(jax_runs):
    gt, init, *edges = jax_runs["big"]
    out = optimize_hierarchical(init, *edges, seg_len=32, device=CPU)
    want = jax_runs["hier_big"]
    dxy, dth = _gap(out, want)
    drift = np.linalg.norm(init[:, :2] - gt[:, :2], axis=1).max()
    err = np.linalg.norm(out[:, :2] - gt[:, :2], axis=1).max()
    jerr = np.linalg.norm(want[:, :2] - gt[:, :2], axis=1).max()
    print(f"hierarchical, 600-node ring: drift {drift:.3g} m, port "
          f"{err:.3g} m, JAX {jerr:.3g} m, apart {dxy:.3g} m {dth:.3g} rad")
    assert out.shape == init.shape and np.isfinite(out).all()
    assert err < 0.5 * drift and err <= jerr + 0.01
    assert dxy <= 0.01 and dth <= 1e-3
    np.testing.assert_allclose(out[0], init[0], atol=1e-3)


def test_step_ladder_survives_large_residual_init(jax_runs):
    gt, init, *edges = jax_runs["sweep"]
    drift = np.linalg.norm(init[:, :2] - gt[:, :2], axis=1).max()
    out = optimize_hierarchical(init, *edges, seg_len=32, cycles=2,
                                device=CPU)
    err = np.linalg.norm(out[:, :2] - gt[:, :2], axis=1).max()
    want = jax_runs["hier_sweep"]
    jerr = np.linalg.norm(want[:, :2] - gt[:, :2], axis=1).max()
    dxy, dth = _gap(out, want)
    print(f"step ladder, 512-node sweep: drift {drift:.3g} m, port "
          f"{err:.3g} m, JAX {jerr:.3g} m, apart {dxy:.3g} m {dth:.3g} rad")
    assert err < 0.5 * drift
    assert err <= 1.5 * jerr + 0.05


@pytest.mark.slow
def test_hierarchical_4096_nodes_matches_jax():
    gt, init, *edges = _sweep_fixture()
    drift = np.linalg.norm(init[:, :2] - gt[:, :2], axis=1).max()
    assert drift > 20.0
    out = optimize_hierarchical(init, *edges, device=CPU)
    want = j_hier(init, *edges)
    err = np.linalg.norm(out[:, :2] - gt[:, :2], axis=1).max()
    dxy, dth = _gap(out, want)
    print(f"hierarchical, 4096-node sweep: port {err:.3g} m from the truth, "
          f"{dxy:.3g} m, {dth:.3g} rad from JAX")
    assert err < 1.0 and dxy <= 0.01 and dth <= 1e-3
    np.testing.assert_allclose(out[0], init[0], atol=1e-3)
