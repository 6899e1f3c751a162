"""The port's loop-closure back end (ndt_slam_tpu_torch.graph.backend)
on the CPU, against the JAX package's GraphBackend where the two share
inputs.

- `correction_due` against what `try_close` does, over the 60 cases of
  tests/unit/test_backend.py:57-78 (pending edges x last correction x
  graph size), and edges in async flight not counted;
- `add_frame`: node poses, odometry edges and their information, the
  keyframes and the drift accumulator equal to JAX's on the same frames;
- `_resolve_verify`: the loop-edge information from the Hessian's
  spectrum, on fixed packed rows (one rejected, one corridor-degenerate,
  one isotropic, one whose keyframe is unknown), equal to JAX's;
- `optimize_all` on both branches, dense and hierarchical, against
  JAX's on the same graph: poses within 1e-4 m / 1e-4 rad;
- `feed_prefetched`: the rows are taken once, and only for the
  verification they were fetched for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.graph.backend import GraphBackend as JGraphBackend

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.graph.backend import GraphBackend

torch.set_num_threads(2)
CPU = torch.device("cpu")
SCAN = np.stack([np.linspace(0.0, 1.0, 32),
                 np.zeros(32, np.float32)], axis=1).astype(np.float32)


def _kw(**kw):
    base = dict(loop_enable=True, loop_opt_min_frames=5, loop_check_skip=2,
                loop_min_frame_gap=10 ** 6, pgo_iterations=2)
    base.update(kw)
    return base


def _backend_with(cfg, n_nodes, pending, last_opt_node):
    be = GraphBackend(cfg, CPU)
    scan = pad_points(SCAN, cfg.max_scan_points, CPU)
    cov = np.eye(3, dtype=np.float32) * 1e-4
    for i in range(n_nodes):
        be.add_frame(i, np.array([0.1 * i, 0.0, 0.0], np.float32), cov, scan)
    if pending:
        be.loop_edges.append((0, n_nodes - 1, np.zeros(3, np.float32),
                              np.eye(3, dtype=np.float32)))
        be._pending_edges = pending
    be._last_opt_node = last_opt_node
    return be, scan


@pytest.mark.parametrize("pending", [0, 1, 3])
@pytest.mark.parametrize("last_opt_node", [-(10 ** 9), 0, 4, 7, 11])
@pytest.mark.parametrize("n_nodes", [6, 9, 12, 13])
def test_correction_due_matches_try_close(pending, last_opt_node, n_nodes):
    cfg = SlamConfig.small(**_kw())
    be, scan = _backend_with(cfg, n_nodes, pending, last_opt_node)
    node = n_nodes - 1
    predicted = be.correction_due(node)
    actual = False
    if node % max(1, cfg.loop_check_skip) == 0:
        out = be.try_close(node, np.array([0.1 * node, 0.0, 0.0],
                                          np.float32), scan)
        actual = out is not None
        if actual:
            assert out.shape == (n_nodes, 3) and np.isfinite(out).all()
    assert predicted == actual


def test_correction_due_ignores_inflight_verify():
    be, _ = _backend_with(SlamConfig.small(**_kw()), 12, pending=0,
                          last_opt_node=-(10 ** 9))
    assert not be.correction_due(11)


def _frames(n=100, seed=0):
    """Fused poses along a noisy circle and growing covariances."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    poses = np.stack([8 * np.sin(th), 8 * (1 - np.cos(th)),
                      np.degrees(th) + 90.0], 1)
    poses[:, :2] += rng.normal(0, 0.05, (n, 2)) * np.arange(n)[:, None] / n
    poses[:, 2] = (poses[:, 2] + 180.0) % 360.0 - 180.0
    covs = []
    for k in range(n):
        a = rng.normal(0, 0.02, (3, 3))
        covs.append((a @ a.T + np.diag([1e-3, 2e-3, 0.5])).astype(np.float32))
    return poses.astype(np.float32), covs


def _both(n=100, **kw):
    cfg = SlamConfig.small(**_kw(loop_keyframe_skip=3, **kw))
    jcfg = JSlamConfig.small(**_kw(loop_keyframe_skip=3, **kw))
    be, jbe = GraphBackend(cfg, CPU), JGraphBackend(jcfg)
    scan = pad_points(SCAN, cfg.max_scan_points, CPU)
    jscan = j_pad(SCAN, jcfg.max_scan_points)
    poses, covs = _frames(n)
    for k in range(n):
        assert be.add_frame(k, poses[k], covs[k], scan) == \
            jbe.add_frame(k, poses[k], covs[k], jscan)
    return be, jbe


def test_add_frame_matches_jax():
    be, jbe = _both()
    np.testing.assert_array_equal(np.stack(be.node_poses_rad),
                                  np.stack(jbe.node_poses_rad))
    assert be.node_sids == jbe.node_sids
    assert len(be.odom_edges) == len(jbe.odom_edges) == 99
    for (z, w), (jz, jw) in zip(be.odom_edges, jbe.odom_edges):
        np.testing.assert_allclose(z, jz, atol=1e-6)
        np.testing.assert_allclose(w, jw, rtol=1e-6)
    assert be.keyframes.sids == jbe.keyframes.sids == list(range(0, 100, 3))
    np.testing.assert_allclose(be.keyframes.pos_var, jbe.keyframes.pos_var,
                               rtol=1e-12)
    assert be._cum_pos_var == pytest.approx(jbe._cum_pos_var, rel=1e-12)


def _rows(b):
    """Packed verify rows: rel(3) cost overlap overlap_tgt accepted H(9)."""
    rows = np.zeros((b, 16), np.float32)
    corridor = np.diag([4e5, 3.0, 9e5]).astype(np.float32)
    iso = np.array([[5e5, 1e4, 2e3], [1e4, 6e5, -3e3], [2e3, -3e3, 8e5]],
                   np.float32)
    for r, (rel, cost, acc, H) in enumerate([
            ((0.4, -0.2, 0.05), 2e-3, 1.0, corridor),
            ((1.0, 0.3, -0.1), 5e-4, 1.0, iso),
            ((0.1, 0.1, 0.0), 1e-3, 0.0, iso),
            ((0.2, 0.0, 0.01), 1e-3, 1.0, iso)]):
        rows[r, :3] = rel
        rows[r, 3:7] = (cost, 0.9, 0.8, acc)
        rows[r, 7:] = H.reshape(-1)
    return rows


def test_resolve_verify_information_matches_jax():
    be, jbe = _both()
    rows = _rows(be.cfg.loop_max_candidates)
    # candidates: keyframes 0, 3, 6 and a sid that is no node
    cand = [0, 3, 6, 10_000]
    be._inflight = (99, cand, torch.from_numpy(rows),
                    torch.from_numpy(rows), None)
    jbe._inflight = (99, cand, jnp.asarray(rows))
    be._resolve_verify()
    jbe._resolve_verify()
    assert be.loops_accepted == jbe.loops_accepted == 2
    assert be._pending_edges == jbe._pending_edges == 2
    for (i, j, z, w), (ji, jj, jz, jw) in zip(be.loop_edges,
                                              jbe.loop_edges):
        assert (i, j) == (ji, jj)
        np.testing.assert_array_equal(z, jz)
        np.testing.assert_allclose(w, jw, rtol=1e-6, atol=1e-6 * abs(jw).max())
    # the corridor's weak direction keeps almost no weight
    w = np.linalg.eigvalsh(be.loop_edges[0][3])
    assert w[0] < 1e-4 * w[-1]
    assert [e["sid_old"] for e in be.edge_log] == [0, 3]


@pytest.mark.parametrize("dense", [True, False])
def test_optimize_all_matches_jax(dense):
    kw = dict(pgo_iterations=10) if dense else dict(
        pgo_iterations=10, pgo_dense_max_nodes=40, pgo_seg_len=16)
    be, jbe = _both(**kw)
    poses, _ = _frames()
    # two loop edges pulling the end of the circle onto its start
    for a, b in ((0, 99), (3, 96)):
        z = np.array([0.0, -0.1 * (b - a) / 99, 0.0], np.float32)
        om = np.eye(3, dtype=np.float32) * 400.0
        be.loop_edges.append((a, b, z, om))
        jbe.loop_edges.append((a, b, z, om))
    got, want = be.optimize_all(), jbe.optimize_all()
    assert got.shape == want.shape == (100, 3)
    dxy = float(np.abs(got[:, :2] - want[:, :2]).max())
    dth = float(np.abs((got[:, 2] - want[:, 2] + 180) % 360 - 180).max())
    print(f"optimize_all, {'dense' if dense else 'hierarchical'}: "
          f"{dxy:.3g} m, {dth:.3g} deg from JAX")
    assert dxy <= 1e-4 and dth <= np.degrees(1e-4)
    assert float(np.abs(got - poses).max()) > 1e-3      # the loop moved it
    np.testing.assert_array_equal(np.stack(be.keyframes.poses_deg),
                                  got[::3])


def test_feed_prefetched_consumed_once_and_identity_checked():
    be = GraphBackend(SlamConfig.small(**_kw()), CPU)
    b = be.cfg.loop_max_candidates
    packed = torch.zeros((b, 16))
    be._inflight = (0, [], packed, packed, None)
    assert be.inflight_packed() is packed
    be.feed_prefetched(np.zeros((b, 16), np.float32))
    assert be._prefetched is not None
    be._resolve_verify()
    assert be._prefetched is None and be._inflight is None
    assert be.inflight_packed() is None
    # rows prefetched for an older dispatch are not taken for a newer one
    be._inflight = (0, [], packed, packed, None)
    be.feed_prefetched(np.ones((b, 16), np.float32))
    other = torch.zeros((b, 16))
    be._inflight = (1, [], other, other, None)
    be._resolve_verify()
    assert be._prefetched is None and be._inflight is None
    assert be.loops_accepted == 0
