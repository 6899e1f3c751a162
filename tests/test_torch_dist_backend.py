"""The port's sharded back end and lockstep runner on two gloo ranks of
the CPU, and the CLI's multi-rank flags.

One module fixture spawns the two ranks once (`parallel/jobs.run`):
- `make_sharded_verify` over (dp, pt) = (2, 1) on the `large_offset` and
  `half_cell_offsets` scenes of tests/test_torch_verify.py against
  `verify_candidates` on one device: `accepted` equal, every packed row
  within 1e-6 (m, rad and the gates), bitwise the same on both ranks;
- `make_sharded_optimize` on the 64-node circle of
  tests/distributed/test_sharded_pose_graph.py (in 72 edge slots, so that
  both ranks hold edges) against `optimize_pcg`
  and JAX's `make_sharded_optimize` over two of its virtual devices:
  5e-4, its own bar;
- `GraphBackend(mesh=)`: the batch capacity rounded up to the "dp" size,
  the scan cache's eviction of decimated keyframes as
  tests/unit/test_backend.py::test_host_scan_cache_evicts_decimated_sids
  holds the JAX package's;
- `run_slam_batch` with the rows sharded over two ranks against the
  unsharded run: every row bit for bit (a row does not depend on the
  others), every rank holding every row.
And `cli/run_slam_torch.py --distributed --loop-shard` in this process
at world size 1 (a one-rank group): the run's summary.json.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ndt_slam_tpu.graph.pose_graph import (
    empty_graph as j_empty_graph,
    make_sharded_optimize as j_make_sharded_optimize,
)

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.graph.loop_closure import (
    pack_verify_out, verify_candidates,
)
from ndt_slam_tpu_torch.graph.pose_graph import graph_from_numpy, optimize_pcg
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.parallel import jobs, start
from ndt_slam_tpu_torch.pipeline.batch_runner import run_slam_batch

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
SLOTS, B = 640, 4
# tests/test_torch_verify.py's configuration
VCFG = SlamConfig.small(
    grid_cells_x=128, grid_cells_y=128, max_scan_points=SLOTS,
    max_submap_points=16384, max_local_map_points=32768, end_frame=10_000,
    loop_enable=True, loop_min_frame_gap=30, loop_radius=3.0,
    loop_score_thre=0.02, loop_keyframe_skip=3, loop_check_skip=3,
    pgo_iterations=10, ndt_max_active_cells=256)
BCFG = SlamConfig.small(end_frame=10_000, ndt_max_active_cells=256)


def _verify_inputs():
    scan = simulate_sequence(n_frames=2, beams=541, seed=3,
                             noise_range=0.01)[0].scan_xy
    p = pad_points(scan, SLOTS, CPU)
    large = np.zeros((B, 3), np.float32)
    large[0] = [0.5, -0.4, np.deg2rad(5.0)]
    half = np.array([[0.62, 0.0, 0.0], [0.0, -0.66, 0.05],
                     [0.58, 0.63, -0.04], [-0.61, 0.7, 0.02]], np.float32)
    tgt = p.xy[None].expand(B, -1, -1).numpy().copy()
    tgt_m = p.mask[None].expand(B, -1).numpy().copy()
    return {name: {"src_xy": p.xy.numpy(), "src_mask": p.mask.numpy(),
                   "tgt_xy": tgt, "tgt_mask": tgt_m, "init": init}
            for name, init in (("large_offset", large),
                               ("half_cell_offsets", half))}


def _se2_between(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    th = np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))
    return np.array([c * dx + s * dy, -s * dx + c * dy, th], np.float32)


def _circle_graph(n_nodes=64, cap_edges=72, seed=0):
    """tests/distributed/test_sharded_pose_graph.py's graph, as arrays,
    in 72 edge slots (its 66 edges reach into the second rank's half)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n_nodes, endpoint=False)
    gt = np.stack([10 * np.cos(th), 10 * np.sin(th), th + np.pi / 2],
                  1).astype(np.float32)
    edges = [(i, i + 1, _se2_between(gt[i], gt[i + 1])
              + rng.normal(0, 0.01, 3).astype(np.float32),
              np.eye(3, dtype=np.float32) * 100)
             for i in range(n_nodes - 1)]
    for (i, j) in [(0, n_nodes - 1), (5, 37), (12, 50)]:
        edges.append((i, j, _se2_between(gt[i], gt[j]),
                      np.eye(3, dtype=np.float32) * 400))
    e = len(edges)
    init = gt + rng.normal(0, 0.2, gt.shape).astype(np.float32)
    init[0] = gt[0]
    arr = dict(poses=init, node_mask=np.ones(n_nodes, bool),
               idx_i=np.zeros(cap_edges, np.int64),
               idx_j=np.zeros(cap_edges, np.int64),
               z=np.zeros((cap_edges, 3), np.float32),
               omega=np.zeros((cap_edges, 3, 3), np.float32),
               edge_mask=np.zeros(cap_edges, bool))
    arr["idx_i"][:e] = [x[0] for x in edges]
    arr["idx_j"][:e] = [x[1] for x in edges]
    arr["z"][:e] = np.stack([x[2] for x in edges])
    arr["omega"][:e] = np.stack([x[3] for x in edges])
    arr["edge_mask"][:e] = True
    return arr, gt


VERIFY = _verify_inputs()
GRAPH, GT = _circle_graph()
SEQS = [simulate_sequence(n_frames=8, beams=181, seed=3),
        simulate_sequence(n_frames=8, beams=181, seed=11)]
PCG = dict(iterations=15)


@pytest.fixture(scope="module")
def started():
    run = [("verify", (VCFG, VERIFY[n]), {}) for n in sorted(VERIFY)]
    run += [("optimize", (GRAPH,), PCG),
            ("scan_cache_eviction", (VCFG.replace(loop_max_candidates=3),),
             {}),
            ("lockstep", (BCFG, SEQS), {})]
    handle = start(jobs.run, 2, run)
    yield handle
    handle.close()


@pytest.fixture(scope="module")
def refs():
    """One device's verifications, PCG solve and lockstep run, and JAX's
    sharded PCG (made while the ranks run)."""
    out = {}
    for name in sorted(VERIFY):
        t = {k: torch.from_numpy(v) for k, v in VERIFY[name].items()}
        out[name] = pack_verify_out(verify_candidates(
            VCFG, t["src_xy"], t["src_mask"], t["tgt_xy"], t["tgt_mask"],
            t["init"])).numpy()
    poses, _ = optimize_pcg(graph_from_numpy(**GRAPH, device=CPU), **PCG)
    out["pcg"] = poses.numpy()
    g = j_empty_graph(64, len(GRAPH["edge_mask"]))._replace(
        poses_rad=jnp.asarray(GRAPH["poses"]),
        node_mask=jnp.asarray(GRAPH["node_mask"]),
        idx_i=jnp.asarray(GRAPH["idx_i"], jnp.int32),
        idx_j=jnp.asarray(GRAPH["idx_j"], jnp.int32),
        z_rad=jnp.asarray(GRAPH["z"]), omega=jnp.asarray(GRAPH["omega"]),
        edge_mask=jnp.asarray(GRAPH["edge_mask"]))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    out["j_pcg"] = np.asarray(j_make_sharded_optimize(mesh, "dp", **PCG)(g)[0])
    out["batch"] = [fe.get_poses() for fe in run_slam_batch(SEQS, BCFG, CPU)]
    return out


@pytest.fixture(scope="module")
def ranks(started, refs):
    return started.result()


@pytest.mark.parametrize("k", [0, 1])
def test_sharded_verify_matches_one_device(ranks, refs, k):
    name = sorted(VERIFY)[k]
    got, other = ranks[0][k], ranks[1][k]
    want = refs[name]
    assert got.shape == (B, 16) and got.tobytes() == other.tobytes()
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    assert got[:, 6].any()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_optimize_matches_pcg_and_jax(ranks, refs):
    half = len(GRAPH["edge_mask"]) // 2
    assert GRAPH["edge_mask"][:half].any() and GRAPH["edge_mask"][half:].any()
    (p0, c0), (p1, c1) = ranks[0][2], ranks[1][2]
    assert p0.tobytes() == p1.tobytes() and c0 == c1
    np.testing.assert_allclose(p0, refs["pcg"], atol=5e-4)
    np.testing.assert_allclose(p0, refs["j_pcg"], atol=5e-4)
    err = np.linalg.norm(p0[:len(GT), :2] - GT[:, :2], axis=1).max()
    assert err < 0.25, err


def test_backend_mesh_capacity_and_scan_cache_eviction(ranks):
    for r in ranks:
        capacity, cached, live = r[3]
        assert capacity == 4          # 3 candidates rounded up to dp = 2
        assert cached == live == [0, 2, 4, 6, 8]


def test_sharded_lockstep_equals_the_unsharded_run(ranks, refs):
    for rank, r in enumerate(ranks):
        poses, rows = r[4]
        assert rows == [rank]
        assert len(poses) == 2
        for got, want in zip(poses, refs["batch"]):
            assert got.shape == want.shape == (8, 3)
            assert got.tobytes() == want.tobytes()


def test_cli_distributed_loop_shard_at_world_size_one(tmp_path, monkeypatch,
                                                      capsys):
    spec = importlib.util.spec_from_file_location(
        "run_slam_torch", os.path.join(ROOT, "cli", "run_slam_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps({
        "max_scan_points": 512, "max_submap_points": 8192,
        "max_local_map_points": 16384, "grid_cells_x": 96,
        "grid_cells_y": 96, "ndt_max_active_cells": 256}))
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [
        "run_slam_torch.py", "--device", "cpu", "--config", str(cfg),
        "--out", str(out), "--simulate", "6", "--distributed",
        "--loop-shard"])
    cli.main()
    assert "[dist] rank 0 of 1: backend gloo" in capsys.readouterr().out
    summary = json.loads((out / "summary.json").read_text())
    assert summary["frames"] == 6 and summary["backend"] == "gloo"
    assert summary["keyframes"] == 2 and "loops_accepted" in summary
    assert not torch.distributed.is_initialized()
