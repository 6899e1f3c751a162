"""The port's main path as a whole (ndt_slam_tpu_torch.pipeline) against
the JAX runner on the CPU: the first 15 frames of the office_loop CARMEN
fixture with SlamConfig.small(), frame by frame within 0.05 m and 0.3°
(the f32-noise bounds of tests/integration/test_batch_runner.py). Also:
a JAX checkpoint taken after frame 8, loaded into the port, gives the
same frame 9; the CLI runs; the package never imports JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.io.carmen import read_carmen_log as j_read_carmen_log
from ndt_slam_tpu.pipeline.checkpoint import save_checkpoint
from ndt_slam_tpu.pipeline.frontend import FrontEnd as JFrontEnd

from ndt_slam_tpu_torch import convert
from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.carmen import read_carmen_gt, read_carmen_log
from ndt_slam_tpu_torch.metrics import ate_rmse
from ndt_slam_tpu_torch.pipeline.checkpoint import load_checkpoint
from ndt_slam_tpu_torch.pipeline.runner import run_slam

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
LOG = os.path.join(ROOT, "tests", "data", "office_loop.clf")
GT = os.path.join(ROOT, "tests", "data", "office_loop.gt")
N = 15
CKPT_AFTER = 9        # frames 0..8 processed when the checkpoint is taken


def _pose_close(a, b):
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=0.05)
    d = np.abs((a[:, 2] - b[:, 2] + 180.0) % 360.0 - 180.0)
    assert d.max() <= 0.3, d.max()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX run (checkpointed after frame 8) and one port run."""
    tmp = tmp_path_factory.mktemp("slice")
    j_frames = j_read_carmen_log(LOG, max_frames=N)
    jfe = JFrontEnd(JSlamConfig.small(end_frame=N))
    ckpt = str(tmp / "jax_ckpt.npz")
    for i, fr in enumerate(j_frames):
        jfe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
        if i + 1 == CKPT_AFTER:
            save_checkpoint(jfe, ckpt)
    frames = read_carmen_log(LOG, max_frames=N)
    out = tmp / "port"
    fe = run_slam(frames, SlamConfig.small(end_frame=N), "cpu",
                  out_dir=str(out), metrics_path=str(out / "metrics.jsonl"))
    return dict(jfe=jfe, fe=fe, ckpt=ckpt, out=out, frames=frames)


def test_slice_poses_match_jax_frame_by_frame(runs):
    jp, p = runs["jfe"].get_poses(), runs["fe"].get_poses()
    assert p.shape == jp.shape == (N, 3)
    _pose_close(p, jp)
    recs = runs["fe"].metrics
    assert all(r["successful"] for r in recs)
    # the Newton loop took the same number of iterations as JAX's
    assert [r.get("iterations") for r in recs] == \
        [r.get("iterations") for r in runs["jfe"].metrics]
    ate = ate_rmse(p, read_carmen_gt(GT)[:N])
    assert ate < 0.05, ate


VARIANTS = {
    # a submap closes every ~3 frames: close, voxel filter, seeding
    "submap_closes": dict(submap_sep_thre=0.6),
    # no dynamic removal (plain appends, carried scans skipped) and the
    # reference's voxel-filtered registration target
    "plain_map_filtered_target": dict(submap_sep_thre=0.6,
                                      remove_moving=False,
                                      ndt_target_filtered=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_slice_variant_matches_jax(variant):
    n = 12
    kw = VARIANTS[variant]
    j_frames = j_read_carmen_log(LOG, max_frames=n)
    jfe = JFrontEnd(JSlamConfig.small(end_frame=n, **kw))
    for fr in j_frames:
        jfe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
    fe = run_slam(read_carmen_log(LOG, max_frames=n),
                  SlamConfig.small(end_frame=n, **kw), "cpu")
    _pose_close(fe.get_poses(), jfe.get_poses())
    assert len(fe.pcmap.submaps) == len(jfe.pcmap.submaps) >= 3
    # sub-mm pose noise can move a point across a voxel boundary, so the
    # clouds match by count (within 1 %), not point for point
    for got, want in zip(fe.pcmap.submap_clouds(),
                         jfe.pcmap.submap_clouds()):
        assert abs(len(got) - len(want)) <= 0.01 * len(want) + 2, \
            (len(got), len(want))


def test_slice_outputs_written(runs):
    out = runs["out"]
    for f in ("poses.txt", "poses_full.txt", "map.pcd", "submap_000.pcd",
              "metrics.jsonl"):
        assert (out / f).stat().st_size > 0, f
    full = np.loadtxt(out / "poses_full.txt")
    np.testing.assert_allclose(full, runs["fe"].get_poses(), atol=1e-4)
    with open(out / "map.pcd") as f:
        head = f.read(400)
    n_pts = int(head.split("POINTS ")[1].split()[0])
    assert n_pts == runs["fe"].pcmap.global_map().shape[0] > 100


def test_jax_checkpoint_resumes_in_port(runs):
    """Map and carries of JAX frame 8, continued by the port: frame 9
    agrees with JAX's frame 9."""
    fe = load_checkpoint(runs["ckpt"], "cpu")
    assert fe.cnt == CKPT_AFTER
    assert len(fe.pose_history) == CKPT_AFTER
    fr = runs["frames"][CKPT_AFTER]
    rec = fe.process(fr.scan_xy, fr.odo_pose, sid=fr.stamp)
    jrec = runs["jfe"].metrics[CKPT_AFTER]
    assert rec["iterations"] == jrec["iterations"]
    assert rec["matched"] == jrec["matched"]
    # the same map buffers in: only f32 summation order differs
    np.testing.assert_allclose(rec["fused_pose"], jrec["fused_pose"],
                               atol=1e-4)


def test_convert_refuses_loop_closure_state(runs):
    with np.load(runs["ckpt"]) as data:
        meta = json.loads(str(data["manifest"]))
        arrays = {k: data[k] for k in data.files if k != "manifest"}
    arrays["be_node_poses"] = np.zeros((0, 3), np.float32)
    with pytest.raises(ValueError, match="loop-closure"):
        convert.frontend_from_state(arrays, meta, "cpu")


def test_cli_runs_on_cpu(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(max_scan_points=512,
                                   max_submap_points=8192,
                                   max_local_map_points=16384,
                                   grid_cells_x=96, grid_cells_y=96)))
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "cli", "run_slam_torch.py"),
         "--log", LOG, "--format", "carmen", "--out", str(out),
         "--config", str(cfg), "--gt", GT, "--end-frame", "4",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"),
    )
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["frames"] == 4 and summary["device"] == "cpu"
    assert summary["ate_rmse_m"] < 0.05
    assert (out / "poses_full.txt").exists() and (out / "map.pcd").exists()


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib, ndt_slam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ndt_slam_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.slow
def test_port_office_loop_80_frames_beats_odometry(tmp_path):
    """The port alone over 80 frames (the JAX package's own fixture
    test, tests/integration/test_carmen_slam.py, at the same bounds)."""
    frames = read_carmen_log(LOG, max_frames=80)
    gt = read_carmen_gt(GT)[:80]
    fe = run_slam(frames, SlamConfig.small(end_frame=80), "cpu",
                  out_dir=str(tmp_path))
    est = fe.get_poses()
    odo = np.stack([f.odo_pose for f in frames])
    accept = np.mean([bool(m.get("successful")) for m in fe.metrics])
    assert accept >= 0.9
    assert ate_rmse(est, gt) < min(0.10, ate_rmse(odo, gt))
