"""Checkpoint and resume of the port (ndt_slam_tpu_torch.pipeline.checkpoint)
on the CPU, with the incremental lattice on: a run interrupted at frame
18 of 36, saved, loaded and continued equals the uninterrupted run bit
for bit, lattice included; the file is the JAX package's format in both
directions (the port writes and JAX reads and continues, JAX writes and
the port reads, each within 1e-4 m of the writer's own continuation);
the config comparison, the manifest-evolution rule, the refusal of
loop-closure state under a config without loops; the runner's and the
CLI's checkpoint options.

With loops on, the back end's half (`be_*`, `kf_*` and the manifest's
`backend` entry): a run of 10 frames is given a pending loop edge
(node 0 to node 9, measured from the ground truth) and saved; the
continuation's first check then runs a correction, a pose-graph solve
and a map rewrite through the corrected poses, right after the resume
(when the map's device scan cache is empty). The port resumed from its
own file equals its straight run bit for bit; JAX reads the port's
file, and the port reads the file JAX writes from that state; each
continuation lands within 0.05 m / 0.3 deg of the other package's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.pipeline.checkpoint import (
    load_checkpoint as j_load_checkpoint, save_checkpoint as j_save_checkpoint,
)
from ndt_slam_tpu.pipeline.frontend import FrontEnd as JFrontEnd

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.io.tsukuba import write_tsukuba_log
from ndt_slam_tpu_torch.pipeline.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd
from ndt_slam_tpu_torch.pipeline.runner import run_slam

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
N, CUT = 36, 18
# a submap closes every ~3 frames, so the cut falls into the third or
# later submap; a 512-cell table keeps the CPU twins quick, and tight
# convergence makes the two packages' continuations comparable (at the
# default ndt_trans_eps of 1 cm they stop up to that far apart)
KW = dict(submap_sep_thre=4.0, ndt_incremental_grid=1,
          ndt_max_active_cells=512, end_frame=10_000, ndt_trans_eps=1e-4,
          ndt_max_iterations=80)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _step(fe, frames):
    for fr in frames:
        fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)


def _dist(a, b):
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    return float(np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port over 36 simulated frames, saved after frame 17 (the save
    changes nothing, so this is also the uninterrupted run), and the JAX
    package over the first 19, saved after frame 17."""
    tmp = tmp_path_factory.mktemp("ckpt")
    frames = simulate_sequence(n_frames=N, beams=181, seed=11)
    cfg = SlamConfig.small(**KW)
    fe = FrontEnd(cfg, "cpu")
    _step(fe, frames[:CUT])
    ckpt = str(tmp / "port.npz")
    save_checkpoint(fe, ckpt)
    saved_mom = _np(fe.pcmap.mom_state()[0]).copy()
    _step(fe, frames[CUT:])

    jcfg = JSlamConfig.small(**KW)
    jfe = JFrontEnd(jcfg)
    _step(jfe, frames[:CUT])
    jckpt = str(tmp / "jax.npz")
    j_save_checkpoint(jfe, jckpt)
    _step(jfe, frames[CUT:CUT + 1])
    return dict(frames=frames, cfg=cfg, jcfg=jcfg, fe=fe, ckpt=ckpt,
                saved_mom=saved_mom, jfe=jfe, jckpt=jckpt, tmp=tmp)


def test_exact_resume_with_lattice(runs):
    fe = load_checkpoint(runs["ckpt"], "cpu")
    assert fe.cnt == CUT and fe.cfg == runs["cfg"]
    assert fe.incremental_grid and fe.pcmap._mom_valid
    np.testing.assert_array_equal(_np(fe.pcmap._mom), runs["saved_mom"])
    assert len(fe.pcmap.local_scans) == CUT
    np.testing.assert_array_equal(fe.init_pose, runs["fe"].init_pose)
    _step(fe, runs["frames"][CUT:])
    full = runs["fe"]
    np.testing.assert_array_equal(np.stack(fe.pose_history),
                                  np.stack(full.pose_history))
    np.testing.assert_array_equal(np.stack(fe.cov_history),
                                  np.stack(full.cov_history))
    np.testing.assert_array_equal(_np(fe.pcmap.mom_state()[0]),
                                  _np(full.pcmap.mom_state()[0]))
    assert len(fe.pcmap.submaps) == len(full.pcmap.submaps) >= 4
    np.testing.assert_array_equal(fe.pcmap.global_map(),
                                  full.pcmap.global_map())
    assert fe.n_grid_fallbacks == 0


def test_port_writes_jax_reads_and_continues(runs):
    jfe = j_load_checkpoint(runs["ckpt"], runs["jcfg"])
    assert jfe.cnt == CUT and jfe.pcmap._mom_valid
    np.testing.assert_array_equal(np.asarray(jfe.pcmap._mom),
                                  runs["saved_mom"])
    # and without a config: the manifest's own builds a JAX SlamConfig
    assert j_load_checkpoint(runs["ckpt"]).cfg == runs["jcfg"]
    _step(jfe, runs["frames"][CUT:CUT + 5])
    got = np.stack(jfe.pose_history)[CUT:]
    want = np.stack(runs["fe"].pose_history)[CUT:CUT + 5]
    d = _dist(got, want)
    print(f"JAX continuing the port's checkpoint, 5 frames: {d:.3g} m")
    assert d <= 1e-4, d


def test_jax_writes_port_reads_and_continues(runs):
    fe = load_checkpoint(runs["jckpt"], "cpu", runs["cfg"])
    assert fe.cnt == CUT and fe.pcmap._mom_valid
    with np.load(runs["jckpt"]) as data:
        np.testing.assert_array_equal(_np(fe.pcmap._mom), data["pcmap_mom"])
        np.testing.assert_array_equal(_np(fe.pcmap._mom_anchor),
                                      data["pcmap_mom_anchor"])
        # key for key the file the port writes
        with np.load(runs["ckpt"]) as own:
            assert sorted(data.files) == sorted(own.files)
            jm = json.loads(str(data["manifest"]))
            pm = json.loads(str(own["manifest"]))
            assert sorted(jm) == sorted(pm)
            assert sorted(jm["pcmap"]) == sorted(pm["pcmap"])
            assert jm["cfg"] == pm["cfg"] and pm["backend"] is None
            for k in sorted(set(data.files) - {"manifest"}):
                assert data[k].dtype == own[k].dtype, k
                assert data[k].shape == own[k].shape, k
    fr = runs["frames"][CUT]
    rec = fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
    d = _dist(rec["fused_pose"], runs["jfe"].pose_history[CUT])
    print(f"the port continuing JAX's checkpoint, next frame: {d:.3g} m")
    assert d <= 1e-4, d


def test_config_mismatch_raises(runs):
    cfg = runs["cfg"]
    with pytest.raises(ValueError, match="config mismatch.*submap_sep_thre"):
        load_checkpoint(runs["ckpt"], "cpu", cfg.replace(submap_sep_thre=9.0))
    # end_frame and draw_skip only steer the outer loop
    fe = load_checkpoint(runs["ckpt"], "cpu",
                         cfg.replace(end_frame=77, draw_skip=2))
    assert fe.cnt == CUT and fe.cfg.end_frame == 77
    # a knowing override; a lattice of another size is left to a rebuild
    fe = load_checkpoint(runs["ckpt"], "cpu",
                         cfg.replace(grid_mom_cells=120), strict=False)
    assert not fe.pcmap._mom_valid
    assert fe.pcmap.mom_state()[0].shape == (120 * 120, 6)


def test_manifest_config_evolution(runs):
    """A manifest written by another build: a key that is no SlamConfig
    field is dropped, a missing field takes its default, and the strict
    comparison covers only keys both sides know."""
    with np.load(runs["ckpt"], allow_pickle=False) as f:
        data = dict(f)
    meta = json.loads(str(data.pop("manifest")))
    meta["cfg"]["max_submap_scans"] = 64
    meta["cfg"].pop("pipeline_depth", None)
    path = str(runs["tmp"] / "older.npz")
    np.savez_compressed(path, manifest=json.dumps(meta), **data)
    fe = load_checkpoint(path, "cpu")
    assert fe.cnt == CUT
    assert fe.cfg.pipeline_depth == SlamConfig().pipeline_depth
    assert load_checkpoint(path, "cpu", runs["cfg"]).cnt == CUT
    with pytest.raises(ValueError, match="config mismatch"):
        load_checkpoint(path, "cpu", runs["cfg"].replace(diff_resol=0.1))


def test_backend_state_is_refused(runs):
    with np.load(runs["ckpt"], allow_pickle=False) as f:
        data = dict(f)
    meta = json.loads(str(data.pop("manifest")))
    meta["backend"] = {"node_sids": []}
    path = str(runs["tmp"] / "with_backend.npz")
    np.savez_compressed(path, manifest=json.dumps(meta), **data)
    with pytest.raises(ValueError, match="loop-closure backend state"):
        load_checkpoint(path, "cpu")


def test_save_is_atomic_and_leaves_no_temporary(runs):
    path = str(runs["tmp"] / "again.npz")
    save_checkpoint(runs["fe"], path)
    save_checkpoint(runs["fe"], path)          # overwrites in place
    assert os.path.exists(path) and not os.path.exists(path + ".tmp.npz")
    assert load_checkpoint(path, "cpu").cnt == N


def test_runner_checkpoints_and_resumes(runs, tmp_path):
    """run_slam saves every 4 frames; a second call with resume skips
    the 8 frames the file covers, appends to the metrics file and ends
    with the poses of one uninterrupted run."""
    frames, cfg = runs["frames"][:12], runs["cfg"]
    ckpt, metrics = str(tmp_path / "c.npz"), str(tmp_path / "m.jsonl")
    run_slam(frames, cfg.replace(end_frame=8), "cpu", metrics_path=metrics,
             checkpoint_path=ckpt, checkpoint_every=4)
    assert load_checkpoint(ckpt, "cpu").cnt == 8
    fe = run_slam(frames, cfg.replace(end_frame=12), "cpu",
                  metrics_path=metrics, checkpoint_path=ckpt, resume=True)
    assert fe.cnt == 12
    np.testing.assert_array_equal(
        fe.get_poses(), np.stack(runs["fe"].pose_history)[:12])
    with open(metrics) as f:
        sids = [json.loads(line)["sid"] for line in f]
    assert sids == list(range(12))
    assert load_checkpoint(ckpt, "cpu").cnt == 12
    # checkpoint_save=False writes nothing
    other = str(tmp_path / "none.npz")
    run_slam(frames, cfg.replace(end_frame=2), "cpu", checkpoint_path=other,
             checkpoint_save=False)
    assert not os.path.exists(other)


def test_cli_tsukuba_checkpoint_resume(runs, tmp_path):
    log = str(tmp_path / "log.txt")
    write_tsukuba_log(log, runs["frames"][:6])
    cfg = tmp_path / "cfg.json"
    small = SlamConfig.small(**KW).to_dict()
    base = SlamConfig().to_dict()
    cfg.write_text(json.dumps({k: v for k, v in small.items()
                               if v != base[k] and k != "end_frame"}))
    out, ckpt = tmp_path / "out", str(tmp_path / "cli.npz")

    def cli(*extra):
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "cli", "run_slam_torch.py"),
             "--log", log, "--format", "tsukuba", "--out",
             str(out), "--config", str(cfg), "--device", "cpu",
             "--checkpoint", ckpt, *extra],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
        assert proc.returncode == 0, proc.stderr
        return json.loads(proc.stdout.strip().splitlines()[-1])

    first = cli("--end-frame", "3", "--checkpoint-every", "2")
    assert first["frames"] == 3 and first["incremental_grid"] is True
    assert first["n_grid_fallbacks"] == 0
    assert first["resampler"] in ("native", "numpy")
    second = cli("--end-frame", "6", "--resume")
    assert second["frames"] == 6
    poses = np.loadtxt(out / "poses_full.txt")
    np.testing.assert_allclose(
        poses, np.stack(runs["fe"].pose_history)[:6], atol=1e-4)
    with open(out / "metrics.jsonl") as f:
        assert len(f.readlines()) == 6


LOOP_CUT, LOOP_N = 10, 14
# loops on, but no candidate ever (the gap): the back end's state without
# a verifier run, so that only the solve and the rewrite are compiled
LOOP_KW = dict(KW, loop_enable=True, loop_min_frame_gap=10 ** 6,
               loop_keyframe_skip=2, loop_check_skip=2, pgo_iterations=5)


@pytest.fixture(scope="module")
def loop_runs(runs):
    frames = runs["frames"][:LOOP_N]
    cfg, jcfg = SlamConfig.small(**LOOP_KW), JSlamConfig.small(**LOOP_KW)
    fe = FrontEnd(cfg, "cpu")
    _step(fe, frames[:LOOP_CUT])
    be = fe.backend
    a, b = (np.asarray(frames[k].true_pose, np.float64) for k in (0, 9))
    c, s_ = np.cos(np.radians(a[2])), np.sin(np.radians(a[2]))
    d = b[:2] - a[:2]
    z = np.array([c * d[0] + s_ * d[1], -s_ * d[0] + c * d[1],
                  np.radians((b[2] - a[2] + 180.0) % 360.0 - 180.0)],
                 np.float32)
    be.loop_edges.append((0, 9, z, np.eye(3, dtype=np.float32) * 100.0))
    be.loops_accepted += 1
    be._pending_edges += 1
    ckpt = str(runs["tmp"] / "loop_port.npz")
    save_checkpoint(fe, ckpt)
    _step(fe, frames[LOOP_CUT:])
    fe.finalize()

    jfe = j_load_checkpoint(ckpt, jcfg)
    jckpt = str(runs["tmp"] / "loop_jax.npz")
    j_save_checkpoint(jfe, jckpt)
    _step(jfe, frames[LOOP_CUT:])
    jfe.finalize()
    return dict(frames=frames, cfg=cfg, fe=fe, ckpt=ckpt, jfe=jfe,
                jckpt=jckpt)


def test_backend_checkpoint_resumes_exactly_through_a_rewrite(loop_runs):
    fe = load_checkpoint(loop_runs["ckpt"], "cpu")
    assert fe.backend is not None and fe.backend._pending_edges == 1
    assert all(d is None for d in fe.pcmap.local_scans_dev)
    _step(fe, loop_runs["frames"][LOOP_CUT:])
    fe.finalize()
    full = loop_runs["fe"]
    assert fe.n_corrections == full.n_corrections == 1
    assert fe.pcmap.remake_stats == full.pcmap.remake_stats
    assert fe.pcmap.remake_stats["rebuilt"] >= 1
    np.testing.assert_array_equal(fe.get_poses(), full.get_poses())
    np.testing.assert_array_equal(np.stack(fe.backend.node_poses_rad),
                                  np.stack(full.backend.node_poses_rad))
    np.testing.assert_array_equal(fe.pcmap.global_map(),
                                  full.pcmap.global_map())


def test_backend_checkpoint_is_the_jax_format(loop_runs):
    with np.load(loop_runs["ckpt"]) as own, np.load(loop_runs["jckpt"]) as jx:
        assert sorted(own.files) == sorted(jx.files)
        for k in sorted(set(own.files) - {"manifest"}):
            assert own[k].dtype == jx[k].dtype and own[k].shape == jx[k].shape
        for k in ("be_node_poses", "be_odom_edges", "be_loop_edges",
                  "kf_poses", "kf_scan_xy", "kf_scan_mask"):
            np.testing.assert_array_equal(own[k], jx[k])
        pm = json.loads(str(own["manifest"]))["backend"]
        jm = json.loads(str(jx["manifest"]))["backend"]
        assert pm == jm and pm["pending_edges"] == 1


def test_jax_continues_port_backend_checkpoint(loop_runs):
    jfe, fe = loop_runs["jfe"], loop_runs["fe"]
    assert jfe.n_corrections == fe.n_corrections == 1
    assert jfe.pcmap.remake_stats == fe.pcmap.remake_stats
    d = _dist(np.stack(jfe.pose_history), fe.get_poses())
    print(f"JAX continuing the port's back-end checkpoint: {d:.3g} m")
    assert d <= 0.05


def test_port_continues_jax_backend_checkpoint(loop_runs):
    fe = load_checkpoint(loop_runs["jckpt"], "cpu", loop_runs["cfg"])
    _step(fe, loop_runs["frames"][LOOP_CUT:])
    fe.finalize()
    jfe = loop_runs["jfe"]
    assert fe.n_corrections == jfe.n_corrections == 1
    d = _dist(fe.get_poses(), np.stack(jfe.pose_history))
    print(f"the port continuing JAX's back-end checkpoint: {d:.3g} m")
    assert d <= 0.05
