"""The port's configuration properties, its CLI's summary.json and the
shape of chip_smoke.py's main-path phases, on the CPU.

- `grid_num_cells`, `grid_extent_x`, `grid_extent_y` equal the JAX
  config's for `SlamConfig()` and `SlamConfig.small()`;
  `resolved_loop_verify_async` is off on the CPU (and on CUDA, where
  it was measured not to pay) unless forced.
- `cli/run_slam_torch.py` on a simulated log writes the JAX CLI's
  `ate_odometry_m` (the odometry of the processed frames against the
  same ground-truth rows as `ate_rmse_m`, checked against
  `ndt_slam_tpu.metrics.ate_rmse` under `--start-frame`), and writes
  the JAX CLI's `grid_fallbacks` only when a window escaped the
  lattice, beside the port's `n_grid_fallbacks`.
- with `--loop` the back end's keys are those the JAX CLI writes
  (read from cli/run_slam.py's source), on a few simulated frames.
- chip_smoke.py runs `[main]` over all 500 frames of the default path
  and `[determinism]` on both grid paths, and `[loop]` over all 500
  frames with loops on, `[pgo]` and `[determinism]` / `[resume]` with
  loops on, `[pipeline]` held bit for bit to the synchronous runs and
  `[gather]` within its bounds (read from its source: the script needs
  a card).
- `resolved_pipeline_depth` is 0 on the CPU and the module constant on
  CUDA unless forced; with a depth, summary.json holds the JAX CLI's
  pipeline keys, and `--profile` writes a Chrome trace.
"""

import ast
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.io.simulate import simulate_sequence
from ndt_slam_tpu.metrics import ate_rmse as j_ate_rmse

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io import pcd

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(max_scan_points=512, max_submap_points=8192,
             max_local_map_points=16384, grid_cells_x=96, grid_cells_y=96)


@pytest.mark.parametrize("make", ["default", "small"])
def test_config_properties_match_jax(make):
    ours = SlamConfig() if make == "default" else SlamConfig.small()
    theirs = JSlamConfig() if make == "default" else JSlamConfig.small()
    for name in ("grid_num_cells", "grid_extent_x", "grid_extent_y"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.grid_num_cells == ours.grid_cells_x * ours.grid_cells_y


def test_resolved_loop_verify_async():
    cfg = SlamConfig()
    assert cfg.loop_verify_async == -1
    assert cfg.resolved_loop_verify_async("cpu") is False
    assert cfg.resolved_loop_verify_async("cuda") is False
    for forced in (0, 1):
        c = cfg.replace(loop_verify_async=forced)
        assert c.resolved_loop_verify_async("cpu") is bool(forced)
        assert c.resolved_loop_verify_async("cuda") is bool(forced)
    # the JAX package resolves -1 to off on its CPU as well
    assert JSlamConfig().resolved_loop_verify_async is False


def _run_cli(tmp_path, monkeypatch, name, overrides, *args):
    spec = importlib.util.spec_from_file_location(
        "run_slam_torch", os.path.join(ROOT, "cli", "run_slam_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = tmp_path / f"{name}.json"
    cfg.write_text(json.dumps({**SMALL, **overrides}))
    out = tmp_path / name
    monkeypatch.setattr(sys, "argv", [
        "run_slam_torch.py", "--device", "cpu", "--config", str(cfg),
        "--out", str(out), *args])
    cli.main()
    return json.loads((out / "summary.json").read_text())


def test_summary_has_the_jax_cli_keys(tmp_path, monkeypatch, capsys):
    summary = _run_cli(tmp_path, monkeypatch, "plain", {},
                       "--simulate", "10", "--start-frame", "3")
    capsys.readouterr()
    assert summary["frames"] == 7
    assert summary["n_grid_fallbacks"] == 0 and "grid_fallbacks" not in summary
    # the maps went through the JAX package's writer order
    assert summary["pcd_writer"] == pcd.writer()
    frames = simulate_sequence(n_frames=10)
    odo = np.asarray([f.odo_pose for f in frames[3:]])
    true = np.asarray([f.true_pose for f in frames[3:]])
    np.testing.assert_allclose(summary["ate_odometry_m"],
                               j_ate_rmse(odo, true), rtol=1e-6)
    assert summary["ate_rmse_m"] < summary["ate_odometry_m"]


def test_summary_reports_grid_fallbacks(tmp_path, monkeypatch, capsys):
    """A lattice no wider than the window: windows escape, and both
    keys say how many frames were redone."""
    summary = _run_cli(tmp_path, monkeypatch, "escape",
                       {"ndt_incremental_grid": 1, "grid_mom_cells": 96},
                       "--simulate", "4")
    capsys.readouterr()
    assert summary["incremental_grid"] is True
    assert summary["grid_fallbacks"] == summary["n_grid_fallbacks"] > 0


def _main_calls():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [n for n in ast.walk(main) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name)]


def test_chip_smoke_runs_the_default_path_in_full_and_both_paths_twice():
    calls = _main_calls()
    main = [c for c in calls if c.func.id == "_run_main_path"
            and ast.literal_eval(c.args[0]) == "main"]
    assert len(main) == 1
    # the config is `full` itself (the full rebuild, every frame), not a
    # copy cut by end_frame
    assert isinstance(main[0].args[3], ast.Name) \
        and main[0].args[3].id == "full"
    det = [c for c in calls if c.func.id == "_check_determinism"]
    assert len(det) == 1
    paths = det[0].args[2]
    assert isinstance(paths, ast.Dict)
    assert {ast.literal_eval(k) for k in paths.keys} == {"full rebuild",
                                                         "lattice"}
    assert {v.id for v in paths.values} == {"full", "inc"}


def _jax_backend_keys():
    """The keys cli/run_slam.py adds to summary.json for the back end."""
    tree = ast.parse(open(os.path.join(ROOT, "cli", "run_slam.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "update" and node.args \
                and isinstance(node.args[0], ast.Dict):
            keys = {ast.literal_eval(k) for k in node.args[0].keys}
            if "loops_accepted" in keys:
                return keys
    raise AssertionError("no back-end summary in cli/run_slam.py")


def test_loop_summary_has_the_jax_cli_keys(tmp_path, monkeypatch, capsys):
    summary = _run_cli(tmp_path, monkeypatch, "loop",
                       {"ndt_max_active_cells": 256}, "--simulate", "6",
                       "--loop")
    capsys.readouterr()
    keys = _jax_backend_keys()
    assert keys == {"loops_accepted", "corrections", "keyframes",
                    "t_backend_s", "t_verify_s", "t_optimize_s",
                    "t_remake_s", "remake_stats"}
    assert keys <= set(summary)
    # six frames: keyframes at 0 and 5, no candidate 80 frames old
    assert summary["keyframes"] == 2 and summary["loops_accepted"] == 0
    assert summary["corrections"] == 0
    assert summary["remake_stats"] == {"calls": 0, "rebuilt": 0, "kept": 0}
    plain = _run_cli(tmp_path, monkeypatch, "noloop",
                     {"ndt_max_active_cells": 256}, "--simulate", "2")
    capsys.readouterr()
    assert not keys & set(plain)


def _calls(fn_name):
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name)]


def test_chip_smoke_runs_the_loop_phases():
    """[loop] on the full rebuild with loop_enable over every frame, the
    rewrite's batched nearest-neighbour calls against the twin, the
    loops-on determinism and resume, and [pgo] in the child with the
    verifier."""
    calls = _calls("main")
    loop = [c for c in calls if c.func.id == "_run_loop_path"]
    assert [ast.literal_eval(c.args[0]) for c in loop] == ["loop"]
    assert isinstance(loop[0].args[3], ast.Name) \
        and loop[0].args[3].id == "loop"
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "loop = full.replace(loop_enable=True)" in src
    assert [c for c in calls if c.func.id == "_check_rewrite_nn"]
    assert [c for c in calls if c.func.id == "_check_loop_determinism"]
    assert [c for c in _calls("_loop_closure_child")
            if c.func.id == "_check_pgo"]


def test_resolved_pipeline_depth():
    from ndt_slam_tpu_torch.config import PIPELINE_AUTO_DEPTH_ON_CUDA

    cfg = SlamConfig()
    assert cfg.pipeline_depth == -1
    assert cfg.resolved_pipeline_depth("cpu") == 0
    assert cfg.resolved_pipeline_depth("cuda") == PIPELINE_AUTO_DEPTH_ON_CUDA
    for forced in (0, 3, 8):
        c = cfg.replace(pipeline_depth=forced)
        assert c.resolved_pipeline_depth("cpu") == forced
        assert c.resolved_pipeline_depth("cuda") == forced
    # the JAX package resolves -1 to 0 off its accelerator as well
    assert JSlamConfig().resolved_pipeline_depth == 0


def _jax_pipeline_keys():
    """The keys cli/run_slam.py adds to summary.json for a pipelined run."""
    tree = ast.parse(open(os.path.join(ROOT, "cli", "run_slam.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "update" and node.args \
                and isinstance(node.args[0], ast.Dict):
            keys = {ast.literal_eval(k) for k in node.args[0].keys}
            if "pipeline_depth" in keys:
                return keys
    raise AssertionError("no pipeline summary in cli/run_slam.py")


def test_pipelined_summary_has_the_jax_cli_keys_and_profile(
        tmp_path, monkeypatch, capsys):
    summary = _run_cli(tmp_path, monkeypatch, "pipe",
                       {"ndt_max_active_cells": 256, "pipeline_depth": 3},
                       "--simulate", "6", "--profile",
                       str(tmp_path / "trace"))
    capsys.readouterr()
    keys = _jax_pipeline_keys()
    assert keys == {"pipeline_depth", "pipeline_rollbacks",
                    "pipeline_replayed"}
    assert keys <= set(summary) and summary["pipeline_depth"] == 3
    assert summary["frames"] == 6
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    records = (tmp_path / "pipe" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["sid"] for r in records] == list(range(6))


def _source(fn_name):
    path = os.path.join(ROOT, "chip_smoke.py")
    src = open(path).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return ast.get_source_segment(src, fn)


def test_chip_smoke_runs_the_pipeline_and_gather_phases():
    """[pipeline] at depth 8 holds each run bit for bit to its synchronous
    run of the same process ([main] on all 500 frames through
    `_run_main_path`, [main-inc], the escape run, [loop] with its loops
    and corrections, a resume from frames in flight); [gather] runs 150
    frames on the card and 15 card against CPU."""
    calls = _calls("main")
    pipe = [c for c in calls if c.func.id == "_check_pipeline"]
    assert len(pipe) == 1
    sync = pipe[0].args[3]
    assert isinstance(sync, ast.Dict)
    assert {ast.literal_eval(k) for k in sync.keys} == {
        "main", "main-inc", "escape", "loop"}
    assert [v.elts[0].id for v in sync.values] == [
        "full", "inc", "escape", "loop"]
    assert [c for c in calls if c.func.id == "_check_gather"]
    inner = _calls("_check_pipeline")
    assert [ast.literal_eval(c.args[0]) for c in inner
            if c.func.id == "_run_main_path"] == ["pipeline"]
    src = _source("_check_pipeline")
    assert src.count("_same_run(") == 4
    for check in ("fe_l.n_replayed >= 1", "fe_i.n_rollbacks > 0",
                  "be.loops_accepted == be_s.loops_accepted",
                  "fe_l.n_corrections == fe_loop.n_corrections",
                  "in_flight > 0", ".tobytes()"):
        assert check in src, check
    whole = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "PIPE_DEPTH = 8 " in whole and "GATHER_FRAMES = 150 " in whole
    gather = _source("_check_gather")
    assert 'ndt_engine="gather"' in gather
    assert "dxy <= 0.05 and dth <= 0.3" in gather
