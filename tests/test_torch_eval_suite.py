"""`cli/eval_suite_torch.py` on the CPU, in-process, and the shape of
chip_smoke.py's `[batch]` and `[suite]` phases.

- a two-entry manifest of simulated logs at the small capacities,
  `--device cpu`, in both modes: the rows carry the keys the JAX
  package's `cli/eval_suite.py` writes (read from its source: its rows
  are dict literals and `rec[...]` assignments), `suite.json` holds the
  printed rows, per-entry mode exits 1 when an entry misses its
  `expect_ate_below` (as the JAX CLI does), and the lockstep rows equal
  the per-entry runs' trajectories within the f32 bounds;
- chip_smoke.py (read from its source: it needs a card) runs `[batch]`
  at the default config over office_loop, killian_robot, killian_movers
  and a 120-frame simulation, loops off, with the sweep at B = 1, 2, 4
  and 8, and `[suite]` through the CLI's per-entry mode over suite.json.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(max_scan_points=512, max_submap_points=8192,
             max_local_map_points=16384, grid_cells_x=96, grid_cells_y=96,
             ndt_max_active_cells=256)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_row_keys(fn_name):
    """Every key a row of `fn_name` in cli/eval_suite.py can carry: the
    string keys of its dict literals and of its `rec[...] =` lines."""
    tree = ast.parse(open(os.path.join(ROOT, "cli", "eval_suite.py")).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("suite")
    manifest = tmp / "suite.json"
    manifest.write_text(json.dumps([
        {"name": "sim_a", "simulate": 8, "overrides": SMALL,
         "expect_ate_below": 0.3},
        {"name": "sim_b", "simulate": 6, "seed": 3, "overrides": SMALL,
         "expect_ate_below": 1e-9},
    ]))
    cli = _load("eval_suite_torch",
                os.path.join(ROOT, "cli", "eval_suite_torch.py"))
    out = {}
    for mode, extra in (("entry", []), ("lockstep", ["--lockstep"])):
        d = tmp / mode
        rc = cli.main([str(manifest), "--out", str(d), "--device", "cpu",
                       *extra])
        out[mode] = (rc, json.loads((d / "suite.json").read_text()), d)
    return out


def test_per_entry_rows_have_the_jax_keys_and_gate_the_ate(suite, capsys):
    rc, rows, out = suite["entry"]
    keys = _jax_row_keys("run_entry")
    assert keys == {"name", "frames", "wall_s", "scans_per_s",
                    "accept_rate", "loops_accepted", "ate_rmse_m",
                    "ate_bound_m", "ate_ok"}
    assert [r["name"] for r in rows] == ["sim_a", "sim_b"]
    for r in rows:
        assert set(r) == keys
    assert [r["frames"] for r in rows] == [8, 6]
    assert rows[0]["ate_ok"] is True and rows[1]["ate_ok"] is False
    assert rc == 1   # sim_b misses its (impossible) bound
    assert (out / "sim_a" / "poses_full.txt").exists()


def test_lockstep_rows_have_the_jax_keys(suite):
    rc, rows, out = suite["lockstep"]
    assert rc == 0
    keys = _jax_row_keys("run_lockstep")
    assert keys == {"name", "frames", "accept_rate", "ate_rmse_m",
                    "wall_s", "scans_per_s"}
    assert [r["name"] for r in rows] == ["sim_a", "sim_b", "(aggregate)"]
    assert set(rows[0]) == set(rows[1]) == {"name", "frames",
                                            "accept_rate", "ate_rmse_m"}
    assert set(rows[2]) == {"name", "frames", "wall_s", "scans_per_s"}
    assert rows[2]["frames"] == 14
    # the lockstep trajectories against the per-entry runs of each log
    for name in ("sim_a", "sim_b"):
        a = np.loadtxt(out / name / "poses_full.txt")
        b = np.loadtxt(out.parent / "entry" / name / "poses_full.txt")
        assert a.shape == b.shape
        assert np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]).max() <= 0.05


def test_cuda_without_a_card_is_refused(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cli = _load("eval_suite_torch",
                os.path.join(ROOT, "cli", "eval_suite_torch.py"))
    assert cli.main([os.path.join(ROOT, "suite.json"), "--out",
                     str(tmp_path)]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _calls(fn_name):
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)]


def _names(calls):
    return [c.func.id if isinstance(c.func, ast.Name) else c.func.attr
            for c in calls]


def test_chip_smoke_runs_the_batch_and_suite_phases():
    main = _names(_calls("main"))
    assert "_check_batch" in main and "_check_suite" in main
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert 'BATCH_LOGS = ("office_loop", "killian_robot", ' \
           '"killian_movers")' in src
    assert "BATCH_SIM = 120" in src
    assert "SWEEP = (1, 2, 4, 8)" in src
    batch = _names(_calls("_check_batch"))
    assert "run_slam_batch" in batch and "reset_launch_counts" in batch
    assert "_check_fitness_batched" in batch
    suite = _calls("_check_suite")
    # the CLI's per-entry mode over suite.json, on the card
    cli = [c for c in suite if getattr(c.func, "attr", "") == "main"]
    assert len(cli) == 1
    args = [ast.unparse(a) for a in cli[0].args[0].elts]
    assert "'--lockstep'" not in args and "'cuda'" in args
