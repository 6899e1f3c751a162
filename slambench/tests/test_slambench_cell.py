"""A configuration, a traffic mix, a driver and a per-layer metric added
as new files and entries alone are found and run; a run loads neither
JAX nor the JAX package; the reference imports nothing of the program;
the command fails without a card."""

import ast
import json
import os
import subprocess
import sys

import pytest

from slambench.tests import tiny

BANNED = {"jax", "jaxlib", "flax", "ndt_slam_tpu"}

DRIVER = '''"""A test driver: the sequential driver's warm-up and window."""
from slambench.drivers import sequential


def warmup(run):
    return dict(sequential.warmup(run), driver="stepper")


def window(run):
    return sequential.window(run)
'''

METRIC = '''"""A test metric: registrations the judge held to the reference."""


def read(ctx):
    return float(ctx.judge.judged)
'''

RUN = '''
import json, sys, torch
torch.set_num_threads(4)
from slambench.harness import banned_modules, run_cell
out = run_cell(sys.argv[1], sys.argv[2], 123456789012, 3.0, False, "cpu")
print(json.dumps({"out": out, "banned": banned_modules(),
                  "program": "ndt_slam_tpu_torch" in sys.modules}))
'''


def _files_of(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_added_files_are_found_and_run(tmp_path):
    root = tiny.checkout(tmp_path)
    sb = os.path.join(root, "slambench")
    cfg = tiny.read(os.path.join(sb, "configs", "tinyrobot.json"))
    cfg.update(name="tinynew", driver="stepper")
    tiny.write(os.path.join(sb, "configs", "tinynew.json"), cfg)
    work = tiny.read(os.path.join(sb, "workloads", "tinyrobot.lap.json"))
    work["logs"][0].update(frames=40, n_movers=2, world="killian")
    work["jobs"] = [{"log": "office", "start": 5, "frames": 30}]
    work["warmup"] = [[0, 3]]
    work["trace"] = {"start": 10, "frames": 3}
    tiny.write(os.path.join(sb, "workloads", "tinynew.corridor.json"), work)
    with open(os.path.join(sb, "drivers", "stepper.py"), "w") as f:
        f.write(DRIVER)
    with open(os.path.join(sb, "metrics", "judged_registrations.py"),
              "w") as f:
        f.write(METRIC)
    bench = tiny.read(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append({"name": "tinynew", "source": "test",
                             "file": "slambench/configs/tinynew.json",
                             "reduced": []})
    bench["workloads"].append({"name": "tinynew.corridor",
                               "config": "tinynew", "traffic": "corridor",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append(
        {"name": "judged_registrations", "unit": "scans", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["tinynew.corridor"]})
    tiny.write(os.path.join(root, "BENCHMARK.json"), bench)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, tiny.REPO]))
    p = subprocess.run([sys.executable, "-c", RUN, root, "tinynew.corridor"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    out = res["out"]
    assert out["correct"], out["checks"]
    assert out["metrics"]["judged_registrations"]["value"] > 0
    assert set(out["metrics"]) == {"scans_per_s", "setup_s",
                                   "judged_registrations"}
    assert "driver" in p.stdout and "stepper" in p.stdout
    assert res["program"] and res["banned"] == []
    assert list(out)[-1] == "checks"


def test_nothing_imports_jax_and_the_reference_not_the_program():
    here = os.path.join(tiny.REPO, "slambench")
    for path in _files_of(here):
        tops = set(_imports(path))
        assert not tops & BANNED, path
        if os.sep + "reference" + os.sep in path:
            assert "ndt_slam_tpu_torch" not in tops, path


def test_command_fails_without_a_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload",
         "robot.office_revisit", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()
