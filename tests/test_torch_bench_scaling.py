"""`cli/bench_scaling_torch.py` on the CPU: each workload's row at the
tool's small cut (`SlamConfig.small` capacities, 361-beam scans, a
256-cell table, a batch of 4) as one and as two gloo ranks, two
threads each; the inputs against the JAX tool's worker; the report's
files with the JAX tool's columns; a failing card row fails the tool,
and the tool refuses to run without a card unless asked for the CPU
rows alone."""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "bench_scaling_torch", os.path.join(ROOT, "cli",
                                            "bench_scaling_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load()
KEY = {"verify": "accepted", "seqstep": "iterations", "pairs": "converged"}


@pytest.fixture(scope="module")
def rows():
    """{n: {workload: row}} for one and two ranks."""
    return {n: {r["workload"]: r for r in TOOL.run_rows(
        n, TOOL.WORKLOADS, reps=1, batch=4, threads=2, small=True)}
        for n in (1, 2)}


def test_one_and_two_ranks_agree(rows):
    for w, key in KEY.items():
        one, two = rows[1][w], rows[2][w]
        assert (one["devices"], two["devices"]) == (1, 2)
        assert one[key] == two[key], (w, one[key], two[key])
        assert len(two["launches"]) == 2
    assert rows[1]["verify"]["accepted"] > 0
    assert rows[1]["pairs"]["converged"] == 4


def test_rows_have_the_jax_columns(rows):
    for n, by in rows.items():
        for w, r in by.items():
            assert r["platform"] == "cpu" and r["workload"] == w
            assert r["batch"] == (1 if w == "seqstep" else 4)
            assert r["sec_per_batch"] > 0
            assert r["pairs_per_sec"] == pytest.approx(
                r["batch"] / r["sec_per_batch"])


def test_report_files(rows, tmp_path, monkeypatch):
    """main with the rows above (no new ranks): the JSON and markdown
    report at the paths given."""
    monkeypatch.setattr(TOOL, "run_rows",
                        lambda n, ws, *a, **k: [dict(rows[n][ws[0]])])
    js, md = tmp_path / "s.json", tmp_path / "s.md"
    assert TOOL.main(["--devices", "1", "2", "--cpu-only", "--reps", "1",
                      "--batch", "4", "--out-json", str(js),
                      "--out-md", str(md)]) == 0
    report = json.loads(js.read_text())
    assert set(report) == {"host_cores", "batch", "reps", "workload",
                           "cpu_rows", "gpu_row"}
    assert report["gpu_row"] is None and report["workload"] == "verify"
    for r in report["cpu_rows"]:
        assert {"devices", "platform", "batch", "workload", "sec_per_batch",
                "pairs_per_sec", "accepted",
                "rel_throughput_vs_1dev"} <= set(r)
    assert report["cpu_rows"][0]["rel_throughput_vs_1dev"] == 1.0
    text = md.read_text()
    assert ("| devices | platform | candidates/s | rel. throughput vs 1 dev |"
            in text)
    assert text.count("| cpu |") == 2


def test_card_row_failure_fails_the_tool(rows, monkeypatch, tmp_path):
    def fake(n, ws, reps, batch, device="cpu", **kw):
        if device != "cpu":
            raise RuntimeError("the card's rank failed")
        return [dict(rows[n][ws[0]])]
    monkeypatch.setattr(TOOL, "run_rows", fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="card's rank failed"):
        TOOL.main(["--devices", "1", "--out-json", str(tmp_path / "s.json"),
                   "--out-md", str(tmp_path / "s.md")])
    assert not (tmp_path / "s.json").exists()


def test_inputs_are_the_jax_tools():
    """The points and draws of `cli/bench_scaling.py`'s worker: its
    `room_scan` (run from its source, without JAX) against the tool's for
    every scan the workloads make, and the verify inits' draw order."""
    src = open(os.path.join(ROOT, "cli", "bench_scaling.py")).read()
    worker = ast.parse(ast.literal_eval(
        next(n.value for n in ast.parse(src).body
             if isinstance(n, ast.Assign)
             and n.targets[0].id == "_WORKER")))
    fn = next(n for n in worker.body if isinstance(n, ast.FunctionDef)
              and n.name == "room_scan")
    scope = {"np": np}
    exec(compile(ast.Module([fn], []), "room_scan", "exec"), scope)
    calls = ([dict(n=1081, pose=(0.1, -0.05, 0.03), noise=0.01),
              dict(n=1081, pose=(0.05, 0.03, 0.02), noise=0.01, seed=9),
              dict(n=720, noise=0.01),
              dict(n=360, pose=(0.01, -0.02, 0.03), noise=0.01, seed=5)]
             + [dict(n=1081, noise=0.01, seed=i + 1) for i in range(8)]
             + [dict(n=4321, pose=(0.2 * i, 0.1 * i, 0.05 * i), noise=0.01,
                     seed=i) for i in range(4)])
    for kw in calls:
        assert (TOOL.room_scan(**kw).tobytes()
                == scope["room_scan"](**kw).tobytes()), kw
    _, inp = TOOL.inputs("verify", 8, 2)
    rng = np.random.default_rng(0)
    for got in [inp["init"], *inp["inits"]]:
        want = np.concatenate([rng.uniform(-1.5, 1.5, (8, 2)),
                               rng.uniform(-0.17, 0.17, (8, 1))],
                              1).astype(np.float32)
        assert got.tobytes() == want.tobytes()
    assert inp["tgt_xy"].shape == (8, 2048, 2)


def test_refuses_without_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card row runs")
    assert TOOL.main(["--devices", "1"]) == 1
    assert "--cpu-only" in capsys.readouterr().err
