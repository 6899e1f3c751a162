"""`cli/eval_ate_torch.py` (the PyTorch package's `metrics`) against
`cli/eval_ate.py` (the JAX package's): both in this process, on the
same pairs of trajectory files, print the same JSON line.

The files: office_loop's ground truth (`tests/data/office_loop.gt`) and a
trajectory made from it with seeded noise and drift, written by the
port's writers as a full file (`poses_full.txt`) and in the reference's
decimated format (`poses.txt`: the count, then every 10th pose). Cases:
full against full, decimated against full (the other side decimated to
match), full against decimated, `--rpe-delta 1`, `--no-align`; and a run
that covers fewer frames than the ground truth warns on stderr, as the
JAX CLI does, with the same line on stdout.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from ndt_slam_tpu_torch.io.carmen import read_carmen_gt
from ndt_slam_tpu_torch.io.traj import (
    save_poses_full, save_poses_reference_format,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GT = os.path.join(ROOT, "tests", "data", "office_loop.gt")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clis():
    return (_load("eval_ate_jax", os.path.join(ROOT, "cli", "eval_ate.py")),
            _load("eval_ate_torch",
                  os.path.join(ROOT, "cli", "eval_ate_torch.py")))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traj")
    gt = read_carmen_gt(GT)
    rng = np.random.default_rng(11)
    est = gt + np.cumsum(rng.normal(0, [0.004, 0.004, 0.05],
                                    gt.shape), axis=0)
    est = est.astype(np.float32)
    out = {"gt": GT}
    for name, writer, poses in [
            ("full", save_poses_full, est),
            ("decimated", save_poses_reference_format, est),
            ("short", save_poses_full, est[:400])]:
        out[name] = str(tmp / f"{name}.txt")
        writer(out[name], poses)
    return out


def _stdout(cli, argv, capsys, monkeypatch, jax_style):
    """(exit code, stdout, stderr) of one CLI run in this process; the
    JAX CLI reads sys.argv."""
    if jax_style:
        monkeypatch.setattr(sys, "argv", ["eval_ate.py", *argv])
        rc = cli.main()
    else:
        rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", [
    ("full", "gt"),
    ("decimated", "gt"),
    ("gt", "decimated"),
    ("full", "gt", "--rpe-delta", "1"),
    ("decimated", "gt", "--no-align", "--rpe-delta", "1"),
])
def test_both_clis_print_the_same_line(clis, files, capsys, monkeypatch,
                                       case):
    argv = [files[case[0]], files[case[1]], *case[2:]]
    j_rc, j_out, _ = _stdout(clis[0], argv, capsys, monkeypatch, True)
    rc, out, _ = _stdout(clis[1], argv, capsys, monkeypatch, False)
    assert rc == j_rc == 0
    assert out == j_out and out.count("\n") == 1
    assert '"ate_rmse_m"' in out
    assert ('"rpe_trans_rmse_m"' in out) == ("--rpe-delta" in case)


def test_length_mismatch_warns_as_the_jax_cli(clis, files, capsys,
                                              monkeypatch):
    argv = [files["short"], files["gt"]]
    j_rc, j_out, j_err = _stdout(clis[0], argv, capsys, monkeypatch, True)
    rc, out, err = _stdout(clis[1], argv, capsys, monkeypatch, False)
    assert rc == j_rc == 0 and out == j_out
    assert '"dropped_frames": 100' in out
    assert err == j_err and "WARNING: trajectory lengths differ by 100" in err
