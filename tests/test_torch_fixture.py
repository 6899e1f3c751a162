"""`cli/make_carmen_fixture_torch.py` (on the PyTorch package's
`wrap_deg` and `raycast`) against the committed fixtures and the JAX
package's generator `cli/make_carmen_fixture.py`.

The first five frames of each layout and format equal the committed log
lines and ground truth and the JAX generator's lines: office_loop
(FLASER), killian_robot (`--layout killian --format robotlaser1`) and
killian_movers (`--layout killian --movers 3`; three movers reproduce
the committed file byte for byte, one or two do not). The CLI writes
office_loop.clf and office_loop.gt byte for byte.
"""

import importlib.util
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "tests", "data")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gens():
    return (_load("mkfix_jax",
                  os.path.join(ROOT, "cli", "make_carmen_fixture.py")),
            _load("mkfix_torch",
                  os.path.join(ROOT, "cli", "make_carmen_fixture_torch.py")))


def _committed(name, n=5):
    with open(os.path.join(DATA, name + ".clf")) as f:
        header = f.readline().rstrip("\n")
        lines = [f.readline().rstrip("\n") for _ in range(n)]
    with open(os.path.join(DATA, name + ".gt")) as f:
        gt = [f.readline().rstrip("\n") for _ in range(n)]
    return header, lines, gt


@pytest.mark.parametrize("name, kw", [
    ("office_loop", {}),
    ("killian_robot", {"layout": "killian", "fmt": "robotlaser1"}),
    ("killian_movers", {"layout": "killian", "n_movers": 3}),
])
def test_first_frames_equal_the_committed_log_and_jax(gens, name, kw):
    j_gen, gen = gens
    lines, gt_lines = gen.generate(n_frames=5, **kw)
    j_lines, j_gt_lines = j_gen.generate(n_frames=5, **kw)
    _, committed, committed_gt = _committed(name)
    assert lines == committed == j_lines
    assert gt_lines == committed_gt == j_gt_lines


def test_cli_writes_office_loop_byte_for_byte(gens, tmp_path):
    _, gen = gens
    gen.main(["--out-dir", str(tmp_path)])
    for ext in (".clf", ".gt"):
        with open(os.path.join(DATA, "office_loop" + ext), "rb") as f:
            want = f.read()
        assert (tmp_path / ("office_loop" + ext)).read_bytes() == want
