"""`cli/profile_register_torch.py` on the CPU (the plain twins), in this
process, at its small cut of the operating point (a 48 x 48 window,
256 active cells, 2048 scan slots, a 4096-slot target), two timed calls
a row.

Every row the JAX tool `cli/profile_register.py` prints is there, with
the JAX tool's name (read from its source: the names are the first
items of its `rows.append(...)` calls, the f-string fields filled in)
and in its order; the floor row, the JAX tool's trivial jit op, is a
trivial tensor operation here. Every time is finite and positive, every
stage ran on the CPU, and the printed table has the JAX tool's columns
with the device operations added. `main` refuses to run without a card
unless asked for the CPU.
"""

import ast
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROF = _load("profile_register_torch",
             os.path.join(ROOT, "cli", "profile_register_torch.py"))


def _jax_row_patterns():
    """A regex a row name of the JAX tool: its literal text, each
    f-string field a number."""
    tree = ast.parse(open(os.path.join(ROOT, "cli",
                                       "profile_register.py")).read())
    pats = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  None) == "append" \
                and isinstance(node.args[0], ast.Tuple):
            name = node.args[0].elts[0]
            if isinstance(name, ast.Constant):
                pats.append(re.escape(name.value))
            else:
                pats.append("".join(
                    re.escape(v.value) if isinstance(v, ast.Constant)
                    else r"\d+" for v in name.values))
    return pats


@pytest.fixture(scope="module")
def profiled():
    return PROF.profile_rows("cpu", reps=2, small=True)


def test_rows_carry_the_jax_tools_names_in_its_order(profiled):
    _, rows = profiled
    pats = _jax_row_patterns()
    assert len(pats) == len(rows) == 9
    assert pats[0] == re.escape("(dispatch floor: trivial jit op)")
    assert rows[0]["name"] == "(floor: trivial torch op)"
    for pat, row in zip(pats[1:], rows[1:]):
        assert re.fullmatch(pat, row["name"]), (pat, row["name"])


def test_every_row_has_a_positive_time_on_the_cpu(profiled):
    header, rows = profiled
    for r in rows:
        assert np.isfinite(r["us"]) and r["us"] > 0, r
        assert r["device"] == "cpu" and r["device_ops"] is None
    assert [r["gflops"] is not None for r in rows] == [
        False, False, False, False, True, True, False, True, False]
    assert header["device"] == "cpu" and header["card"] is None
    assert header["n_src"] > 0 and header["valid_cells"] > 0
    assert header["iterations"] >= 1


def test_table_has_the_jax_columns(profiled):
    lines = PROF.format_table(*profiled).splitlines()
    assert lines[0].startswith("device: cpu; reps=2; n_src=")
    assert "valid cells=" in lines[0] and "iterations=" in lines[0]
    assert lines[1] == "| stage | time [us] | eff. GFLOP/s | device ops |"
    assert len(lines) == 3 + 9 + 1 and lines[-1].startswith("(sum of stages")


def test_main_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert PROF.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
