"""Hooks for the tests under tests/, beside tests/conftest.py: the `slow`
mark for two long tests of the JAX package, and a time limit for each
test. Tests outside tests/ are left as they are."""

import contextlib
import time
from pathlib import Path

import pytest

from tests._time_limit import LIMIT_S, deadline

TESTS = Path(__file__).resolve().parent / "tests"

# The JAX batch runner held to its sequential runner under loop closure.
# The port holds itself to the same in tier-1, in
# tests/test_torch_batch_loop.py::test_batch_with_loops_matches_sequential.
SLOW = {
    # 858 s in a tier-1 run
    ("integration/test_batch_runner.py",
     "test_batch_with_loop_closure_matches_sequential"),
    # 398 s in a tier-1 run
    ("integration/test_batch_runner.py",
     "test_batch_loop_closure_pinned_gates_near_exact"),
}

_DEADLINE = pytest.StashKey[float]()


def _under_tests(item):
    return TESTS in item.path.resolve().parents


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: the marks must be there before `-m` deselects
    for item in items:
        if (_under_tests(item)
                and (item.path.resolve().relative_to(TESTS).as_posix(),
                     item.name) in SLOW):
            item.add_marker(pytest.mark.slow)


def _limited(item):
    """The item's deadline around one phase. Armed per phase, inside the
    phase's call, so the failure is raised where pytest reports it; the
    code that makes and sends reports between phases runs unarmed."""
    if item.get_closest_marker("slow") or not _under_tests(item):
        return contextlib.nullcontext()
    return deadline(item.stash[_DEADLINE],
                    f"{item.nodeid} ran past its time limit of {LIMIT_S:g} s")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    item.stash[_DEADLINE] = time.monotonic() + LIMIT_S
    with _limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _limited(item):
        return (yield)
