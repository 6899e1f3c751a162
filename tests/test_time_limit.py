"""The per-test time limit that the repo's root conftest.py arms around
every test under tests/."""

import signal
import time

import pytest

from tests._time_limit import deadline


def test_block_past_its_limit_fails_with_the_limit():
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="sleeper ran past its time limit of 1 s"):
        with deadline(t0 + 1.0, "sleeper ran past its time limit of 1 s"):
            time.sleep(30)
    assert 0.9 <= time.monotonic() - t0 < 5.0
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_block_under_its_limit_passes_and_disarms():
    with deadline(time.monotonic() + 5.0, "quick"):
        time.sleep(0.01)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
