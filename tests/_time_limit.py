"""A time limit for test code: a real-time interval timer (SIGALRM) that
fails the running code through `pytest.fail` when it runs past. The
handler runs between Python bytecodes, so a call stuck inside C code (a
collective, a compile) is failed only once it returns: the `timeout=` of
each subprocess wait stays the guard for those."""

import contextlib
import signal
import threading
import time

import pytest

# About twice the slowest tier-1 test on the CPU (284 s).
LIMIT_S = 600.0


@contextlib.contextmanager
def deadline(at, message):
    """Fail the block with `message` if it still runs at `time.monotonic()`
    `at`; a block entered after `at` fails at once. Does nothing where
    SIGALRM is missing or off the main thread, and leaves no timer armed."""
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def expired(signum, frame):
        pytest.fail(message, pytrace=False)

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, max(at - time.monotonic(), 1e-3))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
