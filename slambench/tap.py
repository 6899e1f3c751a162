"""What a driver does beside driving: the traced span of a `--trace 1`
run and the snapshots of the registration targets the judge compares.

The traced span is frames [start, start + frames) of the window's first
job: a padded profiler session
(`yardstick.trace.Session`) around them, with the stage timer folded in
before and after so that the stage totals can leave the span out."""

from __future__ import annotations

from typing import Dict, Optional, Set

SPAN = "slambench.span"   # the harness's own stage mark at the span's ends


class Tap:
    def __init__(self, trace: bool, span: dict, snapshots: Set[int],
                 trace_path: str):
        self.trace = trace
        self.start = int(span["start"])
        self.stop = self.start + int(span["frames"])
        self.snapshots = snapshots      # frames of job 0 to snapshot
        self._path = trace_path
        self._session = None
        self._timer = None
        self._pre: Optional[Dict[str, float]] = None
        self.excluded_ms: Dict[str, float] = {}
        self.traced_frames = 0
        self.result = None

    def snapshot_due(self, job: int, frame: int) -> bool:
        return job == 0 and frame in self.snapshots

    def before(self, job: int, frame: int, timer):
        """Called before each scan is handed over."""
        if not self.trace or job != 0:
            return
        if frame == self.start:
            from slambench.yardstick.trace import Session
            # a mark of the harness's own closes the stage interval in
            # flight, so that the session's start and stop fall inside
            # the excluded span and not in the next frame's host stage
            timer.mark(SPAN)
            timer.resolve(wait=True)
            self._timer, self._pre = timer, dict(timer.ms)
            self._session = Session()
            self._session.start()
        elif frame == self.stop:
            self.end()
        if self._session is not None and self.start <= frame < self.stop:
            self.traced_frames += 1

    def watched(self):
        """The timer whose marks the open session annotates."""
        return self._timer if self.result is None else None

    def end(self):
        """Close the traced span (at its last frame or its job's end)."""
        if self._session is None or self.result is not None:
            return
        self._session.stop()
        self._timer.mark(SPAN)
        self._timer.resolve(wait=True)
        post = self._timer.ms
        self.excluded_ms = {k: v - self._pre.get(k, 0.0)
                            for k, v in post.items()}
        self.result = self._session

    def read(self):
        """The trace of the span (after the window), or None."""
        if self.result is None:
            return None
        return self.result.read(self._path)
