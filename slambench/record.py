"""What a window leaves for the readers and the judge."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Job:
    """One log mapped by one front end: the
    program's outputs as they came back."""
    index: int                 # job number in the window
    row: int                   # the log's row where a driver maps several
    #                            logs together (0 here)
    log: str
    start: int                 # the log frame of the job's frame 0
    length: int                # frames of a whole job
    first: int = 0             # the job's first frame in the window (the
    #                            frames before it are mapped in set-up)
    records: List[dict] = dataclasses.field(default_factory=list)
    covs: List[np.ndarray] = dataclasses.field(default_factory=list)
    # frame numbers below count from the job's frame 0
    # (frame, the trajectory right after the correction at that frame)
    corrections: List[tuple] = dataclasses.field(default_factory=list)
    loop_edges: List[tuple] = dataclasses.field(default_factory=list)
    edge_log: List[dict] = dataclasses.field(default_factory=list)
    # frame -> (target xy, target mask) the frame met, on the device
    targets: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    poses: Optional[np.ndarray] = None   # the trajectory at the end
    complete: bool = False

    @property
    def done(self) -> int:
        """Frames whose records came back in the window."""
        return len(self.records)

    def record(self, k: int) -> Optional[dict]:
        """The record of the job's frame k, if it came back in the
        window."""
        i = k - self.first
        return self.records[i] if 0 <= i < len(self.records) else None

    def take(self, fe):
        """Keep what the front end holds once the job is over."""
        self.covs = [np.asarray(c, np.float32) for c in fe.cov_history]
        self.poses = fe.get_poses()
        be = getattr(fe, "backend", None)
        if be is not None:
            self.loop_edges = list(be.loop_edges)
            self.edge_log = list(be.edge_log)


@dataclasses.dataclass
class Window:
    scans: int
    seconds: float
    latencies_s: List[float]
    stage_ms: Dict[str, float]          # stage totals outside the trace
    stage_scans: int                    # scans those totals cover
    jobs: List[Job]
    trace: object = None                # yardstick.trace.Trace or None
    traced_frames: List[tuple] = dataclasses.field(default_factory=list)
