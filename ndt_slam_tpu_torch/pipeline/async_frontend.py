"""Pipelined sequential front end (port of
`ndt_slam_tpu.pipeline.async_frontend`): the host reads a frame's small
outputs a chunk of frames late, in one device-to-host copy a chunk.

A frame's registration needs only state that lives on the device: the
pose, covariance and odometry carries (the previous frame's outputs)
and the registration target, which the fused map append leaves behind.
What the host needs (the trajectory, the travelled distance that
decides a submap close, the records, the loop-closure back end) can lag.
So `PipelinedFrontEnd.process` dispatches each frame speculatively (the
registration step, then the fused map append on the assumption that no
submap closes) and queues it; every `depth` frames, or earlier when a
close or a correction is predicted, the chunk's [K,24] rows
(`FrameResult.small`) and the back end's in-flight verification rows
come to the host in one copy into pinned memory, and the host state is
advanced frame by frame in order, as the synchronous path advances it.

A speculative frame is wrong only where host control would have changed
what the device ran:
1. a lattice escape (`row[23] == 0`): the frame's own registration cut a
   clamped window; the map is rolled back to before it and the frame
   and the rest of the chunk are replayed, the first on the full
   rebuild;
2. a submap close (the travelled distance crosses `submap_sep_thre`):
   the frame's map update takes the close path instead, and every later
   frame registered against the old target; the map is rolled back to
   before the frame, the frame is redone through `add_points` and the
   rest of the chunk replayed;
3. a loop correction: the map was rewritten, so the rest of the chunk
   registered against a stale target and is replayed, with the pose
   carry cleared as `_apply_correction` clears it.

A replay goes through `FrontEnd.process`. Every kept frame saw the
inputs the synchronous path would have given it and every other frame
is run again, so the trajectory equals the synchronous one bit for bit.

A rollback restores references taken at dispatch (`_take_snapshot`).
That is sound only because the map step builds new tensors instead of
writing old ones, so the restore checks each snapshotted tensor's
`_version`. The pipelined front end refuses the lockstep runner's batch
mode, whose stacked buffers are written in place.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PointBuffer, pad_points
from ndt_slam_tpu_torch.pipeline.frontend import FrameResult, FrontEnd

ROW = 24  # FrameResult.small()'s width


class _InFlight(NamedTuple):
    sid: int
    scan_raw: np.ndarray        # raw sensor-frame scan (for a replay)
    rs: np.ndarray              # resampled sensor-frame scan
    odo: np.ndarray             # [3] raw odometry (host)
    odo_dev: torch.Tensor
    scan: PointBuffer           # padded device scan
    out: FrameResult            # the step's outputs (device)
    snapshot: tuple             # map state before this frame's append


def _tensors(obj):
    """The tensors in a snapshot: tensors, PointBuffers, lists."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)


class PipelinedFrontEnd(FrontEnd):
    """FrontEnd with `depth` frames in flight; its trajectory equals the
    synchronous FrontEnd's bit for bit (see the module docstring).

    `process()` returns the list of records resolved in the call (empty
    while frames are in flight); `drain()` resolves the rest and
    `finalize()` drains first."""

    def __init__(self, cfg: SlamConfig, device, depth: Optional[int] = None,
                 mesh=None):
        super().__init__(cfg, device, mesh=mesh)
        self.depth = depth if depth is not None else max(
            1, cfg.resolved_pipeline_depth(self.device.type))
        self._queue: List[_InFlight] = []
        self.n_rollbacks = 0
        self.n_replayed = 0
        # the early-flush prediction (_flush_predicted): odometry travel
        # of the frames in flight
        self._travel_inflight = 0.0
        self._last_odo_dispatched: Optional[np.ndarray] = None

    @property
    def _defer_map(self) -> bool:
        return False

    @_defer_map.setter
    def _defer_map(self, on: bool):
        if on:
            raise ValueError(
                "the pipelined front end does not run in the lockstep "
                "runner's batch mode")

    # ---- dispatch -------------------------------------------------------

    def process(self, scan_xy_local: np.ndarray, odo_pose_deg: np.ndarray,
                sid: Optional[int] = None) -> List[dict]:
        cfg = self.cfg
        if sid is None:
            sid = self.cnt + len(self._queue)
        if sid < cfg.start_frame:
            return [{"sid": sid, "skipped": True}]
        odo = np.asarray(odo_pose_deg, dtype=np.float32)
        if self.cnt == 0 and not self._queue:
            # the bootstrap frame runs synchronously
            rec = super().process(scan_xy_local, odo_pose_deg, sid=sid)
            self._last_odo_dispatched = odo
            return [rec]

        rs = self._resample(
            scan_xy_local, cfg.resample_space, cfg.resample_space_thre
        )
        scan = pad_points(rs, cfg.max_scan_points, self.device)
        odo_dev = torch.from_numpy(odo).to(self.device)
        self.timer.mark("host")
        prev_odo_dev, last_pose_dev, local = self._frame_inputs()
        snapshot = self._take_snapshot()
        out = self._run_step(scan, odo_dev, prev_odo_dev, last_pose_dev,
                             local)
        # the speculative fused append: no submap close (resolution closes
        # eagerly, so the resolved distance has not crossed the threshold)
        assert self.pcmap.fused_add_flags() is not None, (
            "the resolved travel crossed submap_sep_thre without a close")
        self.pcmap._add_scan_fused(PointBuffer(out.global_xy, scan.mask))
        self.timer.mark("map")
        self.last_cov = out.cov
        self._last_pose_dev = out.fused_pose
        self._prev_odo_dev = odo_dev
        if self._last_odo_dispatched is not None:
            self._travel_inflight += float(np.hypot(
                odo[0] - self._last_odo_dispatched[0],
                odo[1] - self._last_odo_dispatched[1]))
        self._last_odo_dispatched = odo
        self._queue.append(_InFlight(
            sid=sid, scan_raw=np.asarray(scan_xy_local), rs=rs, odo=odo,
            odo_dev=odo_dev, scan=scan, out=out, snapshot=snapshot))
        if len(self._queue) >= self.depth or self._flush_predicted():
            return self._resolve()
        return []

    def _flush_predicted(self) -> bool:
        """Resolve now when the frame just dispatched probably closes the
        submap (the resolved travel plus the odometry travel in flight
        crosses the threshold) or runs a deferred correction at its
        back-end check, so that a rollback has no tail to replay. A
        scheduling hint only: a wrong guess costs one small fetch or a
        replay, never the result."""
        cur = self.pcmap.submaps[-1]
        if (self.pcmap.atd + self._travel_inflight
                >= cur.atd_s + self.cfg.submap_sep_thre):
            return True
        be = self.backend
        return be is not None and be.correction_due(
            self.cnt + len(self._queue) - 1)

    def drain(self) -> List[dict]:
        """Resolve every frame in flight (end of run, a checkpoint, or a
        caller that needs the host state whole)."""
        return self._resolve() if self._queue else []

    def finalize(self):
        self.drain()
        super().finalize()

    # ---- resolution -----------------------------------------------------

    def _take_snapshot(self) -> tuple:
        """References to the map state the speculative append replaces,
        with each tensor's version counter. The raw list is copied: the
        append pushes onto it."""
        cur = self.pcmap.submaps[-1]
        p = self.pcmap
        state = (cur.proc, cur.proc_count, list(cur.raw), cur.n_scans,
                 p._cached_target, p._mom, p._mom_anchor, p._mom_valid)
        return state, [(t, t._version) for t in _tensors(state)]

    def _restore_snapshot(self, snapshot: tuple):
        state, versions = snapshot
        for t, v in versions:
            if t._version != v:
                raise RuntimeError(
                    "a tensor of the map held by a rollback snapshot was "
                    "written in place")
        cur = self.pcmap.submaps[-1]
        cur.proc, cur.proc_count = state[0], state[1]
        cur.raw, cur.n_scans = list(state[2]), state[3]
        p = self.pcmap
        p._cached_target = state[4]
        p._mom, p._mom_anchor, p._mom_valid = state[5], state[6], state[7]

    def _fetch(self, entries: List[_InFlight]) -> np.ndarray:
        """The chunk's [K,24] rows on the host, and the back end's
        in-flight verification rows handed to it, from one copy: both
        flattened into one tensor, copied into pinned memory and waited
        on through an event."""
        rows = torch.stack([e.out.small() for e in entries])
        vp = (self.backend.inflight_packed() if self.backend is not None
              else None)
        flat = rows.reshape(-1)
        if vp is not None:
            flat = torch.cat([flat, vp.reshape(-1)])
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            flat = host
        # a copy: the verification rows outlive the pinned buffer
        flat = flat.numpy().copy()
        k = len(entries) * ROW
        if vp is not None:
            self.backend.feed_prefetched(flat[k:].reshape(vp.shape))
        return flat[:k].reshape(len(entries), ROW)

    def _resolve(self) -> List[dict]:
        """Fetch the queue's chunk and advance the host state through it
        in order, as `FrontEnd._finish_frame` does frame by frame;
        rolls back and replays where speculation was wrong."""
        cfg = self.cfg
        entries, self._queue = self._queue, []
        self._travel_inflight = 0.0
        rows = self._fetch(entries)
        self.timer.mark("fetch")

        recs: List[dict] = []
        replay_from: Optional[int] = None
        for idx, e in enumerate(entries):
            row = rows[idx]
            if not row[23] > 0.0:
                # the window escaped the lattice: this registration is
                # invalid; replay from this frame, on the full rebuild
                self._restore_snapshot(e.snapshot)
                self.n_grid_fallbacks += 1
                self.n_rollbacks += 1
                self._force_full_grid = True
                self.last_cov = torch.from_numpy(
                    self.cov_history[-1]).to(self.device)
                self._last_pose_dev = None
                self._prev_odo_dev = None
                replay_from = idx
                break
            fused = row[0:3].copy()
            cov = row[3:12].reshape(3, 3).copy()
            scan_map = PointBuffer(e.out.global_xy, e.scan.mask)
            # the synchronous order: add_pose, the close check, the rest
            self.pcmap.add_pose(fused)
            cur = self.pcmap.submaps[-1]
            closed = self.pcmap.atd - cur.atd_s >= cfg.submap_sep_thre
            if closed:
                # the frame closes the submap: redo its map update
                # through the close path
                self._restore_snapshot(e.snapshot)
                self.pcmap.add_points(scan_map, make_target=True)
                self.n_rollbacks += 1
            self.pcmap.set_last_pose(fused)
            self.pcmap.set_last_scan(scan_map)
            self.pcmap.record_local_scan(e.rs, padded=e.scan)
            self.prev_odo = e.odo
            self.cnt += 1
            self.timer.mark("map")
            rec = self._build_rec(e.sid, row)
            self._record(fused, cov, rec)
            recs.append(rec)
            corrected = self._backend_hook(e.sid, fused, cov, e.scan, rec)
            if closed or corrected:
                # carries back to this frame's outputs; the correction
                # clears the pose carry and keeps the covariance carry,
                # as _apply_correction does
                self.last_cov = e.out.cov
                self._prev_odo_dev = e.odo_dev
                self._last_pose_dev = None if corrected else e.out.fused_pose
                if idx + 1 < len(entries):
                    # the target changed at this frame: the rest of the
                    # chunk registered against a stale one
                    replay_from = idx + 1
                    break

        if replay_from is not None:
            for e in entries[replay_from:]:
                recs.append(FrontEnd.process(self, e.scan_raw, e.odo,
                                             sid=e.sid))
                self.n_replayed += 1
        self.timer.resolve()
        return recs
