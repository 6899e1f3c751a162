"""Lockstep multi-sequence SLAM (port of
`ndt_slam_tpu.pipeline.batch_runner`).

SLAM is sequential within a sequence: frame t+1 needs frame t's map.
Across sequences there is no dependency, so a mapping farm runs B logs
in lockstep: every tick advances each sequence by one frame through
- one batched registration step (`frontend._registration_step` over a
  leading batch dimension: one grid build keyed by (row, cell), one
  `GridStack` of B tables, the row axis of `align`, one
  `kernels.fitness_score_batched` call, the fusion over rows);
- one device-to-host copy of the tick's [B,24] small outputs;
- one batched map step (`pointcloud_map._add_scan_and_target` over
  rows, its interior dynamic-removal pass one `nn_sq_dists_batched`
  call) on the map state the runner keeps stacked on the device.

The per-frame bookkeeping (records, carries, submap decisions, the
loop-closure back end) stays per sequence in its own `FrontEnd`, which
runs in batch mode (`FrontEnd._defer_map`): `_finish_frame` keeps the
carries on the host and leaves its map update to the runner.

The batch size never changes during a run: a sequence that is
bootstrapping (its first frame goes through `FrontEnd.process`), skipped
or exhausted takes an idle row with all-false masks, which matches
nothing and is discarded. A row's result does not depend on the other
rows or on its position in the batch.

The map state of B sequences lives as [B, ...] tensors between ticks
(the open submap's processed cloud and count, its last two raw scans,
the previous submap's closed cloud and the registration target), so a
steady tick is one map step for all of them. A slot whose frame closes
a submap, or whose flag set differs from the tick's most common one, is
handed back to its `FrontEnd` (`_dump_slot`), takes the per-sequence
path and is stacked again when its flags match (`_load_slot`); a loop
correction rebuilds the sequence's own map, which makes its slot stale.
`counts()` says how often each of these happened; the tick's stage
timer splits the map step into `map_fallback` (the handed-back rows'
own path, with the stack's loads, dumps and re-inits), `map_stacked`
(the batched step) and `map` (the rest).

With a mesh the sequences are sharded over its "dp" ranks, as the JAX
package shards the lockstep step's batch: each rank runs its contiguous
rows in lockstep on its own device (the sequences share nothing, so no
collective runs a tick), and `run_slam_batch` gathers every row's
trajectory and records to every rank at the end. Ranks of one "dp" row
and several "pt" ranks repeat the same rows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PAD_COORD, PointBuffer
from ndt_slam_tpu_torch.mapping.pointcloud_map import _add_scan_and_target
from ndt_slam_tpu_torch.parallel.dist import axis
from ndt_slam_tpu_torch.pipeline.frontend import (
    FrontEnd, StageTimer, _registration_step,
)


def _upload(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """`arrays` on `device` in one host-to-device copy: their bytes
    travel as one buffer and come back as views of their own dtype and
    shape. Arrays of 4-byte types come first, so every view is
    aligned."""
    flat = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                           for a in arrays])
    dev = torch.from_numpy(flat).to(device)
    out, at = [], 0
    for a in arrays:
        dtype = torch.bool if a.dtype == np.bool_ else torch.float32
        out.append(dev[at:at + a.nbytes].view(dtype).view(a.shape))
        at += a.nbytes
    return out


# what `BatchFrontEnd.counts()` counts
COUNTS = (
    "ticks",           # process_batch calls on this rank
    "row_ticks",       # rows computed in the batched registration step
    "bootstrap_rows",  # rows that took FrontEnd.process (a bootstrap or
    #                    a frame before start_frame)
    "idle_rows",       # rows handed None
    "slot_fallbacks",  # rows whose map update took their own add_points
    "slot_loads",      # rows loaded into the stack
    "stack_inits",     # stacks made anew for a new steady flag set
)


def _is_slot(pending) -> bool:
    """Is `pending` the ("slot", row) sentinel (not a PointBuffer)?"""
    return type(pending) is tuple and pending[0] == "slot"


class SequenceResult(NamedTuple):
    """Another rank's sequence after a sharded run: what `FrontEnd`
    keeps of a trajectory."""
    pose_history: list
    cov_history: list
    metrics: list

    def get_poses(self) -> np.ndarray:
        return np.asarray(self.pose_history, dtype=np.float32)


class BatchFrontEnd:
    """B FrontEnds on `device`, advanced in lockstep by one batched
    registration step and one batched map step a tick."""

    def __init__(self, cfg: SlamConfig, n_seq: int, device,
                 frontends: Optional[Sequence[FrontEnd]] = None,
                 mesh=None):
        """`frontends`: FrontEnds on `device` to continue (loaded from
        checkpoints, say) instead of new ones, one for each row this
        rank runs. With `mesh` the n_seq rows are sharded over its "dp"
        ranks (n_seq must divide by their number): this rank runs rows
        `self.rows` and holds their FrontEnds only."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_seq = n_seq
        self._dp = axis(mesh, "dp")
        if n_seq % self._dp.size:
            raise ValueError(f"batch size {n_seq} must divide the dp axis "
                             f"({self._dp.size})")
        k = n_seq // self._dp.size
        self.rows = range(self._dp.rank * k, (self._dp.rank + 1) * k)
        self.frontends: List[FrontEnd] = (
            list(frontends) if frontends is not None
            else [FrontEnd(cfg, self.device) for _ in self.rows])
        if len(self.frontends) != len(self.rows):
            raise ValueError(f"{len(self.frontends)} FrontEnds for "
                             f"{len(self.rows)} rows")
        for fe in self.frontends:
            fe._defer_map = True
            # batch mode always rebuilds the grid in full (the stacked
            # map step keeps no lattice), so none is kept
            fe.incremental_grid = fe.pcmap.incremental_grid = False
            # the runner stacks the covariance carry from the host
            if isinstance(fe.last_cov, torch.Tensor):
                fe.last_cov = fe.last_cov.cpu().numpy()
        self._stack: Optional[dict] = None
        self._tick_global = None   # (global_xy [B,S,2], scan_mask [B,S])
        self._idle_target = PointBuffer.empty(cfg.max_local_map_points,
                                              self.device)
        self.timer = StageTimer(self.device)
        self.reset_counts()

    def counts(self) -> dict:
        """The lockstep's own counters since the last `reset_counts` (the
        keys of `COUNTS`)."""
        return dict(self._counts)

    def reset_counts(self):
        self._counts = dict.fromkeys(COUNTS, 0)

    def process_batch(self, scans_xy_local: Sequence[Optional[np.ndarray]],
                      odo_poses_deg: Sequence[Optional[np.ndarray]],
                      sids: Optional[Sequence[Optional[int]]] = None
                      ) -> List[Optional[dict]]:
        """Advance every sequence one frame. An entry None idles its
        sequence's row (it has run out of frames). Returns the per-frame
        records, None for an idle row and for a row of another rank."""
        n = self.n_seq
        if len(scans_xy_local) != n or len(odo_poses_deg) != n:
            raise ValueError(f"{len(scans_xy_local)} scans and "
                             f"{len(odo_poses_deg)} odometry poses for "
                             f"{n} sequences")
        if sids is None:
            sids = [None] * n
        r = slice(self.rows.start, self.rows.stop)
        recs: List[Optional[dict]] = [None] * n
        recs[r] = self._process_rows(scans_xy_local[r], odo_poses_deg[r],
                                     sids[r])
        return recs

    def _process_rows(self, scans_xy_local, odo_poses_deg, sids):
        """`process_batch` over this rank's rows."""
        fes = self.frontends
        cfg = self.cfg
        B = len(fes)
        recs: List[Optional[dict]] = [None] * B

        # the tick's inputs as host [B, ...] blocks; idle rows keep
        # empty masks and harmless carries
        S = cfg.max_scan_points
        scan_np = np.full((B, S, 2), np.float32(PAD_COORD), np.float32)
        mask_np = np.zeros((B, S), bool)
        odo_np = np.zeros((B, 3), np.float32)
        prev_np = np.zeros((B, 3), np.float32)
        last_np = np.zeros((B, 3), np.float32)
        cov_np = np.tile(np.eye(3, dtype=np.float32) * 1e-4, (B, 1, 1))
        compute = []   # (row, sid, resampled scan, odometry)
        counts = self._counts
        counts["ticks"] += 1
        for i, fe in enumerate(fes):
            if scans_xy_local[i] is None:
                counts["idle_rows"] += 1
                continue
            sid = sids[i] if sids[i] is not None else fe.cnt
            if fe.cnt == 0 or sid < cfg.start_frame:
                # bootstrap or skip: the sequential path (its map update
                # is deferred too, and flushed below)
                counts["bootstrap_rows"] += 1
                recs[i] = fe.process(scans_xy_local[i], odo_poses_deg[i],
                                     sid=sid)
                continue
            rs = fe._resample(scans_xy_local[i], cfg.resample_space,
                              cfg.resample_space_thre)
            k = min(len(rs), S)
            scan_np[i, :k] = rs[:k]
            mask_np[i, :k] = True
            odo = np.asarray(odo_poses_deg[i], dtype=np.float32)
            odo_np[i] = odo
            prev_np[i] = fe.prev_odo
            last_np[i] = fe.pcmap.get_last_pose()
            cov_np[i] = fe.last_cov
            compute.append((i, sid, rs, odo))
        counts["row_ticks"] += len(compute)
        self.timer.mark("host")
        if not compute:
            self._flush_map_updates()
            self.timer.mark("map")
            return recs

        scan_xy, odo_b, prev_b, last_b, cov_b, scan_mask = _upload(
            [scan_np, odo_np, prev_np, last_np, cov_np, mask_np],
            self.device)
        local = self._targets([c[0] for c in compute])
        out = _registration_step(cfg, scan_xy, scan_mask, odo_b, prev_b,
                                 last_b, cov_b, local.xy, local.mask,
                                 timer=self.timer)
        small = out.small().cpu().numpy()   # the tick's one fetch
        self.timer.mark("fetch")
        self._tick_global = (out.global_xy, scan_mask)
        for i, sid, rs, odo in compute:
            recs[i] = fes[i]._finish_frame(
                None, small[i], PointBuffer(scan_xy[i], scan_mask[i]), rs,
                odo, None, sid, pending=("slot", i))
        self.timer.mark("finish")
        self._flush_map_updates()
        self.timer.mark("map")
        self.timer.resolve()
        return recs

    def _targets(self, live: List[int]) -> PointBuffer:
        """The tick's [B, L] registration targets: the stacked targets
        as they are when every computing row is stack-resident, else
        stacked row by row (an idle row gets an empty target)."""
        st = self._stack
        if st is not None and all(st["valid"][i] for i in live):
            return st["target"]
        rows = []
        for i, fe in enumerate(self.frontends):
            if i not in live:
                rows.append(self._idle_target)
            else:
                rows.append(self.stacked_target(i)
                            or fe.pcmap.registration_target())
        return PointBuffer(torch.stack([r.xy for r in rows]),
                           torch.stack([r.mask for r in rows]))

    # ---- the stacked map state ----------------------------------------

    def _stack_init(self, key, flags: dict):
        """Empty stacked state (every slot invalid) for a flag set."""
        cfg = self.cfg
        B = len(self.frontends)
        S, C = cfg.max_scan_points, cfg.max_submap_points
        P = C if flags["has_prev"] else 1

        def empty(n):
            return PointBuffer(
                torch.full((B, n, 2), PAD_COORD, dtype=torch.float32,
                           device=self.device),
                torch.zeros((B, n), dtype=torch.bool, device=self.device))

        self._stack = {
            "key": key, "flags": flags,
            "proc": empty(C),
            "count": torch.zeros(B, dtype=torch.int32, device=self.device),
            "raw_a": empty(S), "raw_b": empty(S), "prev": empty(P),
            "target": empty(cfg.max_local_map_points),
            "valid": np.zeros(B, bool),
        }
        self._counts["stack_inits"] += 1

    def _load_slot(self, i: int):
        """Sequence i's map state into stacked slot i. The stacked
        tensors are written in place: nothing outside the stack holds a
        view of them (`_dump_slot` hands out copies)."""
        st = self._stack
        fe = self.frontends[i]
        cur = fe.pcmap.submaps[-1]
        empty = PointBuffer.empty(self.cfg.max_scan_points, self.device)

        def put(name, buf):
            st[name].xy[i] = buf.xy
            st[name].mask[i] = buf.mask

        put("proc", cur.proc)
        st["count"][i] = cur.proc_count
        put("raw_b", cur.raw[-1] if cur.raw else empty)
        put("raw_a", cur.raw[-2] if len(cur.raw) >= 2 else empty)
        if st["flags"]["has_prev"]:
            put("prev", fe.pcmap.submaps[-2].final_cloud)
        st["valid"][i] = True
        self._counts["slot_loads"] += 1

    def _dump_slot(self, i: int):
        """Stacked slot i back into sequence i's map (copies), before a
        per-sequence path or the end of the run."""
        st = self._stack
        if st is None or not st["valid"][i]:
            return
        pm = self.frontends[i].pcmap
        cur = pm.submaps[-1]

        def row(name):
            return PointBuffer(st[name].xy[i].clone(),
                               st[name].mask[i].clone())

        cur.proc = row("proc")
        cur.proc_count = st["count"][i].clone()
        cur.raw = ([row("raw_a"), row("raw_b")] if cur.n_scans >= 2
                   else [row("raw_b")] if cur.n_scans >= 1 else [])
        pm._cached_target = row("target")
        # batch mode left last_scan alone (the runner held the scan):
        # the newest map-frame scan is the stacked raw tail's last
        if cur.raw:
            pm.set_last_scan(cur.raw[-1])
        st["valid"][i] = False

    def stacked_target(self, i: int) -> Optional[PointBuffer]:
        """Sequence i's registration target if its slot is stacked."""
        st = self._stack
        if st is not None and st["valid"][i]:
            return PointBuffer(st["target"].xy[i], st["target"].mask[i])
        return None

    def finalize(self):
        """End of run: every stacked slot back into its sequence's map,
        then each FrontEnd's own finalize (a correction its back end
        still holds)."""
        for i in range(len(self.frontends)):
            self._dump_slot(i)
        for fe in self.frontends:
            fe.finalize()
        self.timer.resolve(wait=True)

    def gather(self) -> list:
        """All n_seq rows, gathered over the "dp" ranks: this rank's
        FrontEnds, and a `SequenceResult` for every row of another rank
        (after `finalize`)."""
        if self._dp.group is None:
            return list(self.frontends)
        mine = [SequenceResult(fe.pose_history, fe.cov_history, fe.metrics)
                for fe in self.frontends]
        parts = [None] * self._dp.size
        dist.all_gather_object(parts, mine, group=self._dp.group)
        out = [row for part in parts for row in part]
        out[self.rows.start:self.rows.stop] = self.frontends
        return out

    def _flush_map_updates(self):
        """Run the tick's deferred map updates: the slots whose flag set
        is the tick's most common one (and that close no submap) in one
        batched map step on the stacked state; every other slot is
        handed back and takes its FrontEnd's own path."""
        fes = self.frontends
        B = len(fes)
        tick, self._tick_global = self._tick_global, None
        pending = []
        for i, fe in enumerate(fes):
            if fe._map_rewritten:
                # a correction rebuilt this map: the stacked copy is stale
                fe._map_rewritten = False
                if self._stack is not None:
                    self._stack["valid"][i] = False
            ps = fe._pending_scan
            if ps is None:
                continue
            fe._pending_scan = None
            flags = fe.pcmap.fused_add_flags()
            key = None if flags is None else tuple(sorted(flags.items()))
            pending.append((i, ps, key))
        if not pending:
            return

        # the steady flag set: the most common, ties to the lowest row
        keys = [k for _, _, k in pending if k is not None]
        steady = max(keys, key=keys.count) if keys else None
        if steady is not None and (self._stack is None
                                   or self._stack["key"] != steady):
            if self._stack is not None:
                for i in range(B):
                    self._dump_slot(i)
            self._stack_init(steady, dict(steady))
        st = self._stack

        active = np.zeros(B, bool)
        overrides = {}   # row -> a map-frame PointBuffer (bootstrap)
        for i, ps, key in pending:
            if key is not None and key == st["key"]:
                if not st["valid"][i]:
                    self._load_slot(i)
                if not _is_slot(ps):
                    overrides[i] = ps
                active[i] = True
            else:
                # a submap close or another flag set: the sequence's path
                self._dump_slot(i)
                if _is_slot(ps):
                    ps = PointBuffer(tick[0][i], tick[1][i])
                fes[i].pcmap.add_points(ps, make_target=True)
                self._counts["slot_fallbacks"] += 1
        self.timer.mark("map_fallback")
        if not active.any():
            return

        # the tick's map-frame scans enter whole (an inactive row's is
        # discarded by `active`); a bootstrap row's scan replaces its row
        if tick is not None and not overrides:
            scan = PointBuffer(*tick)
        else:
            empty = PointBuffer.empty(self.cfg.max_scan_points, self.device)
            rows = [overrides.get(i) or (PointBuffer(tick[0][i], tick[1][i])
                                         if tick is not None else empty)
                    for i in range(B)]
            scan = PointBuffer(torch.stack([r.xy for r in rows]),
                               torch.stack([r.mask for r in rows]))
        act = torch.from_numpy(active).to(self.device)
        proc, count, target = _add_scan_and_target(
            st["proc"], st["count"], st["raw_a"], st["raw_b"], scan,
            st["prev"], **st["flags"])

        def keep(new: PointBuffer, old: PointBuffer) -> PointBuffer:
            return PointBuffer(torch.where(act[:, None, None], new.xy, old.xy),
                               torch.where(act[:, None], new.mask, old.mask))

        # the raw tail rolls: (raw_a, raw_b) <- (raw_b, scan)
        st.update(proc=keep(proc, st["proc"]),
                  count=torch.where(act, count, st["count"]),
                  raw_a=keep(st["raw_b"], st["raw_a"]),
                  raw_b=keep(scan, st["raw_b"]),
                  target=keep(target, st["target"]))
        self.timer.mark("map_stacked")
        # the host counters follow; the target now lives in the stack
        for i, _, _ in pending:
            if active[i]:
                fes[i].pcmap.submaps[-1].n_scans += 1
                fes[i].pcmap._cached_target = None


def run_slam_batch(sequences: Sequence[Sequence], cfg: SlamConfig, device,
                   verbose: bool = False, mesh=None) -> list:
    """Run B frame sequences (objects with .scan_xy and .odo_pose, and
    .sid where they carry one) in lockstep on `device`; a shorter
    sequence idles once it is exhausted. At most cfg.end_frame ticks.
    Loop closure runs per sequence in each FrontEnd's own back end.
    Returns the B FrontEnds, their maps handed back (`finalize`). With
    `mesh` the rows are sharded over its "dp" ranks (every rank passes
    all B sequences) and every rank returns all B rows: its own
    FrontEnds and a `SequenceResult` for each row of another rank."""
    bfe = BatchFrontEnd(cfg, len(sequences), device, mesh=mesh)
    n_frames = max(len(s) for s in sequences)
    for t in range(min(n_frames, cfg.end_frame)):
        live = [t < len(s) for s in sequences]
        bfe.process_batch(
            [s[t].scan_xy if ok else None for s, ok in zip(sequences, live)],
            [s[t].odo_pose if ok else None
             for s, ok in zip(sequences, live)],
            [getattr(s[t], "sid", t) if ok else None
             for s, ok in zip(sequences, live)])
        if verbose and (t + 1) % 50 == 0:
            print(f"[batch_runner] frame {t + 1}/{n_frames}")
    bfe.finalize()
    return bfe.gather()
