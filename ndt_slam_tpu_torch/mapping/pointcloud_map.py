"""Submap-structured point-cloud map (port of
`ndt_slam_tpu.mapping.pointcloud_map`).

Device side: appends, the interior dynamic-removal pass, concatenation
and the voxel filter on fixed-capacity buffers, and the incremental
NDT moment lattice (running moments of the previous submap's closed
cloud plus the open submap's proc buffer; every row appended to proc
is also scattered into it). Host side: the submap open/close decision
(travelled distance vs `submap_sep_thre`), the list of submaps and the
lattice's anchor.

Behaviour kept from the reference (as in the JAX package):
- a new submap is seeded with the previous submap's last two raw scans;
- the first submap keeps its scan[0] raw;
- the NDT target = previous submap's closed cloud + the current
  submap's cloud (unfiltered unless `ndt_target_filtered`);
- interior scan i+1 is filtered against candidates from
  diff(scan_i ∪ scan_{i+2} -> scan_{i+1}), once, when scan i+2 arrives.

After a loop closure `remake_maps` rewrites the map through the
corrected poses, incrementally: submap boundaries stay at the frame
ranges they were built with, and a closed submap is rebuilt only if a
pose it depends on moved past `remake_thresh_trans/rot`. A rebuild
replays the submap's whole add_scan sequence on the device at once
(`_rebuild_submap_fused`): every interior dynamic-removal window of the
submap in one batched pass, one call of the nearest-neighbour kernel's
batch axis, and the buffer filled in the forward order.

Buffer order is part of the contract: `_append` writes at the running
count, `voxel_filter` enumerates voxels from slot 0 and `_concat`
splices b's valid points right after a's valid prefix. A masked write
goes to one extra dump row that is sliced off (`.at[].set(mode="drop")`
in the JAX package).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.angles import sub_deg
from ndt_slam_tpu_torch.core.points import (
    PAD_COORD, PointBuffer, compact, pad_points,
)
from ndt_slam_tpu_torch.core.pose2 import global_points
from ndt_slam_tpu_torch.mapping.dynamic import process_interior_scan
from ndt_slam_tpu_torch.mapping.voxel import voxel_filter
from ndt_slam_tpu_torch.ndt.grid import moments_abs


def _scatter_rows(base: PointBuffer, idx, src: PointBuffer, ok):
    """base with src's rows written at idx (rows with idx ==
    base.capacity land in a dump row that is dropped)."""
    cap = base.capacity
    xy = torch.cat([base.xy, base.xy.new_full((1, 2), PAD_COORD)])
    mask = torch.cat([base.mask, base.mask.new_zeros(1)])
    xy[idx] = src.xy
    mask[idx] = ok
    return xy[:cap], mask[:cap]


def _append_rows(dst: PointBuffer, dst_count, src: PointBuffer):
    """Append src's valid points into dst at dst_count (drop overflow).
    Returns (buffer, new count, compacted src, appended-row mask)."""
    s = compact(src)
    idx = dst_count + torch.arange(s.capacity, device=s.xy.device)
    ok = s.mask & (idx < dst.capacity)
    idx = torch.where(ok, idx, dst.capacity)
    xy, mask = _scatter_rows(dst, idx, s, ok)
    count = dst_count + ok.sum(dtype=torch.int32)
    return PointBuffer(xy, mask), count, s, ok


def _append(dst: PointBuffer, dst_count, src: PointBuffer):
    """Append src's valid points into dst at dst_count (drop overflow)."""
    buf, count, _, _ = _append_rows(dst, dst_count, src)
    return buf, count


def _concat(a: PointBuffer, b: PointBuffer, capacity: int) -> PointBuffer:
    """Prefix-compact `a` followed by b's valid points (stable) in a
    `capacity` buffer: an O(capacity) scatter, no sort of the union.
    Contract: a's valid points occupy a prefix of its buffer."""
    a_n = a.mask.sum()
    bc = compact(b)
    if a.capacity >= capacity:
        base = PointBuffer(a.xy[:capacity], a.mask[:capacity])
    else:
        pad = capacity - a.capacity
        base = PointBuffer(
            torch.cat([a.xy, a.xy.new_full((pad, 2), PAD_COORD)]),
            torch.cat([a.mask, a.mask.new_zeros(pad)]),
        )
    idx = a_n + torch.arange(bc.capacity, device=bc.xy.device)
    ok = bc.mask & (idx < capacity)
    idx = torch.where(ok, idx, capacity)
    xy, mask = _scatter_rows(base, idx, bc, ok)
    xy = torch.where(mask[:, None], xy, PAD_COORD)
    return PointBuffer(xy, mask)


def _add_scan_target_mom(
    proc: PointBuffer, proc_count, raw_a: PointBuffer, raw_b: PointBuffer,
    scan: PointBuffer, prev: PointBuffer, mom, mom_anchor, *,
    append_scan: bool, do_interior: bool, include_newest: bool,
    has_prev: bool, filtered: bool, cap_sub: int, cap_local: int,
    resol: float, thre: float, leaf: float,
    mom_cells: int = 0, grid_res: float = 0.0,
):
    """Per-frame map update: Submap.add_scan (raw append and/or interior
    dynamic-removal pass) + Submap.cloud() + the next frame's
    registration target. `raw_a`/`raw_b` are the submap's last two raw
    scans (used only with `do_interior`); `prev` is the previous
    submap's closed cloud (used only with `has_prev`).

    With a moment lattice `mom` [mom_cells^2, 6] (else None) every row
    this call appends to `proc`, and no row the full buffer dropped, is
    also scattered into it. Returns (proc, proc_count, target, mom)."""

    def add(proc, proc_count, mom, src):
        proc, proc_count, rows, ok = _append_rows(proc, proc_count, src)
        if mom is not None:
            mom = mom + moments_abs(rows.xy, ok, mom_anchor, mom_cells,
                                    mom_cells, grid_res)
        return proc, proc_count, mom

    if append_scan:
        proc, proc_count, mom = add(proc, proc_count, mom, scan)
    if do_interior:
        processed = process_interior_scan(raw_a, raw_b, scan, resol, thre)
        proc, proc_count, mom = add(proc, proc_count, mom, processed)
    cloud = _concat(proc, scan, cap_sub) if include_newest else proc
    cur_t = voxel_filter(cloud, leaf) if filtered else cloud
    if has_prev:
        target = _concat(prev, cur_t, cap_local)
    else:
        target = _concat(cur_t, PointBuffer.empty(1, proc.xy.device),
                         cap_local)
    return proc, proc_count, target, mom


def _add_scan_and_target(proc, proc_count, raw_a, raw_b, scan, prev, **flags):
    """`_add_scan_target_mom` without a lattice: (proc, proc_count,
    target)."""
    return _add_scan_target_mom(proc, proc_count, raw_a, raw_b, scan, prev,
                                None, None, **flags)[:3]


def _rebuild_mom(prev: PointBuffer, proc: PointBuffer, mom_anchor, *,
                 mom_cells: int, grid_res: float, has_prev: bool):
    """From-scratch moment lattice: the current proc buffer plus the
    previous submap's closed cloud (the additive part of the
    registration target; the newest raw scan is added per frame at
    registration). Runs on bootstrap, after a submap close and after a
    load that carries no lattice; the frame loop only ever adds to it."""
    mom = moments_abs(proc.xy, proc.mask, mom_anchor, mom_cells, mom_cells,
                      grid_res)
    if has_prev:
        mom = mom + moments_abs(prev.xy, prev.mask, mom_anchor, mom_cells,
                                mom_cells, grid_res)
    return mom


def _rebuild_submap_fused(scans_xy, scans_mask, poses_deg, active,
                          carried, *, remove_moving: bool, is_first: bool,
                          cap_sub: int, resol: float, thre: float,
                          leaf: float, do_close: bool):
    """Replay a whole submap's add_scan sequence at once.

    scans_xy [n,S,2] / scans_mask [n,S]: sensor-frame scans (padded
    along n); poses_deg [n,3] the corrected poses; active [n] (host
    bool) real scan vs padding; carried [n] (host bool) seeded from the
    previous submap. The interior dynamic-removal pass depends only on
    its own 3-scan window, so all windows run as one batched pass, and
    the buffer fills with a single append of the rows in the forward
    order (append_i, interior_i interleaved). Branches follow
    Submap.step_flags/add_scan.

    Returns (proc, proc_count, proj_xy [n,S,2], proj_mask [n,S],
    closed); closed is the voxel-filtered final cloud with `do_close`,
    else None."""
    n = scans_xy.shape[0]
    dev = scans_xy.device
    act = torch.from_numpy(np.asarray(active, bool)).to(dev)
    proj_mask = scans_mask & act[:, None]
    proj = global_points(poses_deg, scans_xy)
    proj = torch.where(proj_mask[..., None], proj, PAD_COORD)

    idx = np.arange(n)
    if remove_moving:
        append_f = active & (idx == 0) if is_first else np.zeros(n, bool)
        interior_f = active & (idx >= 2)
    else:
        append_f = active & (True if is_first else ~carried)
        interior_f = np.zeros(n, bool)
    append_f = torch.from_numpy(append_f).to(dev)

    if remove_moving:
        interior_f = torch.from_numpy(interior_f).to(dev)
        pad_xy = torch.full_like(proj[:2], PAD_COORD)
        pad_m = torch.zeros_like(proj_mask[:2])
        prev1 = PointBuffer(torch.cat([pad_xy[:1], proj[:-1]]),
                            torch.cat([pad_m[:1], proj_mask[:-1]]))
        prev2 = PointBuffer(torch.cat([pad_xy, proj[:-2]]),
                            torch.cat([pad_m, proj_mask[:-2]]))
        processed = process_interior_scan(prev2, prev1,
                                          PointBuffer(proj, proj_mask),
                                          resol, thre)
        all_xy = torch.stack([proj, processed.xy], dim=1)
        all_mask = torch.stack([proj_mask & append_f[:, None],
                                processed.mask & interior_f[:, None]], dim=1)
    else:
        all_xy = proj[:, None]
        all_mask = (proj_mask & append_f[:, None])[:, None]
    proc, count = _append(
        PointBuffer.empty(cap_sub, dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        PointBuffer(all_xy.reshape(-1, 2), all_mask.reshape(-1)),
    )
    closed = None
    if do_close:
        cloud = proc
        if remove_moving:
            # the newest raw scan rides along: the last active slot
            last = max(int(np.sum(active)) - 1, 0)
            cloud = _concat(proc, PointBuffer(proj[last], proj_mask[last]),
                            cap_sub)
        closed = voxel_filter(cloud, leaf)
    return proc, count, proj, proj_mask, closed


class Submap:
    """One submap: accumulated processed cloud + the raw 3-scan tail."""

    def __init__(self, cfg: SlamConfig, atd_s: float, cnt_s: int, device):
        self.cfg = cfg
        self.device = device
        self.atd_s = atd_s
        self.cnt_s = cnt_s          # global pose index of first scan
        self.cnt_e: Optional[int] = None
        self.proc = PointBuffer.empty(cfg.max_submap_points, device)
        self.proc_count = torch.zeros((), dtype=torch.int32, device=device)
        self.raw: List[PointBuffer] = []   # last 3 raw scans
        self.n_scans = 0
        self.final_cloud: Optional[PointBuffer] = None  # set on close
        self.is_first = cnt_s == 0

    def _push_raw(self, scan: PointBuffer):
        self.raw.append(scan)
        if len(self.raw) > 3:
            self.raw.pop(0)

    def step_flags(self) -> tuple[bool, bool, bool]:
        """(append_scan, do_interior, include_newest) for the NEXT scan.

        remove_moving: only the first submap's first scan is appended
        raw; an interior pass runs once 3 raw scans exist; the newest
        raw scan rides along in `cloud()`. Without remove_moving: plain
        append, no interior, newest already appended."""
        if self.cfg.remove_moving:
            return (self.is_first and self.n_scans == 0,
                    self.n_scans + 1 >= 3,
                    True)
        return (True, False, False)

    def add_scan(self, scan: PointBuffer, carried: bool = False):
        """Add one scan (map-frame points). `carried` marks the two scans
        inherited from the previous submap at creation."""
        cfg = self.cfg
        append_scan, do_interior, _ = self.step_flags()
        if not cfg.remove_moving and carried and not self.is_first:
            # non-first submaps skip the 2 carried scans in plain mode
            append_scan = False
        self._push_raw(scan)
        self.n_scans += 1
        if append_scan:
            self.proc, self.proc_count = _append(
                self.proc, self.proc_count, scan
            )
        if do_interior:
            processed = process_interior_scan(
                self.raw[-3], self.raw[-2], self.raw[-1],
                cfg.diff_resol, cfg.thre_neighbor,
            )
            self.proc, self.proc_count = _append(
                self.proc, self.proc_count, processed
            )

    def cloud(self) -> PointBuffer:
        """Current assembled cloud."""
        if self.cfg.remove_moving and self.raw:
            return _concat(self.proc, self.raw[-1], self.cfg.max_submap_points)
        return self.proc

    def close(self):
        """Voxel-filter and freeze."""
        self.final_cloud = voxel_filter(self.cloud(), self.cfg.submap_leaf_size)


class PointCloudMap:
    """Trajectory + submaps + local/global map assembly."""

    def __init__(self, cfg: SlamConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.poses: List[np.ndarray] = []        # fused poses (deg)
        self.atd = 0.0
        self.submaps: List[Submap] = [Submap(cfg, 0.0, 0, self.device)]
        self.last_pose = np.zeros(3, dtype=np.float32)
        self.last_scan: Optional[PointBuffer] = None
        # raw sensor-frame scans for the map rewrite after a loop
        # closure: the host copies are canonical (the checkpoint carries
        # them); local_scans_dev caches each frame's padded device
        # buffer, so that a rewrite stacks device references instead of
        # uploading. An entry may be None (after a checkpoint load);
        # _rebuild_submap pads and uploads it then, once.
        self.local_scans: List[np.ndarray] = []
        self.local_scans_dev: List[Optional[PointBuffer]] = []
        # registration target left by the last fused add_points (valid
        # until the next map mutation)
        self._cached_target: Optional[PointBuffer] = None
        # incremental NDT moment lattice: running moments of (previous
        # submap's closed cloud + open submap's proc buffer), added to
        # by the fused add path and rebuilt from scratch after the
        # mutations that bypass it (submap close, a load without one)
        self.incremental_grid = cfg.resolved_ndt_incremental_grid(
            self.device.type)
        self._mom: Optional[torch.Tensor] = None
        self._mom_anchor: Optional[torch.Tensor] = None
        self._mom_valid = False
        self.remake_stats = {"calls": 0, "rebuilt": 0, "kept": 0}

    def add_pose(self, pose_deg: np.ndarray):
        pose_deg = np.asarray(pose_deg, dtype=np.float32)
        if self.poses:
            pp = self.poses[-1]
            self.atd += float(np.hypot(pose_deg[0] - pp[0],
                                       pose_deg[1] - pp[1]))
        self.poses.append(pose_deg)

    def add_points(self, scan_map_frame: PointBuffer):
        """Append one map-frame scan. The common (no submap-close) path
        also assembles the next frame's registration target, which
        `registration_target()` returns."""
        cfg = self.cfg
        cur = self.submaps[-1]
        self._cached_target = None
        if self.atd - cur.atd_s >= cfg.submap_sep_thre:
            cur.cnt_e = len(self.poses) - 2
            cur.close()
            new = Submap(cfg, self.atd, len(self.poses) - 1, self.device)
            # seed with the previous submap's last two raw scans
            for s in cur.raw[-2:]:
                new.add_scan(s, carried=True)
            new.add_scan(scan_map_frame)
            self.submaps.append(new)
            self._mom_valid = False
        else:
            self._cached_target = self._add_scan_fused(cur, scan_map_frame)

    def mom_state(self):
        """(mom [B*B, 6], anchor [2] int32) of the incremental lattice,
        rebuilt from scratch if a bypassing mutation invalidated it. The
        anchor centers the lattice on the open submap's first pose;
        `resolved_grid_mom_cells` sizes it so that every frame window
        within the submap's travel fits (the registration step still
        reports a window that does not)."""
        cfg = self.cfg
        if not self._mom_valid:
            B = cfg.resolved_grid_mom_cells
            cur = self.submaps[-1]
            first = (self.poses[cur.cnt_s] if self.poses
                     else np.zeros(3, np.float32))
            anchor = np.floor(
                np.asarray(first[:2], np.float32) / cfg.ndt_resolution
                - B / 2.0
            ).astype(np.int32)
            self._mom_anchor = torch.from_numpy(anchor).to(self.device)
            has_prev = len(self.submaps) >= 2
            prev = (self.submaps[-2].final_cloud if has_prev
                    else PointBuffer.empty(1, self.device))
            self._mom = _rebuild_mom(
                prev, cur.proc, self._mom_anchor, mom_cells=B,
                grid_res=cfg.ndt_resolution, has_prev=has_prev,
            )
            self._mom_valid = True
        return self._mom, self._mom_anchor

    def newest_raw(self) -> Optional[PointBuffer]:
        """The open submap's newest raw scan (map frame): the part of
        the registration target under remove_moving that is not in the
        lattice (it rides along in cloud(), not in proc)."""
        cur = self.submaps[-1]
        return cur.raw[-1] if cur.raw else None

    def _add_scan_fused(self, cur: Submap, scan: PointBuffer) -> PointBuffer:
        """Map update for this frame that also returns the next target
        (and adds to the lattice when the incremental grid is on)."""
        cfg = self.cfg
        append_scan, do_interior, include_newest = cur.step_flags()
        has_prev = len(self.submaps) >= 2
        prev = (self.submaps[-2].final_cloud if has_prev
                else PointBuffer.empty(1, self.device))
        raw_a = cur.raw[-2] if len(cur.raw) >= 2 else scan
        raw_b = cur.raw[-1] if len(cur.raw) >= 1 else scan
        mom, anchor = (self.mom_state() if self.incremental_grid
                       else (None, None))
        proc, count, target, mom = _add_scan_target_mom(
            cur.proc, cur.proc_count, raw_a, raw_b, scan, prev, mom, anchor,
            append_scan=append_scan, do_interior=do_interior,
            include_newest=include_newest, has_prev=has_prev,
            filtered=cfg.ndt_target_filtered,
            cap_sub=cfg.max_submap_points,
            cap_local=cfg.max_local_map_points,
            resol=cfg.diff_resol, thre=cfg.thre_neighbor,
            leaf=cfg.submap_leaf_size,
            mom_cells=cfg.resolved_grid_mom_cells,
            grid_res=cfg.ndt_resolution,
        )
        self._mom = mom
        cur._push_raw(scan)
        cur.n_scans += 1
        cur.proc, cur.proc_count = proc, count
        return target

    def local_map(self) -> PointBuffer:
        """Previous closed cloud + the voxel-filtered current cloud."""
        cfg = self.cfg
        cur_filtered = voxel_filter(self.submaps[-1].cloud(),
                                    cfg.submap_leaf_size)
        if len(self.submaps) >= 2:
            prev = self.submaps[-2].final_cloud
            return _concat(prev, cur_filtered, cfg.max_local_map_points)
        return _concat(cur_filtered, PointBuffer.empty(1, self.device),
                       cfg.max_local_map_points)

    def registration_target(self) -> PointBuffer:
        """NDT target: previous submap's closed cloud + the current
        submap's unfiltered cloud (`local_map()` under
        `ndt_target_filtered`)."""
        if self._cached_target is not None:
            return self._cached_target
        cfg = self.cfg
        if cfg.ndt_target_filtered:
            return self.local_map()
        cur = self.submaps[-1].cloud()
        if len(self.submaps) >= 2:
            prev = self.submaps[-2].final_cloud
            return _concat(prev, cur, cfg.max_local_map_points)
        return _concat(cur, PointBuffer.empty(1, self.device),
                       cfg.max_local_map_points)

    def global_map(self) -> np.ndarray:
        """Host [M,2] float32 of all valid map points."""
        if not self.poses:
            return np.zeros((0, 2), np.float32)
        return np.concatenate(self.submap_clouds(), axis=0)

    def submap_clouds(self) -> List[np.ndarray]:
        """Host clouds: each closed submap's final cloud, then the open
        submap's voxel-filtered cloud."""
        bufs = [sm.final_cloud for sm in self.submaps[:-1]]
        bufs.append(voxel_filter(self.submaps[-1].cloud(),
                                 self.cfg.submap_leaf_size))
        return [b.xy[b.mask].cpu().numpy().astype(np.float32) for b in bufs]

    def set_last_pose(self, pose_deg: np.ndarray):
        self.last_pose = np.asarray(pose_deg, dtype=np.float32)

    def get_last_pose(self) -> np.ndarray:
        return self.last_pose

    def set_last_scan(self, scan: PointBuffer):
        self.last_scan = scan

    def record_local_scan(self, xy_local: np.ndarray,
                          padded: Optional[PointBuffer] = None):
        """Keep a frame's sensor-frame scan for the map rewrite: the host
        copy, and `padded`, the device buffer the caller registered (a
        reference), when it has one."""
        self.local_scans.append(np.asarray(xy_local, dtype=np.float32))
        self.local_scans_dev.append(padded)

    def _rebuild_submap(self, sm: Submap, new_poses: np.ndarray,
                        atd_s: float, is_open: bool) -> Submap:
        """Re-project one submap's scans through corrected poses over
        its frozen frame range (the carried seeds and the members),
        every add_scan branch as the forward pass ran it, in one
        `_rebuild_submap_fused`."""
        cfg = self.cfg
        end = len(new_poses) if is_open else sm.cnt_e + 1
        lo = max(0, sm.cnt_s - 2) if sm.cnt_s > 0 else 0
        frames = range(lo, end)
        n = len(frames)
        n_pad = 8
        while n_pad < n:
            n_pad *= 2
        S = cfg.max_scan_points
        rows = []
        for f in frames:
            if self.local_scans_dev[f] is None:
                self.local_scans_dev[f] = pad_points(self.local_scans[f], S,
                                                     self.device)
            rows.append(self.local_scans_dev[f])
        rows += [PointBuffer.empty(S, self.device)] * (n_pad - n)
        ps = np.zeros((n_pad, 3), np.float32)
        ps[:n] = new_poses[lo:end]
        active = np.arange(n_pad) < n
        carried = np.arange(n_pad) < sm.cnt_s - lo
        proc, count, proj, proj_mask, closed = _rebuild_submap_fused(
            torch.stack([r.xy for r in rows]),
            torch.stack([r.mask for r in rows]),
            torch.from_numpy(ps).to(self.device), active, carried,
            remove_moving=cfg.remove_moving, is_first=sm.cnt_s == 0,
            cap_sub=cfg.max_submap_points, resol=cfg.diff_resol,
            thre=cfg.thre_neighbor, leaf=cfg.submap_leaf_size,
            do_close=not is_open,
        )
        new = Submap(cfg, atd_s, sm.cnt_s, self.device)
        new.proc, new.proc_count = proc, count
        new.n_scans = n
        new.raw = [PointBuffer(proj[i], proj_mask[i])
                   for i in range(max(0, n - 3), n)]
        if not is_open:
            new.cnt_e = sm.cnt_e
            new.final_cloud = closed
        return new

    def remake_maps(self, new_poses_deg: np.ndarray,
                    thresh_trans: Optional[float] = None,
                    thresh_rot: Optional[float] = None):
        """Rewrite the map through pose-graph-corrected poses. A closed
        submap is rebuilt only if a pose it depends on (its members and
        the two carried seed frames) moved more than (thresh_trans [m],
        thresh_rot [deg]); the open submap, the registration target,
        always rebuilds. Negative thresholds force a full rebuild (0
        still keeps submaps whose poses are bit-identical). The cached
        target and the moment lattice are invalidated; `remake_stats`
        counts rebuilt and kept submaps."""
        cfg = self.cfg
        new_poses = np.asarray(new_poses_deg, dtype=np.float32)
        if not len(new_poses) == len(self.local_scans) == len(self.poses):
            raise ValueError(
                f"{len(new_poses)} corrected poses for a map of "
                f"{len(self.poses)} poses and {len(self.local_scans)} scans")
        tt = cfg.remake_thresh_trans if thresh_trans is None else thresh_trans
        tr = cfg.remake_thresh_rot if thresh_rot is None else thresh_rot

        old_poses = np.asarray(self.poses, dtype=np.float32)
        d_t = np.hypot(new_poses[:, 0] - old_poses[:, 0],
                       new_poses[:, 1] - old_poses[:, 1])
        d_r = np.abs(sub_deg(new_poses[:, 2], old_poses[:, 2]))
        moved = (d_t > tt) | (d_r > tr)
        # travelled distance along the corrected trajectory
        seg = np.hypot(np.diff(new_poses[:, 0]), np.diff(new_poses[:, 1]))
        cum = np.concatenate([[0.0], np.cumsum(seg)])

        rebuilt = []
        n_rebuilt = n_kept = 0
        for k, sm in enumerate(self.submaps):
            is_open = k == len(self.submaps) - 1
            end = len(new_poses) if is_open else sm.cnt_e + 1
            lo = max(0, sm.cnt_s - 2) if sm.cnt_s > 0 else 0
            if is_open or moved[lo:end].any():
                rebuilt.append(self._rebuild_submap(
                    sm, new_poses, float(cum[sm.cnt_s]), is_open))
                n_rebuilt += 1
            else:
                sm.atd_s = float(cum[sm.cnt_s])
                rebuilt.append(sm)
                n_kept += 1
        self.submaps = rebuilt
        self.poses = [p for p in new_poses]
        self.atd = float(cum[-1])
        self._cached_target = None
        self._mom_valid = False
        self.last_pose = new_poses[-1].copy()
        self.remake_stats["calls"] += 1
        self.remake_stats["rebuilt"] += n_rebuilt
        self.remake_stats["kept"] += n_kept
