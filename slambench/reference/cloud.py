"""The reference's map: voxel centroids, the moving-object filter, and
submaps that make the registration target, as the upstream front end's
`PointCloudMap`/`Submap` define them.

A point set is a float32 tensor [n, 2] of its points, in the order in
which they were added: a submap's cloud is its processed points
followed by its newest raw scan, and the target the previous submap's
closed cloud followed by the open submap's cloud; each is cut at its
capacity. Scans are kept in the sensor frame, so a correction rewrites
the map through the corrected poses."""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference.geometry import to_map, wrap_deg

NN_CHUNK = 8192


def voxel_keys(xy: torch.Tensor, leaf: float) -> torch.Tensor:
    """int64 key of each point's voxel (edge `leaf`), from the float32
    coordinates; -1 out of the key range."""
    c = torch.floor(xy / np.float32(leaf)).to(torch.int64) + 32768
    ok = ((c >= 0) & (c < 65536)).all(-1)
    return torch.where(ok, c[:, 0] * 65536 + c[:, 1], -1)


def group_sums(keys: torch.Tensor, vals: torch.Tensor):
    """(keys, counts, float64 sums of `vals` [n, ...]) of each distinct
    key, in key order; summed in a fixed order (a sorted running sum),
    so that a rerun gives the same bits on any device."""
    keys, order = torch.sort(keys, stable=True)
    vals = vals[order].double()
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    ends = torch.cumsum(counts, 0)
    cs = torch.cat([vals.new_zeros((1,) + vals.shape[1:]),
                    torch.cumsum(vals, 0)])
    return uniq, counts, cs[ends] - cs[ends - counts]


def voxel_centroids(xy: torch.Tensor, leaf: float) -> torch.Tensor:
    """One point per occupied voxel, the mean of its points, in the
    order of the voxels' keys (x index, then y index)."""
    keys = voxel_keys(xy, leaf)
    keep = keys >= 0
    if not keep.any():
        return xy[:0]
    _, counts, sums = group_sums(keys[keep], xy[keep])
    return (sums / counts[:, None].double()).float()


def nn_sq(src: torch.Tensor, tgt: torch.Tensor, index: bool = False):
    """Squared distance (float64) from each point of `src` [N,2] to its
    nearest in `tgt` [M,2] (inf if `tgt` is empty); with `index` also
    that neighbour's index."""
    best = torch.full((len(src),), float("inf"), dtype=torch.float64,
                      device=src.device)
    arg = torch.zeros(len(src), dtype=torch.int64, device=src.device)
    s = src.double()
    for lo in range(0, len(tgt), NN_CHUNK):
        t = tgt[lo:lo + NN_CHUNK].double()
        d2 = ((s[:, None, :] - t[None, :, :]) ** 2).sum(-1)
        m, a = d2.min(1)
        better = m < best
        best = torch.where(better, m, best)
        arg = torch.where(better, a + lo, arg)
    return (best, arg) if index else best


def moving_filter(prev: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
                  resol: float, thre: float) -> torch.Tensor:
    """The points of `cur` kept by the moving-object filter: a point of
    `cur` whose `resol` voxel neither neighbour scan occupies has
    appeared (a moving object); every point within `thre` of one goes."""
    base = voxel_keys(torch.cat([prev, nxt]), resol)
    keys = voxel_keys(cur, resol)
    appeared = (keys >= 0) & ~torch.isin(keys, base[base >= 0])
    if not appeared.any():
        return cur
    d2 = nn_sq(cur, cur[appeared])
    return cur[d2 >= thre * thre]


class Submap:
    def __init__(self, cfg, atd_s: float, first: int, device):
        self.cfg = cfg
        self.atd_s = atd_s
        self.first = first            # node of its first own scan
        self.last = None              # node of its last scan, once closed
        self.proc = torch.zeros((0, 2), dtype=torch.float32, device=device)
        self.raw = []                 # its last three scans (map frame)
        self.n = 0
        self.closed = None

    def add(self, scan: torch.Tensor, carried: bool = False):
        """One map-frame scan; `carried` for the two the submap starts
        with from its predecessor."""
        cfg = self.cfg
        moving = cfg.remove_moving
        if moving:
            raw_in = self.first == 0 and self.n == 0
        else:
            raw_in = not (carried and self.first != 0)
        interior = moving and self.n >= 2
        self.raw = (self.raw + [scan])[-3:]
        self.n += 1
        cap = cfg.max_submap_points
        if raw_in:
            self.proc = torch.cat([self.proc, scan])[:cap]
        if interior:
            kept = moving_filter(*self.raw, cfg.diff_resol,
                                 cfg.thre_neighbor)
            self.proc = torch.cat([self.proc, kept])[:cap]

    def cloud(self) -> torch.Tensor:
        if self.cfg.remove_moving and self.raw:
            return torch.cat([self.proc, self.raw[-1]]
                             )[:self.cfg.max_submap_points]
        return self.proc

    def close(self):
        self.closed = voxel_centroids(self.cloud(), self.cfg.submap_leaf_size)


class Map:
    """Poses, submaps and the sensor-frame scans of every node."""

    def __init__(self, cfg, device, hold=None):
        self.cfg = cfg
        self.device = device
        self.hold = hold or (lambda xy: xy)   # the precision points keep
        self.poses = []               # float32 [3] per node
        self.scans = []               # float32 tensors [n,2], sensor frame
        self.atd = 0.0
        self.submaps = [Submap(cfg, 0.0, 0, device)]

    def add(self, pose_deg, scan_local: torch.Tensor):
        """A node at `pose_deg` with its sensor-frame scan."""
        pose = np.asarray(pose_deg, np.float32)
        if self.poses:
            last = self.poses[-1]
            # travelled distance: float32 steps summed in float64
            self.atd += float(np.hypot(pose[0] - last[0], pose[1] - last[1]))
        self.poses.append(pose)
        self.scans.append(scan_local)
        scan = self.hold(to_map(pose, scan_local))
        cur = self.submaps[-1]
        if self.atd - cur.atd_s >= self.cfg.submap_sep_thre:
            cur.last = len(self.poses) - 2
            cur.close()
            new = Submap(self.cfg, self.atd, len(self.poses) - 1,
                         self.device)
            for s in cur.raw[-2:]:
                new.add(s, carried=True)
            new.add(scan)
            self.submaps.append(new)
        else:
            cur.add(scan)

    def target(self) -> torch.Tensor:
        """What the next scan registers against."""
        cur = self.submaps[-1].cloud()
        if len(self.submaps) >= 2:
            cur = torch.cat([self.submaps[-2].closed, cur])
        return cur[:self.cfg.max_local_map_points]

    def last_pose(self) -> np.ndarray:
        return self.poses[-1]

    def closes_next(self, pose_deg) -> bool:
        """Whether a node at `pose_deg` would close the open submap."""
        pose = np.asarray(pose_deg, np.float32)
        last = self.poses[-1]
        atd = self.atd + float(np.hypot(pose[0] - last[0],
                                        pose[1] - last[1]))
        return atd - self.submaps[-1].atd_s >= self.cfg.submap_sep_thre

    def rewrite(self, new_poses):
        """The map through corrected poses: a closed submap whose poses
        (its own and the two it was seeded with) all moved less than
        `remake_thresh_trans` m and `remake_thresh_rot` deg stays as it
        is; every other submap, and always the open one, is built again
        over the same nodes."""
        cfg = self.cfg
        new = np.asarray(new_poses, np.float32)
        old = np.asarray(self.poses, np.float32)
        moved = ((np.hypot(new[:, 0] - old[:, 0], new[:, 1] - old[:, 1])
                  > cfg.remake_thresh_trans)
                 | (np.abs(wrap_deg(new[:, 2] - old[:, 2]))
                    > cfg.remake_thresh_rot))
        steps = np.hypot(np.diff(new[:, 0]), np.diff(new[:, 1]))
        travelled = np.concatenate([[0.0], np.cumsum(steps)])
        out = []
        for k, sm in enumerate(self.submaps):
            is_open = k == len(self.submaps) - 1
            end = len(new) if is_open else sm.last + 1
            lo = max(0, sm.first - 2)
            atd_s = float(travelled[sm.first])
            if is_open or moved[lo:end].any():
                sm = self._rebuild(sm, new, lo, end, atd_s, is_open)
            sm.atd_s = atd_s
            out.append(sm)
        self.submaps = out
        self.poses = list(new)
        self.atd = float(travelled[-1])

    def _rebuild(self, sm, new, lo, end, atd_s, is_open) -> Submap:
        fresh = Submap(self.cfg, atd_s, sm.first, self.device)
        for k in range(lo, end):
            fresh.add(self.hold(to_map(new[k], self.scans[k])),
                      carried=k < sm.first)
        if not is_open:
            fresh.last = sm.last
            fresh.close()
        return fresh
