"""Pose-graph back end: nodes, edges, loop detection, optimisation (port
of `ndt_slam_tpu.graph.backend`).

Every processed frame becomes a graph node, odometry edges chain
consecutive fused poses, and accepted loop closures add long-range
edges. After an accepted loop (or a burst of them, with
`loop_opt_min_frames`) the whole trajectory is optimised
(`graph/pose_graph.py`) and the caller rewrites its pose history and
map (`PointCloudMap.remake_maps`).

Bookkeeping is host numpy; a verification is one batched call of
`verify_candidates` on the device of the scans, whose [B,16] result
travels to the host in one copy. That copy is started at dispatch
(non-blocking, into pinned memory) and marked with a CUDA event;
`_resolve_verify` waits on the event, right after the dispatch or, with
`loop_verify_async`, at the next check, so that the verification and
its copy overlap the frames in between.

With a mesh, the verification fans out over its "dp" ranks
(`graph/loop_closure.make_sharded_verify`): every rank holds the same
bookkeeping, passes the whole candidate batch, verifies its slice and
receives every row. The batch capacity is rounded up to the "dp" size.
The batch is assembled on the host from a cache of the keyframes' scans
(one device-to-host copy per keyframe ever, not per check) and goes to
the device in one copy; `_evict_stale_scan_cache` drops the entries of
keyframes the store has decimated away.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.angles import sub_deg
from ndt_slam_tpu_torch.core.points import PAD_COORD, PointBuffer
from ndt_slam_tpu_torch.graph.keyframes import KeyframeStore
from ndt_slam_tpu_torch.graph.loop_closure import (
    make_sharded_verify, pack_verify_out, unpack_verify_row,
    verify_candidates,
)
from ndt_slam_tpu_torch.graph.pose_graph import (
    optimize, optimize_hierarchical, pack_graph,
)

_DEG = np.float32(np.pi / 180.0)


def _pose_deg_to_rad(p):
    return np.array([p[0], p[1], np.deg2rad(p[2])], np.float32)


def _pose_rad_to_deg(p):
    return np.array([p[0], p[1], np.rad2deg(p[2])], np.float32)


def _cal_motion_np(cur_deg: np.ndarray, prev_deg: np.ndarray) -> np.ndarray:
    """cur (-) prev in prev's robot frame, on the host (pose2.cal_motion's
    math; the back end runs it every frame)."""
    dx = float(cur_deg[0]) - float(prev_deg[0])
    dy = float(cur_deg[1]) - float(prev_deg[1])
    th = np.radians(float(prev_deg[2]))
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [c * dx + s * dy, -s * dx + c * dy,
         sub_deg(float(cur_deg[2]), float(prev_deg[2]))],
        np.float32,
    )


def pos_var(cov_deg: np.ndarray) -> float:
    """Largest eigenvalue of the 2x2 position block of a pose covariance
    (closed form): the drift scale for the candidate search."""
    a, b, c = float(cov_deg[0, 0]), float(cov_deg[0, 1]), float(cov_deg[1, 1])
    h = 0.5 * (a + c)
    return max(0.0, h + np.sqrt(max(0.0, (0.5 * (a - c)) ** 2 + b * b)))


class GraphBackend:
    """Host bookkeeping plus verification and optimisation on `device`;
    with `mesh`, the verification sharded over its "dp" ranks."""

    def __init__(self, cfg: SlamConfig, device, mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.keyframes = KeyframeStore(cfg)
        self.node_poses_rad: List[np.ndarray] = []   # per frame
        self.node_sids: List[int] = []
        # odometry chain: edge k connects nodes (k, k+1); kept apart from
        # the loop edges so that the hierarchical solver can condense it
        self.odom_edges: List[tuple] = []             # (z_rad[3], omega[3,3])
        self.loop_edges: List[tuple] = []             # (i, j, z_rad, omega)
        self.loops_accepted = 0
        # per accepted edge: sids, measurement, gates, information spectrum
        self.edge_log: List[dict] = []
        # deferred optimisation (cfg.loop_opt_min_frames): edges accepted
        # since the last correction, and the node it ran at
        self._pending_edges = 0
        self._last_opt_node = -(10 ** 9)
        # summed per-frame position variance (chain model), for the
        # drift-aware candidate radius
        self._cum_pos_var = 0.0
        self._batch_capacity = cfg.loop_max_candidates
        self.mesh = mesh
        self._verify_sharded = None
        # the sharded path's host copies of keyframe scans, by sid
        self._host_scan_cache: dict = {}
        if mesh is not None:
            from ndt_slam_tpu_torch.parallel.mesh import axis_size
            dp = axis_size(mesh, "dp")
            self._batch_capacity = -(-cfg.loop_max_candidates // dp) * dp
            self._verify_sharded = make_sharded_verify(mesh, cfg)
        self.verify_async = cfg.resolved_loop_verify_async(self.device.type)
        # a dispatched verification: (sid, candidate sids, packed device
        # rows, host rows, event marking the host copy's end or None)
        self._inflight = None
        self._dummy_scan: Optional[PointBuffer] = None
        # host rows of the in-flight verification fed by a caller that
        # fetched them with its own copy: (packed, rows)
        self._prefetched: Optional[tuple] = None
        # wall time: verification (dispatch + fetch) and pose-graph solves
        self.t_verify = 0.0
        self.t_optimize = 0.0
        # stage marks of the caller's timer (FrontEnd sets it)
        self.mark = lambda name: None

    # ---- graph growth --------------------------------------------------
    def add_frame(self, sid: int, fused_pose_deg: np.ndarray,
                  cov_deg: np.ndarray, scan_local: PointBuffer) -> int:
        """Register a processed frame as a node and chain an odometry
        edge from the previous node. cov_deg: the fused covariance
        (theta in degrees)."""
        pose_rad = _pose_deg_to_rad(np.asarray(fused_pose_deg, np.float32))
        node = len(self.node_poses_rad)
        self.node_poses_rad.append(pose_rad)
        self.node_sids.append(int(sid))
        # chain-model drift: the fused covariance of a frame is about the
        # step's relative uncertainty, and independent steps add up, so
        # cum_now - cum_k is the variance relative to keyframe k
        self._cum_pos_var += pos_var(np.asarray(cov_deg))
        if node > 0:
            prev_deg = _pose_rad_to_deg(self.node_poses_rad[node - 1])
            z_deg = _cal_motion_np(np.asarray(fused_pose_deg, np.float32),
                                   prev_deg)
            self.odom_edges.append((_pose_deg_to_rad(z_deg),
                                    self._odom_information(cov_deg)))
        if node % max(1, self.cfg.loop_keyframe_skip) == 0:
            self.keyframes.add(sid, fused_pose_deg, scan_local,
                               pos_var=self._cum_pos_var)
        return node

    def _odom_information(self, cov_deg: np.ndarray) -> np.ndarray:
        """3x3 information of an odometry edge, radians; the covariance
        is floored so that a near-zero EKF covariance does not over-pin
        the edge."""
        J = np.diag([1.0, 1.0, float(_DEG)])
        cov_rad = J @ np.asarray(cov_deg, np.float64) @ J.T
        cov_rad += np.diag([1e-4, 1e-4, (0.2 * _DEG) ** 2])
        return np.linalg.inv(cov_rad).astype(np.float32)

    # ---- loop closure --------------------------------------------------
    def try_close(self, sid: int, fused_pose_deg: np.ndarray,
                  scan_local: PointBuffer) -> Optional[np.ndarray]:
        """Detect, verify and (possibly deferred) optimise. Returns the
        corrected per-frame poses [n_frames, 3] (degrees) when a
        correction ran, else None. With cfg.loop_opt_min_frames > 0,
        accepted edges accumulate and a correction runs at most once per
        that many frames."""
        cfg = self.cfg
        t0 = time.perf_counter()
        # the previous check's verification first (async mode)
        self._resolve_verify()
        cand = self.keyframes.candidates(
            np.asarray(fused_pose_deg), sid,
            max_candidates=cfg.loop_max_candidates,
            cur_pos_var=self._cum_pos_var,
        )
        if cand:
            self._dispatch_verify(sid, fused_pose_deg, scan_local, cand)
            if not self.verify_async:
                self._resolve_verify()
        self.t_verify += time.perf_counter() - t0
        self.mark("verify")
        if self._pending_edges == 0:
            return None
        node_now = len(self.node_poses_rad) - 1
        if node_now - self._last_opt_node < cfg.loop_opt_min_frames:
            return None
        self._last_opt_node = node_now
        self._pending_edges = 0
        return self._timed_optimize()

    def correction_due(self, node_idx: int) -> bool:
        """Would a frame landing at graph node `node_idx` trigger a
        deferred correction at its back-end check? Agrees with
        try_close's own condition (for schedulers that predict
        corrections ahead of resolution). Edges still in async flight
        are not counted."""
        if self._pending_edges <= 0:
            return False
        if node_idx % max(1, self.cfg.loop_check_skip) != 0:
            return False
        return node_idx - self._last_opt_node >= self.cfg.loop_opt_min_frames

    def _evict_stale_scan_cache(self) -> None:
        """Drop the sharded path's host copies of keyframes no longer in
        the store (decimation); it would grow without bound otherwise."""
        live = set(self.keyframes.sids)
        if len(self._host_scan_cache) > len(live):
            for s_k in list(self._host_scan_cache):
                if s_k not in live:
                    del self._host_scan_cache[s_k]

    def _dispatch_verify(self, sid: int, fused_pose_deg: np.ndarray,
                         scan_local: PointBuffer, cand: List[int]) -> None:
        """Dispatch the batched verification of the candidate keyframes:
        their scans (device references) stacked on the device with
        masked filler rows up to the batch capacity (with a mesh:
        assembled on the host from the scan cache and sent in one
        copy), the result packed into one [B,16] array whose copy to the
        host starts now."""
        B = self._batch_capacity
        S = scan_local.xy.shape[0]
        init = np.zeros((B, 3), np.float32)
        for b, k in enumerate(cand):
            init[b] = _pose_deg_to_rad(_cal_motion_np(
                np.asarray(fused_pose_deg, np.float32),
                self.keyframes.poses_deg[k]))
        init_dev = torch.from_numpy(init).to(self.device)
        if self._verify_sharded is not None:
            self._evict_stale_scan_cache()
            tgt = np.zeros((B, S, 3), np.float32)   # x, y, mask
            tgt[:, :, :2] = PAD_COORD
            for b, k in enumerate(cand):
                s_k = self.keyframes.sids[k]
                row = self._host_scan_cache.get(s_k)
                if row is None:
                    row = np.concatenate([
                        self.keyframes.scan_xy[k].cpu().numpy(),
                        self.keyframes.scan_mask[k].cpu().numpy()[:, None],
                    ], axis=1).astype(np.float32)
                    self._host_scan_cache[s_k] = row
                tgt[b] = row[:S]
            tgt = torch.from_numpy(tgt).to(self.device)
            out = self._verify_sharded(
                scan_local.xy, scan_local.mask,
                tgt[..., :2].contiguous(), tgt[..., 2] > 0.5, init_dev)
        else:
            if self._dummy_scan is None or self._dummy_scan.capacity != S:
                self._dummy_scan = PointBuffer.empty(S, self.device)
            fill = B - len(cand)
            out = verify_candidates(
                self.cfg, scan_local.xy, scan_local.mask,
                torch.stack([self.keyframes.scan_xy[k] for k in cand]
                            + [self._dummy_scan.xy] * fill),
                torch.stack([self.keyframes.scan_mask[k] for k in cand]
                            + [self._dummy_scan.mask] * fill),
                init_dev,
            )
        packed = pack_verify_out(out)
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = packed, None
        # candidate sids, not store indices: a decimation of the store
        # between dispatch and resolve would move the indices
        cand_sids = [self.keyframes.sids[k] for k in cand]
        self._inflight = (sid, cand_sids, packed, host, done)

    def inflight_packed(self):
        """The in-flight verification's packed device rows, or None (for
        a caller that fetches them together with its own outputs)."""
        return self._inflight[2] if self._inflight is not None else None

    def feed_prefetched(self, rows: np.ndarray) -> None:
        """Hand over the host copy of the in-flight verification's rows;
        the next `_resolve_verify` takes them instead of its own copy,
        once, and only for the verification they were fetched for."""
        if self._inflight is not None:
            self._prefetched = (self._inflight[2], np.asarray(rows))

    def _resolve_verify(self) -> None:
        """Resolve an in-flight verification (waiting for its host copy)
        and add its accepted edges."""
        if self._inflight is None:
            return
        sid, cand_sids, packed, host, done = self._inflight
        self._inflight = None
        pf, self._prefetched = self._prefetched, None
        if pf is not None and pf[0] is packed:
            rows = pf[1]
        else:
            if done is not None:
                done.synchronize()
            rows = host.numpy()

        sid_rows = {s: i for i, s in enumerate(self.node_sids)}
        cur_node = sid_rows.get(sid)
        if cur_node is None:
            return
        cfg = self.cfg
        for b, sid_old in enumerate(cand_sids):
            (z_rad, cost_b, overlap_b, overlap_tgt_b, accepted_b,
             H) = unpack_verify_row(rows[b])
            if not accepted_b:
                continue
            old_node = sid_rows.get(sid_old)
            if old_node is None:
                continue
            # Degeneracy-aware, noise-calibrated information. Its shape is
            # the fine stage's Hessian spectrum: in a corridor the
            # along-axis eigenvalue is orders of magnitude below the
            # others, and a slid but locally perfect match is wrong
            # exactly along that direction, so the weight follows the
            # spectrum down. Its scale calibrates the strongest
            # direction to the verify residual: sigma =
            # max(sqrt(icp mean squared error), loop_info_sigma_floor).
            w, V = np.linalg.eigh((H + H.T) / 2)
            w = np.clip(w, 0.0, None)
            wmax = max(float(w[-1]), 1e-9)
            sigma = max(np.sqrt(max(cost_b, 0.0)), cfg.loop_info_sigma_floor)
            omega = (V * (w * ((1.0 / sigma ** 2) / wmax))) @ V.T
            self.loop_edges.append(
                (old_node, cur_node, z_rad, omega.astype(np.float32)))
            self.edge_log.append({
                "sid_old": int(sid_old), "sid_new": int(sid),
                "z_rad": z_rad.tolist(), "cost": cost_b,
                "overlap": overlap_b, "overlap_tgt": overlap_tgt_b,
                "eigs": np.linalg.eigvalsh((H + H.T) / 2).tolist(),
            })
            self.loops_accepted += 1
            self._pending_edges += 1

    def flush(self) -> Optional[np.ndarray]:
        """Resolve a verification still in flight and apply deferred
        loop edges (end of run)."""
        t0 = time.perf_counter()
        self._resolve_verify()
        self.t_verify += time.perf_counter() - t0
        if self._pending_edges == 0:
            return None
        self._pending_edges = 0
        self._last_opt_node = len(self.node_poses_rad) - 1
        return self._timed_optimize()

    # ---- optimisation --------------------------------------------------
    def _timed_optimize(self) -> np.ndarray:
        t0 = time.perf_counter()
        out = self.optimize_all()
        self.t_optimize += time.perf_counter() - t0
        return out

    def edge_arrays(self):
        """(chain_z [n-1,3], chain_omega, loop_i, loop_j, loop_z [L,3],
        loop_omega) as host arrays: the graph's edges as the solvers
        take them."""
        odom, loops = self.odom_edges, self.loop_edges
        return (
            (np.stack([z for z, _ in odom]) if odom
             else np.zeros((0, 3), np.float32)),
            (np.stack([w for _, w in odom]) if odom
             else np.zeros((0, 3, 3), np.float32)),
            np.array([i for i, _, _, _ in loops], np.int32),
            np.array([j for _, j, _, _ in loops], np.int32),
            (np.stack([z for _, _, z, _ in loops]) if loops
             else np.zeros((0, 3), np.float32)),
            (np.stack([w for _, _, _, w in loops]) if loops
             else np.zeros((0, 3, 3), np.float32)),
        )

    def optimize_all(self) -> np.ndarray:
        """Optimise the whole graph, update the node and keyframe poses,
        and return the corrected per-frame poses (degrees).

        Up to `cfg.pgo_dense_max_nodes` nodes the dense GN solve runs
        on the [3N,3N] system (N the node count padded to a power of two,
        at least 16); above, the hierarchical solver (chain condensation,
        a dense coarse solve, a matrix-free PCG polish)."""
        cfg = self.cfg
        n = len(self.node_poses_rad)
        poses = np.stack(self.node_poses_rad)
        edges = self.edge_arrays()
        if n > cfg.pgo_dense_max_nodes and len(self.odom_edges) == n - 1:
            new_poses = optimize_hierarchical(
                poses, *edges,
                seg_len=cfg.pgo_seg_len,
                coarse_iterations=cfg.pgo_iterations,
                fine_iterations=cfg.pgo_fine_iterations,
                cg_iters=cfg.pgo_cg_iters,
                cycles=cfg.pgo_cycles,
                device=self.device,
            )
        else:
            g = pack_graph(poses, *edges, self.device)
            new_poses, _chi2 = optimize(g, iterations=cfg.pgo_iterations)
            new_poses = new_poses[:n].cpu().numpy()
        self.node_poses_rad = [p.copy() for p in new_poses]

        out_deg = np.stack([_pose_rad_to_deg(p) for p in new_poses])
        sid_rows = {v: i for i, v in enumerate(self.node_sids)}
        self.keyframes.update_poses(out_deg, sid_rows.get)
        return out_deg
