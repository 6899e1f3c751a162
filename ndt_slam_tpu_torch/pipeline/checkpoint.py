"""Checkpoint and exact resume of a running front end and its
loop-closure back end (port of `ndt_slam_tpu.pipeline.checkpoint`).

The format is the JAX package's, key for key, so either package reads
the other's file: one `.npz` holding every array plus a JSON manifest
(`cnt`, `metrics`, `cfg`, the map's structure). Everything is host
numpy at rest; device buffers are rebuilt on load. A run interrupted
at frame k, saved, loaded and continued gives the trajectory of the
uninterrupted run bit for bit: the saved arrays are the very bits the
run held, and the incremental moment lattice is saved, not rebuilt,
because a rebuild sums in another order. The back end's graph (`be_*`:
node poses, odometry and loop edges), its keyframes (`kf_*`: poses and
scans) and its counters (the manifest's `backend` entry) are saved
after a verification still in flight is resolved into edges, as the JAX
package does.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ndt_slam_tpu_torch import convert
from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd


def _fetch(tensors: dict) -> dict:
    """Host numpy copies of `tensors` (name -> tensor, one device) in
    one device-to-host copy: the tensors travel as one byte buffer."""
    if not tensors:
        return {}
    flat = [t.contiguous().reshape(-1).view(torch.uint8)
            for t in tensors.values()]
    host = torch.cat(flat).cpu().numpy()
    out, at = {}, 0
    for (name, t), f in zip(tensors.items(), flat):
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        out[name] = (host[at:at + f.numel()].view(dtype)
                     .reshape(tuple(t.shape)).copy())
        at += f.numel()
    return out


def save_checkpoint(fe: FrontEnd, path: str) -> None:
    """Write the complete front-end state to `path` (.npz), through
    `path + ".tmp.npz"` and an atomic rename."""
    pm = fe.pcmap
    be = fe.backend
    if be is not None:
        # a verification in flight would be lost across a resume
        be._resolve_verify()
    meta = {
        "cnt": fe.cnt,
        "has_prev_odo": fe.prev_odo is not None,
        "has_init_pose": fe.init_pose is not None,
        "metrics": fe.metrics,
        "cfg": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in fe.cfg.to_dict().items()
        },
        "pcmap": {
            "atd": pm.atd,
            "has_last_scan": pm.last_scan is not None,
            "n_submaps": len(pm.submaps),
            "submaps": [],
            "n_local_scans": len(pm.local_scans),
        },
        "backend": None,
    }
    arrays = {}
    if fe.prev_odo is not None:
        arrays["prev_odo"] = np.asarray(fe.prev_odo)
    if fe.init_pose is not None:
        arrays["init_pose"] = np.asarray(fe.init_pose)
    arrays["pose_history"] = (
        np.stack(fe.pose_history) if fe.pose_history
        else np.zeros((0, 3), np.float32)
    )
    arrays["cov_history"] = (
        np.stack(fe.cov_history) if fe.cov_history
        else np.zeros((0, 3, 3), np.float32)
    )
    arrays["pcmap_poses"] = (
        np.stack(pm.poses) if pm.poses else np.zeros((0, 3), np.float32)
    )
    arrays["pcmap_last_pose"] = np.asarray(pm.last_pose)
    for i, s in enumerate(pm.local_scans):
        arrays[f"local_scan_{i}"] = np.asarray(s)

    dev = {"last_cov": fe.last_cov}

    def put(name: str, buf):
        dev[name + "_xy"], dev[name + "_mask"] = buf.xy, buf.mask

    if pm.last_scan is not None:
        put("pcmap_last_scan", pm.last_scan)
    if pm._mom_valid and pm._mom is not None:
        dev["pcmap_mom"] = pm._mom
        dev["pcmap_mom_anchor"] = pm._mom_anchor
    for si, sm in enumerate(pm.submaps):
        meta["pcmap"]["submaps"].append({
            "atd_s": sm.atd_s, "cnt_s": sm.cnt_s, "cnt_e": sm.cnt_e,
            "n_scans": sm.n_scans, "is_first": sm.is_first,
            "n_raw": len(sm.raw),
            "has_final": sm.final_cloud is not None,
        })
        put(f"sm{si}_proc", sm.proc)
        dev[f"sm{si}_proc_count"] = sm.proc_count
        for ri, rb in enumerate(sm.raw):
            put(f"sm{si}_raw{ri}", rb)
        if sm.final_cloud is not None:
            put(f"sm{si}_final", sm.final_cloud)
    if be is not None:
        _backend_state(be, meta, arrays, dev)
    arrays.update(_fetch(dev))

    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, manifest=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def _backend_state(be, meta: dict, arrays: dict, dev: dict) -> None:
    """The back end's half: counters in the manifest, the graph as host
    arrays, the keyframe scans (device tensors) into `dev` for the one
    device-to-host copy."""
    kf = be.keyframes
    meta["backend"] = {
        "node_sids": be.node_sids,
        "n_odom_edges": len(be.odom_edges),
        "n_loop_edges": len(be.loop_edges),
        "loops_accepted": be.loops_accepted,
        "kf_sids": kf.sids,
        "kf_pos_var": kf.pos_var,
        "cum_pos_var": be._cum_pos_var,
        "pending_edges": be._pending_edges,
        "last_opt_node": be._last_opt_node,
    }
    arrays["be_node_poses"] = (
        np.stack(be.node_poses_rad) if be.node_poses_rad
        else np.zeros((0, 3), np.float32)
    )
    # odometry chain: edge k connects nodes (k, k+1); [K, 12] rows
    arrays["be_odom_edges"] = (
        np.stack([np.concatenate([z, om.reshape(-1)])
                  for z, om in be.odom_edges])
        if be.odom_edges else np.zeros((0, 12), np.float32)
    )
    arrays["be_loop_edges"] = (
        np.stack([np.concatenate([np.array([i, j], np.float32), z,
                                  om.reshape(-1)])
                  for i, j, z, om in be.loop_edges])
        if be.loop_edges else np.zeros((0, 14), np.float32)
    )
    if kf.sids:
        arrays["kf_poses"] = np.stack(kf.poses_deg)
        dev["kf_scan_xy"] = torch.stack(kf.scan_xy)
        dev["kf_scan_mask"] = torch.stack(kf.scan_mask)


def load_checkpoint(path: str, device, cfg: Optional[SlamConfig] = None,
                    strict: bool = True) -> FrontEnd:
    """Rebuild a FrontEnd on `device` from a checkpoint; resumes exactly.

    A `cfg` that is passed must match the stored config (`strict`, the
    default): capacities size every restored buffer and start_frame
    anchors the resume-skip count. `end_frame` and `draw_skip` only
    steer the outer loop and may differ; keys only one side knows
    (another build's manifest) are not compared. Pass strict=False to
    override knowingly."""
    arrays, meta = convert.read_checkpoint(path)
    if cfg is not None and strict:
        stored = convert.stored_config(meta)
        exempt = {"end_frame", "draw_skip"}
        diff = {
            k: (stored[k], v) for k, v in cfg.to_dict().items()
            if k not in exempt and k in stored and stored[k] != v
        }
        if diff:
            raise ValueError(
                f"config mismatch vs checkpoint {path}: "
                + ", ".join(
                    f"{k}: checkpoint={a!r} requested={b!r}"
                    for k, (a, b) in sorted(diff.items())
                )
                + " (pass strict=False to override)"
            )
    return convert.frontend_from_state(arrays, meta, device, cfg)
