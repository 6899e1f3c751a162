"""Carry state from the JAX package, or from a checkpoint file, into
the port.

Turns arrays taken from `ndt_slam_tpu` objects (as numpy, through
`np.asarray`) into the port's objects: a SlamConfig from `to_dict()`,
PointBuffer, NDTGrid, CompactGrid, the moment lattice, and a FrontEnd
whose map and carries are restored from the fields of the checkpoint
format (`.npz` arrays and a JSON manifest) that both
`ndt_slam_tpu.pipeline.checkpoint` and the port's `pipeline.checkpoint`
write. `frontend_from_state` is the one reader of that format
(`pipeline.checkpoint.load_checkpoint` is built on it), the
loop-closure back end's state included.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import PointBuffer
from ndt_slam_tpu_torch.mapping.pointcloud_map import Submap
from ndt_slam_tpu_torch.ndt.compact import (
    CompactGrid, cell_slot_of_table, table_rows,
)
from ndt_slam_tpu_torch.ndt.grid import NDTGrid
from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd

_BACKEND_PREFIXES = ("be_", "kf_")


def stored_config(meta: Mapping) -> dict:
    """The manifest's config as SlamConfig keyword arguments: JSON lists
    back to tuples, and keys that are no SlamConfig fields (written by
    another build) dropped; fields the manifest lacks take their
    defaults."""
    known = {f.name for f in dataclasses.fields(SlamConfig)}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in meta["cfg"].items() if k in known}


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def point_buffer(xy, mask, device) -> PointBuffer:
    return PointBuffer(_t(xy, device, np.float32), _t(mask, device, bool))


def ndt_grid(g, device) -> NDTGrid:
    """From an `ndt_slam_tpu.ndt.grid.NDTGrid` (or anything with its
    fields)."""
    return NDTGrid(
        origin=_t(g.origin, device, np.float32),
        mean=_t(g.mean, device, np.float32),
        inv_cov=_t(g.inv_cov, device, np.float32),
        valid=_t(g.valid, device, bool),
        nx=int(g.nx), ny=int(g.ny), resolution=float(g.resolution),
    )


def compact_grid(cg, device) -> CompactGrid:
    """From an `ndt_slam_tpu.ndt.compact.CompactGrid`; the window index
    (`table`, `cell_slot`) is rebuilt from the table."""
    f32 = {k: _t(getattr(cg, k), device, np.float32)
           for k in ("kx", "ky", "mx", "my", "b00", "b01", "b11", "origin")}
    out = CompactGrid(valid=_t(cg.valid, device, bool), nx=int(cg.nx),
                      ny=int(cg.ny), resolution=float(cg.resolution), **f32)
    return out._replace(table=table_rows(out),
                        cell_slot=cell_slot_of_table(out))


def moment_lattice(mom, anchor, device):
    """(mom [B*B, 6] float32, anchor [2] int32) of an incremental
    moment lattice, on `device`."""
    return _t(mom, device, np.float32), _t(anchor, device, np.int32)


def read_checkpoint(path: str):
    """(arrays, manifest) of a checkpoint file, numpy and json only."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["manifest"]))
        arrays = {k: np.asarray(data[k]) for k in data.files
                  if k != "manifest"}
    return arrays, meta


def frontend_from_state(arrays: Mapping[str, np.ndarray], meta: Mapping,
                        device, cfg: Optional[SlamConfig] = None
                        ) -> FrontEnd:
    """A FrontEnd restored from checkpoint fields: `arrays` holds the
    `.npz` arrays, `meta` the JSON manifest. Without `cfg` the
    manifest's config is taken. A saved moment lattice is restored as it
    is (a rebuild would sum in another order); one of another size than
    `cfg` gives is left out, and the map rebuilds it on first use.

    The back end's state is restored into the front end's back end; a
    file that holds it for a config without `loop_enable` is refused
    (resuming with loops off would drop the graph)."""
    device = torch.device(device)
    if cfg is None:
        cfg = SlamConfig.from_dict(stored_config(meta))
    backend = [k for k in arrays if k.startswith(_BACKEND_PREFIXES)]
    if (meta.get("backend") is not None or backend) and not cfg.loop_enable:
        raise ValueError(
            "checkpoint holds loop-closure backend state "
            f"({backend or 'manifest'}), but the config has loop_enable off"
        )
    fe = FrontEnd(cfg, device)
    fe.cnt = int(meta["cnt"])
    fe.metrics = list(meta["metrics"])
    if meta["has_prev_odo"]:
        fe.prev_odo = np.asarray(arrays["prev_odo"], np.float32)
    if meta.get("has_init_pose"):
        fe.init_pose = np.asarray(arrays["init_pose"], np.float32)
    fe.last_cov = _t(arrays["last_cov"], device, np.float32)
    fe.pose_history = [p.astype(np.float32) for p in arrays["pose_history"]]
    fe.cov_history = [c.astype(np.float32) for c in arrays["cov_history"]]

    pm = fe.pcmap
    pm.atd = float(meta["pcmap"]["atd"])
    pm.poses = [p.astype(np.float32) for p in arrays["pcmap_poses"]]
    pm.last_pose = np.asarray(arrays["pcmap_last_pose"], np.float32)
    if meta["pcmap"].get("has_last_scan"):
        pm.last_scan = point_buffer(arrays["pcmap_last_scan_xy"],
                                    arrays["pcmap_last_scan_mask"], device)
    pm.local_scans = [
        np.asarray(arrays[f"local_scan_{i}"], np.float32)
        for i in range(int(meta["pcmap"].get("n_local_scans", 0)))
    ]
    # the device scan cache stays index-aligned with the host scans; a
    # rewrite pads and uploads a restored frame when it first needs it
    pm.local_scans_dev = [None] * len(pm.local_scans)
    if "pcmap_mom" in arrays:
        B = cfg.resolved_grid_mom_cells
        if arrays["pcmap_mom"].shape[0] == B * B:
            pm._mom, pm._mom_anchor = moment_lattice(
                arrays["pcmap_mom"], arrays["pcmap_mom_anchor"], device)
            pm._mom_valid = True
    pm.submaps = []
    for si, sd in enumerate(meta["pcmap"]["submaps"]):
        sm = Submap(cfg, float(sd["atd_s"]), int(sd["cnt_s"]), device)
        sm.cnt_e = sd["cnt_e"]
        sm.n_scans = int(sd["n_scans"])
        sm.is_first = bool(sd["is_first"])
        sm.proc = point_buffer(arrays[f"sm{si}_proc_xy"],
                               arrays[f"sm{si}_proc_mask"], device)
        sm.proc_count = _t(arrays[f"sm{si}_proc_count"], device, np.int32)
        sm.raw = [
            point_buffer(arrays[f"sm{si}_raw{ri}_xy"],
                         arrays[f"sm{si}_raw{ri}_mask"], device)
            for ri in range(int(sd["n_raw"]))
        ]
        if sd["has_final"]:
            sm.final_cloud = point_buffer(arrays[f"sm{si}_final_xy"],
                                          arrays[f"sm{si}_final_mask"],
                                          device)
        pm.submaps.append(sm)
    if meta.get("backend") is not None:
        _restore_backend(fe.backend, arrays, meta["backend"], device)
    return fe


def _restore_backend(be, arrays: Mapping[str, np.ndarray], bm: Mapping,
                     device) -> None:
    """The back end's graph, counters and keyframes from checkpoint
    fields; the keyframe scans go to `device` in two copies (points,
    masks), each row a view."""
    be.node_sids = [int(s) for s in bm["node_sids"]]
    be.node_poses_rad = [p.astype(np.float32)
                         for p in arrays["be_node_poses"]]
    be.loops_accepted = int(bm["loops_accepted"])
    # the drift accumulator and the deferred-optimisation state resume
    # exactly, or the candidate radius and the correction cadence change
    be._cum_pos_var = float(bm.get("cum_pos_var", 0.0))
    be._pending_edges = int(bm.get("pending_edges", 0))
    be._last_opt_node = int(bm.get("last_opt_node", -(10 ** 9)))
    be.odom_edges = [
        (row[:3].astype(np.float32),
         row[3:12].reshape(3, 3).astype(np.float32))
        for row in arrays["be_odom_edges"]
    ]
    be.loop_edges = [
        (int(row[0]), int(row[1]), row[2:5].astype(np.float32),
         row[5:14].reshape(3, 3).astype(np.float32))
        for row in arrays["be_loop_edges"]
    ]
    kf = be.keyframes
    kf.sids = [int(s) for s in bm["kf_sids"]]
    kf.pos_var = [float(v) for v in bm.get("kf_pos_var",
                                           [0.0] * len(kf.sids))]
    kf.poses_deg, kf.scan_xy, kf.scan_mask = [], [], []
    if kf.sids:
        kf.poses_deg = [p.astype(np.float32) for p in arrays["kf_poses"]]
        kf.scan_xy = list(_t(arrays["kf_scan_xy"], device,
                             np.float32).unbind(0))
        kf.scan_mask = list(_t(arrays["kf_scan_mask"], device,
                               bool).unbind(0))
