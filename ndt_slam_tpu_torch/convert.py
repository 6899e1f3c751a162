"""Carry state from the JAX package into the port.

Turns arrays taken from `ndt_slam_tpu` objects (as numpy, through
`np.asarray`) into the port's objects: a SlamConfig from `to_dict()`,
PointBuffer, NDTGrid, CompactGrid, and a FrontEnd whose map and carries
are restored from the fields that
`ndt_slam_tpu.pipeline.checkpoint.save_checkpoint` writes (its `.npz`
arrays and JSON manifest). `load_checkpoint` reads such a file with
numpy and json only; it refuses loop-closure backend state (not ported)
and never writes a checkpoint.
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Optional

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


def config_from_dict(d: Mapping[str, Any]) -> SlamConfig:
    """SlamConfig from `SlamConfig.to_dict()` (JSON lists -> tuples)."""
    return SlamConfig.from_dict(
        {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    )


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


def frontend_from_state(arrays: Mapping[str, np.ndarray], meta: Mapping,
                        device, cfg: Optional[SlamConfig] = None
                        ) -> FrontEnd:
    """A FrontEnd restored from checkpoint fields: `arrays` holds the
    `.npz` arrays, `meta` the JSON manifest."""
    backend = [k for k in arrays if k.startswith(_BACKEND_PREFIXES)]
    if meta.get("backend") is not None or backend:
        raise ValueError(
            "checkpoint holds loop-closure backend state "
            f"({backend or 'manifest'}), which the port does not have"
        )
    device = torch.device(device)
    if cfg is None:
        cfg = config_from_dict(meta["cfg"])
    fe = FrontEnd(cfg, device)
    fe.cnt = int(meta["cnt"])
    fe.metrics = list(meta["metrics"])
    if meta["has_prev_odo"]:
        fe.prev_odo = np.asarray(arrays["prev_odo"], np.float32)
    fe.last_cov = _t(arrays["last_cov"], device, np.float32)
    fe.pose_history = [p.astype(np.float32) for p in arrays["pose_history"]]
    fe.cov_history = [c.astype(np.float32) for c in arrays["cov_history"]]

    pm = fe.pcmap
    pm.atd = float(meta["pcmap"]["atd"])
    pm.poses = [p.astype(np.float32) for p in arrays["pcmap_poses"]]
    pm.last_pose = np.asarray(arrays["pcmap_last_pose"], np.float32)
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
    return fe


def load_checkpoint(path: str, device,
                    cfg: Optional[SlamConfig] = None) -> FrontEnd:
    """Read a checkpoint written by the JAX package and restore it as a
    FrontEnd of the port on `device`."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["manifest"]))
        arrays = {k: np.asarray(data[k]) for k in data.files
                  if k != "manifest"}
    return frontend_from_state(arrays, meta, device, cfg)
