"""The control of the output check: the reference put in the program's
place, holding what it stores in bfloat16.

The configuration states float32. The front end's work is elementwise
arithmetic, 3x3 algebra and nearest-neighbour searches, where TF32
(which changes only matrix products) does not apply, so the nearest
lower precision is bfloat16: every scan it takes, every map point it
stores, every fused pose it carries and every corrected trajectory it
takes are rounded through bfloat16; the arithmetic between them is the
reference's own. A sound check reads this control as not correct.

`FrontEnd` chains the reference's steps (`reference/frontend.py`) into
the interface the drivers drive: `process`, `finalize`, the records,
the trajectory, the back end's edges and the stage timer."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from slambench.reference.frontend import RefFrontEnd, config


def _bf16(xy: torch.Tensor) -> torch.Tensor:
    return xy.to(torch.bfloat16).to(xy.dtype)


def _bf16_np(a) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return _bf16(torch.from_numpy(np.ascontiguousarray(a))).numpy()


class SlamConfig:
    @staticmethod
    def from_dict(slam: dict):
        return config(slam)


class StageTimer:
    """The stage timer's interface; the control's stages are not timed."""

    def __init__(self, device=None):
        self.ms = {}

    def mark(self, name):
        pass

    def resolve(self, wait=False):
        pass


class Target:
    def __init__(self, xy: torch.Tensor):
        self.xy = xy
        self.mask = torch.ones(len(xy), dtype=torch.bool, device=xy.device)


class FrontEnd:
    def __init__(self, cfg, device):
        self.ref = RefFrontEnd(cfg, device, hold=_bf16)
        self.cfg = cfg
        self.device = self.ref.device
        self.timer = StageTimer()
        self.pose_history, self.cov_history = [], []
        self.n_corrections = 0
        self.backend = (SimpleNamespace(loop_edges=[], edge_log=[],
                                        loops_accepted=0)
                        if cfg.loop_enable else None)
        self.pcmap = SimpleNamespace(
            registration_target=lambda: Target(self.ref.map.target()))

    def warmup(self):
        pass

    def process(self, scan_local, odo_pose_deg, sid=None):
        f = self.ref
        sid = f.cnt if sid is None else sid
        odo = np.asarray(odo_pose_deg, np.float32)
        scan = f.scan(scan_local)
        if f.cnt == 0:
            fused, cov = _bf16_np(odo), np.zeros((3, 3), np.float32)
            rec = {"sid": sid, "successful": True, "bootstrap": True,
                   "cost": 0.0, "iterations": 0}
        else:
            r = f.register(scan, odo)
            fused, cov = _bf16_np(r.fused), np.asarray(r.cov, np.float32)
            rec = {"sid": sid, "successful": bool(r.accept),
                   "cost": float(r.cost), "iterations": int(r.iterations),
                   "matched": float(r.matched)}
        rec["fused_pose"] = fused.tolist()
        f.commit(sid, scan, odo, fused, cov)
        self.pose_history.append(fused)
        self.cov_history.append(cov)
        if f.check_due():
            cand = f.graph.candidates(fused, sid)
            found = f.graph.check(sid, fused, scan, cand) if cand else {}
            if found:
                rows = {s: i for i, s in enumerate(f.graph.sids)}
                for s_old, (z, om) in found.items():
                    self.backend.loop_edges.append(
                        (rows[s_old], rows[sid],
                         np.asarray(z, np.float32), om))
                    self.backend.edge_log.append(
                        {"sid_old": s_old, "sid_new": sid,
                         "z_rad": list(map(float, z))})
                self.backend.loops_accepted += len(found)
                f.graph.add_loops(sid, found)
                poses = _bf16_np(f.graph.solve())
                f.correct(poses)
                self.pose_history = list(poses)
                self.n_corrections += 1
                rec["loop_closed"] = True
        return rec

    def finalize(self):
        pass

    def get_poses(self) -> np.ndarray:
        return np.asarray(self.pose_history, np.float32)


SYSTEM = dict(SlamConfig=SlamConfig, FrontEnd=FrontEnd,
              StageTimer=StageTimer)
