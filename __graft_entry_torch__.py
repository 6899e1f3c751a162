"""Entry points of the PyTorch/CUDA port: the per-frame step with
example arguments, and a multi-device dry run.

`entry(device)` returns the port's per-frame registration step
(`ndt_slam_tpu_torch/pipeline/frontend._registration_step`:
registration + fusion) and example arguments on `device`, at the sizes
of `__graft_entry__.entry`: a 96 x 96 window, a 2048-slot scan holding a
541-beam room scan, an 8192-slot target holding a 1081-beam one.

`dryrun_multichip(n, device)` spawns n ranks (`parallel.spawn`, the
rank function `parallel/jobs.dryrun`) and runs on a
`balanced_factors(n)` (dp, pt) mesh the sharded frame step, the sharded
sequential step, the sharded pose-graph solve and the sharded
loop-closure verify, at the sizes of `__graft_entry__.dryrun_multichip`;
every output must be finite and every rank must return the same bits.

Both run on the card unless the caller passes device="cpu" (the plain
PyTorch twins); on "cuda" without a card they raise. A script that
calls `dryrun_multichip` guards its top level with
`if __name__ == "__main__":`, since the spawned ranks re-import it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _room_scan(n, pose=(0.0, 0.0, 0.0), noise=0.01, seed=0):
    """Analytic rectangular-room LiDAR scan (no simulator dependency)."""
    rng = np.random.default_rng(seed)
    tx, ty, th = pose
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    pts = np.empty((n, 2), np.float32)
    for i, a in enumerate(angles):
        wa = a + th
        dx, dy = np.cos(wa), np.sin(wa)
        ts = []
        if dx > 1e-9:
            ts.append((5.0 - tx) / dx)
        if dx < -1e-9:
            ts.append((-5.0 - tx) / dx)
        if dy > 1e-9:
            ts.append((4.0 - ty) / dy)
        if dy < -1e-9:
            ts.append((-4.0 - ty) / dy)
        t = min(t for t in ts if t > 0) + noise * rng.standard_normal()
        pts[i] = (t * np.cos(a), t * np.sin(a))
    return pts


def _device(device):
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "plain PyTorch twins")
    return device


def entry(device="cuda"):
    """(fn, example_args): the per-frame step and its inputs on `device`;
    fn(*example_args) is a `FrameResult`."""
    import torch

    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.core.points import pad_points
    from ndt_slam_tpu_torch.pipeline.frontend import _registration_step

    device = _device(device)
    cfg = SlamConfig(
        grid_cells_x=96, grid_cells_y=96,
        ndt_min_points_per_cell=3,
        max_scan_points=2048,
    )
    scan = pad_points(_room_scan(541, pose=(0.03, 0.02, 0.02)), 2048, device)
    local = pad_points(_room_scan(1081, seed=1), 8192, device)

    def fn(scan_xy, scan_mask, odo, prev_odo, last_pose, last_cov,
           local_xy, local_mask):
        return _registration_step(
            cfg, scan_xy, scan_mask, odo, prev_odo, last_pose, last_cov,
            local_xy, local_mask,
        )

    f32 = dict(dtype=torch.float32, device=device)
    example_args = (
        scan.xy, scan.mask,
        torch.tensor([0.03, 0.02, 1.0], **f32),
        torch.zeros(3, **f32),
        torch.zeros(3, **f32),
        torch.eye(3, **f32) * 1e-4,
        local.xy, local.mask,
    )
    return fn, example_args


def _chain_graph(n_devices: int) -> dict:
    """The dry run's 16-node chain: max(16, n) edges of 0.1 m along x,
    information 100, as numpy `PoseGraph` fields."""
    N, E = 16, max(16, n_devices)
    ii = np.arange(E, dtype=np.int64) % (N - 1)
    poses = np.zeros((N, 3), np.float32)
    poses[:, 0] = np.arange(N) * 0.1
    return {"poses": poses, "node_mask": np.ones(N, bool), "idx_i": ii,
            "idx_j": ii + 1,
            "z": np.tile(np.array([0.1, 0.0, 0.0], np.float32), (E, 1)),
            "omega": np.broadcast_to(np.eye(3, dtype=np.float32) * 100.0,
                                     (E, 3, 3)).copy(),
            "edge_mask": np.ones(E, bool)}


def _all_finite(x) -> bool:
    if isinstance(x, dict):
        return all(_all_finite(v) for k, v in x.items() if k != "wrappers")
    if isinstance(x, tuple):
        return all(_all_finite(v) for v in x)
    a = np.asarray(x)
    return a.dtype.kind not in "fc" or bool(np.isfinite(a).all())


def _bits(x):
    if isinstance(x, dict):
        return [(k, _bits(v)) for k, v in sorted(x.items())
                if k != "wrappers"]
    if isinstance(x, tuple):
        return [_bits(v) for v in x]
    return np.asarray(x).tobytes()


def dryrun_inputs(n_devices: int) -> dict:
    """The dry run's configs and host inputs for n devices: the frame
    config, the verify config, the point buffers (32 and 64 slots per
    "pt" rank of room scans), the odometry and covariance, and the
    chain graph."""
    from ndt_slam_tpu_torch.config import SlamConfig
    from ndt_slam_tpu_torch.parallel.mesh import balanced_factors

    _, pt = balanced_factors(n_devices)
    n_src, n_tgt = 32 * pt, 64 * pt  # tiny, divisible by the pt axis
    src = _room_scan(180, pose=(0.02, 0.01, 0.01))[:n_src]
    tgt = _room_scan(360, seed=1)[:n_tgt]
    return {
        "cfg": SlamConfig(grid_cells_x=32, grid_cells_y=32,
                          ndt_min_points_per_cell=3, ndt_max_iterations=5),
        "vcfg": SlamConfig(grid_cells_x=32, grid_cells_y=32,
                           ndt_min_points_per_cell=3, ndt_max_iterations=3,
                           loop_stage_mults=(2, 1),
                           ndt_max_active_cells=256),
        "inp": {"src_xy": src, "src_mask": np.ones(len(src), bool),
                "tgt_xy": tgt, "tgt_mask": np.ones(len(tgt), bool),
                "odo": np.array([0.02, 0.01, 0.5], np.float32),
                "cov": np.eye(3, dtype=np.float32) * 1e-4},
        "graph": _chain_graph(n_devices),
    }


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the sharded frame step, sequential step, pose-graph solve and
    verify once on `n_devices` spawned ranks on `dryrun_inputs`; returns
    each rank's outputs (numpy, `parallel/jobs.dryrun`). gloo when the
    ranks share one card or run on the CPU, nccl when each has its own
    card (`parallel.dist.choose_backend`). Raises unless every output
    is finite and every rank returned the same bits."""
    from ndt_slam_tpu_torch.parallel import jobs, spawn
    from ndt_slam_tpu_torch.parallel.dist import choose_backend

    device = _device(device)
    d = dryrun_inputs(n_devices)
    backend = choose_backend(device, n_devices)
    ranks = spawn(jobs.dryrun, n_devices, d["cfg"], d["vcfg"], d["inp"],
                  d["graph"], device.type, backend=backend,
                  device=device.type)
    for r, out in enumerate(ranks):
        if not _all_finite(out):
            raise RuntimeError(f"dry run: rank {r} returned a non-finite "
                               f"output")
        if _bits(out) != _bits(ranks[0]):
            raise RuntimeError(f"dry run: rank {r} differs from rank 0")
    return ranks
