"""Device meshes for multi-rank SLAM (port of `ndt_slam_tpu.parallel.mesh`).

The scaling axes are the JAX package's:

- "pt": the point buffers (registration target and source) sharded
  over ranks; the NDT grid moments, the Newton reductions and the
  fitness sums are collectives over this axis;
- "dp": independent work (loop-closure candidates, the sequences of a
  lockstep batch, pose-graph edges) sharded over ranks.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the process
group's ranks, one rank a device, with `mesh_dim_names` (dp, pt); the
collectives of a dimension run on `mesh.get_group(name)`
(`parallel.dist.axis`). Its device type is where the collectives'
tensors travel: "cuda" on nccl, "cpu" on gloo (which copies CUDA
tensors through the host, `parallel/dist.py`).
"""

from __future__ import annotations

import datetime
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ndt_slam_tpu_torch.parallel.dist import TIMEOUT_S


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              axis_batch: str = "dp", axis_points: str = "pt") -> DeviceMesh:
    """A (dp, pt) mesh over the first `n_devices` ranks of the process
    group (all by default); `dp` defaults to 1 (every rank shards
    points). Every rank of the group calls it. Each dimension's group
    fails a collective that waits longer than `dist.TIMEOUT_S`, as the
    world group does (the mesh makes its groups with torch's default
    timeout, minutes longer)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.dist.initialize first")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} ranks, the group has {world}")
    if dp is None:
        dp = 1
    if n % dp != 0:
        raise ValueError(f"n_devices={n} not divisible by dp={dp}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(kind, torch.arange(n).reshape(dp, n // dp),
                      mesh_dim_names=(axis_batch, axis_points))
    for name in mesh.mesh_dim_names:
        dist.distributed_c10d._set_pg_timeout(
            datetime.timedelta(seconds=TIMEOUT_S), mesh.get_group(name))
    return mesh


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    """The extent of mesh dimension `name` (1 for no mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def balanced_factors(n: int) -> tuple[int, int]:
    """Largest f <= sqrt(n) dividing n, as (f, n // f)."""
    f = max(d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0)
    return f, n // f
