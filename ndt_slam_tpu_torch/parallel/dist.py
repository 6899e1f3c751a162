"""Multi-process runtime on torch.distributed (port of
`ndt_slam_tpu.parallel.dist`).

One process a device. A process joins the group through `initialize`
(env:// from torchrun's RANK / WORLD_SIZE / MASTER_ADDR, or an init file
shared by the ranks); the backend is chosen explicitly and printed:
`nccl` when each rank has its own card, `gloo` when ranks share a card
or run on the CPU. Every process group carries a timeout, so a rank
left waiting in a collective fails instead of hanging.

Host roles, as in the JAX package:
- every rank runs the same program on its shard of the point buffers
  (`parallel/register.py`), and the collectives inside it are the
  methods of `Axis`, one mesh dimension's group;
- rank 0, the coordinator, owns the log and the output files;
  `broadcast_frame` ships each frame to every rank in one collective
  (scan, count and pose in one flat payload);
- the map and back-end bookkeeping runs replicated on every rank from
  outputs that are bitwise the same on every rank
  (`pipeline/dist_runner.py`).

`Axis` runs a collective on the tensor's own device, except on a gloo
group, whose CUDA support differs by operation and version: there a
CUDA tensor is copied to the host, reduced there and copied back, at
the call, and `copy_counts()` counts the copies. Ring all-reduce and
all-gather leave the same bits on every rank, on gloo and on NCCL.

`spawn` starts N ranks of one function on this host over a file store
(the CPU tests and chip_smoke.py share it); the function runs in fresh
interpreters, so it lives in this package (`parallel/jobs.py`), never
in a test module.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

# seconds a rank may wait in a collective before its group fails it
TIMEOUT_S = 300

# host copies made by `Axis` for CUDA tensors on gloo groups
_copies = {"to_host": 0, "to_device": 0}


def copy_counts() -> dict:
    """Host copies `Axis` made for CUDA tensors on gloo groups."""
    return dict(_copies)


def reset_copy_counts():
    for k in _copies:
        _copies[k] = 0


class Runtime(NamedTuple):
    rank: int
    world_size: int
    backend: str
    device: torch.device


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """`nccl` when the ranks are on CUDA and each has a card of its own,
    else `gloo` (ranks on the CPU, or sharing a card)."""
    if device.type == "cuda" and \
            torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize(init_file: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device=None,
               verbose: bool = True) -> Optional[Runtime]:
    """Join the process group; a no-op (None) in a single process.

    With `init_file` the ranks meet in that file (file://; `world_size`
    and `rank` given); else torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT; env://) when WORLD_SIZE is above 1.
    `device` defaults to this rank's card where there are cards, else
    the CPU; `backend` to `choose_backend`. Prints the choice."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if init_file is None and env_world <= 1:
        return None
    if init_file is None:
        init_method = "env://"
        world_size = env_world
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        if world_size is None or rank is None:
            raise ValueError("an init file needs the world size and rank")
        init_method = f"file://{os.path.abspath(init_file)}"
        local_rank, local_world = rank, world_size
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda",
                              local_rank % torch.cuda.device_count())
    if backend is None:
        backend = choose_backend(device, local_world)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if verbose:
        share = (" (ranks share the card)" if device.type == "cuda"
                 and backend == "gloo" else "")
        print(f"[dist] rank {rank} of {world_size}: backend {backend}, "
              f"device {device}{share}", flush=True)
    return Runtime(rank, world_size, backend, device)


def shutdown():
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device_count() -> int:
    """Devices this host gives the ranks: `torch.cuda.device_count()`,
    or 1 on a host without a card (the CPU). One process holds one
    device, so this is `jax.local_device_count()` of the JAX package."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def global_device_count() -> int:
    """Devices over all ranks: the world size of the initialised group
    (one device a rank), else `local_device_count()`; the JAX package's
    `jax.device_count()`."""
    if dist.is_initialized():
        return dist.get_world_size()
    return local_device_count()


def _comm_device() -> torch.device:
    """Where tensors of the world group travel: the rank's card on
    nccl, the host on gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Axis:
    """Collectives over one mesh dimension: the counterpart of a JAX axis
    name inside `shard_map`. `group` None is a single rank (every
    collective the identity). A shard is the rank's contiguous slice,
    in rank order, as a JAX `P(axis)` shard is."""

    def __init__(self, group=None):
        self.group = group
        self.size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self._host = group is not None and \
            dist.get_backend(group) == "gloo"

    def _to_comm(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the collective carries: a host copy of a CUDA
        tensor on gloo (counted), bools as uint8."""
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if self._host and t.is_cuda:
            _copies["to_host"] += 1
            return t.cpu()
        return t.clone()

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.is_cuda and not t.is_cuda:
            _copies["to_device"] += 1
            t = t.to(like.device)
        return t.to(torch.bool) if like.dtype == torch.bool else t

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return t
        c = self._to_comm(t)
        dist.all_reduce(c, op=op, group=self.group)
        return self._back(c, t)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors concatenated along dim 0 in rank order
        (JAX's tiled `all_gather`)."""
        if self.group is None:
            return t
        c = self._to_comm(t.contiguous())
        parts = [torch.empty_like(c) for _ in range(self.size)]
        dist.all_gather(parts, c, group=self.group)
        return self._back(torch.cat(parts), t)

    def shard(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous slice of `t` along `dim`; the extent
        must divide by the axis size."""
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"extent {n} does not divide over {self.size} "
                             f"ranks")
        k = n // self.size
        return t.narrow(dim, self.rank * k, k)


def axis(mesh, name: str) -> Axis:
    """The `Axis` of mesh dimension `name` (a single rank for no mesh)."""
    return Axis(None if mesh is None else mesh.get_group(name))


def shard(t: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of a full tensor `t` under a partition spec:
    `spec[d]` names the mesh dimension that dim d is sharded over, or
    None for a replicated dim (JAX's `PartitionSpec`, e.g. ("dp", "pt")
    for [B, N, 2] points)."""
    for d, name in enumerate(spec):
        if name is not None:
            t = axis(mesh, name).shard(t, d)
    return t


def broadcast_scalar(value: float) -> float:
    """One number from the coordinator to every rank (float64, so that
    integer frame ids stay exact). Pass-through in a single process."""
    if not dist.is_initialized():
        return float(value)
    t = torch.tensor([value if is_coordinator() else 0.0],
                     dtype=torch.float64, device=_comm_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def broadcast_frame(scan_xy: Optional[np.ndarray],
                    odo_pose_deg: Optional[np.ndarray], capacity: int):
    """One frame (raw sensor-frame scan and odometry pose) from the
    coordinator to every rank; the others pass None for both. Returns
    (scan_xy [n,2] f32, odo_pose_deg [3] f32), the same on every rank.

    The scan is padded to `capacity` points for the fixed-size
    collective and cut back to its count after; scan, count and pose
    travel in one flat payload, one collective a frame."""
    if not dist.is_initialized():
        return (np.asarray(scan_xy, np.float32),
                np.asarray(odo_pose_deg, np.float32))
    payload = np.zeros(capacity * 2 + 4, np.float32)
    if is_coordinator():
        scan = np.asarray(scan_xy, np.float32)[:capacity]
        n = scan.shape[0]
        payload[:n * 2] = scan.reshape(-1)
        payload[capacity * 2] = n
        payload[capacity * 2 + 1:] = np.asarray(odo_pose_deg, np.float32)
    t = torch.from_numpy(payload).to(_comm_device())
    dist.broadcast(t, src=0)
    payload = t.cpu().numpy()
    n = int(payload[capacity * 2])
    scan = payload[:capacity * 2].reshape(capacity, 2)[:n]
    return scan.copy(), payload[capacity * 2 + 1:].copy()


def _spawned(rank: int, fn, nprocs: int, tmp: str, backend: str, device,
             args: tuple):
    torch.set_num_threads(1)
    if device is not None and torch.device(device).type == "cuda" \
            and torch.device(device).index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    initialize(init_file=os.path.join(tmp, "store"), world_size=nprocs,
               rank=rank, backend=backend, device=device)
    try:
        out = fn(*args)
    finally:
        shutdown()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Spawned:
    """Ranks started by `start`: `result()` waits for them and returns
    their results in rank order (a rank that raised fails the call)."""

    def __init__(self, ctx, tmp):
        self._ctx, self._tmp = ctx, tmp

    def result(self) -> list:
        try:
            while not self._ctx.join():
                pass
            out = []
            for r in range(len(self._ctx.processes)):
                with open(os.path.join(self._tmp.name, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self.close()

    def close(self):
        """Stop ranks still running (after a failure elsewhere) and
        remove the store."""
        for p in self._ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._tmp.cleanup()


def start(fn, nprocs: int, *args, backend: str = "gloo",
          device="cpu") -> Spawned:
    """Start `fn(*args)` on `nprocs` ranks of a new process group (spawned
    interpreters, one thread each, a file store in a fresh temporary
    directory) and return at once; the caller may work meanwhile. `fn`
    must be importable (a module-level function of this package) and
    return a picklable value."""
    import torch.multiprocessing as mp

    tmp = tempfile.TemporaryDirectory()
    ctx = mp.start_processes(
        _spawned, args=(fn, nprocs, tmp.name, backend, device, args),
        nprocs=nprocs, start_method="spawn", join=False)
    return Spawned(ctx, tmp)


def spawn(fn, nprocs: int, *args, **kw) -> list:
    """`start(...)` and wait: the ranks' results in rank order."""
    return start(fn, nprocs, *args, **kw).result()
