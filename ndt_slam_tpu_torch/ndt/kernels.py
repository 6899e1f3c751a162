"""The three NDT kernels: CUDA launchers, plain twins, launch counts.

Each wrapper below replaces one Pallas TPU kernel of
`ndt_slam_tpu/ndt/pallas_kernels.py`; the kernels are CUDA C++ in
`ndt_slam_tpu_torch/csrc/ndt_kernels.cu`:

| wrapper               | TPU kernel                | plain twin                          |
|-----------------------|---------------------------|-------------------------------------|
| `ndt_score_grad_hess` | `_sgh_kernel` (:106)      | `compact.ndt_score_grad_hess_compact` |
| `ndt_scores`          | `_score_many_kernel` (:213) | `compact.ndt_negative_score_compact` per pose |
| `nn_sq_dists`         | `_nn_kernel` (:303)       | `fitness.nn_sq_dists`               |
| `fitness_score`       | `_nn_kernel` + the mean of `fitness_score_pallas` (:369) | `fitness.fitness_score_plain` |

Variants for loop-closure verification (in JAX these are `vmap`s of the
same kernels and of XLA code; no Pallas original of their own):

| wrapper                     | kernel                          | plain twin |
|-----------------------------|---------------------------------|------------|
| `ndt_score_grad_hess_grids` | kernel 1 with a grid axis       | `compact.window_rows` |
| `ndt_scores_grids`          | kernel 2 with a grid axis       | `compact.window_rows(derivs=False)` |
| `nn_sq_dists_batched`       | kernel 3 with a batch axis      | `fitness.nn_sq_dists` over the batch |
| `nn_argmin`                 | kernel 3, argmin form, batched  | `fitness.nn_argmin` |

The device of the input tensors picks the route: a CPU tensor runs the
twin; a CUDA tensor launches the kernel or raises. There is no
fallback. Each wrapper counts its calls that launched in `.launches`;
`launch_counts()` adds the wrappers of one kernel up under its name
(`sgh`, `score_many`, `nn`), `wrapper_launch_counts()` gives each
wrapper's own count.

The first two kernels are bound on the card by latency, not by bytes or
operations: a call touches ~0.3 MB and ~9 table cells a point. The TPU
kernels scan the whole table as a dense [TILE, K] mask (a TPU has no
gather); here one thread per (pose, point) looks its (2r+1)^2 window
cells up through `CompactGrid.cell_slot`, computes the point features
itself in the twin's operation order, and the sums over points are
reduced on the card in a fixed order. A wrapper call is two launches
(the gather, then the sum of the per-block partials) and no tensor
operation: nothing of size N is computed, stacked or copied in torch,
every scalar goes by value and every tensor by pointer, and nothing
waits for the host.

The third kernel is bound by neither bytes nor operations while the
map is young (some 160 live of 2048 source slots and a few thousand
live of 131072 target slots: the live pairs are microseconds of work,
the cost is two launches and the mask bytes every block must look at)
and by f32 operations when every slot is live (2 sub, 2 mul, 1 add, 1
min a pair, no FMA, against SMs x 128 lanes a clock). The TPU kernel
walks every (source, target) slot as a dense block. Here the kernel
reads the operands as the callers hold them (`[N,2]` and `[M,2]`
points, bool masks at any byte offset), stages only live targets
(chunks of `NN_CHUNK` dealt round-robin to the blocks of a source tile,
each warp compacting its live ones into shared memory by ballot), holds
two sources a thread in registers so that one shared-memory load
serves two pairs, and carries a NaN as the twin's minimum
does. A second launch takes the minimum over the block partials,
clamps, applies the source mask and, for `fitness_score`, sums the
valid sources in a fixed order across one cluster of 8 blocks. Both
entry points are two launches and no tensor operation, and `[N]` equals
the twin bit for bit.

The library is built at first use by nvcc (sm_90a, no fast math, no
FMA contraction) into `build/kernels/` at the repository root, keyed by
the source's hash, and loaded with ctypes: a plain C interface, every
pointer and the stream passed as `c_void_p`, every launcher returning
`cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ndt_slam_tpu_torch.ndt.compact import (
    WINDOW_THREADS,
    CompactGrid,
    GridStack,
    ndt_negative_score_compact,
    ndt_score_grad_hess_compact,
    window_rows,
)
from ndt_slam_tpu_torch.ndt.fitness import (
    BIG, fitness_score_plain as _fitness_plain, nn_argmin as _argmin_plain,
    nn_sq_dists as _nn_plain,
)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ndt_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# kMaxPoses in the source: poses of one window-kernel launch, the
# limit of the launch grid's y extent (one block row a pose).
MAX_POSES = 65535
SGH_VALUES = 12      # kSghValues: sums a block writes for one pose
SGH_ROW = 16         # kSghRow: E, matched, grad[3], hess[3,3], 2 pad
NN_TILE = 256        # kNnTile: sources a block of kernel 3 holds
NN_CHUNK = 256       # kNnChunk: targets a block stages at a time
NN_WAVES = 16        # blocks of kernel 3 an SM, over all source tiles

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> tuple[Path, str]:
    """Compile the kernel library unless a build of this exact source
    exists. Returns (library path, compiler output; empty when the
    library was already built)."""
    src = SOURCE.read_bytes()
    flags = " ".join(NVCC_FLAGS).encode()
    tag = hashlib.sha256(src + flags).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libndt_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build_kernels()
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        window = [p] * 9 + [i] * 8 + [f] * 4
        lib.ndt_sgh.argtypes = window + [f, f, p]
        lib.ndt_score_many.argtypes = window + [p]
        lib.ndt_features.argtypes = [p, p, p, p, i, i, f, p]
        lib.ndt_nn.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.ndt_empty.argtypes = [p]
        for fn in (lib.ndt_sgh, lib.ndt_score_many, lib.ndt_features,
                   lib.ndt_nn, lib.ndt_empty):
            fn.restype = i
        sizes = []
        for fn in (lib.ndt_window_threads, lib.ndt_max_poses,
                   lib.ndt_nn_tile, lib.ndt_nn_chunk):
            fn.restype, fn.argtypes = i, []
            sizes.append(fn())
        if sizes != [WINDOW_THREADS, MAX_POSES, NN_TILE, NN_CHUNK]:
            raise RuntimeError("kernel library and wrapper disagree on "
                               "a block size or the pose limit")
        _lib = lib
    return _lib


def _route(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (run the twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no NDT kernel route for device {t.device}")


def _arg(t: torch.Tensor, shape: tuple,
         dtype: torch.dtype = torch.float32) -> int:
    """Checked device pointer of a kernel operand."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        name = str(dtype).removeprefix("torch.")
        raise ValueError(
            f"kernel operand must be a contiguous {name} CUDA tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != shape:
        raise ValueError(f"kernel operand shape {tuple(t.shape)} != {shape}")
    return t.data_ptr()


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _inv_resolution(resolution: float) -> float:
    """The twin divides by the resolution; on the card that is a product
    with the f32 reciprocal (csrc/ndt_kernels.cu, point_feature)."""
    return float(np.float32(1.0) / np.float32(resolution))


def _launch_window(name: str, poses, grid_of, xy, mask, grids, d1: float,
                   d2: float, radius: int, values: int, out_shape: tuple,
                   tail: tuple = ()) -> torch.Tensor:
    """Check the operands `ndt_sgh` and `ndt_score_many` share, allocate
    the output and the per-block partial sums, launch; returns the
    output. `grids` is one `CompactGrid` (with `grid_of` None) or a
    `GridStack` (with `grid_of` [poses] int32); `xy` [N,2] / `mask` [N]
    is one source, [G,N,2] / [G,N] a source row per grid."""
    if isinstance(grids, GridStack):
        g, lead = grids.grids, (grids.grids,)
    elif grids.table is None or grids.cell_slot is None:
        raise ValueError(
            "CompactGrid has no window index (table, cell_slot): build it "
            "with compact.compact_grid or convert.compact_grid")
    else:
        g, lead = 1, ()
    n, nc, k = xy.shape[-2], poses.shape[0], grids.capacity
    if not 1 <= nc <= MAX_POSES:
        raise ValueError(f"{nc} poses; the kernel takes 1..{MAX_POSES}")
    rows = xy.dim() == 3
    if rows and xy.shape[0] != g:
        raise ValueError(f"{xy.shape[0]} source rows for {g} grids")
    blocks = -(-n // WINDOW_THREADS)
    partials = torch.empty((nc, blocks, values), dtype=torch.float32,
                           device=xy.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=xy.device)
    src_lead = (g,) if rows else ()
    _check(getattr(_load(), "ndt_" + name)(
        _arg(xy, (*src_lead, n, 2)), _arg(mask, (*src_lead, n), torch.bool),
        _arg(poses, (nc, 3)),
        None if grid_of is None else _arg(grid_of, (nc,), torch.int32),
        _arg(grids.origin, (*lead, 2)), _arg(grids.table, (*lead, k, 8)),
        _arg(grids.cell_slot, (*lead, grids.nx * grids.ny), torch.int32),
        partials.data_ptr(), out.data_ptr(),
        n, nc, grids.nx, grids.ny, int(radius), k, g, n if rows else 0,
        _inv_resolution(grids.resolution), float(d1), -0.5 * d2, 50.0 / d2,
        *tail, _stream(xy),
    ), name)
    return out


def _sgh_views(out):
    """(E, grad, hess, matched) views of kernel 1's [..., 16] rows."""
    return (out[..., 0], out[..., 2:5], out[..., 5:14].unflatten(-1, (3, 3)),
            out[..., 1])


def ndt_score_grad_hess(pose_rad, xy, mask, cg: CompactGrid, d1: float,
                        d2: float, radius: int = 1):
    """(E, grad[3], hess[3,3], matched) of the NDT objective at one pose
    [3], or batched over poses [C,3] -> ([C], [C,3], [C,3,3], [C]).

    CUDA: `window_kernel<true>` and `window_sum_kernel`; the results are
    views of the kernel's [C,16] output."""
    batched = pose_rad.dim() == 2
    if not _route(xy):
        if not batched:
            return ndt_score_grad_hess_compact(pose_rad, xy, mask, cg, d1,
                                               d2, radius)
        each = [ndt_score_grad_hess_compact(p, xy, mask, cg, d1, d2, radius)
                for p in pose_rad]
        return tuple(torch.stack(part) for part in zip(*each))
    poses = pose_rad.reshape(-1, 3)
    out = _launch_window("sgh", poses, None, xy, mask, cg, d1, d2, radius,
                         SGH_VALUES, (poses.shape[0], SGH_ROW),
                         tail=(-d1 * d2, float(d2)))
    ndt_score_grad_hess.launches += 1
    return _sgh_views(out if batched else out[0])


def ndt_scores(poses_rad, xy, mask, cg: CompactGrid, d1: float, d2: float,
               radius: int = 1):
    """E(p) for a batch of candidate poses [C,3] -> [C].

    CUDA: `window_kernel<false>` over (point blocks x candidates) and
    `window_sum_kernel`."""
    if not _route(xy):
        return torch.stack([
            ndt_negative_score_compact(p, xy, mask, cg, d1, d2, radius)
            for p in poses_rad
        ])
    out = _launch_window("score_many", poses_rad, None, xy, mask, cg, d1,
                         d2, radius, 1, (poses_rad.shape[0],))
    ndt_scores.launches += 1
    return out


def ndt_score_grad_hess_grids(poses_rad, grid_index, xy, mask,
                              gs: GridStack, d1: float, d2: float,
                              radius: int = 1):
    """(E [P], grad [P,3], hess [P,3,3], matched [P]) of pose p [P,3]
    against grid `grid_index[p]` (int32 [P]) of the stack `gs`, one
    ladder stage a call; `xy` [N,2] / `mask` [N] is one source for all
    poses, [G,N,2] / [G,N] a source row per grid.

    CUDA: kernel 1 with its grid axis, two launches; with one grid it
    gives `ndt_score_grad_hess`'s bits. CPU: `compact.window_rows`."""
    if not _route(xy):
        out = window_rows(poses_rad, grid_index, xy, mask, gs, d1, d2,
                          radius)
    else:
        out = _launch_window("sgh", poses_rad, grid_index, xy, mask, gs, d1,
                             d2, radius, SGH_VALUES,
                             (poses_rad.shape[0], SGH_ROW),
                             tail=(-d1 * d2, float(d2)))
        ndt_score_grad_hess_grids.launches += 1
    return _sgh_views(out)


def ndt_scores_grids(poses_rad, grid_index, xy, mask, gs: GridStack,
                     d1: float, d2: float, radius: int = 1):
    """E [P] of pose p against grid `grid_index[p]` of `gs`; the
    operands as for `ndt_score_grad_hess_grids`.

    CUDA: kernel 2 with its grid axis. CPU: `compact.window_rows`."""
    if not _route(xy):
        return window_rows(poses_rad, grid_index, xy, mask, gs, d1, d2,
                           radius, derivs=False)
    out = _launch_window("score_many", poses_rad, grid_index, xy, mask, gs,
                         d1, d2, radius, 1, (poses_rad.shape[0],))
    ndt_scores_grids.launches += 1
    return out


def kernel_point_features(poses_rad, xy, cg: CompactGrid) -> torch.Tensor:
    """[C,N,4] = (px, py, fx, fy) as kernels 1 and 2 compute them on the
    card, for a check against `compact.point_features`."""
    n, nc = xy.shape[0], poses_rad.shape[0]
    out = torch.empty((nc, n, 4), dtype=torch.float32, device=xy.device)
    _check(_load().ndt_features(
        _arg(xy, (n, 2)), _arg(poses_rad, (nc, 3)), _arg(cg.origin, (2,)),
        out.data_ptr(), n, nc, _inv_resolution(cg.resolution), _stream(xy),
    ), "features")
    return out


def empty_launch(device: torch.device):
    """Launch the library's empty kernel on `device`'s current stream."""
    _check(_load().ndt_empty(torch.cuda.current_stream(device).cuda_stream),
           "empty")


_sm_count: dict = {}


def _nn_blocks(device: torch.device, tiles: int, m: int) -> int:
    """Blocks that share the target chunks of one source tile: NN_WAVES
    blocks an SM over all tiles, and no more than there are chunks."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    chunks = -(-m // NN_CHUNK)
    return max(1, min(chunks, -(-NN_WAVES * _sm_count[device] // tiles)))


def _launch_nn(src_xy, src_mask, tgt_xy, tgt_mask, fitness: bool = False,
               argmin: bool = False):
    """Check the operands, allocate the outputs and the scratch, launch
    `nn_kernel` and its finish step over the batch rows of [B,N,2] /
    [B,M,2] operands ([N,2] / [M,2]: one row). Returns d2 ([B,N] or
    [N]), the fitness scalar, or (d2, idx). N, M >= 1."""
    lead = tuple(src_xy.shape[:-2])
    batch = src_xy.shape[0] if lead else 1
    n, m, device = src_xy.shape[-2], tgt_xy.shape[-2], src_xy.device
    tiles = -(-n // NN_TILE)
    blocks = _nn_blocks(device, tiles * batch, m)
    part = torch.empty((batch, blocks, n), dtype=torch.float32, device=device)
    part_idx = (torch.empty((batch, blocks, n), dtype=torch.int32,
                            device=device) if argmin else None)
    live = torch.empty((batch, tiles, blocks), dtype=torch.int32,
                       device=device)
    out = torch.empty(() if fitness else (*lead, n), dtype=torch.float32,
                      device=device)
    idx = (torch.empty((*lead, n), dtype=torch.int32, device=device)
           if argmin else None)
    _check(_load().ndt_nn(
        _arg(src_xy, (*lead, n, 2)), _arg(src_mask, (*lead, n), torch.bool),
        _arg(tgt_xy, (*lead, m, 2)), _arg(tgt_mask, (*lead, m), torch.bool),
        part.data_ptr(), None if part_idx is None else part_idx.data_ptr(),
        live.data_ptr(), None if fitness else out.data_ptr(),
        None if idx is None else idx.data_ptr(),
        out.data_ptr() if fitness else None,
        n, m, batch, blocks, _stream(src_xy),
    ), "nn")
    return (out, idx) if argmin else out


def nn_sq_dists(src_xy, src_mask, tgt_xy, tgt_mask):
    """Per-source squared distance to the nearest valid target ([N];
    1e12 where the source is masked or no target is valid; NaN where a
    valid source or target is NaN, as the twin gives it).

    CUDA: `nn_kernel` over (blocks x source tiles), then
    `nn_finish_kernel`: the minimum over the block partials, the clamp
    at 0 and the source mask. Two launches, no tensor operation; equal
    to the twin bit for bit."""
    if not _route(src_xy):
        return _nn_plain(src_xy, src_mask, tgt_xy, tgt_mask)
    if src_xy.shape[0] == 0 or tgt_xy.shape[0] == 0:
        return torch.full((src_xy.shape[0],), BIG, dtype=torch.float32,
                          device=src_xy.device)
    out = _launch_nn(src_xy, src_mask, tgt_xy, tgt_mask)
    nn_sq_dists.launches += 1
    return out


def fitness_score(src_xy, src_mask, tgt_xy, tgt_mask):
    """Mean over the valid sources of `nn_sq_dists` (a scalar; 1e12
    with no valid source or no valid target).

    CUDA: the same two launches; the finish step also sums the
    distances of the valid sources in a fixed order and divides, so the
    score is the twin's up to the order of that one sum."""
    if not _route(src_xy):
        return _fitness_plain(src_xy, src_mask, tgt_xy, tgt_mask)
    if src_xy.shape[0] == 0 or tgt_xy.shape[0] == 0:
        return torch.full((), BIG, dtype=torch.float32, device=src_xy.device)
    out = _launch_nn(src_xy, src_mask, tgt_xy, tgt_mask, fitness=True)
    fitness_score.launches += 1
    return out


def _check_batch(src_xy, tgt_xy):
    if src_xy.dim() != 3 or tgt_xy.dim() != 3 \
            or src_xy.shape[0] != tgt_xy.shape[0]:
        raise ValueError(f"batched operands [B,N,2] and [B,M,2], got "
                         f"{tuple(src_xy.shape)} and {tuple(tgt_xy.shape)}")


def nn_sq_dists_batched(src_xy, src_mask, tgt_xy, tgt_mask):
    """`nn_sq_dists` of B independent problems: [B,N,2], [B,N],
    [B,M,2], [B,M] -> [B,N].

    CUDA: kernel 3 with its batch axis, two launches for all B; each
    row equal to the twin bit for bit."""
    _check_batch(src_xy, tgt_xy)
    if not _route(src_xy):
        return _nn_plain(src_xy, src_mask, tgt_xy, tgt_mask)
    b, n = src_xy.shape[:2]
    if b == 0 or n == 0 or tgt_xy.shape[1] == 0:
        return torch.full((b, n), BIG, dtype=torch.float32,
                          device=src_xy.device)
    out = _launch_nn(src_xy, src_mask, tgt_xy, tgt_mask)
    nn_sq_dists_batched.launches += 1
    return out


def nn_argmin(src_xy, src_mask, tgt_xy, tgt_mask):
    """(d2 [B,N], idx int32 [B,N]) of B independent problems ([B,N,2],
    [B,N], [B,M,2], [B,M]): d2 is `nn_sq_dists`, idx the lowest index
    of a valid target at that distance. A NaN distance wins: idx is then
    the lowest index that gives a NaN. idx is 0 for a masked source and
    for a source without a valid target.

    CUDA: kernel 3's argmin form with its batch axis and its finish
    step, two launches for all B; d2 equal to the twin bit for bit, idx
    equal. CPU: `fitness.nn_argmin`."""
    _check_batch(src_xy, tgt_xy)
    if not _route(src_xy):
        return _argmin_plain(src_xy, src_mask, tgt_xy, tgt_mask)
    b, n = src_xy.shape[:2]
    if b == 0 or n == 0 or tgt_xy.shape[1] == 0:
        return (torch.full((b, n), BIG, dtype=torch.float32,
                           device=src_xy.device),
                torch.zeros((b, n), dtype=torch.int32, device=src_xy.device))
    out = _launch_nn(src_xy, src_mask, tgt_xy, tgt_mask, argmin=True)
    nn_argmin.launches += 1
    return out


# kernel name -> the wrappers that launch it
WRAPPERS = {
    "sgh": (ndt_score_grad_hess, ndt_score_grad_hess_grids),
    "score_many": (ndt_scores, ndt_scores_grids),
    "nn": (nn_sq_dists, fitness_score, nn_sq_dists_batched, nn_argmin),
}


def reset_launch_counts():
    for fns in WRAPPERS.values():
        for fn in fns:
            fn.launches = 0


def launch_counts() -> dict:
    """Launching calls by kernel, all of its wrappers together."""
    return {name: sum(fn.launches for fn in fns)
            for name, fns in WRAPPERS.items()}


def wrapper_launch_counts() -> dict:
    """Launching calls by wrapper name."""
    return {fn.__name__: fn.launches
            for fns in WRAPPERS.values() for fn in fns}


reset_launch_counts()
