"""The NDT kernels: CUDA launchers, plain twins, launch counts.

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

For the lockstep batch runner (`pipeline/batch_runner.py`; in JAX a
`vmap` of the registration step over the Pallas calls):

| wrapper                 | kernel                              | plain twin |
|-------------------------|-------------------------------------|------------|
| `fitness_score_batched` | kernel 3 with a batch axis, the mean a row | `fitness.fitness_score_plain` over the batch |

One kernel replaces no Pallas kernel but the loop around two of them,
the `lax.while_loop` of `ndt_slam_tpu/ndt/solve.py`'s `align`:

| wrapper      | kernel                                        | plain twin |
|--------------|-----------------------------------------------|------------|
| `ndt_newton` | `newton_kernel`: the whole Newton solve of R rows, one block a row, through kernel 1 and 2's pair visit | the stepwise loop of `solve.align` |

One kernel replaces no Pallas kernel but XLA code, the accept-and-fuse
stage of a registration (`ndt_slam_tpu/fuse/ekf.py`'s `gate_and_fuse`
and the tail of `pipeline/frontend.py`'s `_register_with_grid`):

| wrapper    | kernel                                        | plain twin |
|------------|-----------------------------------------------|------------|
| `ndt_fuse` | `fuse_kernel`: the cost, the NDT covariance from the Hessian (Jacobi eigen-decomposition), the gates, the Kalman blend, the accept select, the map-frame scan, `error_pose` and `trans_probability` of R rows, one block a row | `fuse.ekf.fuse_stage_plain` (`gate_and_fuse_plain` without the tail) |

The device of the input tensors picks the route: a CPU tensor runs the
twin; a CUDA tensor launches the kernel or raises. There is no
fallback. (`ndt_newton` and `ndt_fuse` take CUDA tensors only:
`solve.align` and `fuse.ekf` route, and run the twins for CPU tensors.)
Each wrapper counts its calls that launched in `.launches`;
`launch_counts()` adds the wrappers of one kernel up under its name
(`sgh`, `score_many`, `nn`, `newton`, `fuse`), `wrapper_launch_counts()`
gives each wrapper's own count.

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

The Newton kernel is bound by latency as kernels 1 and 2 are, and by
the iteration's own chain: the stepwise loop around them ran ~60
tensor operations, four launches and a host read of the done flag every
second iteration for a few microseconds of work. One block a row runs
every iteration, the stop and the final derivatives on the card; every
pair goes through the visit kernels 1 and 2 use and every sum runs in
their order, so the scores are theirs bit for bit and the 3x3 algebra
is the stepwise loop's, operation for operation (`csrc/ndt_kernels.cu`).

The fuse kernel is bound by nothing of its work either (a few hundred
f32 operations of 3x3 algebra a row and N point transforms): its twin
issued some 250 tensor operations a registration, half of them
launches, and `torch.linalg.eigh`'s cuSOLVER call checks its `info` on
the host, a copy and a sync. One thread a row does the algebra in
registers in the twin's operation order (its 3x3 products sum in index
order, its eigen-decomposition is cyclic Jacobi, its solve Gaussian
elimination with partial pivoting: within tolerances of the twin, not
bit for bit), and the row's block transforms the scan.

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
        lib.ndt_newton.argtypes = (window[:7] + [p] * 6 + window[9:]
                                   + [f, f, i, f, f, p])
        lib.ndt_fuse.argtypes = [p] * 20 + [i] * 4 + [f] * 9 + [p]
        lib.ndt_sym3_eigh.argtypes = [p, p, p, i, p]
        lib.ndt_empty.argtypes = [p]
        for fn in (lib.ndt_sgh, lib.ndt_score_many, lib.ndt_features,
                   lib.ndt_nn, lib.ndt_newton, lib.ndt_fuse,
                   lib.ndt_sym3_eigh, lib.ndt_empty):
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


def _window_operands(poses, grid_of, xy, mask, grids, d1: float, d2: float,
                     radius: int):
    """Check the operands `ndt_sgh`, `ndt_score_many` and `ndt_newton`
    share; returns their checked pointers (before the outputs) and
    scalars (after them). `grids` is one `CompactGrid` (with `grid_of`
    None) or a `GridStack` (with `grid_of` [poses] int32); `xy` [N,2] /
    `mask` [N] is one source, [G,N,2] / [G,N] a source row per grid."""
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
    src_lead = (g,) if rows else ()
    pointers = (
        _arg(xy, (*src_lead, n, 2)), _arg(mask, (*src_lead, n), torch.bool),
        _arg(poses, (nc, 3)),
        None if grid_of is None else _arg(grid_of, (nc,), torch.int32),
        _arg(grids.origin, (*lead, 2)), _arg(grids.table, (*lead, k, 8)),
        _arg(grids.cell_slot, (*lead, grids.nx * grids.ny), torch.int32))
    scalars = (n, nc, grids.nx, grids.ny, int(radius), k, g, n if rows else 0,
               _inv_resolution(grids.resolution), float(d1), -0.5 * d2,
               50.0 / d2)
    return pointers, scalars


def _launch_window(name: str, poses, grid_of, xy, mask, grids, d1: float,
                   d2: float, radius: int, values: int, out_shape: tuple,
                   tail: tuple = ()) -> torch.Tensor:
    """Check the operands of `ndt_sgh` or `ndt_score_many`
    (`_window_operands`), allocate the output and the per-block partial
    sums, launch; returns the output."""
    pointers, scalars = _window_operands(poses, grid_of, xy, mask, grids, d1,
                                         d2, radius)
    blocks = -(-xy.shape[-2] // WINDOW_THREADS)
    partials = torch.empty((poses.shape[0], blocks, values),
                           dtype=torch.float32, device=xy.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=xy.device)
    _check(getattr(_load(), "ndt_" + name)(
        *pointers, partials.data_ptr(), out.data_ptr(), *scalars, *tail,
        _stream(xy),
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


def ndt_newton(poses_rad, grid_index, xy, mask, grids, d1: float,
               d2: float, radius: int, max_iterations: int, step_size: float,
               trans_eps: float):
    """The whole Newton solve of `solve.align` for R rows in one launch:
    row r from pose [R,3] against grid `grid_index[r]` (int32 [R]) of
    the `GridStack` `grids`, or every row against the `CompactGrid`
    `grids` with `grid_index` None (the 3x3 solve then in one pose's
    form, torch's matrix-vector product); `xy` / `mask` as for
    `ndt_score_grad_hess_grids`. Returns (pose [R,3], iterations int32
    [R], usable bool [R], objective [R], hessian [R,3,3], matched [R]),
    the fields of `solve.NDTResult`.

    CUDA only: `newton_kernel`, one block a row, the loop, its stop and
    the final derivatives on the card. Its plain twin is the stepwise
    loop of `solve.align`, which CPU tensors take."""
    pointers, scalars = _window_operands(poses_rad, grid_index, xy, mask,
                                         grids, d1, d2, radius)
    r, dev = poses_rad.shape[0], xy.device
    pose = torch.empty((r, 3), dtype=torch.float32, device=dev)
    iterations = torch.empty((r,), dtype=torch.int32, device=dev)
    usable = torch.empty((r,), dtype=torch.bool, device=dev)
    objective = torch.empty((r,), dtype=torch.float32, device=dev)
    hessian = torch.empty((r, 3, 3), dtype=torch.float32, device=dev)
    matched = torch.empty((r,), dtype=torch.float32, device=dev)
    _check(_load().ndt_newton(
        *pointers, pose.data_ptr(), iterations.data_ptr(), usable.data_ptr(),
        objective.data_ptr(), hessian.data_ptr(), matched.data_ptr(),
        *scalars, -d1 * d2, float(d2), int(max_iterations), float(step_size),
        float(trans_eps), _stream(xy),
    ), "newton")
    ndt_newton.launches += 1
    return pose, iterations, usable, objective, hessian, matched


def ndt_fuse(cfg, pred_pose, est_pose, hessian, fit, odo_motion, last_pose,
             last_cov, converged=None, odo_pose=None, objective=None,
             src_mask=None, scan_xy=None, scan_mask=None):
    """The accept-and-fuse stage of R registrations in one launch: the
    poses [R,3] (deg), `last_cov` and `hessian` [R,3,3], `fit` [R] (one
    row: [3], [3,3], []), the settings read from `cfg` (a `SlamConfig`).
    With `scan_xy` ([R,N,2]) the tail of the registration step too:
    `converged` [R] bool, `odo_pose` [R,3], `objective` [R], `src_mask`
    [R,S], `scan_mask` [R,N]; without it `fit` is the cost. Returns
    (cost, fused [R,3], cov [R,3,3], accept bool [R], global_xy [R,N,2],
    error_pose [R,3], trans_probability [R]), the tail's four None
    without it.

    CUDA only: `fuse_kernel`, one block a row. Its plain twin is
    `fuse.ekf.fuse_stage_plain` (`gate_and_fuse_plain` without the
    tail), which CPU tensors take; `fuse.ekf` routes."""
    if not pred_pose.is_cuda:
        raise ValueError(
            f"ndt_fuse takes CUDA tensors, got {pred_pose.device}: CPU "
            f"tensors take the plain twin, fuse.ekf.fuse_stage_plain")
    lead = tuple(pred_pose.shape[:-1])
    if len(lead) > 1:
        raise ValueError(f"poses [3] or [R,3], got {tuple(pred_pose.shape)}")
    rows, dev = (lead[0] if lead else 1), pred_pose.device
    tail = scan_xy is not None
    s = src_mask.shape[-1] if tail else 0
    n = scan_xy.shape[-2] if tail else 0

    def new(*shape, dtype=torch.float32):
        return torch.empty((*lead, *shape), dtype=dtype, device=dev)

    fused, cov, accept = new(3), new(3, 3), new(dtype=torch.bool)
    cost, global_xy, error_pose, trans_prob = (
        (new(), new(n, 2), new(3), new()) if tail else (None,) * 4)

    def opt(t, *shape, dtype=torch.float32):
        return None if t is None else _arg(t, (*lead, *shape), dtype)

    _check(_load().ndt_fuse(
        _arg(pred_pose, (*lead, 3)), _arg(est_pose, (*lead, 3)),
        _arg(odo_motion, (*lead, 3)), _arg(last_pose, (*lead, 3)),
        _arg(last_cov, (*lead, 3, 3)), _arg(hessian, (*lead, 3, 3)),
        _arg(fit, lead), opt(converged, dtype=torch.bool), opt(odo_pose, 3),
        opt(objective), opt(src_mask, s, dtype=torch.bool), opt(scan_xy, n, 2),
        opt(scan_mask, n, dtype=torch.bool), opt(cost), fused.data_ptr(),
        cov.data_ptr(), accept.data_ptr(), opt(global_xy, n, 2),
        opt(error_pose, 3), opt(trans_prob), rows, s, n,
        int(cfg.fuse_degenerate_ratio > 0.0), float(cfg.coe_ndt_cov),
        float(cfg.fuse_degenerate_ratio), float(cfg.score_thre),
        float(cfg.max_innovation_trans), float(cfg.max_innovation_rot),
        float(cfg.del_time), float(cfg.coe_vel), float(cfg.coe_omega),
        float(cfg.failed_cost), _stream(pred_pose),
    ), "fuse")
    ndt_fuse.launches += 1
    return cost, fused, cov, accept, global_xy, error_pose, trans_prob


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


def kernel_sym3_eigh(h):
    """(eigenvalues [R,3] ascending, eigenvectors [R,3,3] as columns) of
    the symmetric [R,3,3] `h` (its lower triangle), as the fuse kernel
    decomposes the Hessian on the card, for a check against a float64
    `torch.linalg.eigh`."""
    rows = h.shape[0]
    w = torch.empty((rows, 3), dtype=torch.float32, device=h.device)
    v = torch.empty((rows, 3, 3), dtype=torch.float32, device=h.device)
    _check(_load().ndt_sym3_eigh(_arg(h, (rows, 3, 3)), w.data_ptr(),
                                 v.data_ptr(), rows, _stream(h)), "sym3_eigh")
    return w, v


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
    [N]), the fitness mean ([B] or a scalar), or (d2, idx). N, M >= 1."""
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
    out = torch.empty(lead if fitness else (*lead, n), dtype=torch.float32,
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


def fitness_score_batched(src_xy, src_mask, tgt_xy, tgt_mask):
    """`fitness_score` of B independent problems: [B,N,2], [B,N],
    [B,M,2], [B,M] -> [B] (the lockstep batch runner's fitness call,
    one row a sequence).

    CUDA: kernel 3 with its batch axis and the fitness form of its
    finish step, one cluster a row: two launches for all B. Each row
    sums its valid sources in an order that depends on N only, so row b
    equals `fitness_score` of row b alone bit for bit. CPU:
    `fitness.fitness_score_plain` over the batch."""
    _check_batch(src_xy, tgt_xy)
    if not _route(src_xy):
        return _fitness_plain(src_xy, src_mask, tgt_xy, tgt_mask)
    b, n = src_xy.shape[:2]
    if b == 0 or n == 0 or tgt_xy.shape[1] == 0:
        return torch.full((b,), BIG, dtype=torch.float32,
                          device=src_xy.device)
    out = _launch_nn(src_xy, src_mask, tgt_xy, tgt_mask, fitness=True)
    fitness_score_batched.launches += 1
    return out


# kernel name -> the wrappers that launch it
WRAPPERS = {
    "sgh": (ndt_score_grad_hess, ndt_score_grad_hess_grids),
    "score_many": (ndt_scores, ndt_scores_grids),
    "nn": (nn_sq_dists, fitness_score, nn_sq_dists_batched, nn_argmin,
           fitness_score_batched),
    "newton": (ndt_newton,),
    "fuse": (ndt_fuse,),
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
