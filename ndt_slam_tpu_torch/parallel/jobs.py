"""What the ranks of `parallel.dist.spawn` run: the sharded registration
functions, the multi-rank sequential loop and the sharded back end on
inputs passed in as numpy arrays, with numpy results. The CPU tests and
chip_smoke.py drive the distributed paths through these (spawned ranks
import them from this package, never from a test module). Each job
runs on every rank of an initialized group and returns this rank's
results."""

from __future__ import annotations

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.parallel.dist import axis, shard
from ndt_slam_tpu_torch.parallel.mesh import make_mesh


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple):
        return type(x)(*(_np(v) for v in x)) if hasattr(x, "_fields") \
            else tuple(_np(v) for v in x)
    return x


def _dev(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def registration(cfg: SlamConfig, inp: dict, device="cpu",
                 layouts=((1, 2), (2, 1))) -> dict:
    """On each (dp, pt) mesh of `layouts`: the single-pair register of
    (src, tgt) from `init` about `center`, the batch register of the
    [B] rows (src_b, tgt_b, init_b, center_b) and the frame step of
    (fsrc_b, ftgt_b, odo_b, prev_b, last_b, cov_b), each on this rank's
    shards; on the first layout also the three fitness layouts of
    (fit_src, tgt). Returns {(dp, pt): {name: numpy outputs}} with the
    rows of this rank's "dp" slice and its row indices ("rows")."""
    from ndt_slam_tpu_torch.ndt.fitness import fitness_score
    from ndt_slam_tpu_torch.parallel.register import (
        make_batch_register, make_sharded_frame_step, make_sharded_register,
    )

    t = {k: _dev(v, device) for k, v in inp.items()}
    out = {}
    for li, (dp, pt) in enumerate(layouts):
        mesh = make_mesh(dp * pt, dp=dp)
        one = make_sharded_register(mesh, cfg)(
            shard(t["src_xy"], mesh, ("pt",)),
            shard(t["src_mask"], mesh, ("pt",)),
            shard(t["tgt_xy"], mesh, ("pt",)),
            shard(t["tgt_mask"], mesh, ("pt",)), t["init"], t["center"])
        bp = ("dp", "pt")
        batch = make_batch_register(mesh, cfg)(
            shard(t["src_b"], mesh, bp), shard(t["src_mask_b"], mesh, bp),
            shard(t["tgt_b"], mesh, bp), shard(t["tgt_mask_b"], mesh, bp),
            shard(t["init_b"], mesh, ("dp",)),
            shard(t["center_b"], mesh, ("dp",)))
        step = make_sharded_frame_step(mesh, cfg)(
            shard(t["fsrc_b"], mesh, bp), shard(t["fsrc_mask_b"], mesh, bp),
            shard(t["ftgt_b"], mesh, bp), shard(t["ftgt_mask_b"], mesh, bp),
            *(shard(t[k], mesh, ("dp",))
              for k in ("odo_b", "prev_b", "last_b", "cov_b")))
        rows = axis(mesh, "dp").shard(torch.arange(t["src_b"].shape[0]))
        res = {"register": _np(one), "batch": _np(batch),
               "frame_step": _np(step), "rows": rows.numpy()}
        if li == 0:
            ax = axis(mesh, "pt")
            src, sm = t["fit_src"], t["fit_src_mask"]
            tgt, tm = t["tgt_xy"], t["tgt_mask"]
            res["fitness"] = {
                "sources": fitness_score(ax.shard(src), ax.shard(sm), tgt,
                                         tm, axis=ax, sharded="sources"),
                "targets": fitness_score(src, sm, ax.shard(tgt),
                                         ax.shard(tm), axis=ax,
                                         sharded="targets"),
                "both": fitness_score(ax.shard(src), ax.shard(sm),
                                      ax.shard(tgt), ax.shard(tm), axis=ax,
                                      sharded="both"),
            }
            res["fitness"] = {k: float(v) for k, v in res["fitness"].items()}
        out[(dp, pt)] = res
    return out


def slam(cfg: SlamConfig, frames, device="cpu") -> dict:
    """`run_slam_distributed` over `frames` (read by the coordinator
    only), the kernels' launch counts and `Axis`'s host copies set to 0
    just before: this rank's poses, covariances and accept flags, the
    launches by wrapper, the host copies, the pipelined front end's
    rollbacks and the seconds the run took."""
    import time

    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.parallel.dist import (
        copy_counts, is_coordinator, reset_copy_counts,
    )
    from ndt_slam_tpu_torch.pipeline.dist_runner import run_slam_distributed

    kernels.reset_launch_counts()
    reset_copy_counts()
    t0 = time.perf_counter()
    fe = run_slam_distributed(frames if is_coordinator() else None, cfg,
                              device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"poses": fe.get_poses(), "covs": np.stack(fe.cov_history),
            "accept": [bool(m.get("successful")) for m in fe.metrics],
            "wrappers": kernels.wrapper_launch_counts(),
            "copies": copy_counts(),
            "rollbacks": getattr(fe, "n_rollbacks", 0),
            "seconds": time.perf_counter() - t0}


def slam_halves(cfg: SlamConfig, frames, device="cpu") -> dict:
    """The loop of `run_slam_distributed` (synchronous, the frames
    broadcast by the coordinator) on a `DistFrontEnd` whose sharded step
    also counts the live points of this rank's source and target shards
    each frame, the launch counts and host copies set to 0 just before:
    this rank's poses, covariances and accept flags, the live counts
    [frames, 2] (source, target), the launches by wrapper, the host
    copies and the seconds the run took."""
    import time

    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.parallel.dist import (
        broadcast_frame, broadcast_scalar, copy_counts, is_coordinator,
        reset_copy_counts,
    )
    from ndt_slam_tpu_torch.pipeline.dist_runner import DistFrontEnd

    fe = DistFrontEnd(cfg, device)
    step, live = fe._seq_step, []

    def counted(src_xy, src_mask, odo, prev_odo, last_pose, last_cov,
                tgt_xy, tgt_mask, scan_xy, scan_mask):
        live.append(torch.stack([src_mask.sum(), tgt_mask.sum()]))
        return step(src_xy, src_mask, odo, prev_odo, last_pose, last_cov,
                    tgt_xy, tgt_mask, scan_xy, scan_mask)

    fe._seq_step = counted
    kernels.reset_launch_counts()
    reset_copy_counts()
    t0 = time.perf_counter()
    n = int(broadcast_scalar(len(frames) if is_coordinator() else 0))
    for t in range(n):
        fr = frames[t] if is_coordinator() else None
        scan, odo = broadcast_frame(None if fr is None else fr.scan_xy,
                                    None if fr is None else fr.odo_pose,
                                    4 * cfg.max_scan_points)
        sid = int(broadcast_scalar(fr.sid if fr is not None else 0))
        fe.process(scan, odo, sid=sid)
    fe.finalize()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"poses": fe.get_poses(), "covs": np.stack(fe.cov_history),
            "accept": [bool(m.get("successful")) for m in fe.metrics],
            "live": torch.stack(live).cpu().numpy(),
            "wrappers": kernels.wrapper_launch_counts(),
            "copies": copy_counts(),
            "seconds": time.perf_counter() - t0}


def broadcast(frame, capacity: int):
    """One `broadcast_frame` of `frame` from the coordinator: the scan
    and odometry pose this rank received."""
    from ndt_slam_tpu_torch.parallel.dist import (
        broadcast_frame, is_coordinator,
    )

    mine = frame if is_coordinator() else None
    return broadcast_frame(None if mine is None else mine.scan_xy,
                           None if mine is None else mine.odo_pose,
                           capacity)


def verify(cfg: SlamConfig, inp: dict, device="cpu", dp: int = 2):
    """`make_sharded_verify` over `dp` ranks on (src, src_mask, tgt,
    tgt_mask, init): the packed [B,16] rows every rank receives."""
    from ndt_slam_tpu_torch.graph.loop_closure import (
        make_sharded_verify, pack_verify_out,
    )

    t = {k: _dev(v, device) for k, v in inp.items()}
    fn = make_sharded_verify(make_mesh(dp=dp), cfg)
    out = fn(t["src_xy"], t["src_mask"], t["tgt_xy"], t["tgt_mask"],
             t["init"])
    return _np(pack_verify_out(out))


def optimize(graph_arrays: dict, device="cpu", dp: int = 2, **kw):
    """`make_sharded_optimize` over `dp` ranks on a pose graph given as
    numpy arrays (the `PoseGraph` fields): (poses [N,3], chi2)."""
    from ndt_slam_tpu_torch.graph.pose_graph import (
        graph_from_numpy, make_sharded_optimize,
    )

    g = graph_from_numpy(**graph_arrays, device=device)
    poses, chi2 = make_sharded_optimize(make_mesh(dp=dp), **kw)(g)
    return _np(poses), float(chi2)


def scan_cache_eviction(cfg: SlamConfig, device="cpu") -> tuple:
    """A `GraphBackend` with a mesh: its batch capacity, and the sids
    its scan cache keeps after the store is decimated to every other
    one of ten cached keyframes, beside the store's sids."""
    from ndt_slam_tpu_torch.graph.backend import GraphBackend

    be = GraphBackend(cfg, device, mesh=make_mesh(dp=2))
    for s in range(10):
        be._host_scan_cache[s] = np.zeros((4, 3), np.float32)
    be.keyframes.sids = [0, 2, 4, 6, 8]
    be._evict_stale_scan_cache()
    return be._batch_capacity, sorted(be._host_scan_cache), \
        sorted(be.keyframes.sids)


def lockstep(cfg: SlamConfig, sequences, device="cpu", dp: int = 2):
    """`run_slam_batch` with the rows sharded over `dp` ranks: every
    row's poses as this rank received them, and this rank's rows."""
    from ndt_slam_tpu_torch.pipeline.batch_runner import run_slam_batch

    mesh = make_mesh(dp=dp)
    fes = run_slam_batch(sequences, cfg, device, mesh=mesh)
    rows = axis(mesh, "dp").shard(torch.arange(len(sequences)))
    return [fe.get_poses() for fe in fes], rows.tolist()


def dryrun(cfg: SlamConfig, vcfg: SlamConfig, inp: dict, graph: dict,
           device="cpu") -> dict:
    """The multi-device dry run of `__graft_entry_torch__.py` on every
    rank of the group, on a `balanced_factors(world)` (dp, pt) mesh, the
    launch counts set to 0 just before: the sharded frame step over dp
    frames (src, tgt broadcast to [dp, ...] and sharded ("dp", "pt")),
    the sharded sequential step (src and tgt sharded over "pt", the raw
    scan replicated), and over every rank on "dp" the sharded PCG of
    `graph` (`PoseGraph` fields as numpy arrays) and the sharded verify
    (`vcfg`) of src against one copy of tgt a rank. Returns this rank's
    outputs as numpy and its launches by wrapper."""
    import torch.distributed as dist

    from ndt_slam_tpu_torch.graph.loop_closure import (
        make_sharded_verify, pack_verify_out,
    )
    from ndt_slam_tpu_torch.graph.pose_graph import (
        graph_from_numpy, make_sharded_optimize,
    )
    from ndt_slam_tpu_torch.ndt import kernels
    from ndt_slam_tpu_torch.parallel.mesh import balanced_factors
    from ndt_slam_tpu_torch.parallel.register import (
        make_sharded_frame_step, make_sharded_sequential_step,
    )

    n = dist.get_world_size()
    dp, _ = balanced_factors(n)
    mesh = make_mesh(n, dp=dp)
    t = {k: _dev(v, device) for k, v in inp.items()}
    src, sm, tgt, tm = t["src_xy"], t["src_mask"], t["tgt_xy"], t["tgt_mask"]
    zeros = torch.zeros((dp, 3), dtype=torch.float32, device=src.device)

    def rows(a, b=dp):
        """`a` repeated over b rows."""
        return a.expand(b, *a.shape).contiguous()

    bp = ("dp", "pt")
    kernels.reset_launch_counts()
    frame = make_sharded_frame_step(mesh, cfg)(
        shard(rows(src), mesh, bp), shard(rows(sm), mesh, bp),
        shard(rows(tgt), mesh, bp), shard(rows(tm), mesh, bp),
        *(shard(a, mesh, ("dp",))
          for a in (zeros, zeros, zeros, rows(t["cov"]))))
    seq = make_sharded_sequential_step(mesh, cfg)(
        shard(src, mesh, ("pt",)), shard(sm, mesh, ("pt",)), t["odo"],
        zeros[0], zeros[0], t["cov"], shard(tgt, mesh, ("pt",)),
        shard(tm, mesh, ("pt",)), src, sm)
    flat = make_mesh(n, dp=n)
    g = graph_from_numpy(**graph, device=device)
    pg, chi2 = make_sharded_optimize(flat, iterations=2, cg_iters=8)(g)
    ver = make_sharded_verify(flat, vcfg)(
        src, sm, rows(tgt, n), rows(tm, n),
        torch.zeros((n, 3), dtype=torch.float32, device=src.device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"mesh": (dp, n // dp), "frame_step": _np(frame),
            "sequential_step": _np(seq), "pose_graph": _np(pg),
            "chi2": float(chi2), "verify": _np(pack_verify_out(ver)),
            "wrappers": kernels.wrapper_launch_counts()}


def run(jobs: list) -> list:
    """Run `jobs`, a list of (function name in this module, args, kwargs),
    in order on this rank; their results in a list (one spawn for
    several jobs)."""
    return [globals()[name](*args, **kwargs) for name, args, kwargs in jobs]
