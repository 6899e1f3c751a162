"""Single typed configuration for the whole pipeline.

The same fields, defaults, `from_dict`, `small()`, `replace` and
`to_dict` as `ndt_slam_tpu.config.SlamConfig`, so `suite.json` entries
and `--config` JSON files load unchanged in either package.

Nothing here looks at the machine: which engine runs is decided by the
device of the tensors the caller passes (CUDA tensors go to the
kernels of `ndt/kernels.py`, CPU tensors to their plain twins), and a
setting whose "auto" value depends on the device is resolved by the
caller that knows it (`resolved_ndt_incremental_grid(device_type)`,
`resolved_loop_verify_async(device_type)`,
`resolved_pipeline_depth(device_type)`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping


# What ndt_incremental_grid = -1 means on a CUDA device. Off: on an
# H100 the frame loop is bound by launches, not by device work, and the
# lattice path trades the full rebuild's one large sort for two
# 2048-row moment scatters and a window gather, some 60 more small
# device operations a frame; measured in turns in one process it lost
# to the full rebuild (PERF.md has the runs). The JAX package resolves
# its -1 to on for its accelerator.
LATTICE_AUTO_ON_CUDA = False

# What pipeline_depth = -1 means on a CUDA device: frames in flight
# before the pipelined front end fetches their small outputs in one
# copy. 0 (synchronous): on an H100 the frame's one fetch is about 1 %
# of the frame and the solver's done-flag polls sync the host inside
# every frame anyway, so chunking the fetch has little to hide. In turns
# in one process, over two calls, depth 8 won 12 of 20 pairs of
# office_loop runs without loops (3 of 10, then 9 of 10: no clear win)
# and 3 of 20 with loops, where the frames replayed after each
# correction cost more than the fetches saved (PERF.md has the runs).
# The JAX package resolves its -1 to 8 on its accelerator, where the
# fetch dominated the frame.
PIPELINE_AUTO_DEPTH_ON_CUDA = 0


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # ---- run range ----
    start_frame: int = 0
    end_frame: int = 690
    draw_skip: int = 5
    sidelidar: bool = False

    # ---- preprocessing ----
    resample_space: float = 0.05
    resample_space_thre: float = 0.25

    # ---- NDT registration ----
    ndt_resolution: float = 0.3
    ndt_max_iterations: int = 35
    ndt_step_size: float = 0.1
    ndt_trans_eps: float = 0.01
    ndt_outlier_ratio: float = 0.55
    ndt_min_points_per_cell: int = 6
    ndt_neighborhood: int = 1
    # "auto", "compact" and "pallas" name the compact table (the CUDA
    # kernels); "gather" the dense-window neighbour gather in tensor
    # code (ndt/score.py; see resolved_ndt_engine).
    ndt_engine: str = "auto"
    ndt_max_active_cells: int = 2048
    source_leaf_size: float = 0.05
    score_thre: float = 0.5
    failed_cost: float = 1.0e7
    max_innovation_trans: float = 1.0
    max_innovation_rot: float = 30.0
    ndt_target_filtered: bool = False

    # ---- fusion ----
    del_time: float = 0.5
    coe_vel: float = 0.1
    coe_omega: float = 0.5
    coe_ndt_cov: float = 1.0
    fuse_degenerate_ratio: float = 1e-3

    # ---- mapping ----
    submap_sep_thre: float = 10.0
    submap_leaf_size: float = 0.05
    remove_moving: bool = True
    diff_resol: float = 0.05
    thre_neighbor: float = 0.2

    # ---- fixed capacities ----
    max_scan_points: int = 2048
    max_submap_points: int = 65536
    max_local_map_points: int = 131072
    grid_cells_x: int = 192
    grid_cells_y: int = 192

    # Incremental NDT target grid: a running lattice of NDT moments
    # (additive, keyed by absolute cell index), so that a frame's grid
    # is a window slice plus the newest scan's scatter instead of a
    # rescatter of the whole local map. -1 = auto (see
    # resolved_ndt_incremental_grid); 0/1 force.
    ndt_incremental_grid: int = -1
    # Lattice side in cells; -1 = auto (see resolved_grid_mom_cells).
    grid_mom_cells: int = -1
    # Pipelined host sync: frames in flight before the host fetches
    # their small outputs in one copy (pipeline/async_frontend.py).
    # 0 = synchronous; -1 = auto (see resolved_pipeline_depth). The
    # trajectory is the same bit for bit either way.
    pipeline_depth: int = -1

    # ---- numerics ----
    dtype: Any = dataclasses.field(default="float32")

    # ---- loop closure / pose graph (graph/) ----
    loop_enable: bool = False
    loop_radius: float = 5.0
    loop_drift_gain: float = 3.0
    loop_min_frame_gap: int = 80
    loop_score_thre: float = 0.02
    loop_match_dist: float = 0.4
    loop_min_overlap: float = 0.55
    loop_stage_mults: tuple = (4, 2, 1)
    loop_stage_max_iterations: int = 0
    loop_coarse_starts: int = 5
    loop_max_candidates: int = 4
    loop_info_sigma_floor: float = 0.03
    loop_keyframe_skip: int = 5
    loop_check_skip: int = 5
    loop_verify_async: int = -1
    max_keyframes: int = 4096
    remake_thresh_trans: float = 0.05
    remake_thresh_rot: float = 0.5
    loop_opt_min_frames: int = 0
    pgo_iterations: int = 20
    pgo_dense_max_nodes: int = 512
    pgo_seg_len: int = 32
    pgo_fine_iterations: int = 10
    pgo_cg_iters: int = 1024
    pgo_cycles: int = 3

    # Resolved settings -------------------------------------------------
    @property
    def resolved_ndt_engine(self) -> str:
        """The engine actually run: "compact" (the compact table,
        through the CUDA kernels for CUDA tensors and their plain twins
        for CPU tensors) for "auto", "compact" and "pallas"; "gather"
        (the dense-window neighbour gather of ndt/score.py, tensor code
        on either device) for "gather"."""
        if self.ndt_engine == "gather":
            return "gather"
        if self.ndt_engine not in ("auto", "compact", "pallas"):
            raise ValueError(
                f"ndt_engine={self.ndt_engine!r} is not available in the "
                "PyTorch port (compact and gather are)"
            )
        return "compact"

    def resolved_pipeline_depth(self, device_type: str) -> int:
        """Frames in flight of the pipelined front end on a device of
        `device_type` ("cuda", "cpu"); 0 runs the synchronous front
        end. >= 0 forces; -1 is PIPELINE_AUTO_DEPTH_ON_CUDA on "cuda"
        and 0 elsewhere, as in the JAX package off its accelerator."""
        if self.pipeline_depth >= 0:
            return self.pipeline_depth
        return PIPELINE_AUTO_DEPTH_ON_CUDA if device_type == "cuda" else 0

    def resolved_ndt_incremental_grid(self, device_type: str) -> bool:
        """Whether the front end on a device of `device_type` ("cuda",
        "cpu") registers against the incremental moment lattice.

        Forced off under ndt_target_filtered: the lattice mirrors the
        unfiltered (previous closed cloud + proc + newest scan) target,
        while that mode registers against the voxel-filtered current
        submap. 0/1 force; -1 is LATTICE_AUTO_ON_CUDA on "cuda" and off
        elsewhere."""
        if self.ndt_target_filtered:
            return False
        if self.ndt_incremental_grid >= 0:
            return bool(self.ndt_incremental_grid)
        return LATTICE_AUTO_ON_CUDA and device_type == "cuda"

    def resolved_loop_verify_async(self, device_type: str) -> bool:
        """Whether loop verification on a device of `device_type`
        ("cuda", "cpu") resolves one check cycle late. 0/1 force; -1 is
        off on both: off on "cpu" as in the JAX package, and off on
        "cuda" because there it does not pay: a verify is bound by its
        launches on the host, which resolving late does not hide, and
        in turns on an H100 the late path lost 7 of 10 pairs of
        office_loop runs (PERF.md has the runs; the JAX package resolves
        -1 to on for its accelerator)."""
        if self.loop_verify_async >= 0:
            return bool(self.loop_verify_async)
        return False

    @property
    def resolved_grid_mom_cells(self) -> int:
        """Moment-lattice side length (cells), even, >= the grid window.
        Auto: the window plus, on each side, the submap's travel
        (submap_sep_thre) and 4 m of prediction slack, so that every
        frame window of the open submap fits."""
        window = max(self.grid_cells_x, self.grid_cells_y)
        if self.grid_mom_cells > 0:
            b = max(self.grid_mom_cells, window)
        else:
            margin = math.ceil(
                (self.submap_sep_thre + 4.0) / self.ndt_resolution
            )
            b = window + 2 * margin
        return b + (b % 2)

    @property
    def grid_num_cells(self) -> int:
        return self.grid_cells_x * self.grid_cells_y

    @property
    def grid_extent_x(self) -> float:
        return self.grid_cells_x * self.ndt_resolution

    @property
    def grid_extent_y(self) -> float:
        return self.grid_cells_y * self.ndt_resolution

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SlamConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    # A small config for unit tests / CPU runs.
    @classmethod
    def small(cls, **kw) -> "SlamConfig":
        base = dict(
            max_scan_points=512,
            max_submap_points=8192,
            max_local_map_points=16384,
            grid_cells_x=96,
            grid_cells_y=96,
            max_keyframes=256,
        )
        base.update(kw)
        return cls(**base)
