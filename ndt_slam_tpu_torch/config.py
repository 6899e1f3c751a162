"""Single typed configuration for the whole pipeline.

The same fields, defaults, `from_dict`, `small()`, `replace` and
`to_dict` as `ndt_slam_tpu.config.SlamConfig`, so `suite.json` entries
and `--config` JSON files load unchanged in either package.

Nothing here looks at the machine: which engine runs is decided by the
device of the tensors the caller passes (CUDA tensors go to the
kernels of `ndt/kernels.py`, CPU tensors to their plain twins), and a
setting whose "auto" value depends on the device is resolved by the
caller that knows it (`resolved_ndt_incremental_grid(device_type)`).
Features not ported yet (loop closure, the pipelined front end) resolve
to off; `FrontEnd` refuses a config that forces them on.
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
    # "auto", "compact" and "pallas" all name the one engine the port
    # has: the compact table (see resolved_ndt_engine).
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
    # Pipelined host sync: not ported yet (-1 and 0 mean synchronous).
    pipeline_depth: int = -1

    # ---- numerics ----
    dtype: Any = dataclasses.field(default="float32")

    # ---- loop closure / pose graph: not ported yet ----
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
        """The engine actually run: always the compact table, through
        the CUDA kernels for CUDA tensors and through their plain twins
        for CPU tensors. The dense-window gather engine is not ported."""
        if self.ndt_engine not in ("auto", "compact", "pallas"):
            raise ValueError(
                f"ndt_engine={self.ndt_engine!r} is not available in the "
                "PyTorch port (only the compact engine is)"
            )
        return "compact"

    @property
    def resolved_pipeline_depth(self) -> int:
        """Host-sync chunk depth: the port's front end is synchronous."""
        return 0

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
