"""Map and trajectory PNG export (port of `ndt_slam_tpu.viz`): the
global map's points, the trajectory, the current pose and the accepted
loop-closure edges, drawn with matplotlib's Agg backend (no display).
numpy and matplotlib only; matplotlib is imported when a picture is
drawn."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def render_map_png(
    path: str,
    map_xy: np.ndarray,
    poses_deg: Optional[np.ndarray] = None,
    loop_edges: Optional[Sequence[tuple]] = None,
    title: str = "",
    dpi: int = 120,
) -> str:
    """Write a PNG of the map and trajectory; returns `path`.

    map_xy [N,2] global map points; poses_deg [T,3] trajectory
    (tx, ty, th_deg); loop_edges: (i, j) index pairs into poses_deg of
    accepted loop-closure constraints."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 9))
    map_xy = np.asarray(map_xy)
    if map_xy.size:
        ax.scatter(map_xy[:, 0], map_xy[:, 1], s=0.5, c="#404a58",
                   linewidths=0, rasterized=True, label="map")
    if poses_deg is not None and len(poses_deg):
        poses_deg = np.asarray(poses_deg)
        ax.plot(poses_deg[:, 0], poses_deg[:, 1], "-", c="#d3543a",
                lw=1.2, label="trajectory")
        # current pose: position and a heading tick
        tx, ty, th = poses_deg[-1]
        th_r = np.deg2rad(th)
        ax.plot([tx], [ty], "o", c="#d3543a", ms=5)
        ax.plot([tx, tx + 0.8 * np.cos(th_r)],
                [ty, ty + 0.8 * np.sin(th_r)], "-", c="#d3543a", lw=2)
        if loop_edges:
            for (i, j) in loop_edges:
                if i < len(poses_deg) and j < len(poses_deg):
                    ax.plot(poses_deg[[i, j], 0], poses_deg[[i, j], 1],
                            "-", c="#3a7dd3", lw=0.8, alpha=0.8)
            ax.plot([], [], "-", c="#3a7dd3", lw=0.8, label="loop edges")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if title:
        ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def render_frontend_png(path: str, fe, title: str = "") -> str:
    """Render a FrontEnd's current state (map, poses, loop edges)."""
    map_xy = fe.pcmap.global_map()
    poses = fe.get_poses()
    loops = None
    if fe.backend is not None and fe.backend.loop_edges:
        loops = [(i, j) for (i, j, _z, _w) in fe.backend.loop_edges]
    return render_map_png(
        path, map_xy, poses, loops,
        title=title or f"{len(poses)} frames, "
        f"{len(loops) if loops else 0} loop edges",
    )
