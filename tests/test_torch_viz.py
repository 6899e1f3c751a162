"""The port's map picture (ndt_slam_tpu_torch.viz and the runner's
viz_every / viz_final), the two cases of tests/integration/test_viz.py
on the CPU: a PNG from arrays with a loop edge, and the runner's
pictures every 4 frames and at the end of a simulated run."""

import os

import numpy as np
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.io.simulate import simulate_sequence
from ndt_slam_tpu_torch.pipeline.runner import run_slam
from ndt_slam_tpu_torch.viz import render_map_png

torch.set_num_threads(2)


def test_render_map_png_writes_file(tmp_path):
    path = str(tmp_path / "m.png")
    rng = np.random.default_rng(0)
    map_xy = rng.uniform(-5, 5, (500, 2)).astype(np.float32)
    poses = np.stack([np.linspace(0, 3, 20), np.zeros(20),
                      np.zeros(20)], 1).astype(np.float32)
    out = render_map_png(path, map_xy, poses, loop_edges=[(0, 19)])
    assert os.path.exists(out) and os.path.getsize(out) > 1000
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_runner_viz_outputs(tmp_path):
    frames = simulate_sequence(n_frames=10, beams=181, seed=2)
    cfg = SlamConfig.small(end_frame=10, ndt_max_active_cells=256)
    out_dir = str(tmp_path / "out")
    run_slam(frames, cfg, "cpu", out_dir=out_dir, viz_every=4,
             viz_final=True)
    for name in ("map.png", "viz_00004.png", "viz_00008.png"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    assert not os.path.exists(os.path.join(out_dir, "viz_00010.png"))
