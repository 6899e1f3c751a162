"""Tiny cells for the CPU tests: a checkout of the benchmark in a temp
directory with small capacities and short simulated logs, run on the
CPU through `harness.run_cell` (the card-only checks of `main` left
out)."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SMALL = dict(max_scan_points=512, max_submap_points=8192,
             max_local_map_points=16384, grid_cells_x=96, grid_cells_y=96,
             ndt_max_active_cells=256, max_keyframes=256,
             loop_min_frame_gap=20, submap_sep_thre=3.0)


def read(path):
    with open(path) as f:
        return json.load(f)


def write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def checkout(tmp) -> str:
    """A copy of the benchmark's files (BENCHMARK.json, slambench/) with
    a tiny cell added as files and entries: `tinyrobot.lap` (the robot
    configuration's driver, loops on, 1.3 laps of the office at 0.6 m a
    frame, the first 60 frames mapped in set-up)."""
    root = str(tmp)
    shutil.copytree(os.path.join(REPO, "slambench"),
                    os.path.join(root, "slambench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = read(os.path.join(REPO, "BENCHMARK.json"))
    cfg = read(os.path.join(REPO, "slambench", "configs", "robot.json"))
    cfg["name"] = "tinyrobot"
    cfg["slam"].update(SMALL)
    write(os.path.join(root, "slambench", "configs", "tinyrobot.json"), cfg)
    bench["configs"].append({"name": "tinyrobot", "source": "test",
                             "file": "slambench/configs/tinyrobot.json",
                             "reduced": []})
    lap = read(os.path.join(REPO, "slambench", "workloads",
                            "robot.office_revisit.json"))
    lap["logs"][0].update(frames=140, step=0.6)
    lap["jobs"] = [{"log": "office", "start": 0, "frames": 140,
                    "prefix": 60}]
    lap["warmup"] = [[60, 63]]
    lap["trace"] = {"start": 70, "frames": 3}
    lap["judge"].update(frames=12, targets=4, checks=1.0, corrections=1.0)
    write(os.path.join(root, "slambench", "workloads", "tinyrobot.lap.json"),
          lap)
    bench["workloads"].append(
        {"name": "tinyrobot.lap", "config": "tinyrobot", "traffic": "lap",
         "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tinyrobot.lap")
    write(os.path.join(root, "BENCHMARK.json"), bench)
    return root
