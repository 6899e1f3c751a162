"""The benchmark's lockstep farm at a tiny size on the CPU: a run through
`harness.run_cell` with rows from two sites at two speeds is correct
with every row followed, the control and a moved pose are caught, the
batch runner's counters count what happened, and a row's records do not
depend on the other rows."""

import os

import pytest
import torch

from slambench import harness
from slambench.harness import read_json, run_cell
from slambench.tests import tiny
from slambench.traffic.generator import make_log

CELL = "tinyfarm.two_site"
SEED = 2**31 + 181
SITE = dict(beams=180, fov_deg=180.0, noise_range=0.01, odo_noise_v=0.04,
            odo_noise_w=1.2, odo_bias_w_deg=0.02, max_range=30.0, dt=0.5)
# two sites at two speeds: office rows close a submap every 5 frames,
# killian rows (3 people walking) every 6 or 7
LOGS = [dict(name="office", world="office", frames=60, n_movers=0,
             step=0.6, **SITE),
        dict(name="killian", world="killian", frames=60, n_movers=3,
             step=0.45, **SITE)]
FRAMES = 24
JOBS = [dict(log=log, start=start, frames=FRAMES)
        for log in ("office", "killian") for start in (0, 36)]


def _checkout(tmp) -> str:
    """The tiny checkout with a farm configuration and cell added as
    files and entries: the farm's own files, the tiny capacities, four
    rows of 24 frames, every row judged."""
    root = tiny.checkout(tmp)
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cfg = read_json(os.path.join(tiny.REPO, "slambench", "configs",
                                 "farm.json"))
    cfg.update(name="tinyfarm", rows=len(JOBS))
    cfg["slam"].update(tiny.SMALL)
    tiny.write(os.path.join(root, "slambench", "configs", "tinyfarm.json"),
               cfg)
    work = read_json(os.path.join(tiny.REPO, "slambench", "workloads",
                                  "farm.two_site_fleet.json"))
    work.update(logs=LOGS, jobs=JOBS, warmup=[[0, 8]],
                trace={"start": 10, "frames": 3})
    work["judge"].update(frames=6, targets=3)
    tiny.write(os.path.join(root, "slambench", "workloads", CELL + ".json"),
               work)
    bench["configs"].append({"name": "tinyfarm", "source": "test",
                             "file": "slambench/configs/tinyfarm.json",
                             "reduced": []})
    bench["workloads"].append({"name": CELL, "config": "tinyfarm",
                               "traffic": "two_site", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if "farm.two_site_fleet" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    tiny.write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return _checkout(tmp_path_factory.mktemp("farm"))


@pytest.fixture(scope="module")
def cfg(root):
    from ndt_slam_tpu_torch.config import SlamConfig
    return SlamConfig.from_dict(read_json(os.path.join(
        root, "slambench", "configs", "tinyfarm.json"))["slam"])


@pytest.fixture(scope="module")
def rows():
    """Each job's (scans, odometry), from logs generated once."""
    logs = {s["name"]: make_log(s, SEED, i) for i, s in enumerate(LOGS)}
    return [(logs[j["log"]].scans[j["start"]:j["start"] + j["frames"]],
             logs[j["log"]].odo[j["start"]:j["start"] + j["frames"]])
            for j in JOBS]


def _run(root, system="program"):
    said = []
    out = run_cell(root, CELL, SEED, 120.0, False, "cpu", system,
                   say=said.append)
    return out, said


def _failed(out):
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def _lockstep(cfg, rows, ticks, idle=()):
    """Records of a lockstep run over `rows`, one frame a tick; a row
    idles at the ticks of `idle` (row, tick) and goes on after them."""
    from ndt_slam_tpu_torch.pipeline.batch_runner import BatchFrontEnd
    bfe = BatchFrontEnd(cfg, len(rows), "cpu")
    at = [0] * len(rows)
    recs = [[] for _ in rows]
    for t in range(ticks):
        live = [(i, t) not in idle for i in range(len(rows))]
        out = bfe.process_batch(
            [scans[at[i]] if live[i] else None
             for i, (scans, _) in enumerate(rows)],
            [odo[at[i]] if live[i] else None
             for i, (_, odo) in enumerate(rows)])
        for i, rec in enumerate(out):
            if live[i]:
                recs[i].append(rec)
                at[i] += 1
    bfe.finalize()
    return bfe, recs


def test_two_site_run_is_correct_with_every_row_followed(root,
                                                         monkeypatch):
    seen = []

    class Context(harness.Context):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen.append(self)

    monkeypatch.setattr(harness, "Context", Context)
    out, said = _run(root)
    assert out["correct"], out["checks"]
    assert out["attempted"] == len(JOBS) * FRAMES and out["failed"] == 0
    jobs = [line for line in said if line.startswith("[job]")]
    assert [line.split()[1] for line in jobs] == [
        f"0.{r}" for r in range(len(JOBS))]
    assert all("complete" in line and "cut" not in line for line in jobs)
    followed = [line for line in said if "followed" in line]
    assert len(followed) == len(JOBS)
    # the per-layer readers that need no trace read the untraced run
    for name in ("farm_fallback_share", "farm_map_fallback_ms_per_scan",
                 "farm_map_stacked_ms_per_scan"):
        assert harness._reader(root, name)(seen[0]) > 0.0, name


def test_bf16_control_is_not_correct(root):
    out, _ = _run(root, system="bf16")
    assert not out["correct"]
    assert "pose_gap_m_p50" in _failed(out)


def test_last_row_pose_moved_in_its_records_is_caught(root, monkeypatch):
    from ndt_slam_tpu_torch.pipeline.batch_runner import BatchFrontEnd
    orig = BatchFrontEnd.process_batch

    def moved(self, *args, **kw):
        recs = orig(self, *args, **kw)
        last = recs[-1]
        if last is not None:
            last["fused_pose"] = [last["fused_pose"][0] + 0.1,
                                  *last["fused_pose"][1:]]
        return recs

    monkeypatch.setattr(BatchFrontEnd, "process_batch", moved)
    out, _ = _run(root)
    assert not out["correct"]
    assert "target_miss_share" in _failed(out)


def test_counters_count_the_ticks_and_the_hand_backs(cfg, rows,
                                                     monkeypatch):
    from ndt_slam_tpu_torch.mapping.pointcloud_map import PointCloudMap
    orig = PointCloudMap.add_points
    handed = []

    def spy(self, *args, **kw):
        handed.append(1)
        return orig(self, *args, **kw)

    monkeypatch.setattr(PointCloudMap, "add_points", spy)
    three = [rows[0], rows[2], rows[3]]
    idle = {(1, 4), (1, 5), (2, 9)}
    ticks = 16
    bfe, _ = _lockstep(cfg, three, ticks, idle)
    c = bfe.counts()
    assert c["ticks"] == ticks
    assert c["slot_fallbacks"] == len(handed) > 0
    assert c["stack_inits"] >= 1 and c["slot_loads"] >= 3
    assert c["idle_rows"] == len(idle)
    assert c["bootstrap_rows"] == 3
    assert c["row_ticks"] + c["bootstrap_rows"] + c["idle_rows"] == \
        3 * ticks
    bfe.reset_counts()
    assert set(bfe.counts().values()) == {0}


def test_a_row_alone_equals_its_row_of_the_four(cfg, rows):
    _, four = _lockstep(cfg, rows, FRAMES)
    for r in (0, 3):
        _, one = _lockstep(cfg, [rows[r]], FRAMES)
        assert one[0] == four[r]
