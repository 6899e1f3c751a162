"""The benchmark's arithmetic against hand-worked cases: percentiles,
spreads, the idle share and the stage attribution of a trace, the
per-scan stage times and the roofline's counts."""

import math
import types

import pytest

from slambench.harness import Context
from slambench.yardstick import roofline, stats
from slambench.yardstick.trace import parse_events


def test_percentile_nearest_rank():
    v = list(range(1, 101))           # 1..100
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5   # rank ceil(4.75)=5
    assert stats.percentile([5, 1, 4, 2, 3], 40) == 2   # rank 2
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_quartile_spread():
    # statistics.quantiles([1..8], n=4) = [2.25, 4.5, 6.75]
    assert stats.quartile_spread(range(1, 9)) == pytest.approx(4.5 / 4.5)
    assert stats.quartile_spread([10.0] * 6) == 0.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == 4.0
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 10)]
    assert stats.gaps(iv, -1, 2) == [(-1, 0)]


def test_ate_of_a_rigidly_moved_trajectory_is_zero():
    t = [[0, 0, 0], [1, 0, 0], [2, 1, 0], [3, 3, 0]]
    c, s = math.cos(0.3), math.sin(0.3)
    e = [[c * x - s * y + 5, s * x + c * y - 2, 0] for x, y, _ in t]
    assert stats.ate_rmse(e, t) == pytest.approx(0.0, abs=1e-12)
    assert stats.ate_rmse([[0, 0, 0], [1, 0, 0]],
                          [[0, 0, 0], [1, 0, 0]]) == 0.0


def _events():
    """A padded session: two spins each side; host marks compact@10,
    align@20, fitness@30; three kernels launched at 12, 15 (align) and
    25 (fitness) and one copy (DtoH) launched at 28."""
    def dev(name, ts, dur, corr, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    def run(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def mark(ts, stage):
        return {"ph": "X", "cat": "user_annotation",
                "name": "slambench.mark:" + stage, "ts": ts, "dur": 0}

    return [
        dev("spin_kernel", 0, 10, 1), dev("spin_kernel", 10, 10, 2),
        mark(10, "compact"), mark(20, "align"), mark(30, "fitness"),
        run(12, 10), run(15, 11), run(25, 12), run(28, 13),
        dev("window_kernel", 40, 10, 10), dev("window_sum_kernel", 45, 10, 11),
        dev("nn_kernel", 70, 20, 12),
        dev("Memcpy DtoH (Device -> Pinned)", 95, 5, 13, "gpu_memcpy"),
        dev("spin_kernel", 120, 10, 3), dev("spin_kernel", 130, 10, 4),
        {"ph": "i", "name": "ignored"},
    ]


def test_trace_window_busy_idle_and_stages():
    tr = parse_events(_events())
    assert tr.edges_kept
    assert tr.window_us == (20.0, 120.0)        # lead spins end, trail start
    assert len(tr.ops) == 4
    assert tr.busy_us() == 15 + 20 + 5           # [40,55] [70,90] [95,100]
    idle = 100 * (1 - tr.busy_us() / 100.0)
    assert idle == pytest.approx(60.0)
    assert tr.device_us_by_stage() == {"align": 20.0, "fitness": 25.0}
    # gaps [20,40) [55,70) [90,95) [100,120): the first begins at the
    # align mark (the host's align interval ends there), the rest after
    # the last mark
    g = tr.idle_gaps_by_stage()
    assert g["align"] == pytest.approx(20e-6)
    assert g["?"] == pytest.approx((15 + 5 + 20) * 1e-6)


def test_trace_that_lost_an_edge():
    ev = [e for e in _events() if not (e.get("name") == "spin_kernel"
                                       and e["ts"] >= 120)]
    tr = parse_events(ev)
    assert not tr.edges_kept
    assert tr.window_us == (20.0, 100.0)


def test_stage_ms_per_scan():
    w = types.SimpleNamespace(stage_ms={"grid": 30.0, "compact": 10.0,
                                        "align": 50.0},
                              stage_scans=10)
    ctx = Context(window=w)
    assert ctx.stage_ms_per_scan("grid", "source_filter", "compact") == 4.0
    assert ctx.stage_ms_per_scan("align") == 5.0
    assert ctx.stage_ms_per_scan("verify") is None
    ctx.window = types.SimpleNamespace(stage_ms={"align": 1.0},
                                       stage_scans=0)
    assert ctx.stage_ms_per_scan("align") is None


def test_roofline_counts():
    # kernel 3: 100 x 1000 live pairs, 6 ops each; bytes 200 + 2000 +
    # 8 * 1100 + 800 = 11800
    ops, n_bytes = 100 * 1000 * 6, 200 + 2000 + 8 * 1100 + 4 * 200
    assert roofline.nn_least_s(200, 100, 2000, 1000) == pytest.approx(
        max(ops / 67e12, n_bytes / 3.35e12))
    # Newton: 2 iterations, 10 live points, 4 matched pairs, radius 1
    ops_it = (10 * 20 + 4 * 45) + 12 * (10 * 20 + 4 * 25)
    b1 = 64 * 9 + 12 + 8 + min(90, 36) * 4 + 4 * 32 + 16 * 4
    b12 = 64 * 9 + 144 + 8 + min(1080, 36) * 4 + 4 * 32 + 12 * 4
    want = 2 * max(ops_it / 67e12, (b1 + b12) / 3.35e12)
    assert roofline.newton_least_s(64, 10, 4.0, 2, 36) == pytest.approx(want)
    assert roofline.newton_least_s(64, 10, 4.0, 0, 36) == 0.0
