"""`bench_torch.py` on the CPU: its room scan against `bench.py`'s bit
for bit, its registration step and its device chain against the JAX
package's on the same inputs, every mode's JSON line, and the exit
without a card.

- the register step on `register_inputs(small=True)` (a 48 x 48 window,
  256 cells, a 4096-slot target) against JAX's `_registration_step`, and
  with `--ndt-incremental-grid 1`'s lattice against JAX's
  `_registration_step_inc` (`bench.py:358-381`): est and fused poses
  within 1e-4 m and 1e-4 deg, iterations and `successful` equal;
- `device_chain` over 5 simulated frames at `SlamConfig.small`
  capacities against the same chain built here from JAX's
  `_registration_step` and `_add_scan_and_target` (`bench.py:199-225`):
  fused poses within 1e-3 m and 0.01 deg (the two packages part by
  1.2e-5 m and 1.4e-4 deg; a target left stale or a scan dropped from
  it moves them 0.034 m and 0.33 deg), and the last target's point
  count within 1 % of JAX's (2905 against 2907: voxel-boundary points;
  either fault leaves about 2050).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import PointBuffer as JPointBuffer
from ndt_slam_tpu.core.points import pad_points as j_pad_points
from ndt_slam_tpu.io.native import resample_points as j_resample_points
from ndt_slam_tpu.ndt.grid import lattice_anchor as j_lattice_anchor
from ndt_slam_tpu.ndt.grid import moments_abs as j_moments_abs
from ndt_slam_tpu.mapping.pointcloud_map import (
    _add_scan_and_target as j_add_scan_and_target,
)
from ndt_slam_tpu.pipeline.frontend import (
    _registration_step as j_registration_step,
)
from ndt_slam_tpu.pipeline.frontend import (
    _registration_step_inc as j_registration_step_inc,
)

from ndt_slam_tpu_torch.io.simulate import simulate_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _load("bench")
bench_torch = _load("bench_torch")


def _args(*argv):
    return bench_torch._parser().parse_args(list(argv))


def test_room_scan_bit_for_bit():
    for kw in (dict(n=1081, pose=(0.05, 0.03, 0.02), seed=9),
               dict(n=4321, pose=(0.6, 0.3, 0.15), seed=3),
               dict(n=361, noise=0.0)):
        a, b = bench._room_scan(**kw), bench_torch._room_scan(**kw)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


def test_register_step_matches_jax():
    cfg = bench_torch.register_config(small=True)
    inp = bench_torch.register_inputs(cfg, "cpu", small=True, variants=3)
    step = bench_torch.register_step(cfg, inp)
    jcfg = JSlamConfig(**cfg.to_dict())
    scan, local = inp["scan"], inp["local"]
    for odo in inp["odos"]:
        got = step(odo)
        host = [t.numpy() for t in (scan.xy, scan.mask, odo, inp["prev"],
                                    inp["last"], inp["cov"], local.xy,
                                    local.mask)]
        want = jax.device_get(j_registration_step(
            jcfg, *[jnp.asarray(a) for a in host]))
        for f in ("est_pose", "fused_pose"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(want, f), atol=1e-4)
        assert int(got.iterations) == int(want.iterations)
        assert bool(got.successful) == bool(want.successful)


def test_register_step_lattice_matches_jax():
    cfg = bench_torch.register_config(small=True, incremental=1)
    inp = bench_torch.register_inputs(cfg, "cpu", small=True, variants=3)
    step = bench_torch.register_step(cfg, inp)
    jcfg = JSlamConfig(**cfg.to_dict())
    assert jcfg.resolved_ndt_incremental_grid
    scan, local = inp["scan"], inp["local"]
    B, res = jcfg.resolved_grid_mom_cells, jcfg.ndt_resolution
    anchor = j_lattice_anchor(jnp.zeros(2), B, res)
    mom = j_moments_abs(jnp.asarray(local.xy.numpy()),
                        jnp.asarray(local.mask.numpy()), anchor, B, B, res)
    for odo in inp["odos"]:
        got = step(odo)
        host = [jnp.asarray(t.numpy()) for t in (
            scan.xy, scan.mask, odo, inp["prev"], inp["last"], inp["cov"],
            local.xy, local.mask)]
        want = jax.device_get(j_registration_step_inc(
            jcfg, *host, mom, anchor, host[0], host[1], jnp.int32(0), True))
        for f in ("est_pose", "fused_pose"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(want, f), atol=1e-4)
        assert int(got.iterations) == int(want.iterations)
        assert bool(got.successful) == bool(want.successful)


def _jax_chain(cfg, frames):
    """`bench.py`'s device chain (`:199-225`) on JAX: the fused poses and
    the last frame's target buffer."""
    scans = [j_pad_points(j_resample_points(fr.scan_xy, cfg.resample_space,
                                            cfg.resample_space_thre),
                          cfg.max_scan_points) for fr in frames]
    odos = [jnp.asarray(np.asarray(fr.odo_pose, np.float32))
            for fr in frames]
    flags = dict(
        append_scan=False, do_interior=cfg.remove_moving,
        include_newest=cfg.remove_moving, has_prev=True,
        filtered=cfg.ndt_target_filtered, cap_sub=cfg.max_submap_points,
        cap_local=cfg.max_local_map_points, resol=cfg.diff_resol,
        thre=cfg.thre_neighbor, leaf=cfg.submap_leaf_size,
    )
    prev_cloud = j_pad_points(
        np.concatenate([np.asarray(s.xy)[np.asarray(s.mask)]
                        for s in scans[:4]], 0), cfg.max_submap_points)
    state = (odos[0], odos[0], jnp.eye(3, dtype=jnp.float32) * 1e-4,
             JPointBuffer.empty(cfg.max_submap_points), jnp.int32(0),
             scans[0], scans[1], prev_cloud, prev_cloud)
    fused = []
    for scan, odo in zip(scans, odos):
        (prev_odo, last_pose, last_cov, proc, count,
         raw_a, raw_b, prev_cloud, local) = state
        out = j_registration_step(cfg, scan.xy, scan.mask, odo, prev_odo,
                                  last_pose, last_cov, local.xy, local.mask)
        gbuf = JPointBuffer(out.global_xy, scan.mask)
        proc, count, target = j_add_scan_and_target(
            proc, count, raw_a, raw_b, gbuf, prev_cloud, **flags)
        state = (odo, out.fused_pose, out.cov, proc, count, raw_b, gbuf,
                 prev_cloud, target)
        fused.append(np.asarray(out.fused_pose))
    return np.stack(fused), target


def test_device_chain_matches_jax():
    cfg = bench_torch.pipeline_config(_args("--device", "cpu"), small=True)
    frames = simulate_sequence(n_frames=5, beams=bench_torch.SMALL_BEAMS,
                               seed=4)
    rows, seconds, target = bench_torch.device_chain(cfg, frames, "cpu")
    assert rows.shape == (5, 24) and seconds > 0
    got = rows[:, :3].numpy()
    want, jtarget = _jax_chain(JSlamConfig(**cfg.to_dict()), frames)
    assert np.isfinite(got).all()
    assert np.abs(got[:, :2] - want[:, :2]).max() <= 1e-3
    dth = (got[:, 2] - want[:, 2] + 180.0) % 360.0 - 180.0
    assert np.abs(dth).max() <= 0.01
    n, jn = int(target.mask.sum()), int(np.asarray(jtarget.mask).sum())
    assert abs(n - jn) <= 0.01 * jn


# each mode's argv and the metrics it prints, in order
MODES = [
    ((), ["ndt_register_scans_per_s", "pipeline_scans_per_s",
          "pipeline_batch8_scans_per_s", "pipeline_device_scans_per_s"]),
    (("--cpu-baseline",), ["ndt_register_scans_per_s"]),
    (("--register-only", "--quick"), ["ndt_register_scans_per_s"]),
    (("--pipeline", "--pipeline-depth", "2"), ["pipeline_scans_per_s"]),
    (("--pipeline", "--batch", "2"), ["pipeline_batch2_scans_per_s"]),
    (("--pipeline-device",), ["pipeline_device_scans_per_s"]),
]


def test_every_mode_prints_its_lines(capsys):
    import json

    threads = torch.get_num_threads()
    for argv, names in MODES:
        rc = bench_torch.main([*argv, "--device", "cpu", "--reps", "2"],
                              small=True)
        lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
        assert rc == 0
        assert [l["metric"] for l in lines] == [f"{n}_cpu" for n in names]
        for l in lines:
            assert set(l) == {"metric", "value", "unit", "vs_baseline"}
            assert l["unit"] == "scans/s"
            assert l["value"] > 0 and l["vs_baseline"] > 0
        assert torch.get_num_threads() == threads


def test_no_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    assert bench_torch.main([]) == 1
    assert "--device cpu" in capsys.readouterr().err
