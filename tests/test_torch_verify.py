"""The port's loop-closure verifier (ndt_slam_tpu_torch.graph) against
the JAX package's on the CPU.

The four verifier scenes of tests/integration/test_loop_closure.py, at
`loop_coarse_starts` = 5 (the default): a 0.5 m / 5 deg initial error
recovered (`:42`), a different place rejected (`:172`), both overlap
directions reported (`:208`), half-cell offsets recovered by the coarse
multi-start (`:274`). One module fixture runs the JAX verifier on all
four under one configuration, so it compiles once. The configuration
is that file's `_loop_cfg()` with the capacities cut to what the scenes
fill: 640 scan slots for at most 541 points, and a 256-cell table (a
stage grid of these scans has fewer valid cells, which the fixture
checks, so nothing is dropped).

Held, candidate by candidate: `accepted` equal; the relative pose within
0.05 m / 0.3 deg; both overlaps within 0.02; the cost equal where it is
`failed_cost`, else within 1e-4 m^2 of the JAX package's cost at the
port's own pose, and of the JAX verifier's cost wherever the two poses
agree to 1 mm; and each scene's own claim. Where they do not (one
candidate of `half_cell_offsets`), the ladders leave the candidate
about 0.5 m off, 1 cm apart by f32 summation order (the JAX package
moves it by as much between two of its own compilations), and the 10
fixed ICP iterations end 6 mm apart: costs 1.1e-4 and 1.4e-6 m^2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.config import SlamConfig as JSlamConfig
from ndt_slam_tpu.core.points import pad_points as j_pad
from ndt_slam_tpu.graph.loop_closure import verify_candidates as j_verify
from ndt_slam_tpu.io.simulate import simulate_sequence
from ndt_slam_tpu.ndt.icp import icp_refine as j_icp_refine

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core.points import pad_points
from ndt_slam_tpu_torch.graph import (
    pack_verify_out, relative_pose_deg, unpack_verify_row, verify_candidates,
)
from ndt_slam_tpu_torch.ndt import kernels
from ndt_slam_tpu_torch.ndt.grid import build_grid

torch.set_num_threads(2)

CPU = torch.device("cpu")
SLOTS = 640
CELLS = 256
CFG = dict(
    grid_cells_x=128, grid_cells_y=128, max_scan_points=SLOTS,
    max_submap_points=16384, max_local_map_points=32768, end_frame=10_000,
    loop_enable=True, loop_min_frame_gap=30, loop_radius=3.0,
    loop_score_thre=0.02, loop_keyframe_skip=3, loop_check_skip=3,
    pgo_iterations=10, ndt_max_active_cells=CELLS,
)
B = 4


def _wall_scan(segs, n=541, noise=0.005, seed=0):
    """Raycast a scan of line-segment walls from the origin (the helper
    of tests/integration/test_loop_closure.py)."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    pts = []
    for a in angles:
        d = np.array([np.cos(a), np.sin(a)])
        best = np.inf
        for (p0, p1) in segs:
            p0 = np.asarray(p0, float)
            p1 = np.asarray(p1, float)
            e = p1 - p0
            denom = d[0] * (-e[1]) - d[1] * (-e[0])
            if abs(denom) < 1e-12:
                continue
            t = (p0[0] * (-e[1]) - p0[1] * (-e[0])) / denom
            u = (d[0] * p0[1] - d[1] * p0[0]) / denom
            if t > 0 and 0.0 <= u <= 1.0:
                best = min(best, t)
        if np.isfinite(best):
            r = best + noise * rng.standard_normal()
            pts.append([r * np.cos(a), r * np.sin(a)])
    return np.asarray(pts, np.float32)


def _room(w, h, extra=()):
    segs = [((-w, -h), (w, -h)), ((w, -h), (w, h)),
            ((w, h), (-w, h)), ((-w, h), (-w, -h))]
    return segs + list(extra)


def _scenes():
    """name -> (source points, target points, init [B,3])."""
    scan = simulate_sequence(n_frames=2, beams=541, seed=3,
                             noise_range=0.01)[0].scan_xy
    large = np.zeros((B, 3), np.float32)
    large[0] = [0.5, -0.4, np.deg2rad(5.0)]
    both = np.zeros((B, 3), np.float32)
    both[0] = [0.4, -0.3, np.deg2rad(4.0)]
    half = np.array([[0.62, 0.0, 0.0], [0.0, -0.66, 0.05],
                     [0.58, 0.63, -0.04], [-0.61, 0.7, 0.02]], np.float32)
    place_a = _wall_scan(_room(5, 4, [((2.0, -1.0), (2.0, 1.5))]), seed=1)
    place_b = _wall_scan(_room(4.2, 3.3, [((-2.5, 0.5), (-0.5, 0.5))]),
                         seed=2)
    return {
        "large_offset": (scan, scan, large),
        "mismatched_place": (place_a, place_b, np.zeros((B, 3), np.float32)),
        "both_overlaps": (scan, scan, both),
        "half_cell_offsets": (scan, scan, half),
    }


SCENES = _scenes()


@pytest.fixture(scope="module")
def jax_out():
    """The JAX verifier on every scene, one configuration (one compile)."""
    cfg = JSlamConfig.small(**CFG)
    out = {}
    for name, (src_np, tgt_np, init) in SCENES.items():
        assert len(src_np) <= SLOTS and len(tgt_np) <= SLOTS
        src, tgt = j_pad(src_np, SLOTS), j_pad(tgt_np, SLOTS)
        res = j_verify(cfg, src.xy, src.mask,
                       jnp.broadcast_to(tgt.xy, (B,) + tgt.xy.shape),
                       jnp.broadcast_to(tgt.mask, (B,) + tgt.mask.shape),
                       jnp.asarray(init))
        out[name] = {k: np.asarray(v) for k, v in res._asdict().items()}
    return out


@jax.jit
def _cost_at(src_xy, src_mask, tgt_xy, tgt_mask, poses, match_dist):
    """The JAX package's trimmed mean squared distance at fixed poses."""
    return jax.vmap(lambda p: j_icp_refine(
        p, src_xy, src_mask, tgt_xy, tgt_mask, match_dist=match_dist,
        iterations=0).mean_sq_err)(poses)


def _port(name):
    src_np, tgt_np, init = SCENES[name]
    cfg = SlamConfig.small(**CFG)
    src, tgt = pad_points(src_np, SLOTS, CPU), pad_points(tgt_np, SLOTS, CPU)
    for mult in cfg.loop_stage_mults:      # nothing dropped at capacity
        g = build_grid(tgt.xy, tgt.mask, torch.zeros(2), 128 // mult,
                       128 // mult, cfg.ndt_resolution * mult, min_pts=6)
        assert int(g.valid.sum()) < CELLS
    out = verify_candidates(
        cfg, src.xy, src.mask, tgt.xy[None].expand(B, -1, -1).contiguous(),
        tgt.mask[None].expand(B, -1).contiguous(), torch.from_numpy(init))
    assert kernels.launch_counts() == {"sgh": 0, "score_many": 0, "nn": 0}
    return cfg, out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_verifier_matches_jax(jax_out, name):
    cfg, out = _port(name)
    want = jax_out[name]
    got = {k: v.numpy() for k, v in out._asdict().items()}
    np.testing.assert_array_equal(got["accepted"], want["accepted"])
    rel, rel0 = got["rel_pose_rad"], want["rel_pose_rad"]
    np.testing.assert_allclose(rel[:, :2], rel0[:, :2], atol=0.05)
    assert np.rad2deg(np.abs(rel[:, 2] - rel0[:, 2])).max() <= 0.3
    np.testing.assert_allclose(got["overlap"], want["overlap"], atol=0.02)
    np.testing.assert_allclose(got["overlap_tgt"], want["overlap_tgt"],
                               atol=0.02)
    failed = want["cost"] == np.float32(cfg.failed_cost)
    np.testing.assert_array_equal(got["cost"][failed], want["cost"][failed])
    same = ~failed & (np.abs(rel[:, :2] - rel0[:, :2]).max(axis=1) <= 1e-3)
    np.testing.assert_allclose(got["cost"][same], want["cost"][same],
                               atol=1e-4)
    # the cost as a function of the pose: JAX's at the port's pose
    src_np, tgt_np, _ = SCENES[name]
    j_src, j_tgt = j_pad(src_np, SLOTS), j_pad(tgt_np, SLOTS)
    at_port = _cost_at(j_src.xy, j_src.mask, j_tgt.xy, j_tgt.mask,
                       jnp.asarray(rel), cfg.loop_match_dist)
    np.testing.assert_allclose(got["cost"][~failed],
                               np.asarray(at_port)[~failed], atol=1e-4)
    assert got["hessian"].shape == (B, 3, 3)

    # each scene's own claim, on the port
    if name == "large_offset":
        assert got["accepted"][0] and np.abs(rel[0, :2]).max() < 0.02
        assert abs(rel[0, 2]) < 0.01
    elif name == "mismatched_place":
        assert not got["accepted"].any()
    elif name == "both_overlaps":
        assert got["accepted"][0] and got["overlap"][0] > 0.9
        assert got["overlap_tgt"][0] > 0.9
    else:
        assert got["accepted"].all() and np.abs(rel[:, :2]).max() < 0.05

    # the packed row carries the same values
    packed = pack_verify_out(out).numpy()
    assert packed.shape == (B, 16)
    for k in range(B):
        r, cost, ov, ov_t, acc, hess = unpack_verify_row(packed[k])
        assert np.array_equal(r, rel[k]) and acc == bool(got["accepted"][k])
        assert (cost, ov, ov_t) == (float(got["cost"][k]),
                                    float(got["overlap"][k]),
                                    float(got["overlap_tgt"][k]))
        np.testing.assert_array_equal(hess, got["hessian"][k])


def test_relative_pose_deg():
    a = torch.tensor([1.0, 2.0, 90.0])
    b = torch.tensor([1.0, 3.0, 100.0])
    np.testing.assert_allclose(relative_pose_deg(a, b).numpy(),
                               [1.0, 0.0, 10.0], atol=1e-6)
