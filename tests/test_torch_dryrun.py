"""`__graft_entry_torch__.dryrun_multichip(2, "cpu")`: two gloo ranks of
the CPU (spawned once for the module) run the sharded frame step, the
sharded sequential step, the sharded PCG and the sharded verify on a
(dp, pt) = (1, 2) mesh. `dryrun_multichip` itself raises unless every
output is finite and both ranks return the same bits.

Held against one device (the same functions over a single rank, no
process group) on `dryrun_inputs(2)`: the frame and sequential steps'
poses within 5e-5 m (the distributed tests' bar for a register; the
two halves of each buffer sum in another order than one device's),
`successful` and iterations equal; the PCG's poses within 5e-5 m; the
verify's relative poses within 5e-5 and `accepted` equal.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ndt_slam_tpu_torch.graph.loop_closure import (
    make_sharded_verify, pack_verify_out,
)
from ndt_slam_tpu_torch.graph.pose_graph import (
    graph_from_numpy, make_sharded_optimize,
)
from ndt_slam_tpu_torch.parallel.register import (
    make_sharded_frame_step, make_sharded_sequential_step,
)

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 5e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GRAFT = _load("graft_entry_torch",
              os.path.join(ROOT, "__graft_entry_torch__.py"))


@pytest.fixture(scope="module")
def ranks():
    return GRAFT.dryrun_multichip(2, "cpu")


@pytest.fixture(scope="module")
def one():
    """The dry run's four calls on one device."""
    d = GRAFT.dryrun_inputs(2)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in d["inp"].items()}
    src, sm, tgt, tm = t["src_xy"], t["src_mask"], t["tgt_xy"], t["tgt_mask"]
    z = torch.zeros((1, 3))
    frame = make_sharded_frame_step(None, d["cfg"])(
        src[None], sm[None], tgt[None], tm[None], z, z, z, t["cov"][None])
    seq = make_sharded_sequential_step(None, d["cfg"])(
        src, sm, t["odo"], z[0], z[0], t["cov"], tgt, tm, src, sm)
    pg, chi2 = make_sharded_optimize(None, iterations=2, cg_iters=8)(
        graph_from_numpy(**d["graph"], device="cpu"))
    ver = make_sharded_verify(None, d["vcfg"])(
        src, sm, tgt.expand(2, *tgt.shape).contiguous(),
        tm.expand(2, *tm.shape).contiguous(), torch.zeros((2, 3)))
    return {"frame_step": frame, "sequential_step": seq, "pose_graph": pg,
            "chi2": float(chi2), "verify": pack_verify_out(ver).numpy()}


def test_ranks_ran_the_four_calls(ranks):
    assert len(ranks) == 2
    for r in ranks:
        assert r["mesh"] == (1, 2)
        assert r["frame_step"].fused_pose.shape == (1, 3)
        assert r["verify"].shape == (2, 16)
        assert r["pose_graph"].shape == (16, 3) and np.isfinite(r["chi2"])


@pytest.mark.parametrize("step", ["frame_step", "sequential_step"])
def test_steps_match_one_device(ranks, one, step):
    got, want = ranks[0][step], one[step]
    np.testing.assert_array_equal(got.successful, want.successful.numpy())
    np.testing.assert_array_equal(got.iterations, want.iterations.numpy())
    for name in ("est_pose", "fused_pose"):
        a, b = getattr(got, name), getattr(want, name).numpy()
        np.testing.assert_allclose(a[..., :2], b[..., :2], atol=TOL)
        np.testing.assert_allclose(np.deg2rad(a[..., 2] - b[..., 2]), 0.0,
                                   atol=TOL)


def test_pose_graph_and_verify_match_one_device(ranks, one):
    np.testing.assert_allclose(ranks[0]["pose_graph"],
                               one["pose_graph"].numpy(), atol=TOL)
    got, want = ranks[0]["verify"], one["verify"]
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=TOL)


def test_dryrun_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GRAFT.dryrun_multichip(2)
