"""`__graft_entry_torch__.entry("cpu")` against the JAX package's
`__graft_entry__.entry()` on the CPU: the same example arguments, and
the per-frame step's outputs at the bars of
tests/test_torch_batch_step.py (successful and iterations equal, poses
within 1e-4 m and 1e-4 rad, cost to rtol 1e-4, map-frame points within
2e-4 m).

The JAX step here runs its compact engine, whose fitness takes the
matmul form |s|^2 + |t|^2 - 2 s.t: at the room's 5 m coordinates that
form moves the cost by 2.9e-4 relative. The cost is therefore held to
the JAX package's difference-form fitness, the one its `entry()` takes
on its own chip (`fitness_score_pallas`, in interpret mode here), at
the JAX step's pose.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_slam_tpu.core import pose2 as j_pose2
from ndt_slam_tpu.core.points import PAD_COORD, PointBuffer as JPointBuffer
from ndt_slam_tpu.mapping.voxel import voxel_filter as j_voxel_filter
from ndt_slam_tpu.ndt.pallas_kernels import fitness_score_pallas

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def steps():
    j_entry = _load("graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    t_entry = _load("graft_entry_torch",
                    os.path.join(ROOT, "__graft_entry_torch__.py"))
    j_fn, j_args = j_entry.entry()
    fn, args = t_entry.entry("cpu")
    want = jax.device_get(j_fn(*j_args))
    got = fn(*args)
    return j_args, want, args, got


def test_example_arguments_equal_jax(steps):
    j_args, _, args, _ = steps
    assert len(args) == len(j_args) == 8
    for a, b in zip(args, j_args):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_step_matches_jax_entry(steps):
    _, want, _, got = steps
    assert bool(got.successful) == bool(want.successful)
    assert int(got.iterations) == int(want.iterations)
    assert float(got.matched) == float(want.matched)
    for name in ("est_pose", "fused_pose"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a[:2], b[:2], atol=1e-4)
        assert abs(np.deg2rad(a[2] - b[2])) <= 1e-4
    np.testing.assert_allclose(got.global_xy.numpy(),
                               np.asarray(want.global_xy), atol=2e-4)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov),
                               rtol=1e-3, atol=1e-9)
    assert np.isfinite(got.small().numpy()).all()


def test_cost_matches_jax_difference_form_fitness(steps):
    j_args, want, _, got = steps
    src = j_voxel_filter(JPointBuffer(j_args[0], j_args[1]), 0.05)
    src_map = j_pose2.global_points(want.est_pose, src.xy)
    src_map = jnp.where(src.mask[:, None], src_map, PAD_COORD)
    fit = float(fitness_score_pallas(src_map, src.mask, j_args[6],
                                     j_args[7]))
    np.testing.assert_allclose(float(got.cost), fit, rtol=1e-4)


def test_entry_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    t_entry = _load("graft_entry_torch",
                    os.path.join(ROOT, "__graft_entry_torch__.py"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_entry.entry()
