"""The fuse kernel (`kernels.ndt_fuse`, one launch for the accept-and-fuse
stage of a registration) against its plain twin, and the route of
`fuse.ekf`.

The card tests need a CUDA device and skip without one; they import no
JAX, so run them on the card with `python -m pytest --noconftest
tests/test_torch_fuse_kernel.py`. Each feeds the same CUDA inputs to
the kernel and to the twin (`fuse.ekf.fuse_stage_plain` and
`gate_and_fuse_plain`, torch on the card, `torch.linalg.eigh` included):
the three EKF cases of `tests/test_torch_mapping_fuse.py` (degenerate,
conditioned, reject) and a batch of 16 rows that mixes accepts, a
fitness reject, two innovation rejects, a fused-pose reject, a
non-finite Hessian, an unconverged solve, repeated and zero
eigenvalues, a wrapped heading and masked scan slots. The bars: the
fused pose within 1e-5 (m, deg) or one float32 step of the value where
a step is wider (a heading past 128 deg), the covariance within rtol 1e-4 /
atol 1e-8 (the JAX parity bars), `accept` and the cost equal, the
map-frame scan within 1e-6 m of `pose2.global_points` at the kernel's
own fused pose with `PAD_COORD` exactly where masked, `error_pose`
within 1e-6 of the kernel's fused pose less the odometry (and within
the pose bar of the twin's), `trans_probability` within 1e-6; two
launches bit for bit; one launch a call. A 20-frame simulated sequence
through `FrontEnd(cfg, "cuda")` with the kernel and with the twin agrees
pose by pose within 0.05 m and 0.3 deg, with one launch a registration
and no `torch.linalg.eigh`; a lockstep run launches once a tick. The
kernel is also held to the JAX package's `gate_and_fuse` on the EKF
cases and the 16 rows, at the bars of `tests/test_torch_mapping_fuse.py`,
through `tests/data/fuse_jax_reference.json` (the card has no JAX; a
CPU test recomputes the file with JAX and holds the twin to it), and
its eigen-decomposition alone (`kernels.kernel_sym3_eigh`) to float64
`torch.linalg.eigh` on ill-conditioned, near-repeated, repeated,
diagonal and indefinite matrices, beside cuSOLVER's float32 `eigh`.

The CPU tests hold the route: CPU tensors take the twins and launch
nothing, CUDA tensors (a tensor that reports a CUDA device) reach the
wrapper once a call, and the wrapper refuses CPU tensors.
"""

import json
import os

import numpy as np
import pytest
import torch

from ndt_slam_tpu_torch.config import SlamConfig
from ndt_slam_tpu_torch.core import pose2
from ndt_slam_tpu_torch.core.points import PAD_COORD
from ndt_slam_tpu_torch.fuse import ekf
from ndt_slam_tpu_torch.ndt import kernels

S, N = 64, 96   # source and scan slots a row


def _rot(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return q


def _ekf_case(kind):
    """(pred, est, hessian, cost, odo_motion, last_pose, last_cov), as
    `tests/test_torch_mapping_fuse.py` makes them."""
    rng = np.random.default_rng(7)
    q = _rot(rng)
    evals = {"degenerate": [2e-3, 50.0, 400.0],
             "conditioned": [30.0, 80.0, 500.0],
             "reject": [30.0, 80.0, 500.0]}[kind]
    H = (q * np.asarray(evals)) @ q.T
    pred = np.array([3.0, -2.0, 40.0])
    est = pred + [0.05, -0.03, 0.8]
    cost = 2.0 if kind == "reject" else 0.05
    motion = np.array([0.2, 0.01, 1.5])
    last = np.array([2.8, -2.0, 38.5])
    cov = np.diag([1e-3, 2e-3, 5e-4]) + 1e-4
    return [np.asarray(v, np.float32) for v in
            (pred, est, H, cost, motion, last, cov)]


# row kind -> what it exercises (the gates with the default SlamConfig:
# score_thre 0.5, max_innovation_trans 1 m, max_innovation_rot 30 deg)
ROWS = ("accept", "fitness_reject", "innovation_reject_t",
        "innovation_reject_r", "fused_reject", "nonfinite_hessian",
        "unconverged", "repeated_evals", "isotropic", "masked_slots",
        "degenerate", "zero_hessian", "wrapped_heading", "accept_b",
        "accept_c", "empty_source")


def _row(kind, rng):
    """One row's inputs: pose (pred, est, odo_pose, motion, last_pose),
    last_cov, hessian, objective, converged, fit, and the live counts of
    its source and scan slots."""
    pred = np.array([rng.uniform(-5, 5), rng.uniform(-5, 5),
                     rng.uniform(-170, 170)])
    est = pred + [rng.uniform(-0.08, 0.08), rng.uniform(-0.08, 0.08),
                  rng.uniform(-1.5, 1.5)]
    motion = np.array([rng.uniform(0.05, 0.3), rng.uniform(-0.02, 0.02),
                       rng.uniform(-3, 3)])
    last = pred - [motion[0], motion[1], motion[2]]
    odo = pred + [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5),
                  rng.uniform(-5, 5)]
    a = rng.standard_normal((3, 3)) * 1e-3
    last_cov = a @ a.T + np.diag([1e-3, 2e-3, 5e-4])
    H = (_rot(rng) * rng.uniform(40.0, 900.0, 3)) @ _rot(rng).T
    H = 0.5 * (H + H.T) + 1000.0 * np.eye(3)
    objective, converged, fit = -rng.uniform(50, 300), True, 0.05
    n_src, n_scan = int(rng.integers(20, S)), int(rng.integers(30, N))
    if kind == "fitness_reject":
        fit = 0.9
    elif kind == "innovation_reject_t":
        est = pred + [1.2, 0.4, 0.5]
    elif kind == "innovation_reject_r":
        est = pred + [0.1, 0.0, 35.0]
    elif kind == "fused_reject":
        # the innovation passes both gates (0.9 m, 28.6 deg), but the
        # projection drops its component along (1, 0, -1) / sqrt 2 and
        # turns it into (0.7 m, 0, 0.7 rad = 40 deg): the fused pose
        # leaves the rotation gate
        pred[2] = 10.0
        est = pred + [0.9, 0.0, np.degrees(0.5)]
        v = np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                      [1.0, 0.0, -1.0]]) / [[np.sqrt(2)], [1.0],
                                            [np.sqrt(2)]]
        H = (v.T * [5e4, 8e4, 1e-3]) @ v
        last_cov = np.eye(3)
    elif kind == "nonfinite_hessian":
        H[1, 2] = np.nan
    elif kind == "unconverged":
        converged = False
    elif kind == "repeated_evals":
        q = _rot(rng)
        H = (q * [300.0, 300.0, 900.0]) @ q.T
    elif kind == "isotropic":
        H = 400.0 * np.eye(3)
    elif kind == "masked_slots":
        n_src, n_scan = 3, 5
    elif kind == "degenerate":
        q = _rot(rng)
        H = (q * [2e-3, 50.0, 400.0]) @ q.T
    elif kind == "zero_hessian":
        H = np.zeros((3, 3))
    elif kind == "wrapped_heading":
        pred[2], est[2] = 179.5, -179.0
    elif kind == "empty_source":
        n_src = 0
    return pred, est, odo, motion, last, last_cov, H, objective, converged, \
        fit, n_src, n_scan


def _rows_batch(device, kinds=ROWS, seed=11):
    """The batch of `kinds` as the stage's operands on `device`."""
    rng = np.random.default_rng(seed)
    rows = [_row(k, rng) for k in kinds]
    f32 = lambda i, shape=(): torch.tensor(  # noqa: E731
        np.asarray([r[i] for r in rows], np.float32).reshape(-1, *shape),
        device=device)
    src_mask = torch.zeros(len(rows), S, dtype=torch.bool, device=device)
    scan_mask = torch.zeros(len(rows), N, dtype=torch.bool, device=device)
    for b, r in enumerate(rows):
        live = rng.permutation(S)[:r[10]]
        src_mask[b, torch.from_numpy(live).to(device)] = True
        scan_mask[b, :r[11]] = True
    scan = torch.tensor(rng.uniform(-20, 20, (len(rows), N, 2)),
                        dtype=torch.float32, device=device)
    return dict(
        pred_pose=f32(0, (3,)), est_pose=f32(1, (3,)), odo_pose=f32(2, (3,)),
        odo_motion=f32(3, (3,)), last_pose=f32(4, (3,)),
        last_cov=f32(5, (3, 3)), hessian=f32(6, (3, 3)),
        objective=f32(7).reshape(-1), fit=f32(9).reshape(-1),
        converged=torch.tensor([r[8] for r in rows], device=device),
        src_mask=src_mask, scan_xy=scan, scan_mask=scan_mask)


def _cost(cfg, ops):
    """The cost the stage fuses with: the fitness, or `failed_cost`
    where the solve did not converge."""
    return torch.where(ops["converged"], ops["fit"], cfg.failed_cost)


# The JAX package's `fuse.ekf.gate_and_fuse`, run row by row on the CPU
# on the float32 inputs of the three EKF cases (the degenerate one also
# with the projection off) and of the 16 rows. The card has no JAX: its
# tests read the outputs from this file, and a CPU test recomputes them.
JAX_FILE = os.path.join(os.path.dirname(__file__), "data",
                        "fuse_jax_reference.json")
EKF_CASES = ("degenerate", "conditioned", "reject", "degenerate_flat")


def _ekf_cfg(cfg, case):
    return cfg.replace(fuse_degenerate_ratio=0.0) \
        if case == "degenerate_flat" else cfg


def _jax_inputs():
    """{case: (settings change, [rows of gate_and_fuse's 7 operands])}
    as float32 numpy: each EKF case one row, "rows" the 16 rows."""
    out = {c: [_ekf_case(c.removesuffix("_flat"))] for c in EKF_CASES}
    ops = _rows_batch("cpu")
    cost = _cost(SlamConfig(), ops)
    out["rows"] = [[t[b].numpy() for t in (
        ops["pred_pose"], ops["est_pose"], ops["hessian"], cost,
        ops["odo_motion"], ops["last_pose"], ops["last_cov"])]
        for b in range(len(ROWS))]
    return out


def _jax_reference():
    """{case: {"fused", "cov", "accept"}} of the JAX package."""
    import jax.numpy as jnp

    from ndt_slam_tpu.config import SlamConfig as JSlamConfig
    from ndt_slam_tpu.fuse.ekf import gate_and_fuse as j_gate_and_fuse

    out = {}
    for case, rows in _jax_inputs().items():
        jcfg = _ekf_cfg(JSlamConfig(), case)
        res = [j_gate_and_fuse(jcfg, *[jnp.asarray(a) for a in r])
               for r in rows]
        out[case] = {
            "fused": [np.asarray(f, np.float32).tolist() for f, _, _ in res],
            "cov": [np.asarray(c, np.float32).tolist() for _, c, _ in res],
            "accept": [bool(a) for _, _, a in res]}
    return out


def _read_jax_reference():
    with open(JAX_FILE) as fh:
        return json.load(fh)["cases"]


def _assert_as_jax(fused, cov, accept, want):
    """The bars `tests/test_torch_mapping_fuse.py` holds the twin to
    against the JAX package: accept equal, the fused pose within rtol
    1e-5 / atol 1e-5, the covariance within rtol 1e-4 / atol 1e-8."""
    fused, cov = fused.cpu().reshape(-1, 3), cov.cpu().reshape(-1, 3, 3)
    assert accept.cpu().reshape(-1).tolist() == want["accept"]
    np.testing.assert_allclose(fused.numpy(), np.float32(want["fused"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), np.float32(want["cov"]),
                               rtol=1e-4, atol=1e-8)


def _one_row(ops, b):
    """Row b of the batch's operands, one row's shapes."""
    return {k: v[b].contiguous() for k, v in ops.items()}


def _stage(fn, cfg, ops):
    return fn(cfg, ops["pred_pose"], ops["est_pose"], ops["hessian"],
              ops["objective"], ops["converged"], ops["fit"], ops["odo_pose"],
              ops["odo_motion"], ops["last_pose"], ops["last_cov"],
              ops["src_mask"], ops["scan_xy"], ops["scan_mask"])


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: `fuse.ekf`'s route is
    decided by `is_cuda`, the work under it runs on the CPU."""
    @property
    def is_cuda(self):
        return True


def _fake_fuse(calls):
    def run(cfg, pred, est, hessian, fit, *rest):
        calls.append(tuple(pred.shape))
        lead = tuple(pred.shape[:-1])
        return (torch.zeros(lead), pred.clone(), torch.eye(3).expand(
            *lead, 3, 3), torch.ones(lead, dtype=torch.bool), None, None,
            None)
    return run


@pytest.mark.parametrize("rows", [False, True])
def test_cpu_tensors_take_the_twin(monkeypatch, rows):
    """On CPU tensors `fuse_stage` and `gate_and_fuse` are their plain
    twins and launch nothing."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fuse wrapper was called on CPU tensors")
    monkeypatch.setattr(ekf, "ndt_fuse", refuse)
    kernels.reset_launch_counts()
    cfg = SlamConfig()
    ops = _rows_batch("cpu")
    if not rows:
        ops = _one_row(ops, 0)
    got = _stage(ekf.fuse_stage, cfg, ops)
    want = _stage(ekf.fuse_stage_plain, cfg, ops)
    args = (ops["pred_pose"], ops["est_pose"], ops["hessian"], got[0],
            ops["odo_motion"], ops["last_pose"], ops["last_cov"])
    gf = ekf.gate_and_fuse(cfg, *args)
    wf = ekf.gate_and_fuse_plain(cfg, *args)
    for g, w in zip((*got, *gf), (*want, *wf)):
        assert torch.equal(g, w)
    lead = (len(ROWS),) if rows else ()
    assert got[1].shape == (*lead, 3) and got[4].shape == (*lead, N, 2)
    assert kernels.launch_counts()["fuse"] == 0


@pytest.mark.parametrize("entry", ["fuse_stage", "gate_and_fuse"])
def test_route_on_card_tensors(monkeypatch, entry):
    """A tensor on the card reaches the wrapper once a call, in its own
    shapes (one row or rows)."""
    calls = []
    monkeypatch.setattr(ekf, "ndt_fuse", _fake_fuse(calls))
    cfg = SlamConfig()
    for ops in (_rows_batch("cpu"), _one_row(_rows_batch("cpu"), 3)):
        card = {k: v.as_subclass(_OnCard) for k, v in ops.items()}
        if entry == "fuse_stage":
            out = _stage(ekf.fuse_stage, cfg, card)
            assert len(out) == 7
        else:
            fused, cov, accept = ekf.gate_and_fuse(
                cfg, card["pred_pose"], card["est_pose"], card["hessian"],
                card["fit"], card["odo_motion"], card["last_pose"],
                card["last_cov"])
            assert fused.shape == ops["pred_pose"].shape
    assert calls == [(len(ROWS), 3), (3,)]


def test_wrapper_refuses_cpu_tensors_and_counts():
    """`kernels.ndt_fuse` takes CUDA tensors only and says where CPU
    tensors go; its launches count under `fuse`."""
    ops = _rows_batch("cpu")
    with pytest.raises(ValueError, match="CUDA tensors.*fuse_stage_plain"):
        kernels.ndt_fuse(SlamConfig(), ops["pred_pose"], ops["est_pose"],
                         ops["hessian"], ops["fit"], ops["odo_motion"],
                         ops["last_pose"], ops["last_cov"])
    assert kernels.WRAPPERS["fuse"] == (kernels.ndt_fuse,)
    kernels.ndt_fuse.launches = 2
    assert kernels.launch_counts()["fuse"] == 2
    assert kernels.wrapper_launch_counts()["ndt_fuse"] == 2
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["fuse"] == 0


def test_jax_reference_file_is_the_jax_package():
    """The file the card tests read holds what the JAX package's
    `gate_and_fuse` gives on these inputs today (rewrite it with
    `python tests/test_torch_fuse_kernel.py`)."""
    pytest.importorskip("jax")
    want, got = _read_jax_reference(), _jax_reference()
    assert sorted(got) == sorted(want)
    for case in want:
        assert got[case]["accept"] == want[case]["accept"], case
        for key in ("fused", "cov"):
            np.testing.assert_allclose(got[case][key], want[case][key],
                                       rtol=1e-6, atol=1e-9, err_msg=case)


@pytest.mark.parametrize("case", [*EKF_CASES, "rows"])
def test_twin_matches_the_jax_reference_file(case):
    """The CPU twin against the JAX package's outputs in the file, at the
    bars of `tests/test_torch_mapping_fuse.py`: each EKF case as one row,
    the 16 rows as one batch."""
    rows = _jax_inputs()[case]
    args = [torch.from_numpy(np.stack([r[i] for r in rows]))
            for i in range(7)]
    if case != "rows":
        args = [a[0] for a in args]
    fused, cov, accept = ekf.gate_and_fuse(_ekf_cfg(SlamConfig(), case),
                                           *args)
    _assert_as_jax(fused, cov, accept, _read_jax_reference()[case])


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _bits_equal(x, y):
    if x.dtype == torch.bool:
        return torch.equal(x, y)
    return bool(((x.view(torch.int32) == y.view(torch.int32))
                 | (torch.isnan(x) & torch.isnan(y))).all())


def _assert_pose_close(got, want, scale=None):
    """Within 1e-5 (m, deg), or within eps |x| of `scale` (`want`) where
    that is wider: one float32 step of a heading past 128 deg is 1.5e-5
    deg, and the two sides may round it to neighbouring steps."""
    bar = torch.clamp(torch.finfo(torch.float32).eps
                      * (want if scale is None else scale).abs(), min=1e-5)
    gap = (got - want).abs()
    assert bool((gap <= bar).all()), float((gap - bar).max())


def _check_stage(cfg, ops):
    """The kernel's fuse stage against the twin's on the same CUDA
    operands, to the bars of the module docstring; returns the
    kernel's outputs."""
    before = kernels.launch_counts()["fuse"]
    got = _stage(ekf.fuse_stage, cfg, ops)
    assert kernels.launch_counts()["fuse"] == before + 1
    want = _stage(ekf.fuse_stage_plain, cfg, ops)
    cost, fused, cov, accept, g, err, tprob = got
    assert torch.equal(accept, want[3]), (accept, want[3])
    assert torch.equal(cost, want[0])
    _assert_pose_close(fused, want[1])
    torch.testing.assert_close(cov, want[2], rtol=1e-4, atol=1e-8)
    torch.testing.assert_close(tprob, want[6], rtol=0, atol=1e-6)
    _assert_pose_close(err, want[5], scale=want[1])
    torch.testing.assert_close(
        err, pose2.cal_global_motion(fused, ops["odo_pose"]), rtol=0,
        atol=1e-6)
    at_own = pose2.global_points(fused, ops["scan_xy"])
    m = ops["scan_mask"]
    torch.testing.assert_close(g[m], at_own[m], rtol=0, atol=1e-6)
    assert bool((g[~m] == PAD_COORD).all())
    again = _stage(ekf.fuse_stage, cfg, ops)
    for a, b in zip(got, again):
        assert _bits_equal(a, b)
    return got


@pytest.mark.parametrize("kind", ["degenerate", "conditioned", "reject"])
def test_ekf_cases_match_the_twin(cuda, kind):
    """The JAX parity cases, alone through `gate_and_fuse` and as one
    row of the whole stage (a short scan, two masked slots)."""
    cfg = SlamConfig()
    pred, est, H, cost, motion, last, cov = (
        torch.from_numpy(a).to(cuda) for a in _ekf_case(kind))
    args = (pred, est, H, cost, motion, last, cov)
    before = kernels.launch_counts()["fuse"]
    fused, c, accept = ekf.gate_and_fuse(cfg, *args)
    assert kernels.launch_counts()["fuse"] == before + 1
    wf, wc, wa = ekf.gate_and_fuse_plain(cfg, *args)
    assert bool(accept) == bool(wa) == (kind != "reject")
    _assert_pose_close(fused, wf)
    torch.testing.assert_close(c, wc, rtol=1e-4, atol=1e-8)
    if kind == "degenerate":
        # without the projection the kernel fuses along the weak
        # direction too, as the twin does
        flat = cfg.replace(fuse_degenerate_ratio=0.0)
        f0, _, _ = ekf.gate_and_fuse(flat, *args)
        w0, _, _ = ekf.gate_and_fuse_plain(flat, *args)
        _assert_pose_close(f0, w0)
        assert float((f0 - fused).abs().max()) > 1e-3
    rng = np.random.default_rng(5)
    scan = torch.tensor(rng.uniform(-10, 10, (N, 2)), dtype=torch.float32,
                        device=cuda)
    scan_mask = torch.ones(N, dtype=torch.bool, device=cuda)
    scan_mask[[4, 50]] = False
    src_mask = torch.zeros(S, dtype=torch.bool, device=cuda)
    src_mask[:40] = True
    _check_stage(cfg, dict(
        pred_pose=pred, est_pose=est, hessian=H,
        objective=torch.tensor(-120.0, device=cuda),
        converged=torch.tensor(True, device=cuda), fit=cost,
        odo_pose=pred + torch.tensor([0.3, -0.1, 2.0], device=cuda),
        odo_motion=motion, last_pose=last, last_cov=cov, src_mask=src_mask,
        scan_xy=scan, scan_mask=scan_mask))


def test_kernel_matches_the_jax_package(cuda):
    """The kernel against the JAX package's `gate_and_fuse` (the file's
    outputs, run row by row on the CPU) at the bars of
    `tests/test_torch_mapping_fuse.py`: the EKF cases through
    `gate_and_fuse`, the 16 rows through `gate_and_fuse` and through the
    whole stage, one launch each."""
    cfg, want = SlamConfig(), _read_jax_reference()
    for case in EKF_CASES:
        args = [torch.from_numpy(a).to(cuda)
                for a in _jax_inputs()[case][0]]
        _assert_as_jax(*ekf.gate_and_fuse(_ekf_cfg(cfg, case), *args),
                       want[case])
    ops = _rows_batch(cuda)
    before = kernels.launch_counts()["fuse"]
    fused, cov, accept = ekf.gate_and_fuse(
        cfg, ops["pred_pose"], ops["est_pose"], ops["hessian"],
        _cost(cfg, ops), ops["odo_motion"], ops["last_pose"],
        ops["last_cov"])
    _assert_as_jax(fused, cov, accept, want["rows"])
    _, fused, cov, accept, *_ = _stage(ekf.fuse_stage, cfg, ops)
    _assert_as_jax(fused, cov, accept, want["rows"])
    assert kernels.launch_counts()["fuse"] == before + 2


def _sym3_cases(rng):
    """Symmetric 3x3 matrices, [R,3,3] float64, by kind: NDT Hessians at
    their scales, ill-conditioned (1e4 to 1e8), near-repeated roots
    (relative gaps 1e-3 to 1e-7), exactly repeated, diagonal, zero,
    indefinite and a permuted diagonal."""
    def rot():
        return _rot(rng)

    def mat(evals):
        q = rot()
        return (q * np.asarray(evals, np.float64)) @ q.T

    cases = {"hessian": [mat(rng.uniform(40.0, 9e4, 3)) for _ in range(64)],
             "ill_conditioned": [mat([10.0 ** -e, 1.0, 5.0]) * 1e3
                                 for e in (1, 2, 3, 4, 5)]
             + [mat([1e-3, 2.0, 4e4]), mat([2e-3, 50.0, 400.0])],
             "near_repeated": [mat([300.0, 300.0 * (1 + g), 900.0])
                               for g in (1e-3, 1e-4, 1e-5, 1e-6, 1e-7)]
             + [mat([5.0, 900.0, 900.0 * (1 + g)])
                for g in (1e-3, 1e-5, 1e-7)],
             "repeated": [mat([300.0, 300.0, 900.0]),
                          mat([7.0, 400.0, 400.0]), 400.0 * np.eye(3)],
             "diagonal": [np.diag([3.0, 1.0, 2.0]), np.zeros((3, 3)),
                          np.diag([0.0, 0.0, 5.0])],
             "indefinite": [mat([-50.0, 1e-2, 300.0]),
                            mat([-900.0, -20.0, -1.0])]}
    return {k: np.stack(v) for k, v in cases.items()}


@pytest.mark.parametrize("kind", ["hessian", "ill_conditioned",
                                  "near_repeated", "repeated", "diagonal",
                                  "indefinite"])
def test_sym3_eigh_against_float64(cuda, kind):
    """The fuse kernel's eigen-decomposition (`kernel_sym3_eigh`, the
    same device function) against float64 `torch.linalg.eigh` of the
    float32 matrix, beside cuSOLVER's float32 `eigh` that the twin
    calls: eigenvalues within 8 eps |A|, the residual |A V - V diag(w)|
    and |V^T V - I| within 8 eps (|A| the largest eigenvalue's
    magnitude), each column against float64's where its eigenvalue
    stands apart from the others by 1e-3 |A| (elsewhere a vector is free
    within its eigenspace), and the largest residual and departure from
    orthogonality no more than twice cuSOLVER's or 4 eps, whichever is
    wider."""
    eps = float(torch.finfo(torch.float32).eps)
    a32 = torch.tensor(_sym3_cases(np.random.default_rng(17))[kind],
                       dtype=torch.float32, device=cuda)
    a64 = a32.double().cpu()
    w64, v64 = torch.linalg.eigh(a64)
    w, v = (t.double().cpu() for t in kernels.kernel_sym3_eigh(a32))
    wc, vc = (t.double().cpu() for t in torch.linalg.eigh(a32))
    scale = w64.abs().amax(-1).clamp(min=1e-30)
    eye = torch.eye(3, dtype=torch.float64)

    def residuals(w_, v_):
        res = torch.linalg.matrix_norm(a64 @ v_ - v_ * w_[:, None, :],
                                       ord=2) / scale
        orth = torch.linalg.matrix_norm(v_.mT @ v_ - eye, ord=2)
        return res, orth

    res, orth = residuals(w, v)
    res_c, orth_c = residuals(wc, vc)
    d_w = ((w - w64).abs().amax(-1) / scale)
    print(f"[sym3_eigh] {kind}: eigenvalues {float(d_w.max()):.3g} |A|; "
          f"residual {float(res.max()):.3g} (cuSOLVER "
          f"{float(res_c.max()):.3g}); orthogonality {float(orth.max()):.3g}"
          f" (cuSOLVER {float(orth_c.max()):.3g})")
    assert float(d_w.max()) <= 8 * eps
    assert float(res.max()) <= 8 * eps and float(orth.max()) <= 8 * eps
    assert float(res.max()) <= max(2 * float(res_c.max()), 4 * eps)
    assert float(orth.max()) <= max(2 * float(orth_c.max()), 4 * eps)
    gap = torch.stack([w64[:, 1] - w64[:, 0],
                       torch.minimum(w64[:, 1] - w64[:, 0],
                                     w64[:, 2] - w64[:, 1]),
                       w64[:, 2] - w64[:, 1]], -1) / scale[:, None]
    apart = gap > 1e-3
    cos = (v * v64).sum(-2).abs()
    assert bool((cos[apart] >= 1 - 1e-4).all()), cos[apart].min()


def test_rows_batch_matches_the_twin(cuda):
    """16 rows in one launch, each row's kind as named in ROWS; each row
    also equal to its own one-row launch."""
    cfg = SlamConfig()
    ops = _rows_batch(cuda)
    got = _check_stage(cfg, ops)
    accept = dict(zip(ROWS, got[3].tolist()))
    for kind in ("fitness_reject", "innovation_reject_t",
                 "innovation_reject_r", "fused_reject", "unconverged"):
        assert not accept[kind], kind
    for kind in ("accept", "nonfinite_hessian", "repeated_evals",
                 "isotropic", "masked_slots", "degenerate", "zero_hessian",
                 "wrapped_heading", "accept_b", "accept_c"):
        assert accept[kind], kind
    assert float(got[0][ROWS.index("unconverged")]) == cfg.failed_cost
    for b in (0, ROWS.index("fused_reject"), ROWS.index("wrapped_heading")):
        one = _stage(ekf.fuse_stage, cfg, _one_row(ops, b))
        for a, r in zip(got, one):
            assert _bits_equal(a[b], r)


def test_sequence_and_lockstep_on_the_kernel(cuda, monkeypatch):
    """20 simulated frames through `FrontEnd(cfg, "cuda")` with the
    kernel and with the twin: pose by pose within 0.05 m and 0.3 deg, one
    launch a registration, no `torch.linalg.eigh` on the kernel's run;
    then three lockstep rows over 12 ticks, one launch a tick."""
    from ndt_slam_tpu_torch.io.simulate import simulate_sequence
    from ndt_slam_tpu_torch.pipeline import frontend
    from ndt_slam_tpu_torch.pipeline.batch_runner import run_slam_batch

    cfg = SlamConfig.small(ndt_trans_eps=1e-3)
    frames = simulate_sequence(20, beams=181, seed=3)

    def run():
        fe = frontend.FrontEnd(cfg, cuda)
        for fr in frames:
            fe.process(fr.scan_xy, fr.odo_pose, sid=fr.sid)
        return fe.get_poses()

    def no_eigh(*args, **kwargs):
        raise AssertionError("torch.linalg.eigh on the card's path")
    kernels.reset_launch_counts()
    with monkeypatch.context() as m:
        m.setattr(torch.linalg, "eigh", no_eigh)
        got = run()
        torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse"] == len(frames) - 1
    with monkeypatch.context() as m:
        m.setattr(frontend, "fuse_stage", ekf.fuse_stage_plain)
        want = run()
    assert np.abs(got[:, :2] - want[:, :2]).max() < 0.05
    dth = (got[:, 2] - want[:, 2] + 180.0) % 360.0 - 180.0
    assert np.abs(dth).max() < 0.3

    seqs = [simulate_sequence(12, beams=181, seed=s) for s in (4, 5, 6)]
    kernels.reset_launch_counts()
    run_slam_batch(seqs, cfg, cuda)
    # tick 0 bootstraps every row; each later tick is one batched step
    assert kernels.launch_counts()["fuse"] == 11


if __name__ == "__main__":
    # rewrite the JAX package's outputs that the card tests read
    with open(JAX_FILE, "w") as fh:
        json.dump({"what": "ndt_slam_tpu.fuse.ekf.gate_and_fuse, row by "
                           "row on the CPU, float32 (see _jax_reference)",
                   "cases": _jax_reference()}, fh, indent=1)
        fh.write("\n")
