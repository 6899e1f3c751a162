"""The port's public surface against the JAX package's: each package's
`__all__`, every name in it, `__version__`, and that importing the NDT
and pipeline packages pulls in neither JAX nor the kernel library."""

import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["", "core", "fuse", "graph", "io", "mapping", "ndt", "parallel",
            "pipeline", "pre"]
# the JAX package's only public name without a counterpart
SKIPPED = {"resample_points_jax"}
# names the port exports beyond the JAX package's `__all__`: its
# torch.distributed runtime and functions the JAX package leaves in
# their modules
PORT_ONLY = {
    "graph": {"make_sharded_optimize", "make_sharded_verify",
              "optimize_hierarchical", "optimize_pcg", "pack_verify_out",
              "unpack_verify_row"},
    "parallel": {"Axis", "SeqStepOut", "axis", "axis_size",
                 "broadcast_frame", "broadcast_scalar", "initialize",
                 "is_coordinator", "make_sharded_sequential_step", "shard",
                 "spawn", "start"},
}


def _pair(sub):
    name = "." + sub if sub else ""
    return (importlib.import_module("ndt_slam_tpu" + name),
            importlib.import_module("ndt_slam_tpu_torch" + name))


def test_all_matches_jax():
    for sub in PACKAGES:
        jax_pkg, port = _pair(sub)
        want = (set(jax_pkg.__all__) - SKIPPED) | PORT_ONLY.get(sub, set())
        assert sorted(port.__all__) == sorted(want), sub
        assert len(port.__all__) == len(set(port.__all__)), sub


def test_every_name_imports():
    for sub in PACKAGES:
        _, port = _pair(sub)
        for name in set(port.__all__) - {"__version__"}:
            obj = getattr(port, name)
            assert obj.__module__.startswith("ndt_slam_tpu_torch"), (sub,
                                                                     name)


def test_version_equal():
    jax_pkg, port = _pair("")
    assert port.__version__ == jax_pkg.__version__ == "0.1.0"


def test_import_loads_neither_jax_nor_kernels():
    code = r"""
import json, sys
before = set(sys.modules)
from ndt_slam_tpu_torch.ndt import align, fitness_score
from ndt_slam_tpu_torch.pipeline import FrontEnd
new = set(sys.modules) - before
kernels = sys.modules.get("ndt_slam_tpu_torch.ndt.kernels")
with open("/proc/self/maps") as f:
    mapped = [l for l in f if "libndt_kernels" in l]
print(json.dumps({
    "jax": sorted(m for m in new if m.split(".")[0] in ("jax", "ndt_slam_tpu")),
    "lib_loaded": kernels is not None and kernels._lib is not None,
    "mapped": len(mapped)}))
"""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "lib_loaded": False, "mapped": 0}
