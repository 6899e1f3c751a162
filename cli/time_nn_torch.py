#!/usr/bin/env python
"""Time the nearest-neighbour kernel of the PyTorch/CUDA port on one GPU
as the map fills.

  python cli/time_nn_torch.py

Times the two launches of `kernels.nn_sq_dists` and of
`kernels.fitness_score` (device time from torch.profiler, mean of 10
calls) at four fills of 2048 source and 131072 target slots, all
prefixes: a young map (158 x 5924 live), a map a third full (200 x
40000), a full map under a real scan (200 x 131072) and full load (2048
x 131072). Prints one JSON line a fill with [pair launch, finish launch]
microseconds for each entry point. That the kernel equals its plain
version is held by chip_smoke.py and tests/test_torch_kernels.py, not
here. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))


def _device_us(fn, calls: int = 10) -> list:
    """Mean device microseconds of [nn_kernel, nn_finish_kernel] in one
    fn() call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"nn_kernel": 0.0, "nn_finish_kernel": 0.0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key in out:
                if key in e.name:
                    out[key] += e.time_range.elapsed_us() / calls
    return [round(out["nn_kernel"], 2), round(out["nn_finish_kernel"], 2)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_nn_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from ndt_slam_tpu_torch.ndt import kernels

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    n, m = 2048, 131072
    rng = np.random.default_rng(0)
    src = torch.from_numpy(
        rng.uniform(-20, 20, (n, 2)).astype(np.float32)).to(device)
    tgt = torch.from_numpy(
        rng.uniform(-20, 20, (m, 2)).astype(np.float32)).to(device)
    idx_n = torch.arange(n, device=device)
    idx_m = torch.arange(m, device=device)
    fills = {"young_map": (158, 5924), "mid_map": (200, 40000),
             "full_map": (200, m), "full": (n, m)}
    for fill, (n_live, m_live) in fills.items():
        sm, tm = idx_n < n_live, idx_m < m_live
        row = {"card": card, "fill": fill, "live": [n_live, m_live]}
        for mode, fn in (("d2", kernels.nn_sq_dists),
                         ("fitness", kernels.fitness_score)):
            row[mode] = _device_us(lambda: fn(src, sm, tgt, tm))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
