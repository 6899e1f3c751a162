#!/usr/bin/env python3
"""The benchmark of ndt_slam_tpu_torch: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA cards the
cell asks for (it fails without them). The last line of standard output
is the result's JSON object; the numbers of the output check, each with
its limit, are the last lines of standard error. `--control bf16` runs
the output check's control in the program's place."""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout (the
# program's own kernels build into build/kernels there)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
# one intra-op thread: the host path is one Python thread, and with a
# pool of eight its speed swung by up to 17 % between runs of one seed
# on the H100's host (PERF.md)
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
# the process and every thread it starts (the CUDA driver's among them)
# on two fixed cores, the last two it may use, so that the scheduler
# does not move the host path between cores from run to run
CORES = sorted(os.sched_getaffinity(0))[-2:]
os.sched_setaffinity(0, CORES)
sys.path.insert(0, ROOT)

from slambench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
