"""The system under test: the program, or in its place the control of
the output check (`--control bf16`, never in the benchmark's own runs).

From the program the benchmark takes its configuration class, its
front end and its stage timer (whose marks the traced run reads)."""

from __future__ import annotations

from typing import NamedTuple


class System(NamedTuple):
    name: str
    SlamConfig: type
    FrontEnd: type
    StageTimer: type


def load(name: str) -> System:
    if name == "program":
        from ndt_slam_tpu_torch.config import SlamConfig
        from ndt_slam_tpu_torch.pipeline.frontend import FrontEnd, StageTimer
        return System(name, SlamConfig, FrontEnd, StageTimer)
    if name == "bf16":
        from slambench.reference.control import SYSTEM
        return System(name, **SYSTEM)
    raise ValueError(f"no system {name!r}: program or bf16")
