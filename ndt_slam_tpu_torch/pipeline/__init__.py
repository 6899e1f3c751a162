"""Per-frame front end, the host loop over a log and the lockstep
batch runner over several."""
from ndt_slam_tpu_torch.pipeline.frontend import FrameResult, FrontEnd

__all__ = ["FrontEnd", "FrameResult"]
