"""The lockstep's batched fitness pass (kernel 3's batched form, one
call a tick over every row) as a share of its roofline over the traced
span: the least time of each followed row's live pairs
(yardstick.roofline.nn_least_s) over the device time of the tick's
fitness stage. The same reading as nn_roofline's, in the lockstep's
cell."""

from slambench.metrics.nn_roofline import read  # noqa: F401
