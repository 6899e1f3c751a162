"""The lockstep's Newton solves' share of their roofline over the
traced span: the least time of every followed row's solve in the
traced ticks (yardstick.roofline.newton_least_s, with the judge's
counts keyed by row and frame), over all device time the tick's align
stage launched (one rows-form launch of the kernel a tick). The same
reading as newton_roofline's, in the lockstep's cell."""

from slambench.metrics.newton_roofline import read  # noqa: F401
