"""Share of the traced device window in which no operation ran: 100 x
(1 - union of busy intervals / window), the window between the padded
session's leading and trailing spins."""


def read(ctx):
    tr = ctx.window.trace
    if tr is None or not tr.ops:
        return None
    span = tr.window_us[1] - tr.window_us[0]
    return 100.0 * (1.0 - tr.busy_us() / span) if span > 0 else None
