"""Milliseconds a scan of the lockstep's StageTimer stage map_stacked
(the batched map step on the stacked rows), on the card's timeline,
over the window outside the traced span."""


def read(ctx):
    return ctx.stage_ms_per_scan("map_stacked")
