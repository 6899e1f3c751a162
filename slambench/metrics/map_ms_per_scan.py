"""Milliseconds a scan of the StageTimer stage(s) map (map step), on the
card's timeline, over the window outside the traced span."""


def read(ctx):
    return ctx.stage_ms_per_scan("map")
