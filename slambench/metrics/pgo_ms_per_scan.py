"""Milliseconds a scan of the StageTimer stage(s) backend (back end, pose-
graph solve and map rewrite), on the card's timeline, over the window
outside the traced span."""


def read(ctx):
    return ctx.stage_ms_per_scan("backend")
