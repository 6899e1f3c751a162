"""Milliseconds a scan of the StageTimer stage(s) fitness, fuse (accept and
fuse: fitness and the Kalman fusion), on the card's timeline, over the
window outside the traced span."""


def read(ctx):
    return ctx.stage_ms_per_scan("fitness", "fuse")
