"""Milliseconds a scan of the lockstep's StageTimer stage map_fallback
(the handed-back rows' own map path, with the stack's loads, dumps and
re-inits), on the card's timeline, over the window outside the traced
span."""


def read(ctx):
    return ctx.stage_ms_per_scan("map_fallback")
