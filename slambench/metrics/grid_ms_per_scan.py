"""Milliseconds a scan of the StageTimer stage(s) grid, source_filter,
compact (registration, grid build, source filter and compact table), on
the card's timeline, over the window outside the traced span."""


def read(ctx):
    return ctx.stage_ms_per_scan("grid", "source_filter", "compact")
