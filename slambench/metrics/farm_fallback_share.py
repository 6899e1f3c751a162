"""Share of the lockstep's row-frames whose map update was handed back
to the row's own path (a submap close, or a flag set other than the
tick's most common one), from the runner's counters over the window:
100 x slot_fallbacks / (row_ticks + bootstrap_rows). None where the
program keeps no such counters."""


def read(ctx):
    c = getattr(ctx.window, "counts", None)
    if not c:
        return None
    rows = c["row_ticks"] + c["bootstrap_rows"]
    return 100.0 * c["slot_fallbacks"] / rows if rows else None
