"""Scans whose record came back inside the window, over all rows,
divided by the window's seconds (from the first scan handed over to the
last record back, every job's set-up and finalize inside)."""


def read(ctx):
    w = ctx.window
    return w.scans / w.seconds if w.seconds > 0 and w.scans else None
