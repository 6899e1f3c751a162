"""Device operations (kernels, copies, sets) a scan in the traced span,
from the profiler's trace."""


def read(ctx):
    tr, n = ctx.window.trace, ctx.traced_scans()
    if tr is None or not n:
        return None
    return len(tr.ops) / n
