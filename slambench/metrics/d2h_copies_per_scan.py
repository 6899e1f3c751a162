"""Device-to-host copies a scan in the traced span (the fetches and the
host syncs), from the profiler's trace."""


def read(ctx):
    tr, n = ctx.window.trace, ctx.traced_scans()
    if tr is None or not n:
        return None
    return sum(op.cat == "gpu_memcpy" and "DtoH" in op.name
               for op in tr.ops) / n
