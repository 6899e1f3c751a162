"""The Newton solve's share of its roofline over the traced span: the
least time the card could take for the solves' work (yardstick.roofline:
live source points from the reference's source filter, the matched
pairs and iterations each record reports), over all device time that
the align stage launched, its kernels and its tensor operations."""

from slambench.yardstick.roofline import newton_least_s


def read(ctx):
    tr = ctx.window.trace
    if tr is None:
        return None
    dev_s = tr.device_us_by_stage().get("align", 0.0) * 1e-6
    cfg = ctx.cfg
    least = 0.0
    for job in ctx.followed_rows():
        for k in range(ctx.run.tap.start, ctx.run.tap.stop):
            rec = job.record(k)
            if rec is None or rec.get("bootstrap") or (job.row, k) not in \
                    ctx.judge.counts:
                continue
            n_live, _ = ctx.judge.counts[(job.row, k)]
            least += newton_least_s(
                cfg.max_scan_points, n_live, float(rec["matched"]),
                int(rec["iterations"]), cfg.grid_cells_x * cfg.grid_cells_y,
                cfg.ndt_neighborhood)
    return 100.0 * least / dev_s if dev_s > 0 and least > 0 else None
