"""Kernel 3's share of its roofline in the fitness pass over the traced
span: the least time for live source x live target pairs at 6
operations a pair (yardstick.roofline; the counts from the reference's
source filter and target), over all device time that the fitness stage
launched."""

from slambench.yardstick.roofline import nn_least_s


def read(ctx):
    tr = ctx.window.trace
    if tr is None:
        return None
    dev_s = tr.device_us_by_stage().get("fitness", 0.0) * 1e-6
    cfg = ctx.cfg
    least = 0.0
    for job in ctx.followed_rows():
        for k in range(ctx.run.tap.start, ctx.run.tap.stop):
            if job.record(k) is None or (job.row, k) not in ctx.judge.counts:
                continue
            n_live, m_live = ctx.judge.counts[(job.row, k)]
            least += nn_least_s(cfg.max_scan_points, n_live,
                                cfg.max_local_map_points, m_live)
    return 100.0 * least / dev_s if dev_s > 0 and least > 0 else None
