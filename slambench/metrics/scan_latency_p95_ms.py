"""95th percentile (nearest rank), over every scan of the window, of the
host time from handing the scan to the front end until its record
returned."""

from slambench.yardstick.stats import percentile


def read(ctx):
    lat = ctx.window.latencies_s
    return percentile(lat, 95.0) * 1e3 if lat else None
