"""Metric readers, one file each, found by the metric's name in
BENCHMARK.json: `read(ctx)` returns the metric's value, or None when
this run has nothing to read it from (the metric is then left out of
the result line). `ctx` is `harness.Context`."""
