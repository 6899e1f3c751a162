"""Drivers of the benchmark, one module each, found by the `driver` of a
configuration file. A driver gives `warmup(run)`, which drives a
throwaway system through the traffic's warm-up frames during set-up,
and `window(run)`, which drives the system under test through the
traffic's jobs back to back for the run's seconds and returns a
`record.Window`."""
