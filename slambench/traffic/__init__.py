"""Traffic of the benchmark: laser logs generated from a seed."""
