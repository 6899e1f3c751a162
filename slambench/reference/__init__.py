"""Reference of the benchmark: a plain implementation of the system's
semantics, its control and the judge."""
