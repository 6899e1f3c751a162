"""Per-frame front end, the host loop over a log and the lockstep
batch runner over several."""
