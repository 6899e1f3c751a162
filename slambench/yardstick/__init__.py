"""The benchmark's own arithmetic: statistics, the profiler session and
the reading of its trace, the peaks and the work counts of the
roofline. Later changes to the program do not reach it."""
