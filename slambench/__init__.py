"""The benchmark of ndt_slam_tpu_torch (see PERF.md)."""
