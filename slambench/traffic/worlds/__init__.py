"""Worlds of the traffic generator, one module each, found by name: a
module gives `segments()` (the static walls, [M,4]), `path(n_frames,
step)` (the ground-truth poses, [n,3] x y theta_deg) and
`movers_at(frame, n_movers)` (the moving obstacles' walls at a frame)."""
