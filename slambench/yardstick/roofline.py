"""Peaks of the card and the work of the kernels' layers.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W): 67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of
HBM. A layer's least time is the larger of its operations over the
first and its bytes over the second; each input byte is counted once,
and only the work these inputs need. The counts follow the kernel
checks' bound arithmetic of the repository's smoke test (its phase 3)."""

from __future__ import annotations

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
CANDIDATES = 12      # line-search poses scored a Newton iteration


def least_s(n_bytes: float, ops: float) -> float:
    return max(float(n_bytes) / HBM_BYTES_PER_S, float(ops) / F32_FLOP_PER_S)


def _window_bytes(slots: int, n_live: int, poses: int, matched: float,
                  cells: int, window: int, out_floats: int) -> float:
    """Bytes one window-kernel call needs: the source slots (x, y and
    mask), the poses, the grid origin, the window index of the cells the
    live points reach, the table rows of the matched cells, the output."""
    return (slots * 9 + poses * 12 + 8
            + min(poses * n_live * window, cells) * 4
            + matched * 32 + out_floats * 4)


def newton_least_s(slots: int, n_live: int, matched: float, iterations: int,
                   cells: int, radius: int = 1) -> float:
    """Least time of one registration's Newton solve: each iteration
    the score, gradient and Hessian at the pose (about 20 operations a
    live point for its features and 45 a matched point-cell pair) and
    the CANDIDATES line-search scores (20 a live point, 25 a matched
    pair, the pairs taken as at the pose)."""
    window = (2 * radius + 1) ** 2
    ops = ((n_live * 20 + matched * 45)
           + CANDIDATES * (n_live * 20 + matched * 25))
    n_bytes = (_window_bytes(slots, n_live, 1, matched, cells, window, 16)
               + _window_bytes(slots, n_live, CANDIDATES, matched, cells,
                               window, CANDIDATES))
    return iterations * least_s(n_bytes, ops)


def nn_least_s(src_slots: int, src_live: int, tgt_slots: int,
               tgt_live: int) -> float:
    """Least time of kernel 3's fitness pass: 6 operations a live
    (source, target) pair (2 subtractions, 2 products, a sum, a
    minimum); both masks, the live points and the per-source result."""
    ops = src_live * tgt_live * 6
    n_bytes = (src_slots + tgt_slots + 8 * (src_live + tgt_live)
               + 4 * src_slots)
    return least_s(n_bytes, ops)
