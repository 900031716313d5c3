"""The card's peaks and the work the kernels must do (frozen here, so that
every implementation of a kernel is held to the same count).

Peaks of one NVIDIA H100 SXM at its full 700 W: HBM3 3.35 TB/s (NVIDIA's
data sheet); no integer rate is published, so INT32 issue is taken as 132
SMs x 64 lanes x 1.98 GHz boost, one operation a lane a cycle (half of the
67 TFLOP/s float32 lanes).  A card set below 700 W reaches less: the run
reports its power limit beside each share.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the Gotoh forward kernels' arithmetic a DP cell: M 12, I 12, D and both
# scans 13, fields, packing and the store 8
GOTOH_OPS_PER_CELL = 45
# the shear histogram's a staged byte: decode 1, range 1, count 1, allele
# 5, strand column 2, count 1
SHEAR_OPS_PER_BYTE = 11
SHEAR_COLS = 128  # int32 count columns the histogram writes a position


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least seconds a kernel that moves n_bytes and does n_ops integer
    operations can take: the larger of the two rates' times."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def gotoh_bound_s(B: int, Lq: int, Ls: int) -> float:
    """One Gotoh forward launch of B alignments of Lq x Ls cells: int8
    query and subject, two int32 lengths in; the int32 (Lq, B, Ls) plane and
    four int32 fields an alignment out; every cell computed."""
    n_bytes = B * (Lq + Ls) + 8 * B + 4 * Lq * B * Ls + 16 * B
    return bound_s(n_bytes, GOTOH_OPS_PER_CELL * B * Lq * Ls)


def shear_bound_s(window: int, lanes: int) -> float:
    """One shear-histogram launch: each of `lanes` lanes reads `window`
    staged bytes; `window` rows of SHEAR_COLS int32 counts are written."""
    staged = window * lanes
    return bound_s(staged + 4 * SHEAR_COLS * window, SHEAR_OPS_PER_BYTE * staged)
