"""Peaks of the card and the work a request needs (copied from
``chip_smoke.bound``, the repo's bound arithmetic).

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates): 3.35 TB/s of HBM, 67 TFLOP/s of 32-bit arithmetic outside the
tensor cores.  A warm Count reads each operand row once and does a
bitwise op and a popcount a word, so its bound is the bytes.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PLANE_BYTES = (1 << 20) // 8  # one row of one slice: 131,072 bytes


def request_bytes(rows, n_slices: int) -> int:
    """The bytes a request of Counts needs: each distinct row it names,
    over every slice, read once.  ``rows``: the calls' operand lists."""
    distinct = {r for call in rows for r in call}
    return len(distinct) * int(n_slices) * PLANE_BYTES


def request_ops(rows, n_slices: int) -> int:
    """32-bit word operations a request needs: per call, a fold op for
    each operand past the first and a popcount and an add a word."""
    words = int(n_slices) * PLANE_BYTES // 4
    return sum((len(set(call)) + 1) * words for call in rows)


def bound_s(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over the 32-bit rate, and which of the two."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
