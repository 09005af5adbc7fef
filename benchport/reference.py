"""The plain reference: exact Counts of N-ary folds, from the pairs.

It rebuilds every row of the index as dense 32-bit words on ``device``
from ``datagen``'s pairs (the same seed gives the same pairs the port was
handed), then folds and counts each checked call with plain torch
operations: no kernel, cache or batching of the program, and nothing of
``pilosa_tpu_torch`` imported.  Pilosa's semantics: ``Union`` ORs the
operands, ``Intersect`` ANDs them, ``Difference`` keeps the first
operand's bits that no other operand has; ``Count`` sums the set bits
over every slice.

``control=True`` computes the same counts with each slice's count carried
in bfloat16 and summed in bfloat16: the configuration's guarantee of
exact counts broken the way a fast path on the tensor cores would break
it.  The check has to call that not correct.
"""

from __future__ import annotations

import torch

from benchport import datagen

WORDS = datagen.SLICE_WIDTH // 32
_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_H01 = 0x0101010101010101


def dense_rows(cfg: dict, seed: int, device, block: int = 16) -> torch.Tensor:
    """int32 [rows, slices, W]: bit ``c`` of row ``r`` is set iff the
    pairs hold ``(r, c)``."""
    n_slices, n_rows = int(cfg["slices"]), int(cfg["rows"])
    dense = torch.zeros((n_rows, n_slices, WORDS), dtype=torch.int32, device=device)
    flat = dense.view(-1)
    for rows, cols in datagen.chunks(cfg, seed, device, block):
        slices = cols >> datagen.SLICE_BITS
        local = cols & (datagen.SLICE_WIDTH - 1)
        # One bit once: a pair given twice sets it once.
        pos = torch.unique(((rows * n_slices + slices) << datagen.SLICE_BITS) | local)
        word = (pos >> 5)
        bit = torch.bitwise_left_shift(torch.ones_like(pos), pos & 31)
        # Distinct bits of one word add up to their OR; int64 bit values
        # past 2**31 wrap to the int32 word's sign bit.
        val = torch.where(bit >= (1 << 31), bit - (1 << 32), bit).to(torch.int32)
        flat.index_add_(0, word, val)
        del rows, cols, slices, local, pos, word, bit, val
    return dense


def popcount_slices(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each slice: int32 [S, W] -> int64 [S]."""
    x = words.contiguous().view(torch.int64)
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = (x * _H01) >> 56
    return (x & 0xFF).sum(dim=-1)


def fold(dense: torch.Tensor, op: str, rows: list[int]) -> torch.Tensor:
    acc = dense[rows[0]]
    for r in rows[1:]:
        if op == "Union":
            acc = acc | dense[r]
        elif op == "Intersect":
            acc = acc & dense[r]
        elif op == "Difference":
            acc = acc & ~dense[r]
        else:
            raise ValueError(f"unknown op {op!r}")
    return acc


def count(dense: torch.Tensor, op: str, rows: list[int], control: bool = False) -> int:
    per_slice = popcount_slices(fold(dense, op, rows))
    if control:
        return int(per_slice.to(torch.bfloat16).sum(dtype=torch.bfloat16).float().item())
    return int(per_slice.sum().item())


def counts(dense: torch.Tensor, calls, control: bool = False) -> list[int]:
    """``calls``: (op, rows) pairs -> their Counts."""
    return [count(dense, op, rows, control) for op, rows in calls]
