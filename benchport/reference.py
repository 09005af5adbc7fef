"""The plain reference: exact Counts of call trees over any frames, from
the pairs.

``per_slice`` remakes the configuration's pairs with ``datagen`` (the
same seed gives the same pairs the port was handed) one block of slices
at a time.  For each block it builds dense 32-bit words on ``device``
for the (frame, row)s that the checked calls name and no others, folds
every call there with plain torch operations (calls of one tree shape up
to ``GROUP`` at a time, their leaves gathered side by side) and keeps
each slice's count, so its memory is set by the block and the rows
named, not by the index.  No kernel, cache or batching of the program,
and nothing of ``pilosa_tpu_torch`` imported.  Pilosa's semantics: ``Union`` ORs the
operands, ``Intersect`` ANDs them, ``Difference`` keeps the first
operand's bits that no other operand has, ``Xor`` XORs them in turn;
``Count`` sums the set bits over every slice.

``totals(per_slice, control=True)`` gives the same counts with each
slice's count carried in bfloat16 and summed in bfloat16: the
configuration's guarantee of exact counts broken the way a fast path on
the tensor cores would break it.  The check has to call that not
correct.
"""

from __future__ import annotations

import torch

from benchport import datagen, schema

WORDS = datagen.SLICE_WIDTH // 32
# Calls of one tree shape folded together: fewer launches, and a fold's
# tensors hold at most this many calls' blocks.
GROUP = 16
_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_H01 = 0x0101010101010101


def popcount_slices(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each slice: int32 [..., S, W] -> int64 [..., S]."""
    x = words.contiguous().view(torch.int64)
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = (x * _H01) >> 56
    return (x & 0xFF).sum(dim=-1)


def fold(call, leaf) -> torch.Tensor:
    """The words of a call tree; ``leaf(("Bitmap", frame, row))`` gives a
    leaf's words."""
    if call[0] == "Bitmap":
        return leaf(call)
    acc = fold(call[1], leaf)
    for child in call[2:]:
        w = fold(child, leaf)
        if call[0] == "Union":
            acc = acc | w
        elif call[0] == "Intersect":
            acc = acc & w
        elif call[0] == "Difference":
            acc = acc & ~w
        elif call[0] == "Xor":
            acc = acc ^ w
        else:
            raise ValueError(f"unknown op {call[0]!r}")
    return acc


def _total(per_slice: torch.Tensor, control: bool) -> int:
    if control:
        return int(per_slice.to(torch.bfloat16).sum(dtype=torch.bfloat16).float().item())
    return int(per_slice.sum().item())


def count(dense: torch.Tensor, op: str, rows: list[int], control: bool = False) -> int:
    """One N-ary call's Count over a whole frame's dense words, int32
    [rows, slices, W]."""
    call = (op,) + tuple(("Bitmap", None, r) for r in rows)
    return _total(popcount_slices(fold(call, lambda leaf: dense[leaf[2]])), control)


def _skeleton(call) -> tuple:
    """A call tree with its leaves blanked: calls of one skeleton fold
    together."""
    if call[0] == "Bitmap":
        return ("Bitmap",)
    return (call[0],) + tuple(_skeleton(c) for c in call[1:])


def _set_bits(dense: torch.Tensor, slot: torch.Tensor, rows, cols, s0: int) -> None:
    """OR the pairs of one chunk into ``dense`` [named rows, block, W]
    (int32), block starting at slice ``s0``; ``slot``: the frame's row ->
    named row, -1 for rows no call names."""
    at = slot[rows]
    keep = at >= 0
    at, cols = at[keep], cols[keep]
    slices = (cols >> datagen.SLICE_BITS) - s0
    local = cols & (datagen.SLICE_WIDTH - 1)
    # One bit once: a pair given twice sets it once.
    pos = torch.unique(((at * dense.shape[1] + slices) << datagen.SLICE_BITS) | local)
    bit = torch.bitwise_left_shift(torch.ones_like(pos), pos & 31)
    # Distinct bits of one word add up to their OR; int64 bit values
    # past 2**31 wrap to the int32 word's sign bit.
    val = torch.where(bit >= (1 << 31), bit - (1 << 32), bit).to(torch.int32)
    dense.view(-1).index_add_(0, pos >> 5, val)


def per_slice(cfg: dict, seed: int, device, calls: list, block: int = 16,
              root: str | None = None) -> torch.Tensor:
    """int64 [len(calls), slices]: each call's count in each slice."""
    n_slices = int(cfg["slices"])
    named = sorted({leaf for c in calls for leaf in schema.leaves(c)})
    index = {leaf: i for i, leaf in enumerate(named)}
    slot = {f["name"]: torch.full((f["rows"],), -1, dtype=torch.int64) for f in schema.frames(cfg)}
    for (name, r), i in index.items():
        slot[name][r] = i
    slot = {name: s.to(device) for name, s in slot.items()}
    out = torch.zeros((len(calls), n_slices), dtype=torch.int64, device=device)
    if not named:
        return out
    dense = torch.zeros((len(named), block, WORDS), dtype=torch.int32, device=device)
    shapes: dict = {}
    for j, c in enumerate(calls):
        shapes.setdefault(_skeleton(c), []).append(j)
    # (skeleton, its calls, their leaves' named rows [calls, leaves])
    plan = [(skel, torch.tensor(js[g:g + GROUP], device=device),
             torch.tensor([[index[leaf] for leaf in schema.leaves(calls[j])]
                           for j in js[g:g + GROUP]], device=device))
            for skel, js in shapes.items() for g in range(0, len(js), GROUP)]

    def fold_block(b: int) -> None:
        s0 = b * block
        nb = min(block, n_slices - s0)
        words = dense[:, :nb]
        for skel, js, ids in plan:
            leaves = iter(ids.unbind(1))
            out[js, s0:s0 + nb] = popcount_slices(fold(skel, lambda _, it=leaves: words[next(it)]))

    current = None
    for frame, rows, cols in datagen.chunks(cfg, seed, device, block, root):
        if cols.numel() == 0:
            continue
        b = (int(cols.min()) >> datagen.SLICE_BITS) // block
        last = (int(cols.max()) >> datagen.SLICE_BITS) // block
        if last != b or (current is not None and b < current):
            raise ValueError(f"a chunk of slices {b * block}-{(last + 1) * block} is out of "
                             f"block order (block {current} of {block} slices was open)")
        if b != current:
            if current is not None:
                fold_block(current)
                dense.zero_()
            current = b
        _set_bits(dense, slot[frame], rows, cols, b * block)
    if current is not None:
        fold_block(current)
    return out


def totals(counts: torch.Tensor, control: bool = False) -> list[int]:
    """Each call's Count from ``per_slice``'s counts; with ``control`` in
    bfloat16."""
    return [_total(row, control) for row in counts]
