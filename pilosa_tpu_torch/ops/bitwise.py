"""Dense packed-bitmap ops in plain PyTorch, plus numpy host helpers.

Layout: a slice of a row is a dense bit vector of SLICE_WIDTH (2^20) bits,
packed little-endian-within-word into 32768 words (bit ``i`` of the slice
lives at ``words[i >> 5] >> (i & 31) & 1``).  On a device a fragment's
working set is ``int32[rows, 32768]`` and batched query execution stacks
slices into ``int32[n_slices, 32768]``.

Words are ``int32`` on the torch side: a bit-exact view of the host's
``uint32`` words (torch on the CPU has no ``>>`` or ``~`` for ``uint32``).
Host arrays cross as ``torch.from_numpy(a.view(np.int32))`` and come back
as ``t.numpy().view(np.uint32)``.  Torch has no popcount op, so the plain
versions count bits with a SWAR reduction over the int32 words.

The plain versions here are what a CPU tensor runs and what every CUDA
kernel (ops/kernels.py) is held against.  Counts are int32 like the
kernels' (a slice holds at most 2^20 bits; a dispatch spans at most
2047 slices, see ``dispatch._GRAM_SLICES_MAX``).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.pilosa import SLICE_WIDTH

WORD_BITS = 32
WORDS_PER_SLICE = SLICE_WIDTH // WORD_BITS  # 32768


# ---------------------------------------------------------------------------
# Host -> torch word conversion
# ---------------------------------------------------------------------------

def to_words(host: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 host words -> int32 tensor on ``device`` (bit-exact view)."""
    a = np.ascontiguousarray(host, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# Elementwise set algebra (shapes [..., W]; work on numpy and torch alike)
# ---------------------------------------------------------------------------

_PAIR_OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "andnot": lambda a, b: a & ~b,
}


def apply_pair_op(op: str, a, b):
    try:
        f = _PAIR_OPS[op]
    except KeyError:
        raise ValueError(f"unknown op {op!r}") from None
    return f(a, b)


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (SWAR).  The arithmetic right
    shifts of negative words only smear the sign into bits the masks
    clear, and the first subtraction wraps mod 2^32 exactly like the
    unsigned form."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F  # bytes <= 8: x is non-negative now
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def count(x: torch.Tensor) -> torch.Tensor:
    """Total set bits over the last axis. [..., W] -> int32[...]."""
    return popcount_words(x).sum(dim=-1, dtype=torch.int32)


def count_and(a, b):
    """sum(popcount(a & b)) — IntersectionCount."""
    return count(a & b)


def count_or(a, b):
    return count(a | b)


def count_xor(a, b):
    return count(a ^ b)


def count_andnot(a, b):
    return count(a & ~b)


def count_op(op: str, a, b=None):
    """count(op(a, b)); ``op="none"`` counts ``a`` alone.  ``b`` may be
    per-row (a's shape) or one shared row [W]."""
    if op == "none":
        return count(a)
    return count(apply_pair_op(op, a, b))


def batch_intersection_count(rows, src):
    """|rows[k] & src| for a stack of rows: rows int32[K, W], src int32[W]
    (or broadcastable).  Returns int32[K] — TopN's exact-count phase."""
    return count(rows & src)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, device=device).long()


def gather_count(op: str, row_matrix, pairs):
    """Batched Count(<op>(Bitmap(p0), Bitmap(p1))) over all slices.

    row_matrix: int32[S, R, W]; pairs: int[B, 2] row ids.  Returns
    int32[B]: per-query counts summed over slices and words."""
    p = _index(pairs, row_matrix.device)
    a = row_matrix[:, p[:, 0]]  # [S, B, W]
    b = row_matrix[:, p[:, 1]]
    return count(apply_pair_op(op, a, b)).sum(dim=0, dtype=torch.int32)


def gather_src_counts(row_matrix, pos, src_stack):
    """Per-(slice, candidate) ``|rm[s, pos[k]] & src[s]|`` -> int32[S, K]
    (TopN candidate scoring across every slice at once)."""
    p = _index(pos, row_matrix.device)
    return count(row_matrix[:, p] & src_stack[:, None, :])


def gather_count_multi(op: str, row_matrix, idx):
    """Batched Count over a left-fold of K gathered rows per query —
    N-operand Intersect ("and"), Union ("or"), Difference ("andnot"),
    and the time-quantum Range view cover (op="or").  idx: int[B, K]
    padded with fold-idempotent ids.  Returns int32[B]."""
    ix = _index(idx, row_matrix.device)
    g = row_matrix[:, ix]  # [S, B, K, W]
    if op == "andnot":
        rest = g[:, :, 1]
        for j in range(2, g.shape[2]):
            rest = rest | g[:, :, j]
        acc = g[:, :, 0] & ~rest
    elif op in ("and", "or"):
        acc = g[:, :, 0]
        for j in range(1, g.shape[2]):
            acc = apply_pair_op(op, acc, g[:, :, j])
    else:
        raise ValueError(f"unsupported multi-op {op!r}")
    return count(acc).sum(dim=0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Tree-fold counts: one dispatch for arbitrary nested Count trees.
#
# A query's expression tree over Bitmap leaves is compiled to a PERFECT
# binary tree of depth D: ``leaves`` holds the 2^D gathered row ids
# (in-order), ``opc`` the 2^D - 1 internal-node opcodes level-major
# BOTTOM-UP.  Opcodes 0-3 are and/or/xor/andnot; TREE_PASS takes the LEFT
# child unchanged (the padding op that fills any shape to a perfect tree).
# ---------------------------------------------------------------------------

TREE_PASS = 4


def tree_select(o, a, b):
    """Combine one node's children by opcode, elementwise over packed
    words (numpy arrays or torch tensors; ``o`` broadcasts)."""
    w = np.where if isinstance(a, np.ndarray) else torch.where
    return w(
        o == 0, a & b,
        w(o == 1, a | b, w(o == 2, a ^ b, w(o == 3, a & ~b, a))),
    )


def gather_count_tree(row_matrix, leaves, opc):
    """Batched ``Count(<tree>)`` over all slices.  row_matrix: int32[S, R, W];
    leaves: int[B, K] with K = 2^D; opc: int[B, K-1].  Returns int32[B]."""
    dev = row_matrix.device
    lv = _index(leaves, dev)
    oc = _index(opc, dev)
    k = lv.shape[1]
    vals = row_matrix[:, lv]  # [S, B, K, W]
    off = 0
    n = k // 2
    while n >= 1:
        o = oc[None, :, off : off + n, None]
        vals = tree_select(o, vals[:, :, 0::2], vals[:, :, 1::2])
        off += n
        n //= 2
    return count(vals[:, :, 0]).sum(dim=0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# All-pairs Gram: G[i, j] = |row_i & row_j| summed over slices, exact.
# ---------------------------------------------------------------------------

# Per-step budget for the unpacked 0/1 float32 operand (R x bits x 4
# bytes); the word axis of a slice subdivides until a step fits, so tall
# row sets need no row-count ceiling.
GRAM_STEP_BYTES = 1 << 30

# fp32 holds every integer up to 2^24 exactly: a step's contracted length
# (bits) stays at or below it, so every partial sum of 0/1 products is an
# exact integer whatever order the matrix product adds them in.
GRAM_STEP_BITS_MAX = 1 << 24


def pair_gram(row_matrix: torch.Tensor, step_bytes: int = GRAM_STEP_BYTES) -> torch.Tensor:
    """All-pairs intersection-count Gram int64[R, R] over int32[S, R, W].

    Slices are disjoint bit ranges of the same rows, so the Gram over the
    concatenated unpacked bit vectors equals the per-slice sum — and any
    word-axis subdivision splits it further.  Each (slices, word-chunk)
    step unpacks to float32 0/1 values and runs one ``torch.matmul`` with
    TF32 off (torch has no integer GEMM on CUDA); the steps accumulate in
    int64.  A step covers whole slices when they fit, else one slice's
    word chunk."""
    s, r, w = row_matrix.shape
    dev = row_matrix.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("pair_gram needs full fp32 products: TF32 rounds the 0/1 sums")
    acc = torch.zeros((r, r), dtype=torch.int64, device=dev)
    if s == 0 or r == 0 or w == 0:
        return acc
    cw = w
    while cw > 1 and cw % 2 == 0 and (
        r * cw * WORD_BITS * 4 > step_bytes or cw * WORD_BITS > GRAM_STEP_BITS_MAX
    ):
        cw //= 2
    ns = 1
    if cw == w:
        per = max(1, min(step_bytes // max(1, r * w * WORD_BITS * 4),
                         GRAM_STEP_BITS_MAX // (w * WORD_BITS)))
        ns = min(s, per)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=dev)
    for s0 in range(0, s, ns):
        for c0 in range(0, w, cw):
            x = row_matrix[s0 : s0 + ns, :, c0 : c0 + cw].transpose(0, 1)  # [r, ns, cw]
            bits = ((x.unsqueeze(-1) >> shifts) & 1).to(torch.float32).reshape(r, -1)
            acc += torch.matmul(bits, bits.T).to(torch.int64)
    return acc


def gram_pair_counts(op: str, gram, pairs):
    """Per-pair counts for any pair op from the AND-Gram matrix.

    |a|b| = |a|+|b|-|a&b|;  |a^b| = |a|+|b|-2|a&b|;  |a&~b| = |a|-|a&b|.
    Works on numpy arrays or torch tensors (gram [R,R]; pairs int[B,2]).
    """
    g_and = gram[pairs[:, 0], pairs[:, 1]]
    if op == "and":
        return g_and
    d0 = gram[pairs[:, 0], pairs[:, 0]]
    d1 = gram[pairs[:, 1], pairs[:, 1]]
    if op == "or":
        return d0 + d1 - g_and
    if op == "xor":
        return d0 + d1 - 2 * g_and
    if op == "andnot":
        return d0 - g_and
    raise ValueError(f"unknown op {op!r}")


# ---------------------------------------------------------------------------
# Host-side numpy helpers (mask building, packing) — used to prepare
# device inputs.
# ---------------------------------------------------------------------------

def make_range_mask(start_bit: int, end_bit: int, n_words: int = WORDS_PER_SLICE) -> np.ndarray:
    """Dense uint32 mask with bits [start_bit, end_bit) set.

    Used for Range/CountRange style queries restricted to a column interval
    within a slice (roaring.go CountRange analog), and to mask the tail of a
    partially-filled last slice.
    """
    start_bit = max(0, min(start_bit, n_words * WORD_BITS))
    end_bit = max(start_bit, min(end_bit, n_words * WORD_BITS))
    mask = np.zeros(n_words, dtype=np.uint32)
    if start_bit == end_bit:
        return mask
    sw, sb = divmod(start_bit, WORD_BITS)
    ew, eb = divmod(end_bit, WORD_BITS)
    if sw == ew:
        mask[sw] = ((np.uint64(1) << np.uint64(eb)) - np.uint64(1)) & ~(
            (np.uint64(1) << np.uint64(sb)) - np.uint64(1)
        )
        return mask
    mask[sw] = np.uint32(0xFFFFFFFF) & np.uint32(~((1 << sb) - 1) & 0xFFFFFFFF)
    mask[sw + 1 : ew] = np.uint32(0xFFFFFFFF)
    if ew < n_words and eb:
        mask[ew] = np.uint32((1 << eb) - 1)
    return mask


def pack_positions(positions: np.ndarray, n_words: int = WORDS_PER_SLICE) -> np.ndarray:
    """Pack sorted (or unsorted) bit positions into a dense uint32 word array."""
    words = np.zeros(n_words, dtype=np.uint32)
    if len(positions) == 0:
        return words
    positions = np.asarray(positions, dtype=np.uint64)
    w = (positions >> np.uint64(5)).astype(np.int64)
    b = (positions & np.uint64(31)).astype(np.uint32)
    np.bitwise_or.at(words, w, np.uint32(1) << b)
    return words


def unpack_positions(words: np.ndarray) -> np.ndarray:
    """Inverse of pack_positions: dense words -> sorted uint64 bit positions."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint64)


def pack_rows_matrix(rows_positions, n_rows: int, n_words: int = WORDS_PER_SLICE) -> np.ndarray:
    """Build a dense uint32[n_rows, n_words] matrix from per-row position lists."""
    m = np.zeros((n_rows, n_words), dtype=np.uint32)
    for r, pos in rows_positions:
        if r < n_rows and len(pos):
            m[r] = pack_positions(pos, n_words)
    return m


# ---------------------------------------------------------------------------
# numpy reference implementations (ground truth for property tests — the
# analog of the Go SWAR fallbacks in roaring/assembly.go:26-73)
# ---------------------------------------------------------------------------

def np_popcount(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.uint32)
    return np.unpackbits(x.view(np.uint8)).reshape(*x.shape, 32).sum(-1)


# Byte-popcount lookup table for count_words: one gather + sum beats the
# 8x unpackbits expansion by ~20x when only the TOTAL is wanted.
_POP8 = np_popcount(np.arange(256, dtype=np.uint32)).astype(np.uint16)


def count_words(x: np.ndarray) -> int:
    """Total set-bit count of a packed word array (any uint dtype).
    The fast lane for cardinality-only callers — np_popcount stays the
    per-word reference (property tests hold this to it)."""
    x = np.ascontiguousarray(x)
    return int(_POP8[x.view(np.uint8)].sum(dtype=np.int64))


def np_count(x: np.ndarray) -> int:
    return int(np_popcount(x).sum())


def np_count_and(a, b) -> int:
    return np_count(np.bitwise_and(a, b))


def np_count_or(a, b) -> int:
    return np_count(np.bitwise_or(a, b))


def np_count_xor(a, b) -> int:
    return np_count(np.bitwise_xor(a, b))


def np_count_andnot(a, b) -> int:
    return np_count(np.bitwise_and(a, np.bitwise_not(np.asarray(b, dtype=np.uint32))))


def np_gather_count_tree(
    row_matrix: np.ndarray, leaves: np.ndarray, opc: np.ndarray
) -> np.ndarray:
    """numpy ground truth for gather_count_tree."""
    k = leaves.shape[1]
    vals = row_matrix[:, leaves, :]  # [S, B, K, W]
    off = 0
    n = k // 2
    while n >= 1:
        o = opc[None, :, off : off + n, None]
        vals = tree_select(o, vals[:, :, 0::2], vals[:, :, 1::2])
        off += n
        n //= 2
    acc = vals[:, :, 0]
    return np_popcount(acc).reshape(acc.shape[0], acc.shape[1], -1).sum(axis=(0, 2))


def np_gather_count_multi(op: str, row_matrix: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """numpy ground truth for gather_count_multi."""
    g = row_matrix[:, idx, :]  # [S, B, K, W]
    if op == "or":
        acc = np.bitwise_or.reduce(g, axis=2)
    elif op == "and":
        acc = np.bitwise_and.reduce(g, axis=2)
    elif op == "andnot":
        acc = g[:, :, 0] & ~np.bitwise_or.reduce(g[:, :, 1:], axis=2)
    else:
        raise ValueError(f"unsupported multi-op {op!r}")
    return np_popcount(acc).reshape(acc.shape[0], acc.shape[1], -1).sum(axis=(0, 2))


def np_gather_count_or_multi(row_matrix: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """numpy ground truth for gather_count_or_multi."""
    return np_gather_count_multi("or", row_matrix, idx)
