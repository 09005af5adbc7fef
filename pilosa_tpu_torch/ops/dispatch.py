"""Dispatch: a CUDA tensor goes to its kernel, a CPU tensor to the plain
version.

The choice is the tensor's device and nothing else: there is no probe,
no ``try`` and no environment switch between a kernel and its plain
version (each wrapper in ``ops/kernels.py`` makes that choice itself).
What this module decides is WHICH kernel serves a call — the resident
or the gather pair kernel, the staged or the gather tree and multi-fold
kernels — and
the gates the engine and executor import: the Gram's slice bound and the row-major lane's
(``rowmajor_ok``).  Every gather kernel reads its ids from global
memory, so unlike the TPU dispatch no batch is cut into id chunks: any
B and K run in one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels


def _rows2d(x: torch.Tensor) -> torch.Tensor:
    """[..., W] -> contiguous [M, W] (the count_rows kernel's shape); a
    contiguous [M, W] as it is."""
    if x.dim() == 2 and x.is_contiguous():
        return x
    return x.reshape(-1, x.shape[-1]).contiguous()


def count(x: torch.Tensor) -> torch.Tensor:
    """Total set bits over the last axis. [..., W] -> int32[...]."""
    out = kernels.count_rows(_rows2d(x))
    return out if x.dim() == 2 else out.reshape(x.shape[:-1])


def batch_intersection_count(rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """|rows[k] & src| for a stack of rows [..., W] — TopN's exact-count
    hot loop.  A [W] src is shared by every row (read with stride 0, no
    K-way broadcast in memory); otherwise src is per row."""
    b = src.contiguous() if src.dim() == 1 else _rows2d(src.expand_as(rows))
    out = kernels.count_rows(_rows2d(rows), b, "and")
    return out if rows.dim() == 2 else out.reshape(rows.shape[:-1])


# Gram gate the executor imports: per-pair counts must stay inside int32
# (<= 2047 slices x 2^20 bits); the Gram kernel's wrapper raises past it.
_GRAM_SLICES_MAX = kernels.GRAM_SLICES_MAX


def resident_strategy(n_rows: int, w: int, batch: int) -> bool:
    """Whether the resident kernel serves a pair batch: streaming the
    rows once must beat gathering 2 rows per pair (R < 2B), and R rows of
    a 128-word chunk plus 4 bytes per pair fit one block's shared memory
    (``R x 512 + 4B <= 232,448``, W a multiple of 128).

    The second clause is the tiling of the first resident kernel.  The
    staged kernel needs less (only the rows the pairs name, and a single
    stage of 64-word chunks fits every R this admits:
    ``kernels.resident_tiling``), but ``engine.prefer_rowmajor`` reads
    this predicate, so the admitted set stays as it was."""
    return (n_rows < 2 * batch and w >= 128 and w % 128 == 0
            and n_rows * 128 * 4 + batch * 4 <= kernels.SMEM_BYTES)


def gather_count(op: str, row_matrix: torch.Tensor, pairs):
    """Batched Count(<op>(Bitmap, Bitmap)) over int32[S, R, W] for int[B, 2]
    row-id pairs -> int32[B].  The executor keeps its own cached Gram
    (engine.pair_gram); this is the direct-kernel lane."""
    n_slices, n_rows, w = row_matrix.shape
    if resident_strategy(n_rows, w, len(pairs)):
        return kernels.resident_count2(op, row_matrix, pairs)
    return kernels.gather_count2(op, row_matrix, pairs)


def topn_scorer_counts(row_matrix: torch.Tensor, pos, src_stack: torch.Tensor):
    """Per-(slice, candidate) |rm[s, pos[k]] & src[s]| -> int32[S, K]."""
    return kernels.gather_src_counts(row_matrix, pos, src_stack)


# The staged multi kernel serves a batch whose folds average MULTI_K_MIN
# or more distinct operands, whose groups of 128 folds make
# MULTI_REFS_MIN or more references, and which names each distinct row
# MULTI_REUSE_MIN or more times for every group staging it: a group past
# the first stages every tile again, so a batch of G groups needs refs >=
# MULTI_REUSE_MIN x (2G - 1) x U.  Every clause counts references as each
# query's distinct operands: a Range cover's pads repeat its first id,
# and both kernels read a repeat almost free (the gather kernel from L1,
# the staged kernel not at all).
# Measured on the H100 (PERF_GATES.md, the multi gate: both layouts, unpadded
# folds and Range-like folds padded to K = 23): at 8-12 distinct
# operands a fold the gather kernel, whose repeats L2 serves, wins or
# ties unless rows repeat 8 times; at 15-16 one group of 128 folds is
# 7-32% faster staged from 3 references a row and 64 folds tie within
# 10%; from 18 the staged kernel wins at every reuse from 2 (MULTI_K_MIN
# sits between 12 and 15).  Groups of 16 folds (260-370 references) lose
# or tie at any reuse, groups of 64 (960+) tie or win: the staged
# wrapper's host work, compaction and per-query lists, weighs on small
# batches (MULTI_REFS_MIN sits between).  2 groups win at 8 references a
# row and lose at 4; 4 groups lose at 8.
MULTI_K_MIN = 14
MULTI_REFS_MIN = 600
MULTI_REUSE_MIN = 2


def multi_strategy(n_distinct: int, w: int, batch: int, k: int, n_slices: int,
                   refs: int) -> bool:
    """Whether the staged multi kernel (``resident_count_multi``) serves a
    batch of B folds of K operands (K: the padded width) naming
    ``n_distinct`` rows, ``refs`` references in all (each query's
    distinct operands, summed): on average MULTI_K_MIN operands a fold,
    MULTI_REFS_MIN references a group of up to 128 folds, every row named
    often enough for the batch's groups (above), and a tiling of the rows
    and the group's operand offsets that fits one block's shared memory.
    The rule is the same in both layouts (the gate's grid measured
    both)."""
    if not _multi_refs_ok(batch, refs / batch if batch else 0):
        return False
    groups = -(-batch // kernels.MULTI_GROUP)
    if refs < MULTI_REUSE_MIN * (2 * groups - 1) * n_distinct:
        return False
    return kernels.multi_tiling(n_distinct, w, batch, k, n_slices)[0] > 0


def _multi_refs_ok(batch: int, k: float) -> bool:
    """The gate's clauses on B and the operands a fold: with the padded
    K, which bounds each query's distinct operands, they decline a batch
    before any compaction."""
    return k >= MULTI_K_MIN and min(batch, kernels.MULTI_GROUP) * k >= MULTI_REFS_MIN


def fold_refs(local: np.ndarray) -> int:
    """The references a batch of fold ids makes: each query's distinct
    operands, summed."""
    srt = np.sort(local, axis=1)
    return local.shape[0] + int(np.count_nonzero(srt[:, 1:] != srt[:, :-1]))


def staged_multi_batch(idx, n_slices: int, n_rows: int, w: int):
    """``multi_strategy`` applied to a batch of fold ids over a matrix of
    ``n_slices`` x ``n_rows`` rows of ``w`` words: the batch's compaction
    (``kernels.compact_rows``) where the staged kernel serves it, else
    None.  A batch the gate declines on B and K alone is not compacted."""
    ix = np.asarray(idx)
    if ix.ndim != 2 or not _multi_refs_ok(*ix.shape):
        return None
    ids, local = kernels.compact_rows(ix, n_rows, "multi fold idx")
    if not multi_strategy(ids.size, w, ix.shape[0], ix.shape[1], n_slices, fold_refs(local)):
        return None
    return ids, local


def _multi(op: str, matrix: torch.Tensor, idx, row_major: bool):
    """The staged kernel's counts where the gate admits the batch, else
    None; the batch is compacted once, for the gate and the kernel both."""
    a, b, w = matrix.shape
    n_slices, n_rows = (b, a) if row_major else (a, b)
    compacted = staged_multi_batch(idx, n_slices, n_rows, w)
    if compacted is None:
        return None
    return kernels.resident_count_multi(op, matrix, idx, row_major, compacted=compacted)


def gather_count_multi(op: str, row_matrix: torch.Tensor, idx):
    """K-operand left-fold counts (N-operand Intersect/Union/Difference,
    Range covers) -> int32[B]: the staged kernel where ``multi_strategy``
    admits the batch, else the gather kernel.  The choice reads shapes
    only."""
    got = _multi(op, row_matrix, idx, row_major=False)
    return kernels.gather_count_multi(op, row_matrix, idx) if got is None else got


# The staged tree kernel serves a batch whose LIVE leaf references (the
# leaves that reach the root, ``kernels.tree_live_leaves``: the only ones
# the gather kernel loads) reach this many per distinct leaf row in each
# of the kernel's groups of 64 trees (every group stages all of the
# batch's rows and folds every leaf, dead ones too).  Measured on the
# H100 (PERF_GATES.md, the tree gate, on random trees and on trees padded
# with PASS nodes as the executor pads them): to about 3 live references
# a row the gather kernel wins or ties; from 4 on trees whose leaves all
# live, and from 8 on padded ones, the staged kernel is faster.
TREE_REUSE_MIN = 4


def tree_strategy(n_distinct: int, w: int, opc, n_slices: int) -> bool:
    """Whether the staged tree kernel (``resident_count_tree``) serves a
    batch of B trees of K leaves with opcodes ``opc`` (int[B, K - 1])
    naming ``n_distinct`` rows: each group of up to 64 trees names them
    often enough with its live leaves (``min(B, 64) x live / B >=
    TREE_REUSE_MIN x U``; live counted only where all B x K leaves would
    be enough) and two stages of them fit one block's shared memory (at W
    = 32,768 the reuse clause keeps U <= 256, which always fits; a W with
    no 64-word chunk has no tiling)."""
    batch, k = np.shape(opc)[0], np.shape(opc)[1] + 1
    group = min(batch, kernels.TREE_GROUP)
    if group * k < TREE_REUSE_MIN * n_distinct:
        return False
    live = int(kernels.tree_live_leaves(opc).sum())
    if group * live < TREE_REUSE_MIN * n_distinct * batch:
        return False
    return kernels.tree_tiling(n_distinct, w, k, n_slices)[1] == 2


def gather_count_tree(row_matrix: torch.Tensor, leaves, opc):
    """Perfect-tree opcode-fold counts (nested Count trees) -> int32[B]:
    the staged kernel where ``tree_strategy`` admits the batch, else the
    gather kernel.  The choice reads the batch's shape, distinct rows and
    live leaves; the batch's rows are compacted once, for the gate and the
    staged kernel both."""
    lv = np.asarray(leaves)
    if lv.ndim == 2 and lv.size:
        n_slices, n_rows, w = row_matrix.shape
        ids, local = kernels.compact_rows(lv, n_rows, "gather_count_tree leaves")
        if tree_strategy(ids.size, w, opc, n_slices):
            return kernels.resident_count_tree(row_matrix, lv, opc, compacted=(ids, local))
    return kernels.gather_count_tree(row_matrix, leaves, opc)


def rowmajor_ok(n_slices: int, w: int, k: int = 2) -> bool:
    """Whether the row-major kernels take a matrix of ``n_slices`` slices
    of ``w`` words for folds of ``k`` operands.

    The TPU gate was a VMEM bound: its kernels buffered ``k`` whole rows
    (every slice) per pipeline slot, ``2 * k * S * W * 4 <= 8 MiB``
    (S <= 16 at k = 2).  The CUDA kernels buffer no whole row — a block
    streams one slice of its operands through registers, 16 bytes a
    thread at a time — so neither ``w`` nor ``k`` bounds them.  What remains is the int32 count: a
    full-density count is S * 2^20 bits per query, so S <= 2047
    (``_GRAM_SLICES_MAX``)."""
    return n_slices <= _GRAM_SLICES_MAX


def gather_count_rowmajor(op: str, row_major: torch.Tensor, pairs):
    """Pair counts over a ROW-MAJOR [R, S, W] matrix -> int32[B]."""
    return kernels.gather_count2_rowmajor(op, row_major, pairs)


def gather_count_multi_rowmajor(op: str, row_major: torch.Tensor, idx):
    """K-operand fold counts over a ROW-MAJOR [R, S, W] matrix -> int32[B]:
    the staged kernel where ``multi_strategy`` admits the batch, else the
    row-major gather kernel."""
    got = _multi(op, row_major, idx, row_major=True)
    return kernels.gather_count_multi_rowmajor(op, row_major, idx) if got is None else got
