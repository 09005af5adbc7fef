"""Dispatch: a CUDA tensor goes to its kernel, a CPU tensor to the plain
version.

The choice is the tensor's device and nothing else: there is no probe,
no ``try`` and no environment switch between a kernel and its plain
version (each wrapper in ``ops/kernels.py`` makes that choice itself).
What this module decides is WHICH kernel serves a call — the resident
or the gather pair kernel, the staged or the gather tree kernel — and
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
    """[..., W] -> contiguous [M, W] (the count_rows kernel's shape)."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def count(x: torch.Tensor) -> torch.Tensor:
    """Total set bits over the last axis. [..., W] -> int32[...]."""
    return kernels.count_rows(_rows2d(x)).reshape(x.shape[:-1])


def batch_intersection_count(rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """|rows[k] & src| for a stack of rows [..., W] — TopN's exact-count
    hot loop.  A [W] src is shared by every row (read with stride 0, no
    K-way broadcast in memory); otherwise src is per row."""
    b = src.contiguous() if src.dim() == 1 else _rows2d(src.expand_as(rows))
    return kernels.count_rows(_rows2d(rows), b, "and").reshape(rows.shape[:-1])


# Gram gate the executor imports: per-pair counts must stay inside int32
# (<= 2047 slices x 2^20 bits).
_GRAM_SLICES_MAX = 2047


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


def gather_count_multi(op: str, row_matrix: torch.Tensor, idx):
    """K-operand left-fold counts (N-operand Intersect/Union/Difference,
    Range covers) -> int32[B]."""
    return kernels.gather_count_multi(op, row_matrix, idx)


# The staged tree kernel serves a batch whose leaf references reach this
# many per distinct leaf row in each of the kernel's groups of 64 trees
# (every group stages all of the batch's rows).  Measured on the H100
# (PERF.md, the tree gate): at about 2.3 references a row the two kernels
# tie or the gather kernel, whose repeated rows L2 serves, wins; at 4 and
# more the staged kernel is faster, by 15-35% at one group and 20-37%
# at two and four.
TREE_REUSE_MIN = 3


def tree_strategy(n_distinct: int, w: int, batch: int, k: int, n_slices: int) -> bool:
    """Whether the staged tree kernel (``resident_count_tree``) serves a
    batch of B trees of K leaves naming ``n_distinct`` rows: each group of
    up to 64 trees names them often enough (``min(B, 64) x K >=
    TREE_REUSE_MIN x U``) and two stages of them fit one block's shared
    memory (at W = 32,768 the first clause keeps U <= 341, which always
    fits; a W with no 64-word chunk has no tiling)."""
    if min(batch, kernels.TREE_GROUP) * k < TREE_REUSE_MIN * n_distinct:
        return False
    return kernels.tree_tiling(n_distinct, w, k, n_slices)[1] == 2


def gather_count_tree(row_matrix: torch.Tensor, leaves, opc):
    """Perfect-tree opcode-fold counts (nested Count trees) -> int32[B]:
    the staged kernel where ``tree_strategy`` admits the batch, else the
    gather kernel.  The choice reads shapes only; the batch's rows are
    compacted once, for the gate and the staged kernel both."""
    lv = np.asarray(leaves)
    if lv.ndim == 2 and lv.size:
        n_slices, n_rows, w = row_matrix.shape
        ids, local = kernels.compact_rows(lv, n_rows, "gather_count_tree leaves")
        if tree_strategy(ids.size, w, lv.shape[0], lv.shape[1], n_slices):
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
    """K-operand fold counts over a ROW-MAJOR [R, S, W] matrix -> int32[B]."""
    return kernels.gather_count_multi_rowmajor(op, row_major, idx)
