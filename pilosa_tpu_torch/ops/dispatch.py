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
# or more distinct operands, whose blocks of 128 folds make
# MULTI_REFS_MIN or more references, which names each distinct row
# MULTI_REUSE_MIN or more times for every block staging it (a batch past
# 128 folds takes further blocks, each staging every tile again: G
# blocks need refs >= MULTI_REUSE_MIN x (2G - 1) x U), whose rows fit a
# ring of two stages or more, and whose folds share their rows: the
# kernel reads a row once per group of four folds that names it, so its
# plan's group rows (``kernels.MultiPlan.group_rows``) are at most
# MULTI_SHARE_MAX of the references, unless the folds are wide (on
# average MULTI_WIDE_K operands or more and MULTI_WIDE_REUSE references a
# row and block).  Every clause counts references as each query's
# distinct operands: a Range cover's pads repeat its first id, and both
# kernels read a repeat almost free (the gather kernel from L1, the
# staged kernel not at all).
# Measured on the H100 (PERF_GATES.md, the multi gate: both layouts,
# random folds, Range-like folds padded to K = 23, Range batches of 4-16
# bitmap rows over spans of 4-20 of 31 day views, and the paths'
# batches): folds whose groups share rows (group rows at most 0.5-0.7 of
# the references: every Range batch of the paths) tie or win from 9
# operands a fold and 2 references a row, by up to 50%; random folds,
# which share little, win only when wide (15 operands and 3 a row); 8
# operands lose unless the groups share half their rows; 16 folds lose
# or tie at any reuse (MULTI_REFS_MIN); one stage (981 rows of K=23)
# loses by 20%.
MULTI_K_MIN = 9
MULTI_REFS_MIN = 600
MULTI_REUSE_MIN = 2
MULTI_SHARE_MAX = 0.7
MULTI_WIDE_K = 15
MULTI_WIDE_REUSE = 3


def multi_strategy(n_distinct: int, w: int, batch: int, k: int, n_slices: int,
                   refs: int) -> bool:
    """The clauses of the staged multi kernel's gate that read the
    batch's shape (``multi_shares`` reads its plan): B folds of K
    operands (K: the padded width) naming ``n_distinct`` rows, ``refs``
    references in all (each query's distinct operands, summed) — on
    average MULTI_K_MIN operands a fold, MULTI_REFS_MIN references a
    block of up to 128 folds, every row named often enough for the
    batch's blocks (above), and a tiling of two stages or more for the
    rows beside the bound on a block's plan (``kernels.multi_group_ints``).
    The rule is the same in both layouts (the gate's grid measured
    both)."""
    if not _multi_refs_ok(batch, refs / batch if batch else 0):
        return False
    groups = -(-batch // kernels.MULTI_GROUP)
    if refs < MULTI_REUSE_MIN * (2 * groups - 1) * n_distinct:
        return False
    own = kernels.multi_group_ints(batch, k)
    return kernels.multi_tiling(n_distinct, w, own)[1] >= 2


def multi_shares(group_rows: int, batch: int, n_distinct: int, refs: int) -> bool:
    """The gate's clause on the plan: the groups' rows at most
    MULTI_SHARE_MAX of the references, or wide folds named often (above)."""
    if group_rows <= MULTI_SHARE_MAX * refs:
        return True
    blocks = -(-batch // kernels.MULTI_GROUP)
    return (refs >= MULTI_WIDE_K * batch
            and refs >= MULTI_WIDE_REUSE * (2 * blocks - 1) * n_distinct)


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


def staged_multi_batch(op: str, idx, n_slices: int, n_rows: int, w: int):
    """The multi gate applied to a batch of ``op`` fold ids over a matrix
    of ``n_slices`` x ``n_rows`` rows of ``w`` words: ``(compaction,
    plan)`` (``kernels.compact_rows``, ``kernels.multi_plan``) where the
    staged kernel serves it, else None.  A batch the gate declines on B
    and K alone is not compacted, one declined on its shape not planned."""
    ix = np.asarray(idx)
    if ix.ndim != 2 or not _multi_refs_ok(*ix.shape):
        return None
    ids, local = kernels.compact_rows(ix, n_rows, "multi fold idx")
    refs = fold_refs(local)
    if not multi_strategy(ids.size, w, ix.shape[0], ix.shape[1], n_slices, refs):
        return None
    plan = kernels.multi_plan(op, ids, local)
    if not multi_shares(plan.group_rows, ix.shape[0], ids.size, refs):
        return None
    return (ids, local), plan


def _multi(op: str, matrix: torch.Tensor, idx, row_major: bool):
    """The staged kernel's counts where the gate admits the batch, else
    None; the batch is compacted and planned once, for the gate and the
    kernel both."""
    a, b, w = matrix.shape
    n_slices, n_rows = (b, a) if row_major else (a, b)
    staged = staged_multi_batch(op, idx, n_slices, n_rows, w)
    if staged is None:
        return None
    compacted, plan = staged
    return kernels.resident_count_multi(op, matrix, idx, row_major, compacted=compacted, plan=plan)


def gather_count_multi(op: str, row_matrix: torch.Tensor, idx):
    """K-operand left-fold counts (N-operand Intersect/Union/Difference,
    Range covers) -> int32[B]: the staged kernel where the multi gate
    (``staged_multi_batch``) admits the batch, else the gather kernel.
    The choice reads the batch's shape and its plan."""
    got = _multi(op, row_matrix, idx, row_major=False)
    return kernels.gather_count_multi(op, row_matrix, idx) if got is None else got


def gather_count_multi_mixed(matrix: torch.Tensor, groups, row_major: bool = False):
    """The counts of several fold groups ``[(op, idx int[B_g, K_g])]``
    -> int32[sum B_g], in group order: each group the multi gate
    (``staged_multi_batch``) admits keeps its staged launch, and the rest
    go together into one launch of the mixed kernel, whose queries carry
    their own op and K, so a row that several groups name is read about
    once.  ``matrix``: slice-major [S, R, W], or row-major [R, S, W]
    with ``row_major``."""
    a, b, w = matrix.shape
    n_slices, n_rows = (b, a) if row_major else (a, b)
    counts: list = [None] * len(groups)
    for g, (op, idx) in enumerate(groups):
        staged = staged_multi_batch(op, idx, n_slices, n_rows, w)
        if staged is not None:
            compacted, plan = staged
            counts[g] = kernels.resident_count_multi(op, matrix, idx, row_major,
                                                     compacted=compacted, plan=plan)
    rest = [grp for grp, c in zip(groups, counts) if c is None]
    if not rest:
        return torch.cat(counts)
    mixed = kernels.gather_count_multi_mixed(matrix, *kernels.mixed_groups(rest), row_major)
    if len(rest) == len(groups):
        return mixed
    q = 0
    for g, (_op, idx) in enumerate(groups):
        if counts[g] is None:
            n = np.shape(idx)[0]
            counts[g] = mixed[q:q + n]
            q += n
    return torch.cat(counts)


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
    the staged kernel where the multi gate admits the batch, else the
    row-major gather kernel."""
    got = _multi(op, row_major, idx, row_major=True)
    return kernels.gather_count_multi_rowmajor(op, row_major, idx) if got is None else got
