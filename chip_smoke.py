"""Smoke run of pilosa_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Probes the card (fails without CUDA) and prints its name and power
   limit as nvidia-smi reports them.
2. Builds the thirteen CUDA kernels from ``pilosa_tpu_torch/csrc`` with
   nvcc (one process per source, all started together), and beside them
   compiles the resident, fold, row-major, TopN, Gram, gather pair and
   plane-build kernels once more with ``-Xptxas -v`` to report their
   registers and shared memory.
3. Holds each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, for every op variant; exact equality
   (integer counts), and times both with CUDA events beside the kernel's
   memory bound (the L2 flushed before each launch by writing 128 MB).
   ``count_rows`` is also held on ragged and split stacks and timed at
   [256, W] & src, [64, W] and one 16-byte row (its floor), each through
   its entry point, as a launch alone and by its host work a call.  ``gather_count_tree`` is held
   on PASS-only trees, PASS roots, dead leaves moved to row R - 1, one
   tree, a batch past the launch's parameters and a ragged W (a
   "tree_checks" line), and its bound counts the rows its live leaves
   name.  The row-major kernels are also timed against the slice-major
   ones on the transposed matrix with the same ids.  The two
   staged kernels (``resident_count2``, ``resident_count_tree``) are held
   exactly on their edge cases — duplicate ids, self-pairs, unreferenced
   rows, padded trees, ragged and multi-group batches, the resident
   gate's edge — and timed: ``resident_count2`` at R = 64, 256, 400 and
   B = 256 to 4,096, and both tree kernels on the same batches at B = 16,
   32, 64 x K = 4, 8, 16 and at batches of 128 and 256 trees (a
   "tree_gate" line, with each kernel's gathered bytes over its time).
   The staged multi fold (``resident_count_multi``) is held exactly on
   both layouts and its edge cases (K = 1-23, padded lists, duplicate
   ids, unreferenced rows, ragged and multi-block batches, one stage);
   every multi-fold batch the HTTP and tall paths launch, rebuilt at its
   own shape (``multi_path_batches``), is timed through the gather and
   the staged kernels ("multi_paths" line, with what each plan reads:
   ``plan_reads``), the staged kernel's tilings against each other and
   its wrapper's tiling at 1-4 producer warps, at its five timed shapes
   ("multi_tilings"), range-wide's batch also at
   the mesh's shard shapes [8, R, W] and [32, R, W] (in the kernels
   line), and both kernels over a grid of B x K x references per row,
   Range-like padded folds and Range batches of a few bitmap rows over
   spans of day views, in both layouts ("multi_gate", the data behind
   ``dispatch.MULTI_K_MIN`` and ``MULTI_REUSE_MIN``).  ``gather_count2`` is timed at
   B = 16, 64, 256 and 600 (past the pairs a launch carries in its
   parameters), through its entry point and as a launch alone (B
   = 16 also at 1-16 segments a row).  The Gram kernel (``pair_gram``)
   is held exactly at R = 1, 17, 64, 256 x S = 1, 7, 64, a strided
   300-of-512-row pool view, a narrow ragged view, R = 1,024 at S = 16
   and the executor's row buckets of 64 to 4,096 rows (whole over 4,096
   words, and the first slice at the full W), and timed at the
   executor's S = 64, R = 256 beside its plain version and the library
   yardstick (bits unpacked to int8 and ``torch._int_mm`` per slice; the
   port never calls it), and at the buckets at the pool's 2 GiB.  Its
   bound takes the bit products
   at the faster of the two b1 tensor-core rates (mma.sync and wgmma)
   that ``csrc/mma_probe.cu`` measures in the same run (the data sheet
   gives none; the reading is the kernels line's ``b1_probe``).  The
   bulk plane build (``build_planes``) is held exactly on
   tests/test_bulk.py's ragged case, one pair, one word's 32 bits, the
   last bit of a slice, one group, ids past 2^22, ascending keys with
   some outside the arena, and its three timed shapes (N pairs x G
   groups: the bulk path's chunk 131,072 x 66, bench.py's 2^20 x 256,
   and 2^23 x 4,096, a 512 MiB arena), through its entry point and as a
   launch alone, beside its bound (the arena written once, the keys read once); the
   whole device lane equals the host lane, unsorted keys set a descent
   flag and raise, and G = 0 launches nothing.
4. The diffcheck path: the differential sweep ``ops/diffcheck.py`` over
   every lane on the card (its ``topn_counts`` lane is that kernel's path).
5. Drives the executor path — ``Executor.execute`` over a ``Holder`` — at
   64 slices x 256 rows (the default 2 GiB row-pool budget holds all of
   them) with 2,000 seeded random bits per row per slice: batched pair
   Counts (direct resident kernel, then the Gram kernel and the native
   lookup lane), pair Counts on a ``no_gram`` executor (slice-major or
   row-major gather, as the pool's size decides), a no-Gram body mixing
   pair and nested Counts (slice-major gather and tree kernels), Counts
   that reach the sequential path (count kernel), and a TopN with a source
   bitmap (both TopN kernels).  Every answer is checked against the same
   port's ``Executor(engine="numpy")`` on the same holder (for batches, a
   seeded 16-query subset of each request).  Every pair batch the path
   hands dispatch is recorded; after it, ``gather_count2`` is held and
   timed at each batch that took the gather kernel, and at the row-major
   gather batches as slice-major ones (a "gather2_paths" line).
6. Drives the HTTP path on the same data directory, which also holds a
   time-quantum frame ``t`` (YMD, 64 slices x 8 rows x 2,000 stamped bits
   per row per slice): the port's ``Server`` with its default config
   (engine on the card) on an ephemeral port, ``POST /index/i/query``
   over urllib — a pair batch, N-ary Intersect / Union / Difference
   batches (multi-fold kernel), nested and multi-operand Xor Counts
   (tree-fold kernel), three ``Count(Range(...))`` batches over the
   multi-view matrix (each takes the staged multi-fold kernel: its
   Counts of one row over overlapping spans share their views; the
   "range-wide" covers fold 17.5 operands),
   "tree-wide": 256 nested Counts over the 256 rows (the gather tree
   kernel), and "tree-hot": 256 nested Counts over 64 hot rows, whose
   K=8 and K=16 buckets name their rows often enough with their live
   leaves for the staged tree kernel.  A seeded 16-query subset of each
   answer is checked against ``Executor(srv.holder, engine="numpy")``.
7. Drives the tall path in a data directory of its own: 32 slices x 1,024
   rows x 1,000 distinct bits per row per slice, 4 GiB dense, twice what
   the default 2 GiB pool holds.  Pair and N-ary batches naming every row
   page through the executor's row-major pool in parts, one Union over
   640 rows streams its slices through row-major transients, a write
   refreshes the pool's resident planes, and a planner pinned to the
   "rmgather" lane serves a batch from it; each checked against the numpy
   engine.
   After the HTTP path, ``gather_count_tree`` is held and timed at every
   tree batch the executor ("gather-3") and HTTP ("tree", "tree-wide",
   "tree-hot") paths handed the tree dispatch, rebuilt at its own shape,
   through its entry point and as a launch alone beside its live-row
   bound, and the staged kernel on the same batch (a "tree_paths" line).
   Then the bulk path, on the HTTP path's data directory with a new port
   ``Server`` (default config): the pairs ``build_holder`` loaded into
   ``f`` (regenerated from its seed) go to frame ``fb`` through
   ``Client.bulk_stream`` in 250 chunks of 131,072 pairs, one
   ``build_planes`` launch each; before any roaring materialization a
   16-pair Count batch, a Count and a TopN with a src on ``fb`` equal the
   same on ``f`` and the numpy engine's (the TopN: the executor path's
   numpy answer on ``f``, whose bits ``fb`` holds); the 64 fragment checksums of
   ``fb`` equal ``f``'s; a small inverse-enabled frame equals its twin
   through ``/ingest`` in both views; and, with pyarrow, the Arrow export
   of ``fb``'s slice 0 re-ingested through ``/bulk`` exports the same
   bytes.  A chunk's time is split into its steps, each timed inside
   the server on every chunk it applies (a "bulk" line).
8. The mesh phase (``pilosa_tpu_torch.parallel``), after the bulk path, on
   a copy of the first MESH_SLICES (16) slices of the same data
   directory's f and t plus an empty frame ``fm``: first one NCCL
   rank of world size 1 in this process, ``Executor(holder,
   engine=MeshEngine(...))`` beside the single-GPU executor on the same
   holder — a no-Gram gather batch, a cold and a warm pair batch
   (resident kernel, then the Gram), an N-ary batch (gather fold), the
   range-wide batch (staged fold), nested trees (gather and staged), a TopN
   with a src, the collective self-check (every sharded composition,
   ``topn_counts`` among them) and a bulk load of 8 chunks of 131,072
   pairs through the MeshEngine; every answer equals the single-GPU
   executor's and the numpy engine's (a seeded subset; the TopN in full,
   the numpy engine's TopN over the same 16 slices), and each kernel of the
   mesh path launches.  Then two ranks on the one card over gloo,
   started as ``python -m pilosa_tpu_torch.cli lockstep`` starts them,
   each over its own copy of that directory (``int32[8, 256, 32768]`` a
   rank): the same requests through rank 0's HTTP door
   (answers equal to the single-GPU path's), ``POST /debug/mesh-check``,
   a SetBit and a Count, and the bulk load through ``/bulk``; SIGINT
   shuts the job down, each rank's exit line gives its launches, its
   per-batch wall, kernel-step and collective ms (``PILOSA_TPU_MESH_TIMING``)
   and its holder's digest; every kernel of the path must have launched
   on every rank, and the digests must be equal.  Last, every batch the MeshEngine
   handed a kernel is held exactly against the kernel's plain version at
   the two-rank shard's shapes, [8, R, W] (this phase's) and [32, R, W]
   (the whole 64 slices').  Two ranks on one card measure no multi-GPU
   speed.
9. The fleet phase (``pilosa_tpu_torch.replica``), after the mesh phase,
   on the same data directory (f, t, fb and the bulk path's small
   frames; t keeps its standard and January views, FLEET_T_VIEWS, where
   the open-file limit is short of three groups of every view): three
   replica groups
   g0, g1 and g2, each a port ``Server`` in this process (default
   config, engine on the card, the query cache off as the reference's
   group workers run) over its own copy, behind ``python -m
   pilosa_tpu_torch.cli replica-router`` with a durable WAL in a process
   of its own.  Reads through the router (a cold and a warm pair batch,
   the N-ary, nested and range-wide batches and the TopN, each sent
   twice, spread by the router's round robin) equal one another and the
   numpy engine's on a seeded subset, and each group serves reads that
   launch kernels (its ``X-Pilosa-Group``
   header; the launch counters read around each request).  The router's
   own cost: once every group has served the warm requests, each is sent
   FLEET_HOP_SENDS times through the router and, after each, straight to
   the door of the group that served it.  Writes: a SetBit burst over every
   slice, a Count from each group (read-your-writes), and a bulk load of
   8 x 131,072 pairs through the router's ``/bulk`` that every group
   builds on the card.  Catch-up: g2 closes, a burst commits on two of
   three, g2 returns on its directory and the router replays the missed
   suffix.  Resync: g2 returns on an empty directory and the router
   streams it every fragment of every frame from a donor; a cold pair
   batch and the TopN straight to its door equal the answers; where
   pyarrow imports, the router restarts on its WAL with the columnar
   lane on and a second blank resync builds g2's standard views with
   ``build_planes``.  After each, the three ``/replica/digest`` bodies
   are equal.  Last, a second router partitions the slices over g0 and
   g1 (``--shard-map``): SetBits through it land on their slice's owner
   only, and pair and N-ary batches over them merge to the numpy
   engine's answers.  Every kernel of the fleet path must launch.  A
   "fleet" line gives each read's router and door ms, the serving
   groups, launches, the catch-up's records and ms, the resyncs' bytes,
   ms and MB/s, the WAL's bytes and the digests.
10. The analysis phase (``pilosa_tpu_torch.analysis``), after the tall
   path: three processes start together.  The project linter over the
   package (``python -m pilosa_tpu_torch.analysis``) must exit 0 with "0
   NEW"; the interleaving explorer's live scenarios and the protocol model
   check (``--explore all``) must exit 0; and ``python3 chip_smoke.py
   --lock-check DIR`` runs with ``PILOSA_TPU_LOCK_CHECK=1`` over a copy of
   the first ANALYSIS_SLICES (8) slices of frame ``f``: a port ``Server``
   on the card, four client threads started together from cold, each
   sending the pair, N-ary, tree and TopN batches (rotated, so the
   kernels' first loads race) and then a SetBit and a Count of its own;
   every answer equals the numpy engine's, every kernel those requests
   reach launches, the kernels' build lock is seen by the checker, and
   the checker records no violation.  An "analysis" line gives the
   findings, the schedules explored, the lock violations and the seconds.
11. Fails unless every kernel's launch counter moved during its path: the
   counters are set to 0 just before each path and read just after it.

Prints a ptxas line, a tree-checks and two staged-checks lines,
``{"card": ..., "layout" / "tree_gate" / "multi_paths" / "multi_tilings" /
"multi_gate" / "gather2_paths" / "tree_paths": [...]}`` lines, a ``{"card": ..., "bulk": {...}}``
line, ``{"card": ..., "mesh_nccl": {...}}``, ``{"card": ..., "mesh": {...}}``, ``{"card": ..., "fleet": {...}}``
and ``{"card": ..., "analysis": {...}}`` lines, a ``{"card": ..., "requests": [...]}`` line
per path, a ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": {...}}``.  Any failure raises.

    python3 chip_smoke.py --resident-against DIR

times ``pair_gram`` (at its four timed shapes), ``build_planes`` (at
``BUILD_TIMED``), ``resident_count2``, ``gather_count2``, the two count entry points
(``dispatch.count``, ``dispatch.batch_intersection_count``), the tree entry
point (``dispatch.gather_count_tree``) and the two multi-fold entry points
(``dispatch.gather_count_multi``, ``dispatch.gather_count_multi_rowmajor``)
of this checkout against those of the checkout at DIR (for example an
earlier commit unpacked with ``git archive``) on the same inputs —
pairs at S=64 R=256 for B = 256 to 4,096, counts at [64, W], [256, W] &
src and [1, 4], trees at the kernels line's shapes and every tree bucket
of the paths (``tree_path_batches``), folds at every batch the paths
launch and at the kernels line's timed shapes — in the order DIR, this,
this, DIR, after checking that the two agree exactly; it prints a
``{"card": ..., "gram_against": [...]}``, a ``"build_against"``, a
``"resident_against"``, a ``"gather2_against"``, a
``"count_against"``, a ``"tree_against"``, a ``"staged_against"`` (the
staged multi kernels alone, each through its own wrapper, at the kernels
line's shapes, with each wrapper's host work) and a ``{"card": ...,
"multi_against": [...]}`` line.

    python3 chip_smoke.py --multi-against DIR

prints the last two of those lines alone (``multi_against``).

    python3 chip_smoke.py --requests-against DIR

drives the executor and HTTP paths' requests (no kernel phase, no tall
path) with the package of the checkout at DIR and with this one, each in
a process of its own (``--requests ROOT``), in the order DIR, this,
this, DIR, every answer checked against the numpy engine, and prints a
``{"card": ..., "requests_against": [...]}`` line of each request's wall
ms a side.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from datetime import datetime

import numpy as np
import torch

# ``--requests ROOT`` drives the paths with the package of the checkout at
# ROOT (see ``requests_of``).
if sys.argv[1:2] == ["--requests"]:
    sys.path.insert(0, os.path.abspath(sys.argv[2]))

from pilosa_tpu_torch.ops import kernels  # noqa: E402

SLICE_WIDTH = 1 << 20
W = SLICE_WIDTH // 32

# Main-path size: 64 slices x 256 rows x 128 KiB = 2 GiB, exactly the
# default per-pool budget (PILOSA_TPU_POOL_BYTES); 64 slices is the most
# at which TopN's scorer pool still holds one 256-row candidate chunk.
N_SLICES = 64
N_ROWS = 256
BITS_PER_ROW = 2000
PAIR_BATCH = 256
GATHER_BATCH = 16
SUBSET = 16
SEED = 7

# The HTTP path: frame ``t`` (time quantum YMD) with 8 rows, stamped as
# bench.py stamps its time-range workload (48 stamps in 2017: months 1-12
# x days {1, 15} x hours {0, 12}); fold batches of 64 queries and Range
# batches of 128.
TIME_ROWS = 8
STAMPS = [datetime(2017, m, d, hh) for m in range(1, 13) for d in (1, 15) for hh in (0, 12)]
FOLD_BATCH = 64
RANGE_BATCH = 128
TREE_WIDE_BATCH = 256
# "tree-hot" draws its nested Counts from the first 64 rows only.
TREE_HOT_ROWS = 64

# The tall path: 32 slices x 1,024 rows x 128 KiB = 4 GiB, twice the
# default pool budget (which holds 512 rows at 32 slices), so batches
# naming every row page through the pool in parts.  Pair batches name
# every row once; the N-ary body cycles Intersect of 3, Union of 4 and
# Difference of 3 with every fifth call a pair Xor; one Union names more
# rows than the pool holds.
TALL_SLICES = 32
TALL_ROWS = 1024
TALL_BITS = 1000
TALL_NARY = 256
TALL_XOR = 64
WIDE_UNION = 640

# H100 SXM published peaks (NVIDIA data sheet) used for the bounds: HBM3
# bandwidth and the 32-bit non-tensor-core rate for the integer word ops.
# The data sheet publishes no 1-bit rate: the Gram's bit products are
# bounded by the rate ``b1_rate`` measures in the same run.  The dense
# int8 tensor-core rate (2 ops a product) is reported beside it only.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_INT8_OPS_S = 1979e12
# Integer ops per 32-bit word: pair op, popc, add (2 without a pair op).
OPS_PER_WORD = 3

SOURCES = {
    "count_rows": "pilosa_tpu_torch/csrc/count_rows.cu",
    "resident_count2": "pilosa_tpu_torch/csrc/resident_count2.cu",
    "gather_count2": "pilosa_tpu_torch/csrc/gather_count2.cu",
    "gather_src_counts": "pilosa_tpu_torch/csrc/gather_src_counts.cu",
    "gather_count_multi": "pilosa_tpu_torch/csrc/gather_count_multi.cu",
    "gather_count_tree": "pilosa_tpu_torch/csrc/gather_count_tree.cu",
    "resident_count_tree": "pilosa_tpu_torch/csrc/resident_count_tree.cu",
    "gather_count2_rowmajor": "pilosa_tpu_torch/csrc/gather_count2_rowmajor.cu",
    "gather_count_multi_rowmajor": "pilosa_tpu_torch/csrc/gather_count_multi_rowmajor.cu",
    "topn_counts": "pilosa_tpu_torch/csrc/topn_counts.cu",
    "resident_count_multi": "pilosa_tpu_torch/csrc/resident_count_multi.cu",
    "pair_gram": "pilosa_tpu_torch/csrc/pair_gram.cu",
    "build_planes": "pilosa_tpu_torch/csrc/build_planes.cu",
    "gather_count_multi_mixed": "pilosa_tpu_torch/csrc/gather_count_multi_mixed.cu",
}
# The def line of each Pallas kernel in pilosa_tpu/ops/pallas_kernels.py.
REPLACES = {
    "count_rows": "pilosa_tpu/ops/pallas_kernels.py:83",  # fused_count2 (+ fused_count1 :669)
    "resident_count2": "pilosa_tpu/ops/pallas_kernels.py:187",
    "gather_count2": "pilosa_tpu/ops/pallas_kernels.py:241",
    "gather_src_counts": "pilosa_tpu/ops/pallas_kernels.py:343",
    # fused_gather_count_multi (+ fused_gather_count_or :592)
    "gather_count_multi": "pilosa_tpu/ops/pallas_kernels.py:554",
    "gather_count_tree": "pilosa_tpu/ops/pallas_kernels.py:626",
    "resident_count_tree": "pilosa_tpu/ops/pallas_kernels.py:626",  # the staged variant
    "gather_count2_rowmajor": "pilosa_tpu/ops/pallas_kernels.py:415",
    "gather_count_multi_rowmajor": "pilosa_tpu/ops/pallas_kernels.py:490",
    "topn_counts": "pilosa_tpu/ops/pallas_kernels.py:293",
    # the staged variant of fused_gather_count_multi (+ the row-major form :490)
    "resident_count_multi": "pilosa_tpu/ops/pallas_kernels.py:554",
    # not Pallas: the reference's all-pairs Gram, an int8 product on the MXU
    "pair_gram": "pilosa_tpu/ops/bitwise.py:282",
    # not Pallas: the reference's device bulk build lane, a jitted sort,
    # dedup and scatter-add (its kernel body: _jax_kernel, :152)
    "build_planes": "pilosa_tpu/bulk/build.py:181",
    # replaces none by itself: fused_gather_count_multi's per-(op, K)
    # launches of one request, folded into one
    "gather_count_multi_mixed": "pilosa_tpu/ops/pallas_kernels.py:554",
}
# Which path must launch each kernel: the executor path keeps the four
# pair/TopN kernels, the HTTP path the five fold kernels (the mixed multi
# kernel through the N-ary requests, the gather multi kernel through the
# "range-short" request's Range covers, the staged tree kernel through the
# "tree-hot" request, the staged multi kernel through the "range-wide"
# request), the tall path the two row-major kernels, and the differential
# sweep the whole-row scorer, the bulk path the plane build.
PATH_OF = {
    "count_rows": "executor", "resident_count2": "executor", "gather_count2": "executor",
    "gather_src_counts": "executor", "gather_count_multi": "http", "gather_count_tree": "http",
    "resident_count_tree": "http", "resident_count_multi": "http",
    "gather_count2_rowmajor": "tall", "gather_count_multi_rowmajor": "tall",
    "topn_counts": "diffcheck", "pair_gram": "executor", "build_planes": "bulk",
    "gather_count_multi_mixed": "http",
}
PAIR_OPS = ("and", "or", "xor", "andnot")
PQL_OPS = {"and": "Intersect", "or": "Union", "andnot": "Difference", "xor": "Xor"}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush_buf = None


def _flush_l2() -> None:
    """Overwrite more than the 50 MB L2 so the next launch reads cold,
    as the main path's callers find the matrices."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of fn() in ms: CUDA events around each launch,
    the L2 flushed before each."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        _flush_l2()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def bound(nbytes: int, ops: int, ops_s: float = PEAK_OPS_S) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over ``ops_s`` (the 32-bit rate; the measured b1
    tensor-core rate for the Gram), in ms, and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def span_pool(rng) -> list[tuple[str, str]]:
    """bench.py's dashboard span pool (its time-range workload): four
    fixed widget ranges plus 24 random day-aligned spans in Jan-Feb."""
    pool = [
        ("2017-01-01T00:00", "2018-01-01T00:00"),
        ("2017-02-01T00:00", "2017-07-15T12:00"),
        ("2017-03-01T00:00", "2017-04-01T00:00"),
        ("2017-06-10T00:00", "2017-06-20T00:00"),
    ]
    for _ in range(24):
        m1 = int(rng.integers(1, 3))
        d1 = int(rng.integers(1, 28))
        dur = int(rng.integers(1, 22))
        m2, d2 = m1, d1 + dur
        if d2 > 28:
            m2, d2 = m1 + 1, d2 - 28
        pool.append((f"2017-{m1:02d}-{d1:02d}T00:00", f"2017-{m2:02d}-{d2:02d}T00:00"))
    return pool


def new_spans(rng, n: int) -> list[tuple[str, str]]:
    """Short day-aligned spans in Mar-May: covers the pool never asked."""
    out = []
    for _ in range(n):
        m, d = int(rng.integers(3, 6)), int(rng.integers(2, 21))
        out.append((f"2017-{m:02d}-{d:02d}T00:00", f"2017-{m:02d}-{d + int(rng.integers(1, 8)):02d}T00:00"))
    return out


def wide_spans(rng, n: int) -> list[tuple[str, str]]:
    """Day-aligned spans of 16-19 days in January ("the last two or three
    weeks"): covers of 16-19 day views, most of which the pool's January
    spans already name, that no earlier request asked."""
    out = []
    for _ in range(n):
        days = int(rng.integers(16, 20))
        d = int(rng.integers(1, 32 - days))
        out.append((f"2017-01-{d:02d}T00:00", f"2017-01-{d + days:02d}T00:00"))
    return out


def cover(span) -> list[str]:
    """The YMD view cover of a span (the Range lane's operand list)."""
    from pilosa_tpu_torch.core.timequantum import views_by_time_range
    from pilosa_tpu_torch.core.view import VIEW_STANDARD

    start, end = (datetime.strptime(t, "%Y-%m-%dT%H:%M") for t in span)
    return views_by_time_range(VIEW_STANDARD, start, end, "YMD")


def _entry_name(mangled: str) -> str:
    """``kernel<args>`` for a mangled template kernel's name (its integer
    template arguments), else the name as ptxas printed it.  The mangled
    identifier is length-prefixed and may follow an anonymous namespace's
    tag, whose hash can end in digits: the prefix is the digit run equal
    to the length of what follows it."""
    m = re.search(r"([A-Za-z0-9_]+_kernel)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    ident = m.group(1)
    for i in range(len(ident)):
        j = i
        while j < len(ident) and ident[j].isdigit():
            j += 1
        if j > i and int(ident[i:j]) == len(ident) - j:
            ident = ident[j:]
            break
    return f"{ident}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def ptxas_usage(names) -> dict:
    """Registers, spills, stack and shared memory per kernel of the given
    sources, as ``nvcc -Xptxas -v`` reports them (one nvcc per source, together)."""
    procs = {}
    with tempfile.TemporaryDirectory() as d:
        for name in names:
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS[:4], "-Xptxas", "-v", "-cubin",
                   "-o", os.path.join(d, f"{name}.cubin"), os.path.join(kernels._CSRC, f"{name}.cu")]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        out = {}
        for name, p in procs.items():
            text = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n{text}")
            # Per entry, ptxas prints its spill line before its register line.
            entries, fn, spill, stack = [], None, None, None
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    fn, spill, stack = m.group(1), None, None
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    spill = int(m.group(1))
                m = re.search(r"(\d+) bytes stack frame", line)
                if m:
                    stack = int(m.group(1))
                m = re.search(r"Used (\d+) registers", line)
                if m and fn:
                    smem = re.search(r"(\d+) bytes smem", line)
                    entries.append({"entry": _entry_name(fn), "registers": int(m.group(1)),
                                    "smem_bytes": int(smem.group(1)) if smem else 0,
                                    "spill_store_bytes": spill, "stack_bytes": stack})
            out[name] = entries
    return out


# ---------------------------------------------------------------------------
# phase 1: card
# ---------------------------------------------------------------------------

def probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this run needs the card")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = out[0].strip()
    print(card, flush=True)
    # The plain Gram's exactness needs full fp32 products (the default).
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _gen(seed: int) -> torch.Generator:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _rand_words(gen, shape) -> torch.Tensor:
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device="cuda", generator=gen)


# count_rows's edge shapes (M, W): one 16-byte row, a ragged W, a row of
# one segment, and 1,000 rows of four.
COUNT_EDGES = ((1, 4), (3, 1028), (300, 4096), (1000, W))


def check_kernels() -> tuple[dict, list, list, dict]:
    """Every kernel == its plain version on the card for every op
    variant, at the main path's shapes; returns per-kernel timings, the
    slice-major vs row-major comparison, the tree gate's grid and the
    multi lines (``time_multi``)."""
    gen = _gen(SEED)
    rm = _rand_words(gen, (N_SLICES, N_ROWS, W))
    stack = _rand_words(gen, (N_SLICES, W))
    rows = rm[0].contiguous()  # [256, W]: a TopN candidate chunk
    src = _rand_words(gen, (W,))
    rng = np.random.default_rng(SEED)
    err = dict.fromkeys(kernels.KERNELS, 0)

    def diff(name, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
        d = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
        err[name] = max(err[name], d)
        if d:
            raise AssertionError(f"{name}: kernel differs from its plain version by {d}")

    # count_rows: no op over a [64, W] stack (Count), every op against a
    # shared src (TopN scoring) and against per-row operands.
    diff("count_rows", kernels.count_rows(stack), kernels.count_rows_plain(stack))
    for op in PAIR_OPS:
        diff("count_rows", kernels.count_rows(rows, src, op), kernels.count_rows_plain(rows, src, op))
        other = rm[1].contiguous()
        diff("count_rows", kernels.count_rows(rows, other, op), kernels.count_rows_plain(rows, other, op))
    pairs_r = rng.integers(0, N_ROWS, size=(PAIR_BATCH, 2)).astype(np.int32)
    pairs_g = rng.integers(0, N_ROWS, size=(GATHER_BATCH, 2)).astype(np.int32)
    pos = rng.permutation(N_ROWS).astype(np.int32)
    for op in PAIR_OPS:
        diff("resident_count2", kernels.resident_count2(op, rm, pairs_r),
             kernels.resident_count2_plain(op, rm, pairs_r))
        diff("gather_count2", kernels.gather_count2(op, rm, pairs_g),
             kernels.gather_count2_plain(op, rm, pairs_g))
    diff("gather_src_counts", kernels.gather_src_counts(rm, pos, stack),
         kernels.gather_src_counts_plain(rm, pos, stack))
    torch.cuda.synchronize()
    # count_rows on stacks one segment a row and split into several, ragged.
    gen_c = _gen(SEED + 15)
    for m, w in COUNT_EDGES:
        a = _rand_words(gen_c, (m, w))
        one = _rand_words(gen_c, (w,))
        diff("count_rows", kernels.count_rows(a), kernels.count_rows_plain(a))
        diff("count_rows", kernels.count_rows(a, one, "xor"), kernels.count_rows_plain(a, one, "xor"))
    del a, one
    fold_cases = check_fold_kernels(rm, rng, diff)
    print(json.dumps({"tree_checks": check_tree_edges(rm, diff)}), flush=True)
    print(json.dumps({"narrow_folds": check_narrow_folds(rm, diff)}), flush=True)
    print(json.dumps({"mixed_checks": check_mixed(rm, diff)}), flush=True)
    check_staged_kernels(rm, diff)
    print(json.dumps({"staged_checks": {"resident_count_multi": check_staged_multi(rm, diff)}}),
          flush=True)

    # Timings at the main path's shapes; bytes count each input the
    # function needs once (the rows this run's ids reference).
    def uniq(ids):
        return len(np.unique(ids))

    row_b = W * 4
    res = {}
    # count_rows at TopN phase 1's [256, W] & src (the line's numbers), the
    # sequential Count's [64, W], and its floor: one 16-byte row.
    res["count_rows"] = dict(
        count_times(rows, src, "and"), shape=f"[{N_ROWS}, {W}] & shared src (TopN phase 1)",
        plain_ms=cuda_ms(lambda: kernels.count_rows_plain(rows, src, "and"), reps=5))
    res["count_rows"]["count_path"] = dict(
        count_times(stack, None, "none"), shape=f"[{N_SLICES}, {W}] no op (sequential Count)",
        plain_ms=cuda_ms(lambda: kernels.count_rows_plain(stack), reps=5))
    res["count_rows"]["floor"] = dict(count_times(stack[:1, :4].contiguous(), None, "none"),
                                      shape="[1, 4] no op (one launch's floor)")
    # gather_count2 at B = 16 (the kernels line) and 64, 256, 600 ("shapes"),
    # each also timed without the entry point's host work ("kernel_ms").
    g2 = [gather2_times("and", rm, rng.integers(0, N_ROWS, size=(b, 2)).astype(np.int32))
          for b in GATHER2_BATCHES[1:]]
    res["gather_count2"] = dict(
        gather2_times("and", rm, pairs_g, sweep=True),
        shape=f"rm [{N_SLICES}, {N_ROWS}, {W}], {GATHER_BATCH} pairs, and",
        plain_ms=cuda_ms(lambda: kernels.gather_count2_plain("and", rm, pairs_g), reps=5),
        shapes=g2,
    )
    nb, by = bound(N_SLICES * uniq(pos) * row_b + N_SLICES * row_b + pos.nbytes
                   + N_SLICES * N_ROWS * 4, N_SLICES * N_ROWS * W * OPS_PER_WORD)
    res["gather_src_counts"] = dict(
        shape=f"rm [{N_SLICES}, {N_ROWS}, {W}], {N_ROWS} candidates",
        ms=cuda_ms(lambda: kernels.gather_src_counts(rm, pos, stack)),
        plain_ms=cuda_ms(lambda: kernels.gather_src_counts_plain(rm, pos, stack), reps=3),
        bound_ms=nb, bound_by=by,
    )
    res.update(time_fold_kernels(rm, fold_cases))
    del fold_cases
    # The mixed kernel at the single-group shapes of the line's
    # gather_count_multi entry, timed there.
    single = [dict(shape=e["shape"], gather_ms=e["abba_gather_ms"], mixed_ms=e["mixed_ms"],
                   mixed_over_gather=e["mixed_over_gather"])
              for e in [res["gather_count_multi"], *res["gather_count_multi"]["shapes"]]]
    staged, gate = time_staged_kernels(rm, pairs_r)
    res.update(staged)
    words = _Words()
    staged, multi = time_multi(words, diff)
    res.update(staged)
    del words
    torch.cuda.empty_cache()
    tall, layout = check_tall_kernels(rm, stack, rng, diff)
    res.update(tall)
    del rm, stack, rows
    torch.cuda.empty_cache()
    res["gather_count_multi_mixed"] = dict(time_mixed(diff), single_group=single)
    res.update(check_gram(diff))
    res.update(check_build_planes(diff))
    for name in res:
        res[name]["max_abs_err"] = err[name]
    return res, layout, gate, multi


# Queries per plain-version call in the fold checks: the plain versions
# materialize the [S, B, K, W] gather, so the batch is cut to keep that
# under a few GiB (the counts are per query; cutting B changes none).
PLAIN_CHUNK = 16


def _chunked(plain, *per_query):
    """Run ``plain(*args)`` over query chunks and concatenate: the plain
    version on the same inputs, with its transient memory bounded."""
    b = len(per_query[0])
    return torch.cat([plain(*(a[i:i + PLAIN_CHUNK] for a in per_query))
                      for i in range(0, b, PLAIN_CHUNK)])


def _andnot_left_fold(rm, idx):
    """Difference as the TPU kernel folds it: acc & ~row, left to right."""
    from pilosa_tpu_torch.ops import bitwise

    ix = torch.as_tensor(idx, device=rm.device).long()
    acc = rm[:, ix[:, 0]]
    for j in range(1, ix.shape[1]):
        acc = acc & ~rm[:, ix[:, j]]
    return bitwise.count(acc).sum(dim=0, dtype=torch.int32)


def range_shape(rng):
    """The Range lane's kernel shape at this run's data: a multi-view
    matrix of (view, row) rows (capacity a power of two, as the executor
    allocates it), and RANGE_BATCH covers drawn from the span pool, padded
    to the widest by repeating the first id (the executor's pad)."""
    pool = span_pool(np.random.default_rng(13))
    covers = [cover(sp) for sp in pool]
    views = sorted({v for c in covers for v in c})
    n = len(views) * TIME_ROWS
    cap = 1 << (n - 1).bit_length()
    pos = {v: i for i, v in enumerate(views)}
    k = max(len(c) for c in covers)
    idx = np.zeros((RANGE_BATCH, k), dtype=np.int32)
    for q in range(RANGE_BATCH):
        c = covers[int(rng.integers(0, len(covers)))]
        r = int(rng.integers(0, TIME_ROWS))
        ids = [pos[v] * TIME_ROWS + r for v in c]
        idx[q] = ids + [ids[0]] * (k - len(ids))
    return cap, idx


# ---------------------------------------------------------------------------
# The multi-fold batches the paths launch
# ---------------------------------------------------------------------------

# The requests whose multi-fold batches are timed at their own shapes
# draw from generators of their own, so the kernel phase rebuilds the
# batches the paths launch (as the executor builds them) without driving
# the paths.
NARY_SEED = SEED + 8
RANGE_SEED = SEED + 9
TALL_NARY_SEED = SEED + 10
NARY_SHAPES = (("nary-and", "and", 3), ("nary-or", "or", 4), ("nary-andnot", "andnot", 3))
# range-wide: every time row over each of 16 wide spans (128 Counts).
RANGE_WIDE_SPANS = 16
# The executor's defaults the tall path runs under: the 2 GiB row-pool
# budget (512 rows of 32 slices) and the 2 GiB slice-streaming budget.
TALL_POOL_ROWS = (2 << 30) // (TALL_SLICES * W * 4)
STREAM_BYTES = 2 << 30


def nary_requests(n_rows: int) -> dict:
    """The HTTP path's N-ary batches: name -> (op, int32[FOLD_BATCH, K]
    operand rows)."""
    rng = np.random.default_rng(NARY_SEED)
    return {name: (op, rng.integers(0, n_rows, size=(FOLD_BATCH, k)).astype(np.int32))
            for name, op, k in NARY_SHAPES}


def range_requests(time_rows: int) -> tuple[list, list, list]:
    """range-1's, range-2's and range-wide's (row, span) items: 128 draws
    from the span pool; 96 more draws and 32 Counts over four new spans,
    shuffled; every row over each of RANGE_WIDE_SPANS wide spans,
    shuffled."""
    rng = np.random.default_rng(RANGE_SEED)
    pool = span_pool(np.random.default_rng(13))

    def draw():
        return int(rng.integers(0, time_rows)), pool[int(rng.integers(0, len(pool)))]

    one = [draw() for _ in range(RANGE_BATCH)]
    fresh = new_spans(rng, 4)
    two = [draw() for _ in range(RANGE_BATCH - 32)]
    two += [(int(rng.integers(0, time_rows)), fresh[i % len(fresh)]) for i in range(32)]
    two = [two[i] for i in rng.permutation(len(two))]
    wide = [(r, sp) for sp in wide_spans(rng, RANGE_WIDE_SPANS) for r in range(time_rows)]
    return one, two, [wide[i] for i in rng.permutation(len(wide))]


def range_short(time_rows: int) -> list:
    """range-short's (row, span) items: every row over each of two short
    August spans that no other request asks, each over August 15th (a day
    of STAMPS): covers of 1-7 day views."""
    rng = np.random.default_rng(RANGE_SEED + 1)
    spans = []
    for _ in range(2):
        d = int(rng.integers(9, 16))
        end = max(16, d + int(rng.integers(1, 8)))
        spans.append((f"2017-08-{d:02d}T00:00", f"2017-08-{end:02d}T00:00"))
    return [(r, sp) for sp in spans for r in range(time_rows)]


def range_batches(one, two, wide) -> list:
    """The Range lane's kernel batches of range-1, range-2 and range-wide
    as the executor builds them: (request, matrix rows, idx).  The multi-view
    matrix's rows are the (view, row) combos in sorted order, a later
    request's new combos after them, capacity a power of two; a batch is
    the Counts the cover memo misses (range-2 repeats range-1's), each
    cover padded to the widest by repeating its first id."""
    pos, memo, out = {}, set(), []
    for name, items in (("range-1", one), ("range-2", two), ("range-wide", wide)):
        covers = [(r, tuple(cover(sp))) for r, sp in items]
        for c in sorted({(v, r) for r, cv in covers for v in cv} - pos.keys()):
            pos[c] = len(pos)
        misses = [(r, cv) for r, cv in covers if (r, cv) not in memo]
        k = max(len(cv) for _, cv in misses)
        idx = np.array([[pos[(v, r)] for v in cv] + [pos[(cv[0], r)]] * (k - len(cv))
                        for r, cv in misses], dtype=np.int32)
        memo |= set(misses)
        out.append((name, 1 << (len(pos) - 1).bit_length(), idx))
    return out


def tall_nary_ops(n_rows: int) -> list:
    """The tall-nary request: (op, operand rows) per Count — Intersect of
    3, Union of 4 and Difference of 3 in turn, every fifth a pair Xor —
    with operands walking a permutation of the rows."""
    rng = np.random.default_rng(TALL_NARY_SEED)
    walk = iter(np.resize(rng.permutation(n_rows), 4 * (TALL_NARY + TALL_XOR)))
    shapes = (("and", 3), ("or", 4), ("andnot", 3))
    out = []
    for i in range(TALL_NARY + TALL_XOR):
        op, k = ("xor", 2) if i % 5 == 4 else shapes[(i - i // 5) % 3]
        out.append((op, [int(next(walk)) for _ in range(k)]))
    return out


def tall_nary_batches(ops, cap: int) -> list:
    """The row-major fold batches of the tall-nary request as the
    executor pages it: parts whose distinct rows fit the pool's ``cap``
    slots (``rowpool.chunk_queries``), one batch per (op, K >= 3) group of
    a part; pool slots drawn at random.  (part, op, idx) each."""
    from pilosa_tpu_torch.rowpool import chunk_queries

    rng = np.random.default_rng(TALL_NARY_SEED + 1)
    out = []
    parts = chunk_queries(list(range(len(ops))), lambda i: ops[i][1], cap, oversize_ok=True)
    for p, part in enumerate(parts):
        want = sorted({x for i in part for x in ops[i][1]})
        slot = dict(zip(want, rng.permutation(cap)[:len(want)].tolist()))
        groups: dict = {}
        for i in part:
            op, rows = ops[i]
            if len(rows) > 2:
                groups.setdefault((op, len(rows)), []).append([slot[x] for x in rows])
        for (op, _), lists in groups.items():
            out.append((p, op, np.array(lists, dtype=np.int32)))
    return out


def multi_path_batches() -> list:
    """Every multi-fold batch the HTTP and tall paths launch, at its own
    shape: {"request", "layout" ("slice": [S, R, W], "row": [R, S, W]),
    "matrix" (its first two dims), "op", "idx"}.  The wide Union streams
    its 32 slices in chunks of the streaming budget, one launch each."""
    out = [dict(request=f"http {name}", layout="slice", matrix=(N_SLICES, N_ROWS), op=op, idx=idx)
           for name, (op, idx) in nary_requests(N_ROWS).items()]
    for name, cap, idx in range_batches(*range_requests(TIME_ROWS)):
        out.append(dict(request=f"http {name}", layout="slice", matrix=(N_SLICES, cap), op="or",
                        idx=idx))
    for p, op, idx in tall_nary_batches(tall_nary_ops(TALL_ROWS), TALL_POOL_ROWS):
        out.append(dict(request=f"tall-nary part {p}", layout="row",
                        matrix=(TALL_POOL_ROWS, TALL_SLICES), op=op, idx=idx))
    s_chunk = STREAM_BYTES // (WIDE_UNION * W * 4)
    union = np.random.default_rng(TALL_NARY_SEED + 2).permutation(WIDE_UNION)[None].astype(np.int32)
    for s0 in range(0, TALL_SLICES, s_chunk):
        out.append(dict(request="tall-wide-union", layout="row",
                        matrix=(WIDE_UNION, min(s_chunk, TALL_SLICES - s0)), op="or", idx=union))
    return out


def multi_timed_batches() -> list:
    """The shapes the kernels line times for the two gather folds, drawn anew:
    the pool [64, 256, W] at B=64 (K=3 and, 4 or, 16 andnot), the Range
    batch of ``range_shape`` (B=128, K=23) and row-major [1024, 32, W] at
    B=512 (K=3 and, 4 or, 16 andnot)."""
    rng = np.random.default_rng(SEED + 11)
    out = []
    for k, op in ((3, "and"), (4, "or"), (16, "andnot")):
        out.append(dict(request=f"timed pool K={k}", layout="slice", matrix=(N_SLICES, N_ROWS),
                        op=op, idx=rng.integers(0, N_ROWS, size=(FOLD_BATCH, k)).astype(np.int32)))
    cap, ridx = range_shape(rng)
    out.append(dict(request="timed Range", layout="slice", matrix=(N_SLICES, cap), op="or",
                    idx=ridx))
    for k, op in ((3, "and"), (4, "or"), (16, "andnot")):
        out.append(dict(request=f"timed row-major K={k}", layout="row",
                        matrix=(TALL_ROWS, TALL_SLICES), op=op,
                        idx=rng.integers(0, TALL_ROWS, size=(2 * PAIR_BATCH, k)).astype(np.int32)))
    return out


class _Words:
    """One buffer of random words on the card, viewed as each batch's
    matrix (the counts' values do not matter to a timing; the shapes do)."""

    def __init__(self):
        self.buf = None

    def matrix(self, batch) -> torch.Tensor:
        a, b = batch["matrix"]
        n = a * b * W
        if self.buf is None or self.buf.numel() < n:
            self.buf = None
            torch.cuda.empty_cache()
            self.buf = _rand_words(_gen(SEED + 12), (n,))
        return self.buf[:n].view(a, b, W)


def multi_bound(batch) -> tuple[float, str]:
    """The least time for a batch: each distinct row's slices read once,
    the ids read and the counts written; a fold op for each of a query's
    distinct operands past the first (a repeat changes nothing), a
    popcount and an add a word."""
    from pilosa_tpu_torch.ops import dispatch

    idx = batch["idx"]
    b = idx.shape[0]
    a, c = batch["matrix"]
    s = a if batch["layout"] == "slice" else c
    return bound(s * len(np.unique(idx)) * W * 4 + idx.nbytes + b * 4,
                 s * W * (dispatch.fold_refs(idx) + b))


def _multi_summary(batch) -> dict:
    """A batch's shape: B, padded K, distinct rows U, references (each
    query's distinct operands, summed: ``dispatch.fold_refs``), operands
    a fold and references a row, and its bound."""
    from pilosa_tpu_torch.ops import dispatch

    idx = batch["idx"]
    b, k = idx.shape
    u = len(np.unique(idx))
    refs = dispatch.fold_refs(idx)
    a, c = batch["matrix"]
    nb, by = multi_bound(batch)
    return {"request": batch["request"], "layout": batch["layout"], "op": batch["op"],
            "matrix": [a, c, W], "B": b, "K": k, "distinct": u, "refs": refs,
            "operands": refs / b, "reuse": refs / u, "bound_ms": nb, "bound_by": by}


def multi_choice(batch) -> str:
    """The kernel the multi dispatch gives a batch."""
    from pilosa_tpu_torch.ops import dispatch

    a, c = batch["matrix"]
    row_major = batch["layout"] == "row"
    s, r = (c, a) if row_major else (a, c)
    staged = dispatch.staged_multi_batch(batch["op"], batch["idx"], s, r, W) is not None
    return "staged" if staged else "gather"


def _multi_entry(dispatch_mod, batch, m):
    fn = (dispatch_mod.gather_count_multi if batch["layout"] == "slice"
          else dispatch_mod.gather_count_multi_rowmajor)
    return lambda: fn(batch["op"], m, batch["idx"])


def multi_plan_of(batch) -> tuple:
    """The staged kernel's plan of a batch as its wrapper builds it
    (``kernels.multi_plan``), and the wrapper's tiling of it: (plan,
    (chunk_words, stages)); chunk_words 0 where nothing fits."""
    a, c = batch["matrix"]
    r = a if batch["layout"] == "row" else c
    ids, local = kernels.compact_rows(batch["idx"], r, "multi idx")
    plan = kernels.multi_plan(batch["op"], ids, local)
    return plan, kernels.multi_tiling(plan.u, W, plan.block_ints)


def plan_reads(plan) -> dict:
    """What a plan has the kernel read a tile: the rows its classes fold
    (each group's union: one shared-memory read a row and vector), the
    classes, and the first rows andnot reads once more."""
    ints, u = plan.ints, plan.u
    starts = ints[u:u + plan.groups + 1]
    rows = classes = 0
    for g in range(plan.groups):
        at = int(starts[g]) + 2 * kernels.MULTI_Q
        while at < starts[g + 1]:
            n = int(ints[at]) >> 4
            rows, classes = rows + n, classes + 1
            at += 4 * ((n + 4) // 4)
    return {"groups": plan.groups, "group_rows": rows, "classes": classes,
            "first_rows": plan.groups * kernels.MULTI_Q if plan.op == "andnot" else 0,
            "plan_ints": int(ints.size), "block_ints": plan.block_ints}


# ---------------------------------------------------------------------------
# The tree batches the paths launch
# ---------------------------------------------------------------------------

# The requests that hand the tree lane nested Counts (``_tree_call``'s four
# shapes in turn), how many Counts each carries and the rows they name:
# the executor path's "gather-3 mixed" (8), the HTTP path's "tree"
# (FOLD_BATCH), "tree-wide" (TREE_WIDE_BATCH) and "tree-hot"
# (TREE_WIDE_BATCH over TREE_HOT_ROWS).  ``tree_path_batches`` draws them
# anew from a generator of its own.
TREE_PATH_REQUESTS = (("gather-3", 8, N_ROWS), ("tree", FOLD_BATCH, N_ROWS),
                      ("tree-wide", TREE_WIDE_BATCH, N_ROWS), ("tree-hot", TREE_WIDE_BATCH, TREE_HOT_ROWS))
TREE_PATHS_SEED = SEED + 13


def tree_encodings(calls) -> list:
    """The executor's own tree encodings of Count calls over frame "f", one
    bucket per leaf count as the tree lane launches them: [(leaves
    int32[B, K], opc int32[B, K - 1])], K ascending.  Compiled by the
    port's executor over an empty index (the encoding reads only the
    calls)."""
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql.parser import parse

    by_k: dict = {}
    with tempfile.TemporaryDirectory() as d:
        h = Holder(d)
        h.open()
        try:
            h.create_index("i").create_frame("f", FrameOptions())
            ex = Executor(h, engine="numpy")
            for call in parse(" ".join(calls)).calls:
                _, _, (_, k), lv, oc = ex._compile_count_tree("i", call.children[0])
                by_k.setdefault(k, []).append((lv, oc))
        finally:
            h.close()
    return [(np.array([lv for lv, _ in v], np.int32), np.array([oc for _, oc in v], np.int32))
            for _, v in sorted(by_k.items())]


def tree_path_batches() -> list:
    """Every tree bucket of TREE_PATH_REQUESTS over the pool [S, R] = [64,
    256], drawn anew: {"request", "S", "R", "leaves", "opc"}."""
    rng = np.random.default_rng(TREE_PATHS_SEED)
    out = []
    for request, n, rows in TREE_PATH_REQUESTS:
        for lv, oc in tree_encodings([_tree_call(rng, rows, i) for i in range(n)]):
            out.append({"request": request, "S": N_SLICES, "R": N_ROWS, "leaves": lv, "opc": oc})
    return out


def tree_bound(s: int, w: int, leaves, opc) -> dict:
    """The least time for a tree batch: the distinct rows its LIVE leaves
    name (``kernels.tree_live_leaves``), each slice read once, the ids and
    opcodes read and the counts written; a node op for each live leaf, a
    popcount and an add a word.  Beside it the batch's live leaves and
    the bound the first design counted (every leaf's distinct rows)."""
    live = kernels.tree_live_leaves(opc)
    u = len(np.unique(leaves[live]))
    b, k = leaves.shape
    nb, by = bound(s * u * w * 4 + leaves.nbytes + opc.nbytes + b * 4,
                   s * w * (int(live.sum()) + b))
    return {"B": b, "K": k, "live_leaves": int(live.sum()), "leaves": b * k,
            "distinct_live": u, "distinct": len(np.unique(leaves)), "bound_ms": nb, "bound_by": by,
            "all_leaves_bound_ms": s * len(np.unique(leaves)) * w * 4 / PEAK_BYTES_S * 1e3}


def tree_times(m, leaves, opc) -> dict:
    """gather_count_tree on one batch: exact against its plain version,
    then the entry point's device time (its host work included, as the
    path pays it), the launch's alone (ids packed, ``kernel_ms``) and the
    entry point's host work a call (``host_ms``), beside its live-row
    bound (``tree_bound``)."""
    s, r, w = m.shape
    lv = np.ascontiguousarray(leaves, dtype=np.int32)
    oc = np.ascontiguousarray(opc, dtype=np.int32)
    want = _chunked(lambda x, y: kernels.gather_count_tree_plain(m, x, y), lv, oc)
    if not torch.equal(kernels.gather_count_tree(m, lv, oc), want):
        raise AssertionError(f"gather_count_tree B={len(lv)} K={lv.shape[1]}: kernel differs "
                             "from its plain version")
    ints = np.concatenate([lv.reshape(-1), kernels.tree_opcode_words(oc).reshape(-1)])
    dev = kernels._ints(ints, m.device)
    ptr = ints.ctypes.data if ints.size <= kernels.TREE_PARAM_INTS else dev.data_ptr()
    out = torch.empty(len(lv), dtype=torch.int32, device=m.device)
    fn = kernels._fn("gather_count_tree")
    stream = kernels._stream(m)

    def kernel_only():
        kernels._check(fn(m.data_ptr(), ptr, out.data_ptr(), s, r, w, len(lv), lv.shape[1],
                          stream), "gather_count_tree")

    kernel_only()
    if not torch.equal(out, want):
        raise AssertionError(f"gather_count_tree B={len(lv)}: kernel-only launch differs")
    return dict(tree_bound(s, w, lv, oc), S=s, R=r,
                ms=cuda_ms(lambda: kernels.gather_count_tree(m, lv, oc)),
                kernel_ms=cuda_ms(kernel_only),
                host_ms=host_ms(lambda: kernels.gather_count_tree(m, lv, oc)))


# Every tree batch the executor and HTTP paths hand the tree dispatch, as
# (S, R, leaves, opc, the kernel dispatch picks): the batches
# time_tree_paths rebuilds.
TREE_SEEN: list = []


def record_tree_batches() -> None:
    """Wrap the tree dispatch so that each call appends its batch to
    TREE_SEEN; the request records carry a summary."""
    from pilosa_tpu_torch.ops import dispatch

    def seen(m, leaves, opc, _fn=dispatch.gather_count_tree):
        s, r, w = m.shape
        lv = np.array(leaves, np.int32)
        staged = dispatch.tree_strategy(len(np.unique(lv)), w, opc, s)
        TREE_SEEN.append({"S": s, "R": r, "leaves": lv, "opc": np.array(opc, np.int32),
                          "pick": "resident_count_tree" if staged else "gather_count_tree"})
        return _fn(m, leaves, opc)

    dispatch.gather_count_tree = seen


def _tree_summary(b) -> dict:
    live = kernels.tree_live_leaves(b["opc"])
    return {"S": b["S"], "R": b["R"], "B": len(b["leaves"]), "K": b["leaves"].shape[1],
            "live_leaves": int(live.sum()), "distinct_live": len(np.unique(b["leaves"][live])),
            "pick": b["pick"]}


def time_tree_paths() -> list:
    """gather_count_tree at every tree batch the executor and HTTP paths
    handed the tree dispatch, each rebuilt over random words at its own
    matrix shape (``tree_times``), and beside it the staged kernel's
    device time on the same batch where that has a tiling
    (``staged_ms``), whichever of the two the gate picked (``pick``)."""
    def times(m, b):
        lv, oc = b["leaves"], b["opc"]
        t = dict(tree_times(m, lv, oc), pick=b["pick"], staged_ms=None)
        if kernels.tree_tiling(len(np.unique(lv)), m.shape[2], lv.shape[1], m.shape[0])[1]:
            if not torch.equal(kernels.resident_count_tree(m, lv, oc), kernels.gather_count_tree(m, lv, oc)):
                raise AssertionError(f"tree path batch B={len(lv)} K={lv.shape[1]}: the kernels disagree")
            t["staged_ms"] = cuda_ms(lambda: kernels.resident_count_tree(m, lv, oc))
        return t

    return _time_path_batches(TREE_SEEN, SEED + 14, times)


def check_fold_kernels(rm, rng, diff) -> dict:
    """gather_count_multi (and, or, andnot; K = 2-5 and 16; padded and
    unpadded) and gather_count_tree (K = 2, 4, 8, 16; opcodes 0-5, so
    pass nodes too) against their plain versions on the card, exactly, at
    the pool's shape (S = 64, R = 256, B = 64) and, for the Range lane, at
    the multi-view matrix's shape.  Returns the timed cases."""
    cases = {"gather_count_multi": [], "gather_count_tree": []}
    b = FOLD_BATCH
    for k in (2, 3, 4, 5, 16):
        idx = rng.integers(0, N_ROWS, size=(b, k)).astype(np.int32)
        for op in kernels.MULTI_OPS:
            got = kernels.gather_count_multi(op, rm, idx)
            diff("gather_count_multi", got,
                 _chunked(lambda x, _op=op: kernels.gather_count_multi_plain(_op, rm, x), idx))
            lo = 1 if op == "andnot" else 0
            pad = idx[np.arange(b)[:, None], rng.integers(lo, k, size=(b, 3))]
            diff("gather_count_multi", kernels.gather_count_multi(op, rm, np.concatenate([idx, pad], 1)), got)
            if op == "andnot" and k in (2, 3, 5):
                diff("gather_count_multi", got, _chunked(lambda x: _andnot_left_fold(rm, x), idx))
        if k in (3, 4, 16):
            cases["gather_count_multi"].append(
                {"op": {3: "and", 4: "or", 16: "andnot"}[k], "idx": idx, "rm": "pool"})
    cap, ridx = range_shape(rng)
    rmr = _rand_words(_gen(SEED + 3), (N_SLICES, cap, W))
    diff("gather_count_multi", kernels.gather_count_multi("or", rmr, ridx),
         _chunked(lambda x: kernels.gather_count_multi_plain("or", rmr, x), ridx))
    cases["gather_count_multi"].append({"op": "or", "idx": ridx, "rm": rmr})
    for k in kernels.TREE_LEAVES:
        leaves = rng.integers(0, N_ROWS, size=(b, k)).astype(np.int32)
        opc = rng.integers(0, 6, size=(b, k - 1)).astype(np.int32)
        diff("gather_count_tree", kernels.gather_count_tree(rm, leaves, opc),
             _chunked(lambda x, y: kernels.gather_count_tree_plain(rm, x, y), leaves, opc))
        cases["gather_count_tree"].append({"leaves": leaves, "opc": opc})
    torch.cuda.synchronize()
    return cases


# Narrow gather folds: one or two queries over a few slices, as a wide
# Union streams its slices; the fold kernels then narrow their chunk.
NARROW_BATCHES = (1, 2)
NARROW_SLICES = (5, 7, 16)
NARROW_KS = (5, 16, N_ROWS)


def _fold_vectors(b: int, s: int, sms: int) -> int:
    """The int4 vectors a thread of the gather folds takes (NV in
    csrc/gather_multi.cuh): 4, halved while B x chunks x S blocks are
    fewer than the card's SMs."""
    nv = 4
    while nv > 1 and b * -(-W // (4 * 256 * nv)) * s < sms:
        nv //= 2
    return nv


def check_narrow_folds(rm, diff) -> list:
    """Both gather folds at B = 1-2 over 5, 7 and 16 slices of the pool
    (slice-major views, row-major copies), K = 5, 16 and every row once,
    each op, against their plain versions exactly: the launches that take
    one, two and four int4 vectors a thread.  Returns the cases with the
    vectors each took."""
    rng = np.random.default_rng(STAGED_SEED + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names, seen = [], set()
    for s in NARROW_SLICES:
        layouts = (("slice", rm[:s], kernels.gather_count_multi, kernels.gather_count_multi_plain),
                   ("row", rm[:s].transpose(0, 1).contiguous(), kernels.gather_count_multi_rowmajor,
                    kernels.gather_count_multi_rowmajor_plain))
        for layout, m, fn, plain in layouts:
            name = "gather_count_multi" if layout == "slice" else "gather_count_multi_rowmajor"
            for b in NARROW_BATCHES:
                for k in NARROW_KS:
                    idx = (np.stack([rng.permutation(N_ROWS) for _ in range(b)]) if k == N_ROWS
                           else rng.integers(0, N_ROWS, size=(b, k))).astype(np.int32)
                    for op in kernels.MULTI_OPS:
                        diff(name, fn(op, m, idx), plain(op, m, idx))
                nv = _fold_vectors(b, s, sms)
                seen.add(nv)
                names.append(f"{layout} S={s} B={b}: NV={nv}")
        del layouts
    torch.cuda.synchronize()
    if not {1, 2} <= seen:
        raise AssertionError(f"narrow folds took NV {sorted(seen)} on {sms} SMs, want 1 and 2")
    return names


def time_fold_kernels(rm, cases) -> dict:
    """CUDA-event times of the two fold kernels and their plain versions
    at each checked main-path shape.  ``bound_ms`` counts each referenced
    row once (the function's inputs; for the tree, the rows its live
    leaves name: ``tree_bound``); ``gathered_bound_ms`` is the bytes the
    first designs gathered, B x S x K x W x 4 (a row named twice is read
    twice), over the same rate."""
    row_b = W * 4

    def entry(name, shape, matrix, ids, launch, plain):
        b, k = ids.shape
        s = matrix.shape[0]
        nb, by = bound(s * len(np.unique(ids)) * row_b + ids.nbytes + b * 4, b * s * W * (k + 1))
        return dict(
            shape=shape, ms=cuda_ms(launch), plain_ms=cuda_ms(plain, reps=2, warm=1),
            bound_ms=nb, bound_by=by, gathered_bound_ms=b * s * k * row_b / PEAK_BYTES_S * 1e3,
            all_rows_floor_ms=matrix.shape[0] * matrix.shape[1] * row_b / PEAK_BYTES_S * 1e3,
        )

    multi = []
    for c in cases["gather_count_multi"]:
        m = rm if isinstance(c["rm"], str) else c["rm"]
        idx, op = c["idx"], c["op"]
        where = "pool" if m is rm else "Range multi-view matrix"
        multi.append(entry(
            "gather_count_multi",
            f"{where} [{m.shape[0]}, {m.shape[1]}, {W}], B={idx.shape[0]}, K={idx.shape[1]}, {op}",
            m, idx, lambda: kernels.gather_count_multi(op, m, idx),
            lambda: _chunked(lambda x: kernels.gather_count_multi_plain(op, m, x), idx)))
        # The same one group through the mixed entry, timed in turns with
        # the gather entry.
        ops, off, ids = kernels.mixed_groups([(op, idx)])
        gather_ms, mixed_ms = abba_medians(lambda: kernels.gather_count_multi(op, m, idx),
                                       lambda: kernels.gather_count_multi_mixed(m, ops, off, ids))
        multi[-1].update(abba_gather_ms=gather_ms, mixed_ms=mixed_ms,
                         mixed_over_gather=mixed_ms / gather_ms)
    tree = []
    for c in cases["gather_count_tree"]:
        lv, oc = c["leaves"], c["opc"]
        tree.append(dict(
            tree_times(rm, lv, oc),
            shape=f"pool [{N_SLICES}, {N_ROWS}, {W}], B={lv.shape[0]}, K={lv.shape[1]}, opcodes 0-5",
            plain_ms=cuda_ms(lambda: _chunked(lambda x, y: kernels.gather_count_tree_plain(rm, x, y),
                                              lv, oc), reps=2, warm=1),
            gathered_bound_ms=lv.size * N_SLICES * row_b / PEAK_BYTES_S * 1e3))
    # The line's own numbers: the N-ary Intersect shape (K=3) and the
    # depth-3 tree (K=8); every other shape rides along under "shapes".
    out = {"gather_count_multi": dict(multi[0], shapes=multi[1:]),
           "gather_count_tree": dict(tree[2], shapes=tree[:2] + tree[3:])}
    return out


def abba_medians(fa, fb) -> tuple[float, float]:
    """Median CUDA-event times of fa and fb over ``_abba_rounds`` (a b b
    a, three times, the L2 flushed before each launch)."""
    a, b = _abba_rounds(fa, fb)
    return float(np.median(a)), float(np.median(b))


def check_mixed(rm, diff) -> list:
    """gather_count_multi_mixed against its plain version on the card,
    exactly: and / or / andnot mixed in one batch with K = 1-23 ragged,
    ids repeated inside a query, andnot whose first operand other queries
    name; batches on both sides of the launch's parameters (ids in the
    parameters, ids in a device array); both layouts (a row-major copy of
    16 slices); and B = 1-2 over 5 and 7 slices, which narrow the chunk.
    Each case also against the gather kernel group by group.  Returns the
    cases' names."""
    rng = np.random.default_rng(SEED + 21)
    names = []

    def batch(b, kmax, n_rows):
        ops = [kernels.MULTI_OPS[i] for i in rng.integers(0, 3, size=b)]
        ks = rng.integers(1, kmax + 1, size=b)
        ids = rng.integers(0, n_rows, size=int(ks.sum())).astype(np.int32)
        off = np.concatenate([[0], np.cumsum(ks)]).astype(np.int32)
        for q in range(1, b, 5):  # a repeat inside a query
            if ks[q] > 1:
                ids[off[q] + 1] = ids[off[q]]
        for q in range(0, b, 4):  # andnot's first operand named by the next query
            if ops[q] == "andnot" and q + 1 < b:
                ids[off[q + 1]] = ids[off[q]]
        return ops, off, ids

    row = rm[:16].transpose(0, 1).contiguous()
    for b, kmax in ((48, 23), (400, 23), (32, 16)):
        ops, off, ids = batch(b, kmax, N_ROWS)
        n_ints = kernels.multi_mixed_ints(ops, off, ids).size
        where = "params" if n_ints <= kernels.MIXED_PARAM_INTS else "array"
        got = kernels.gather_count_multi_mixed(rm, ops, off, ids)
        diff("gather_count_multi_mixed", got, kernels.gather_count_multi_mixed_plain(rm, ops, off, ids))
        # (a fold of one operand is that operand under any op)
        one = torch.cat([kernels.gather_count_multi(op if off[q + 1] - off[q] > 1 else "or", rm,
                                                    ids[off[q]:off[q + 1]][None])
                         for q, op in enumerate(ops)])
        diff("gather_count_multi_mixed", got, one)
        diff("gather_count_multi_mixed", kernels.gather_count_multi_mixed(row, ops, off, ids, True),
             kernels.gather_count_multi_mixed_plain(rm[:16], ops, off, ids))
        names.append(f"B={b} K=1-{kmax} ({n_ints} ints, {where}), slice- and row-major")
    for s in (5, 7):
        for b in (1, 2):
            ops, off, ids = batch(b, 23, N_ROWS)
            m = rm[:s]
            diff("gather_count_multi_mixed", kernels.gather_count_multi_mixed(m, ops, off, ids),
                 kernels.gather_count_multi_mixed_plain(m, ops, off, ids))
            names.append(f"S={s} B={b}: NV={_fold_vectors(b, s, torch.cuda.get_device_properties(0).multi_processor_count)}")
    torch.cuda.synchronize()
    return names


# The star-team cell (benchport: configuration startrace-gh, traffic
# team-stars): 32 Counts a request, Union of 8-16 and Intersect of 3-4 of
# 512 users drawn Zipf(1.0), over the pool its 32 GiB budget gives, 653
# rows of 401 slices, slice-major.
STAR_SLICES = 401
STAR_POOL_ROWS = 653
STAR_USERS = 512
STAR_CALLS = 32
STAR_REQUESTS = 4


def star_team_groups(rng) -> list:
    """One star-team request's N-ary groups as the executor hands them to
    the mixed dispatch: [(op, int32[B_g, K])] in (op, K) order; each call's
    users drawn as the traffic draws them (the K largest of Zipf log
    weights plus Gumbel noise), users at pool slots 0-511."""
    log_p = -np.log(np.arange(1, STAR_USERS + 1, dtype=np.float64))
    rank_row = rng.permutation(STAR_USERS)
    groups: dict = {}
    for _ in range(STAR_CALLS):
        union = rng.random() < 0.5
        k = int(rng.integers(8, 17) if union else rng.integers(3, 5))
        order = np.argsort(-(log_p + rng.gumbel(size=STAR_USERS)))[:k]
        groups.setdefault(("or" if union else "and", k), []).append(rank_row[order])
    return [(op, np.array(rows, dtype=np.int32)) for (op, _k), rows in sorted(groups.items())]


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of fn() (which ends with the counts on the
    host), the L2 flushed before each."""
    fn()
    out = []
    for _ in range(reps):
        _flush_l2()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def time_mixed(diff) -> dict:
    """The mixed kernel's "kernels" line entry at star-team's shape: a few
    requests drawn as the traffic draws them over a [401, 653, W] pool,
    each held exactly against the plain version and the gather kernel's
    per-group launches; the kernel through its entry point (``ms``, L2
    flushed) beside its bound (the batch's distinct rows read once), the
    plain version, the per-group gather_count_multi launches it replaces,
    timed in turns with it and summed (``groups_ms``), and on the host's
    clock both ways with each launch's fetch, as the executor ran them
    (``wall_ms``, ``groups_wall_ms``), and their host work alone
    (``host_ms``, ``groups_host_ms``)."""
    pool = _rand_words(_gen(SEED + 22), (STAR_SLICES, STAR_POOL_ROWS, W))
    rng = np.random.default_rng(SEED + 23)
    reqs = []
    for _ in range(STAR_REQUESTS):
        groups = star_team_groups(rng)
        ops, off, ids = kernels.mixed_groups(groups)

        def mixed(_a=(ops, off, ids)):
            return kernels.gather_count_multi_mixed(pool, *_a)

        def per_group(_g=groups):
            return [kernels.gather_count_multi(op, pool, idx) for op, idx in _g]

        got = mixed()
        diff("gather_count_multi_mixed", got, kernels.gather_count_multi_mixed_plain(pool, ops, off, ids))
        diff("gather_count_multi_mixed", got, torch.cat(per_group()))
        u = len(np.unique(ids))
        refs = sum(len(set(ids[off[q]:off[q + 1]].tolist())) for q in range(len(ops)))
        nb, by = bound(STAR_SLICES * u * W * 4 + kernels.multi_mixed_ints(ops, off, ids).nbytes
                       + len(ops) * 4, STAR_SLICES * W * (refs + len(ops)))
        groups_ms, ms = abba_medians(per_group, mixed)
        reqs.append(dict(
            ms=ms, bound_ms=nb, bound_by=by, groups_ms=groups_ms,
            plain_ms=cuda_ms(lambda: kernels.gather_count_multi_mixed_plain(pool, ops, off, ids),
                             reps=1, warm=1),
            wall_ms=wall_ms(lambda: mixed().cpu()),
            groups_wall_ms=wall_ms(lambda: [c.cpu() for c in per_group()]),
            host_ms=host_ms(mixed, n=20), groups_host_ms=host_ms(per_group, n=20),
            groups=len(groups), calls=len(ops), distinct=u, named=int(ids.size)))
    del pool
    torch.cuda.empty_cache()
    out = {k: float(np.median([r[k] for r in reqs])) for k in reqs[0] if k != "bound_by"}
    out.update(bound_by=reqs[0]["bound_by"], requests=reqs,
               shape=f"star-team: pool [{STAR_SLICES}, {STAR_POOL_ROWS}, {W}], {STAR_CALLS} Counts "
                     f"(Union 8-16, Intersect 3-4, Zipf users), medians of {STAR_REQUESTS} requests")
    return out


def check_tree_edges(rm, diff) -> list:
    """gather_count_tree against its plain version on the card, exactly,
    for each K: every node a PASS (only the leftmost leaf live); a PASS
    root over random subtrees (the right half dead); opcodes 0-5 with
    every dead leaf moved to row R - 1 (the counts must not move); one
    tree; the smallest batch past the launch's parameters (ids in a
    device array); and a ragged W of 1,028 words over 3 slices.  Returns
    the case names."""
    from pilosa_tpu_torch.ops import bitwise

    rng = np.random.default_rng(TREE_PATHS_SEED + 1)
    r = N_ROWS
    ragged = _rand_words(_gen(TREE_PATHS_SEED), (3, 40, 1028))
    names = []
    for k in kernels.TREE_LEAVES:
        past = kernels.TREE_PARAM_INTS // (k + 2) + 1

        def trees(b, rows=r):
            return (rng.integers(0, rows, size=(b, k)).astype(np.int32),
                    rng.integers(0, 6, size=(b, k - 1)).astype(np.int32))

        lv, oc = trees(FOLD_BATCH)
        every = np.full_like(oc, bitwise.TREE_PASS)
        root = oc.copy()
        root[:, -1] = bitwise.TREE_PASS
        moved = lv.copy()
        moved[~kernels.tree_live_leaves(oc)] = r - 1
        cases = [("all PASS", rm, lv, every), ("PASS root", rm, lv, root),
                 ("opcodes 0-5", rm, lv, oc), ("dead leaves on R-1", rm, moved, oc),
                 ("B=1", rm, *trees(1)), (f"B={past} (ids in an array)", rm, *trees(past)),
                 ("W=1028 over 3 slices", ragged, *trees(5, 40))]
        for name, m, a, o in cases:
            diff("gather_count_tree", kernels.gather_count_tree(m, a, o),
                 _chunked(lambda x, y, _m=m: kernels.gather_count_tree_plain(_m, x, y), a, o))
            names.append(f"K={k} {name}")
        diff("gather_count_tree", kernels.gather_count_tree(rm, moved, oc),
             kernels.gather_count_tree(rm, lv, oc))
    torch.cuda.synchronize()
    return names


# The staged kernels' exact checks use a generator of their own, so the
# shapes every earlier check and timing draws stay as they were.
STAGED_SEED = SEED + 7
# The resident gate's edge at W = 32,768: the most rows resident_strategy
# admits (452 rows x 512 + 4 x 230 pairs <= 232,448 bytes), over 8 slices.
EDGE_ROWS, EDGE_PAIRS, EDGE_SLICES = 452, 230, 8
# Shapes timed besides the main one, and the tree gate's grid: B x K, and
# batches of more than one group of 64 trees (B, K, rows drawn from).
RESIDENT_ROWS_TIMED = (64, 400)
RESIDENT_BATCHES_TIMED = (512, 1024, 4096)
TREE_GATE_BATCHES = (16, 32, 64)
TREE_GATE_KS = (4, 8, 16)
TREE_GATE_WIDE = ((128, 16, 256), (256, 16, 256), (128, 16, 96), (256, 16, 96),
                  (128, 8, 128), (256, 8, 256), (256, 4, 64))
# Trees as the executor pads them (PASS nodes over the tree's leftmost
# leaf): one of _tree_call's shapes — 0, the 3-operand Xor (3 of 4 leaves
# live); 2, depth 3 (6 of 8); 3, depth 4 (8 of 16) — B trees over rows
# drawn from the first ``rows``, as (shape, B, rows).
TREE_GATE_PADDED = tuple((shape, b, rows) for shape in (0, 2, 3) for b in (64, 128)
                         for rows in (256, 128, 64, 32))


def check_staged_kernels(rm, diff) -> None:
    """resident_count2 and resident_count_tree against their plain
    versions on the card, exactly, for every op and opcode: pairs naming
    every row (64-word tiles), duplicate pairs and self-pairs (a, a), pools whose
    rows are mostly unreferenced, batches that are not a multiple of the
    warp count or span several pair groups, and R at the resident gate's
    edge (one stage); trees of K = 2-16 leaves with opcodes 0-5 (pass
    nodes), duplicate leaves, unreferenced rows, padded trees (a TREE_PASS
    root), ragged and multi-group batches, and a batch whose distinct
    leaves fit only one stage."""
    from pilosa_tpu_torch.ops import bitwise, dispatch

    rng = np.random.default_rng(STAGED_SEED)
    r = N_ROWS
    every = rng.integers(0, r, size=(PAIR_BATCH, 2))
    every[:, 0] = np.resize(rng.permutation(r), PAIR_BATCH)
    dup = rng.integers(0, r, size=(20, 2))[rng.integers(0, 20, size=240)]
    dup[::3, 1] = dup[::3, 0]
    pair_cases = {
        "every row": every, "duplicates + self-pairs": dup,
        "unreferenced rows": rng.integers(200, r, size=(PAIR_BATCH, 2)),
        "B=250": rng.integers(0, r, size=(250, 2)), "B=600": rng.integers(0, r, size=(600, 2)),
    }
    for pairs in pair_cases.values():
        pairs = pairs.astype(np.int32)
        for op in PAIR_OPS:
            diff("resident_count2", kernels.resident_count2(op, rm, pairs),
                 kernels.resident_count2_plain(op, rm, pairs))
    edge = _rand_words(_gen(STAGED_SEED), (EDGE_SLICES, EDGE_ROWS, W))
    if not dispatch.resident_strategy(EDGE_ROWS, W, EDGE_PAIRS) or dispatch.resident_strategy(
            EDGE_ROWS + 1, W, EDGE_PAIRS):
        raise AssertionError("the resident gate's edge moved")
    # Every row named (U = R: one stage), and a self-pair.
    pairs = rng.integers(0, EDGE_ROWS, size=(EDGE_PAIRS, 2)).astype(np.int32)
    pairs.reshape(-1)[:EDGE_ROWS] = rng.permutation(EDGE_ROWS)
    pairs[-1] = [EDGE_ROWS - 1, EDGE_ROWS - 1]
    tiling = kernels.resident_tiling(len(np.unique(pairs)), W, EDGE_PAIRS, EDGE_SLICES)
    for op in PAIR_OPS:
        diff("resident_count2", kernels.resident_count2(op, edge, pairs),
             kernels.resident_count2_plain(op, edge, pairs))

    def trees(b, k, lo=0, hi=r, rows=None):
        if rows is None:
            leaves = rng.integers(lo, hi, size=(b, k))
        else:
            leaves = rows[rng.integers(0, len(rows), size=(b, k))]
        return leaves.astype(np.int32), rng.integers(0, 6, size=(b, k - 1)).astype(np.int32)

    tree_cases = [(f"K={k}", rm, *trees(FOLD_BATCH, k)) for k in kernels.TREE_LEAVES]
    lv, oc = trees(FOLD_BATCH, 16, rows=np.array([3, 7, 7, 200]))
    tree_cases.append(("duplicates", rm, lv, oc))
    tree_cases.append(("unreferenced rows", rm, *trees(FOLD_BATCH, 8, lo=192)))
    lv, oc = trees(FOLD_BATCH, 8)
    lv[:, 4:] = lv[:, :4]
    oc[:, -1] = bitwise.TREE_PASS
    tree_cases.append(("padded", rm, lv, oc))
    tree_cases.append(("B=13", rm, *trees(13, 16)))
    tree_cases.append(("B=300", rm, *trees(300, 4)))
    tree_cases.append(("one stage", edge, *trees(1024, 16, hi=EDGE_ROWS)))
    for _, m, lv, oc in tree_cases:
        want = _chunked(lambda x, y, _m=m: kernels.resident_count_tree_plain(_m, x, y), lv, oc)
        diff("resident_count_tree", kernels.resident_count_tree(m, lv, oc), want)
    one = kernels.tree_tiling(len(np.unique(tree_cases[-1][2])), W, 16, EDGE_SLICES)
    torch.cuda.synchronize()
    del edge
    torch.cuda.empty_cache()
    print(json.dumps({"staged_checks": {
        "resident_count2": sorted(pair_cases) + [f"gate edge R={EDGE_ROWS} B={EDGE_PAIRS}: tiling {tiling}"],
        "resident_count_tree": [c[0] for c in tree_cases[:-1]] + [f"one stage: tiling {one}"]}}),
        flush=True)


def time_staged_kernels(rm, pairs_r) -> tuple[dict, list]:
    """Times of the two staged kernels (CUDA events, L2 flushed): their
    "kernels" line entries, and the tree gate's grid — both tree kernels
    on the same batches — with each kernel's gathered bytes (B x S x K x
    W x 4, a row named twice counted twice) over its time and the batch's
    reuse (B x K over its distinct leaves)."""
    from pilosa_tpu_torch.ops import dispatch

    rng = np.random.default_rng(STAGED_SEED + 1)
    row_b = W * 4
    res = {}

    def pair_entry(m, pairs):
        s, r = m.shape[:2]
        u = len(np.unique(pairs))
        chunk, stages = kernels.resident_tiling(u, W, len(pairs), s)
        nb, by = bound(s * u * row_b + pairs.nbytes + len(pairs) * 4,
                       s * len(pairs) * W * OPS_PER_WORD)
        return dict(
            shape=f"rm [{s}, {r}, {W}], {len(pairs)} pairs ({u} distinct rows), and",
            ms=cuda_ms(lambda: kernels.resident_count2("and", m, pairs)),
            plain_ms=cuda_ms(lambda: _chunked_pairs("and", m, pairs), reps=3),
            bound_ms=nb, bound_by=by, chunk_words=chunk, stages=stages,
            smem_bytes=kernels.staged_smem_bytes(u, chunk, stages, kernels.pair_span_ints(len(pairs))))

    main = pair_entry(rm, pairs_r)
    shapes = []
    for r in RESIDENT_ROWS_TIMED:
        m = rm[:, :r].contiguous() if r <= N_ROWS else _rand_words(_gen(STAGED_SEED + r), (N_SLICES, r, W))
        shapes.append(pair_entry(m, rng.integers(0, r, size=(PAIR_BATCH, 2)).astype(np.int32)))
        del m
        torch.cuda.empty_cache()
    for b in RESIDENT_BATCHES_TIMED:
        shapes.append(pair_entry(rm, rng.integers(0, N_ROWS, size=(b, 2)).astype(np.int32)))
    res["resident_count2"] = dict(main, shapes=shapes)

    gate, tree_entries = [], {}

    def gate_entry(lv, oc, padded=False):
        b, k = lv.shape
        u = len(np.unique(lv))
        live = int(kernels.tree_live_leaves(oc).sum())
        gathered = b * N_SLICES * k * row_b
        g_ms = cuda_ms(lambda: kernels.gather_count_tree(rm, lv, oc))
        s_ms = cuda_ms(lambda: kernels.resident_count_tree(rm, lv, oc))
        return {
            "B": b, "K": k, "distinct": u, "reuse": b * k / u, "padded": padded, "live_leaves": live,
            "live_reuse": live / u, "gather_ms": g_ms,
            "staged_ms": s_ms, "gather_gathered_tb_s": gathered / g_ms / 1e9,
            "staged_gathered_tb_s": gathered / s_ms / 1e9,
            "unique_bound_ms": N_SLICES * u * row_b / PEAK_BYTES_S * 1e3,
            "staged_tiling": list(kernels.tree_tiling(u, W, k, N_SLICES)),
            "dispatch": "staged" if dispatch.tree_strategy(u, W, oc, N_SLICES) else "gather"}

    for b in TREE_GATE_BATCHES:
        for k in TREE_GATE_KS:
            lv = rng.integers(0, N_ROWS, size=(b, k)).astype(np.int32)
            oc = rng.integers(0, 4, size=(b, k - 1)).astype(np.int32)
            gate.append(gate_entry(lv, oc))
            if b == FOLD_BATCH:
                tree_entries[k] = (lv, oc)
    for b, k, rows in TREE_GATE_WIDE:
        lv = rng.integers(0, rows, size=(b, k)).astype(np.int32)
        gate.append(gate_entry(lv, rng.integers(0, 4, size=(b, k - 1)).astype(np.int32)))
    for shape, b, rows in TREE_GATE_PADDED:
        (lv, oc), = tree_encodings([_tree_call(rng, rows, shape) for _ in range(b)])
        gate.append(gate_entry(lv, oc, padded=True))

    entries = []
    for k in (16, 8, 4):
        lv, oc = tree_entries[k]
        u = len(np.unique(lv))
        chunk, stages = kernels.tree_tiling(u, W, k, N_SLICES)
        nb, by = bound(N_SLICES * u * row_b + lv.nbytes + oc.nbytes + len(lv) * 4,
                       len(lv) * N_SLICES * W * (k + 1))
        entries.append(dict(
            chunk_words=chunk, stages=stages, smem_bytes=kernels.staged_smem_bytes(
                u, chunk, stages, kernels.tree_group_ints(k)),
            shape=f"pool [{N_SLICES}, {N_ROWS}, {W}], B={len(lv)}, K={k} ({u} distinct rows)",
            ms=cuda_ms(lambda: kernels.resident_count_tree(rm, lv, oc)),
            plain_ms=cuda_ms(lambda: _chunked(
                lambda x, y: kernels.resident_count_tree_plain(rm, x, y), lv, oc), reps=2, warm=1),
            bound_ms=nb, bound_by=by, gathered_bound_ms=len(lv) * N_SLICES * k * row_b / PEAK_BYTES_S * 1e3))
    res["resident_count_tree"] = dict(entries[0], shapes=entries[1:])
    return res, gate


# The multi gate's grid (both kernels on the same batches, both layouts,
# over one buffer of 32 x 1,024 rows: [32, 1024, W] or [1024, 32, W]):
# B x K x references per distinct row (each row of the batch named
# exactly B x K / U times, give or take one); Range-like folds, K =
# 23 with a ragged number of distinct operands a query (MULTI_GATE_DS on
# average) padded by repeating the first, B x operands x references; and
# Range batches with structure, as range-wide's: MULTI_GATE_BITMAPS
# bitmap rows, each over spans of about d of MULTI_GATE_VIEWS day views
# (MULTI_GATE_SPAN_DAYS), B x d x bitmap rows.
MULTI_GATE_BATCHES = (16, 64, 128, 256, 512)
MULTI_GATE_KS = (3, 4, 8, 16, 23)
MULTI_GATE_REUSE = (1, 2, 3, 4, 8)
MULTI_GATE_SLICES, MULTI_GATE_ROWS = 32, 1024
MULTI_GATE_PADDED_BATCHES = (64, 128)
MULTI_GATE_DS = (8, 12, 16, 20)
MULTI_GATE_PADDED_REUSE = (2, 3, 4, 8)
MULTI_GATE_SPAN_BATCHES = (32, 64, 128)
MULTI_GATE_SPAN_DAYS = (4, 8, 12, 16, 20)
MULTI_GATE_BITMAPS = (4, 8, 16)
MULTI_GATE_VIEWS = 31
# Rows that fit only one stage beside the plan of 512 folds of 16
# operands (4 blocks of groups): the staged kernel's one-stage edge at W =
# 32,768.
ONE_STAGE_ROWS = 1200
# Producer warps timed at the wrapper's tiling ("multi_tilings").
MULTI_PRODUCERS = (1, 2, 3, 4)


def check_staged_multi(rm, diff) -> list:
    """resident_count_multi against its plain version (the compaction
    remap, then the plain fold) on the card, exactly, both layouts, every
    op: K = 1, 2, 3, 5, 16, 23; lists padded to eight with an operand the
    fold ignores a second time (andnot after the first); duplicate ids
    within a query; unreferenced rows; a ragged batch and one of three
    groups; and 512 folds over ONE_STAGE_ROWS rows, which fit only one
    stage.  Each also equals the gather kernel of its layout.  Returns the
    case names with their tilings."""
    rng = np.random.default_rng(STAGED_SEED + 2)
    layouts = {"slice": rm, "row": rm[:16].transpose(0, 1).contiguous()}
    r = N_ROWS
    cases = [(f"K={k}", rng.integers(0, r, size=(FOLD_BATCH, k))) for k in (1, 2, 3, 5, 16, 23)]
    cases.append(("duplicates", np.array([3, 7, 7, 200])[rng.integers(0, 4, size=(FOLD_BATCH, 16))]))
    cases.append(("unreferenced rows", rng.integers(192, r, size=(FOLD_BATCH, 8))))
    cases.append(("B=13", rng.integers(0, r, size=(13, 16))))
    cases.append(("B=300", rng.integers(0, r, size=(300, 4))))
    short = rng.integers(0, r, size=(FOLD_BATCH, 5))
    names = []
    for layout, m in layouts.items():
        row_major = layout == "row"
        gather = kernels.gather_count_multi_rowmajor if row_major else kernels.gather_count_multi
        for name, idx in cases + [("padded", None)]:
            for op in kernels.MULTI_OPS:
                if idx is None:  # K = 5 padded to 8
                    lo = 1 if op == "andnot" else 0
                    ix = np.concatenate(
                        [short, short[np.arange(FOLD_BATCH)[:, None], rng.integers(lo, 5, size=(FOLD_BATCH, 3))]], 1)
                else:
                    ix = idx
                ix = ix.astype(np.int32)
                got = kernels.resident_count_multi(op, m, ix, row_major)
                diff("resident_count_multi", got, _chunked(
                    lambda x, _op=op: kernels.resident_count_multi_plain(_op, m, x, row_major), ix))
                if ix.shape[1] > 1 or op != "andnot":  # the gather kernel folds one row as is too
                    diff("resident_count_multi", got, gather(op, m, ix))
                if idx is None:
                    diff("resident_count_multi", got, kernels.resident_count_multi(op, m, short, row_major))
            if layout == "slice":
                ix = short if idx is None else idx
                tiling = multi_plan_of(dict(layout="slice", matrix=(N_SLICES, r), op="or", idx=ix))[1]
                names.append(f"{name}: tiling {tiling}")
    del layouts
    # One stage: 512 folds of 16 over ONE_STAGE_ROWS rows of a 4-slice matrix.
    big = _rand_words(_gen(STAGED_SEED + 3), (4, ONE_STAGE_ROWS, W))
    ix = np.resize(rng.permutation(ONE_STAGE_ROWS), (512, 16)).astype(np.int32)
    for op in kernels.MULTI_OPS:
        tiling = multi_plan_of(dict(layout="slice", matrix=(4, ONE_STAGE_ROWS), op=op, idx=ix))[1]
        if tiling[1] != 1:
            raise AssertionError(f"{ONE_STAGE_ROWS} rows {op}: tiling {tiling}, want one stage")
    for layout, m in (("slice", big), ("row", big.transpose(0, 1).contiguous())):
        for op in kernels.MULTI_OPS:
            diff("resident_count_multi", kernels.resident_count_multi(op, m, ix, layout == "row"),
                 _chunked(lambda x, _op=op: kernels.resident_count_multi_plain(_op, m, x, layout == "row"), ix))
    names.append(f"one stage, {ONE_STAGE_ROWS} rows B=512 K=16: tiling {tiling}")
    torch.cuda.synchronize()
    del big
    torch.cuda.empty_cache()
    return names


def _gate_batch(rng, b, k, reuse, n_rows):
    """B folds of K operands naming U = B x K / reuse distinct rows of
    ``n_rows``, each about ``reuse`` times; None where U would exceed the
    rows."""
    u = max(1, round(b * k / reuse))
    if u > n_rows:
        return None
    rows = rng.choice(n_rows, size=u, replace=False)
    return rng.permutation(np.resize(rows, b * k)).reshape(b, k).astype(np.int32)


def _gate_batch_padded(rng, b, d, reuse, n_rows, k=23):
    """B Range-like folds: query q names d_q distinct rows (d_q drawn from
    d - 6 .. d + 6 within 1 .. K, d on average) consecutive in a walk over
    U = sum(d_q) / reuse rows of ``n_rows``, padded to K by repeating its
    first; None where U would exceed the rows."""
    dq = rng.integers(max(1, d - 6), min(k, d + 6) + 1, size=b)
    u = max(int(dq.max()), round(int(dq.sum()) / reuse))
    if u > n_rows:
        return None
    walk = np.resize(rng.choice(n_rows, size=u, replace=False), int(dq.sum()))
    idx = np.empty((b, k), dtype=np.int32)
    at = 0
    for q, n in enumerate(dq):
        idx[q, :n] = walk[at:at + n]
        idx[q, n:] = walk[at]
        at += n
    return idx


def _gate_batch_spans(rng, b, d, bitmaps, n_rows, k=23, views=MULTI_GATE_VIEWS):
    """B Range Counts with range-wide's structure: query q counts bitmap
    row q mod ``bitmaps`` over a span of d - 3 .. d + 3 consecutive days
    of ``views`` day views (the rows (day, bitmap row), drawn from
    ``n_rows``), padded to K by repeating its first; queries shuffled."""
    rows = rng.choice(n_rows, size=views * bitmaps, replace=False).reshape(views, bitmaps)
    idx = np.empty((b, k), dtype=np.int32)
    for q in range(b):
        n = int(rng.integers(max(1, d - 3), min(k, views, d + 3) + 1))
        day = int(rng.integers(0, views - n + 1))
        idx[q, :n] = rows[day:day + n, q % bitmaps]
        idx[q, n:] = idx[q, 0]
    return idx[rng.permutation(b)]


def time_multi(words, diff) -> tuple[dict, dict]:
    """The staged multi kernel's "kernels" line entry (range-wide's batch,
    the one its path launches, with the timed Range, the pool's K=16,
    range-1, range-2 and range-wide at the mesh's two shard shapes, [8, R,
    W] and [32, R, W], beside it), and the multi lines: every batch the
    paths launch timed through both kernels ("paths"), the wrapper's
    tiling against the others at the five shapes ("tilings"), and the
    gate's grid ("gate").  Every path batch and every entry is held
    against the plain versions of both kernels, exactly; in the grid
    every staged count equals the gather kernel's on the same batch."""
    def gather(batch, m):
        fn = kernels.gather_count_multi if batch["layout"] == "slice" else kernels.gather_count_multi_rowmajor
        return lambda: fn(batch["op"], m, batch["idx"])

    def staged(batch, m, tiling=None, producers=kernels.MULTI_PRODUCER_WARPS):
        row_major = batch["layout"] == "row"
        if tiling is None:
            return lambda: kernels.resident_count_multi(batch["op"], m, batch["idx"], row_major)
        plan = multi_plan_of(batch)[0]

        def run():
            out = torch.zeros(batch["idx"].shape[0], dtype=torch.int32, device=m.device)
            return kernels._launch_resident_multi(plan, m, *tiling, row_major, out, producers)
        return run

    def plains(batch, m):
        """The plain versions of both kernels on the batch: (gather's,
        the staged kernel's) launches, each over PLAIN_CHUNK queries."""
        op, idx, row_major = batch["op"], batch["idx"], batch["layout"] == "row"
        g = (kernels.gather_count_multi_rowmajor_plain if row_major
             else kernels.gather_count_multi_plain)
        return (lambda: _chunked(lambda x: g(op, m, x), idx),
                lambda: _chunked(lambda x: kernels.resident_count_multi_plain(op, m, x, row_major), idx))

    def both(batch, reps=10, check=False):
        m = words.matrix(batch)
        rec = _multi_summary(batch)
        plan, tiling = multi_plan_of(batch)
        g = gather(batch, m)
        if check:
            g_plain, s_plain = plains(batch, m)
            diff("gather_count_multi" if batch["layout"] == "slice" else "gather_count_multi_rowmajor",
                 g(), g_plain())
        rec["gather_ms"] = cuda_ms(g, reps=reps)
        rec["tiling"] = list(tiling)
        rec["staged_ms"] = None
        if tiling[0]:
            st = staged(batch, m)
            if check:
                diff("resident_count_multi", st(), s_plain())
            elif not torch.equal(st(), g()):
                raise AssertionError(f"multi {batch['request']}: staged and gather counts differ")
            rec["staged_ms"] = cuda_ms(st, reps=reps)
            rec.update(plan_reads(plan))
        rec["dispatch"] = multi_choice(batch)
        return rec

    path_batches = multi_path_batches()
    paths = [both(b, check=True) for b in path_batches]
    timed = {b["request"]: b for b in multi_timed_batches()}
    range_paths = {b["request"]: b for b in path_batches if "range" in b["request"]}
    wide = range_paths["http range-wide"]
    row12 = [wide, timed["timed Range"], timed["timed pool K=16"], range_paths["http range-1"],
             range_paths["http range-2"]]
    shards = [dict(wide, request=f"http range-wide, mesh shard S={s}", matrix=(s, wide["matrix"][1]))
              for s in sorted({MESH_SLICES // MESH_RANKS, N_SLICES // MESH_RANKS})]

    tilings = []
    for batch in row12:
        m = words.matrix(batch)
        plan, tiling = multi_plan_of(batch)
        want = staged(batch, m)()
        rec = dict(_multi_summary(batch), wrapper=list(tiling), ms={}, producers_ms={})
        for t in kernels.MULTI_TILINGS:
            if W % t[0] == 0 and kernels.multi_smem_bytes(plan.u, *t, plan.block_ints) <= kernels.SMEM_BYTES:
                rec["ms"][f"{t[0]}w x{t[1]}"] = cuda_ms(staged(batch, m, t))
        for p in MULTI_PRODUCERS:
            run = staged(batch, m, tiling, p)
            if not torch.equal(run(), want):
                raise AssertionError(f"multi {batch['request']}: {p} producer warps differ")
            rec["producers_ms"][p] = cuda_ms(run)
        tilings.append(rec)

    entries = []
    for batch in row12 + shards:
        m = words.matrix(batch)
        idx, op = batch["idx"], batch["op"]
        nb, by = multi_bound(batch)
        plan, (chunk, stages) = multi_plan_of(batch)
        s_plain = plains(batch, m)[1]
        diff("resident_count_multi", staged(batch, m)(), s_plain())
        entries.append(dict(
            shape=(f"{batch['request']}: [{m.shape[0]}, {m.shape[1]}, {W}], B={idx.shape[0]}, "
                   f"K={idx.shape[1]} ({len(np.unique(idx))} distinct rows), {op}"),
            ms=cuda_ms(staged(batch, m)), plain_ms=cuda_ms(s_plain, reps=2, warm=1),
            bound_ms=nb, bound_by=by, chunk_words=chunk, stages=stages,
            smem_bytes=kernels.multi_smem_bytes(plan.u, chunk, stages, plan.block_ints),
            host_ms=host_ms(staged(batch, m), n=50),
            gathered_bound_ms=idx.size * m.shape[0] * W * 4 / PEAK_BYTES_S * 1e3, **plan_reads(plan)))

    rng = np.random.default_rng(STAGED_SEED + 4)
    gate = []
    for layout in ("slice", "row"):
        dims = (MULTI_GATE_SLICES, MULTI_GATE_ROWS) if layout == "slice" else (
            MULTI_GATE_ROWS, MULTI_GATE_SLICES)
        for b in MULTI_GATE_BATCHES:
            for k in MULTI_GATE_KS:
                for reuse in MULTI_GATE_REUSE:
                    idx = _gate_batch(rng, b, k, reuse, MULTI_GATE_ROWS)
                    if idx is None:
                        continue
                    batch = dict(request="gate", layout=layout, matrix=dims,
                                 op=kernels.MULTI_OPS[len(gate) % 3], idx=idx)
                    gate.append(both(batch, reps=5))
        for b in MULTI_GATE_PADDED_BATCHES:
            for d in MULTI_GATE_DS:
                for reuse in MULTI_GATE_PADDED_REUSE:
                    idx = _gate_batch_padded(rng, b, d, reuse, MULTI_GATE_ROWS)
                    if idx is None:
                        continue
                    batch = dict(request="gate padded", layout=layout, matrix=dims, op="or", idx=idx)
                    gate.append(both(batch, reps=5))
        for b in MULTI_GATE_SPAN_BATCHES:
            for d in MULTI_GATE_SPAN_DAYS:
                for bitmaps in MULTI_GATE_BITMAPS:
                    idx = _gate_batch_spans(rng, b, d, bitmaps, MULTI_GATE_ROWS)
                    batch = dict(request=f"gate spans {bitmaps} bitmaps", layout=layout, matrix=dims,
                                 op="or", idx=idx)
                    gate.append(both(batch, reps=5))
    res = {"resident_count_multi": dict(entries[0], shapes=entries[1:])}
    return res, {"paths": paths, "tilings": tilings, "gate": gate}


def _chunked_pairs(op, m, pairs):
    """resident_count2's plain version over PAIR_BATCH pairs at a time (it
    materializes both gathered rows of every pair)."""
    return torch.cat([kernels.resident_count2_plain(op, m, pairs[i:i + PAIR_BATCH])
                      for i in range(0, len(pairs), PAIR_BATCH)])


def _abba(fa, fb) -> tuple[list, list]:
    """cuda_ms of two launches in the order a, b, b, a."""
    a1, b1, b2, a2 = cuda_ms(fa), cuda_ms(fb), cuda_ms(fb), cuda_ms(fa)
    return [a1, a2], [b1, b2]


def _load_other(other_root: str):
    """The kernels and dispatch modules of the checkout at ``other_root``,
    its dispatch bound to its own kernels."""
    import importlib.util

    import pilosa_tpu_torch.ops as ops_pkg

    key = "pilosa_tpu_torch.ops.kernels"
    saved = sys.modules[key], ops_pkg.kernels
    mods = []
    try:
        for name in ("kernels", "dispatch"):
            path = os.path.join(other_root, "pilosa_tpu_torch", "ops", f"{name}.py")
            spec = importlib.util.spec_from_file_location(f"other_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods.append(mod)
            sys.modules[key] = ops_pkg.kernels = mods[0]
    finally:
        sys.modules[key], ops_pkg.kernels = saved
    # The loaded entry points live in a registry keyed by name, which both
    # modules would share: give the other checkout a store of its own.
    from pilosa_tpu_torch.analysis import lockcheck

    mods[0]._fns = lockcheck.named_global(f"ops.kernels.fns@{os.path.abspath(other_root)}",
                                          max_entries=len(mods[0].KERNELS) + 1)
    return mods


# ABBA rounds a multi-fold batch takes in --resident-against: the
# smallest batches (0.2 ms) spread 10-20% between two readings.
MULTI_ABBA_ROUNDS = 3


def _abba_rounds(fa, fb) -> tuple[list, list]:
    """MULTI_ABBA_ROUNDS rounds of ``_abba``: the readings of a, of b."""
    a_ms, b_ms = [], []
    for _ in range(MULTI_ABBA_ROUNDS):
        a, b = _abba(fa, fb)
        a_ms += a
        b_ms += b
    return a_ms, b_ms


def resident_against(other_root: str) -> int:
    """``pair_gram`` (``gram_against``), ``build_planes``
    (``build_against``), ``resident_count2``, ``gather_count2`` and the
    two multi-fold entry points (``dispatch.gather_count_multi``,
    ``dispatch.gather_count_multi_rowmajor``) of this checkout against
    those of ``other_root`` on the same inputs: exact agreement, then ABBA
    times (other, this, this, other) — resident pairs at S=64 R=256 for B
    = 256 to 4,096, gather pairs there for B = 4 to 600
    (MULTI_ABBA_ROUNDS rounds, and each entry point's host work a call),
    folds (MULTI_ABBA_ROUNDS rounds) at
    every batch the paths launch (``multi_path_batches``) and at the
    kernels line's timed shapes (``multi_timed_batches``), each with this checkout's staged
    kernel on the same batch where it has a tiling ("staged_ms", whatever
    the gate picks)."""
    from pilosa_tpu_torch.ops import dispatch

    card = probe()
    kernels.build()
    other, other_dispatch = _load_other(other_root)
    other.build()
    print(json.dumps({"card": card, "other": other_root, "gram_against": gram_against(other)}),
          flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "other": other_root, "build_against": build_against(other)}),
          flush=True)
    rm = _rand_words(_gen(SEED), (N_SLICES, N_ROWS, W))
    rng = np.random.default_rng(SEED)
    rows = []
    for b in (PAIR_BATCH,) + RESIDENT_BATCHES_TIMED:
        pairs = rng.integers(0, N_ROWS, size=(b, 2)).astype(np.int32)
        for op in PAIR_OPS:
            if not torch.equal(kernels.resident_count2(op, rm, pairs), other.resident_count2(op, rm, pairs)):
                raise AssertionError(f"resident_count2 {op} B={b}: the checkouts disagree")
        o_ms, ms = _abba(lambda: other.resident_count2("and", rm, pairs),
                         lambda: kernels.resident_count2("and", rm, pairs))
        rows.append({"S": N_SLICES, "R": N_ROWS, "B": b, "distinct": len(np.unique(pairs)),
                     "other_ms": o_ms, "ms": ms})
    print(json.dumps({"card": card, "other": other_root, "resident_against": rows}), flush=True)
    rows = []
    for b in (4,) + GATHER2_BATCHES:
        pairs = rng.integers(0, N_ROWS, size=(b, 2)).astype(np.int32)
        for op in PAIR_OPS:
            if not torch.equal(kernels.gather_count2(op, rm, pairs), other.gather_count2(op, rm, pairs)):
                raise AssertionError(f"gather_count2 {op} B={b}: the checkouts disagree")
        o_ms, ms = _abba_rounds(lambda: other.gather_count2("and", rm, pairs),
                                lambda: kernels.gather_count2("and", rm, pairs))
        rows.append({"S": N_SLICES, "R": N_ROWS, "B": b, "distinct": len(np.unique(pairs)),
                     "other_ms": o_ms, "ms": ms,
                     "other_host_ms": host_ms(lambda: other.gather_count2("and", rm, pairs)),
                     "host_ms": host_ms(lambda: kernels.gather_count2("and", rm, pairs))})
    print(json.dumps({"card": card, "other": other_root, "gather2_against": rows}), flush=True)
    print(json.dumps({"card": card, "other": other_root,
                      "count_against": count_against(rm, dispatch, other_dispatch)}), flush=True)
    print(json.dumps({"card": card, "other": other_root,
                      "tree_against": tree_against(rm, dispatch, other_dispatch)}), flush=True)
    del rm
    torch.cuda.empty_cache()
    multi_against(other, other_dispatch, card, other_root)
    return 0


def multi_against(other, other_dispatch, card: str, other_root: str) -> None:
    """The multi folds of this checkout against ``other``'s (a
    ``_load_other`` pair): the staged kernels alone (``resident_count_multi``,
    each its own wrapper) at the kernels line's shapes — range-wide, the
    timed Range, the pool's K=16, range-1, range-2 and range-wide at the
    mesh's two shard shapes — exact, then MULTI_ABBA_ROUNDS rounds of ABBA
    and each wrapper's host work a call ("staged_against"); then the two
    entry points with their gates at every batch the paths launch and at
    the timed shapes, each with this checkout's staged kernel on the same
    batch where it has a tiling ("multi_against")."""
    from pilosa_tpu_torch.ops import dispatch

    words = _Words()
    timed = {b["request"]: b for b in multi_timed_batches()}
    paths = {b["request"]: b for b in multi_path_batches()}
    wide = paths["http range-wide"]
    shapes = [wide, timed["timed Range"], timed["timed pool K=16"], paths["http range-1"],
              paths["http range-2"]]
    shapes += [dict(wide, request=f"http range-wide, mesh shard S={s}", matrix=(s, wide["matrix"][1]))
               for s in sorted({MESH_SLICES // MESH_RANKS, N_SLICES // MESH_RANKS})]
    staged = []
    for batch in shapes:
        m = words.matrix(batch)
        row_major = batch["layout"] == "row"

        def mine():
            return kernels.resident_count_multi(batch["op"], m, batch["idx"], row_major)

        def theirs():
            return other.resident_count_multi(batch["op"], m, batch["idx"], row_major)
        if not torch.equal(mine(), theirs()):
            raise AssertionError(f"resident_count_multi {batch['request']}: the checkouts disagree")
        o_ms, ms = _abba_rounds(theirs, mine)
        staged.append(dict(_multi_summary(batch), other_ms=o_ms, ms=ms,
                           other_host_ms=host_ms(theirs, n=50), host_ms=host_ms(mine, n=50),
                           tiling=list(multi_plan_of(batch)[1])))
    print(json.dumps({"card": card, "other": other_root, "staged_against": staged}), flush=True)
    multi = []
    for batch in multi_path_batches() + multi_timed_batches():
        m = words.matrix(batch)
        mine, theirs = _multi_entry(dispatch, batch, m), _multi_entry(other_dispatch, batch, m)
        if not torch.equal(mine(), theirs()):
            raise AssertionError(f"multi-fold {batch['request']}: the checkouts disagree")
        o_ms, ms = _abba_rounds(theirs, mine)
        row_major = batch["layout"] == "row"
        staged_ms = None
        if multi_plan_of(batch)[1][0]:
            def staged_fn():
                return kernels.resident_count_multi(batch["op"], m, batch["idx"], row_major)
            if not torch.equal(staged_fn(), mine()):
                raise AssertionError(f"multi-fold {batch['request']}: staged and entry point disagree")
            staged_ms = cuda_ms(staged_fn)
        multi.append(dict(_multi_summary(batch), other_ms=o_ms, ms=ms, staged_ms=staged_ms,
                          dispatch=multi_choice(batch)))
    print(json.dumps({"card": card, "other": other_root, "multi_against": multi}), flush=True)


def multi_against_only(other_root: str) -> int:
    """``--multi-against DIR``: ``multi_against`` alone (no Gram, build,
    pair, count or tree phase)."""
    card = probe()
    kernels.build()
    other, other_dispatch = _load_other(other_root)
    other.build()
    multi_against(other, other_dispatch, card, other_root)
    return 0


def gram_against(other) -> list:
    """``kernels.pair_gram`` of this checkout against ``other``'s at the
    kernels line's four timed shapes (S=64 R=256, the executor's; 300 of
    a 512-row pool's rows, strided; S=16 R=1,024; the 64-row bucket, S=256
    R=64): exact agreement, then MULTI_ABBA_ROUNDS rounds of ABBA."""
    gen = _gen(GRAM_SEED)
    pool = _rand_words(gen, (N_SLICES, GRAM_POOL_ROWS, W))
    s, r = GRAM_STRIDED
    shapes = [("executor", pool[:, :N_ROWS].contiguous()),
              (f"{r} of {GRAM_POOL_ROWS} rows, strided", pool[:s, :r])]
    s, r = GRAM_TALL
    shapes.append(("tall", _rand_words(gen, (s, r, W))))
    r = GRAM_BUCKETS[0]
    shapes.append(("bucket", _rand_words(gen, (GRAM_POOL_BYTES // (r * W * 4), r, W))))
    rows = []
    for name, m in shapes:
        if not torch.equal(kernels.pair_gram(m), other.pair_gram(m)):
            raise AssertionError(f"pair_gram {name}: the checkouts disagree")
        o_ms, ms = _abba_rounds(lambda: other.pair_gram(m), lambda: kernels.pair_gram(m))
        rows.append({"shape": name, "S": m.shape[0], "R": m.shape[1], "other_ms": o_ms, "ms": ms})
    return rows


def build_against(other) -> list:
    """``kernels.build_planes`` of this checkout against ``other``'s at
    BUILD_TIMED (entry points, output allocation included): exact
    agreement, then MULTI_ABBA_ROUNDS rounds of ABBA."""
    def theirs(keys, g):
        res = other.build_planes(keys, g)
        return res[0] if isinstance(res, tuple) else res

    rows = []
    for n, g in BUILD_TIMED:
        sl, _, _, keys = _keys(*build_timed_pairs(n, g))
        if not torch.equal(_built(keys, len(sl)), theirs(keys, len(sl))):
            raise AssertionError(f"build_planes N={n} G={g}: the checkouts disagree")
        o_ms, ms = _abba_rounds(lambda: theirs(keys, len(sl)),
                                lambda: kernels.build_planes(keys, len(sl)))
        rows.append({"N": n, "G": len(sl), "other_ms": o_ms, "ms": ms})
    return rows


def count_against(rm, mine, theirs) -> list:
    """The two count entry points of this checkout's dispatch (``mine``)
    against another's (``theirs``) on the same inputs: the sequential
    Count's [64, W] stack (``count``), TopN phase 1's [256, W] against a
    shared src (``batch_intersection_count``) and one 16-byte row; exact
    agreement, then ABBA rounds and each one's host work a call."""
    stack = rm[:, 0].contiguous()
    cand, src = rm[0], rm[1, 0]
    tiny = stack[:1, :4].contiguous()
    out = []
    for name, call in (("[64, W] Count", lambda d: d.count(stack)),
                       ("[256, W] & shared src", lambda d: d.batch_intersection_count(cand, src)),
                       ("[1, 4] Count", lambda d: d.count(tiny))):
        if not torch.equal(call(mine), call(theirs)):
            raise AssertionError(f"count_rows {name}: the checkouts disagree")
        o_ms, ms = _abba_rounds(lambda: call(theirs), lambda: call(mine))
        out.append({"shape": name, "other_ms": o_ms, "ms": ms,
                    "other_host_ms": host_ms(lambda: call(theirs)), "host_ms": host_ms(lambda: call(mine))})
    return out


def tree_against(rm, mine, theirs) -> list:
    """The tree entry point (``dispatch.gather_count_tree``, with its gate)
    of this checkout's dispatch (``mine``) against another's (``theirs``)
    on the same inputs over the pool [64, 256, W]: the kernels line's
    shapes (B=64, K = 2-16, opcodes 0-5) drawn anew and every tree bucket
    of the paths (``tree_path_batches``); exact agreement, then ABBA
    rounds, each one's host work a call and the live-row bound."""
    from pilosa_tpu_torch.ops import dispatch

    rng = np.random.default_rng(TREE_PATHS_SEED + 2)
    batches = [{"request": f"timed K={k}", "leaves": rng.integers(0, N_ROWS, size=(FOLD_BATCH, k)).astype(np.int32),
                "opc": rng.integers(0, 6, size=(FOLD_BATCH, k - 1)).astype(np.int32)}
               for k in kernels.TREE_LEAVES]
    out = []
    for bt in batches + tree_path_batches():
        lv, oc = bt["leaves"], bt["opc"]
        if not torch.equal(mine.gather_count_tree(rm, lv, oc), theirs.gather_count_tree(rm, lv, oc)):
            raise AssertionError(f"tree {bt['request']} K={lv.shape[1]}: the checkouts disagree")
        o_ms, ms = _abba_rounds(lambda: theirs.gather_count_tree(rm, lv, oc),
                                lambda: mine.gather_count_tree(rm, lv, oc))
        staged = dispatch.tree_strategy(len(np.unique(lv)), W, oc, N_SLICES)
        out.append(dict(tree_bound(N_SLICES, W, lv, oc), request=bt["request"], other_ms=o_ms, ms=ms,
                        other_host_ms=host_ms(lambda: theirs.gather_count_tree(rm, lv, oc)),
                        host_ms=host_ms(lambda: mine.gather_count_tree(rm, lv, oc)),
                        pick="resident_count_tree" if staged else "gather_count_tree"))
    return out


def check_tall_kernels(rm, stack, rng, diff) -> tuple[dict, list]:
    """The row-major kernels at the tall path's shape — row-major
    [1024, 32, W], 512 pairs naming every row once (all four ops) and
    K = 3, 4, 16 folds (and / or / andnot, padded and unpadded) — and
    topn_counts at the pool's [64, 256, W] against a [64, W] src, each
    against its plain version exactly.  Returns their timings, and the
    slice-major kernels timed against the row-major ones on the same
    ids over the [32, 1024, W] transpose (ABBA order, L2 flushed)."""
    rmr = _rand_words(_gen(SEED + 5), (TALL_ROWS, TALL_SLICES, W))
    pairs = rng.permutation(TALL_ROWS).reshape(-1, 2).astype(np.int32)
    b = len(pairs)
    for op in PAIR_OPS:
        diff("gather_count2_rowmajor", kernels.gather_count2_rowmajor(op, rmr, pairs),
             _chunked(lambda x, _op=op: kernels.gather_count2_rowmajor_plain(_op, rmr, x), pairs))
    folds = []
    for k, line_op in ((3, "and"), (4, "or"), (16, "andnot")):
        idx = rng.integers(0, TALL_ROWS, size=(b, k)).astype(np.int32)
        for op in kernels.MULTI_OPS:
            got = kernels.gather_count_multi_rowmajor(op, rmr, idx)
            diff("gather_count_multi_rowmajor", got, _chunked(
                lambda x, _op=op: kernels.gather_count_multi_rowmajor_plain(_op, rmr, x), idx))
            lo = 1 if op == "andnot" else 0
            pad = idx[np.arange(b)[:, None], rng.integers(lo, k, size=(b, 3))]
            diff("gather_count_multi_rowmajor",
                 kernels.gather_count_multi_rowmajor(op, rmr, np.concatenate([idx, pad], 1)), got)
        folds.append((line_op, idx))

    def topn_plain():
        return torch.cat([kernels.topn_counts_plain(rm[:, i:i + 64], stack)
                          for i in range(0, rm.shape[1], 64)])

    diff("topn_counts", kernels.topn_counts(rm, stack), topn_plain())
    torch.cuda.synchronize()

    row_b = W * 4
    res = {}
    nb, by = bound(TALL_SLICES * len(np.unique(pairs)) * row_b + pairs.nbytes + b * 4,
                   TALL_SLICES * b * W * OPS_PER_WORD)
    res["gather_count2_rowmajor"] = dict(
        shape=f"row-major rm [{TALL_ROWS}, {TALL_SLICES}, {W}], {b} pairs, and",
        ms=cuda_ms(lambda: kernels.gather_count2_rowmajor("and", rmr, pairs)),
        plain_ms=cuda_ms(lambda: _chunked(
            lambda x: kernels.gather_count2_rowmajor_plain("and", rmr, x), pairs), reps=2, warm=1),
        bound_ms=nb, bound_by=by,
    )
    multi = []
    for op, idx in folds:
        k = idx.shape[1]
        nb, by = bound(TALL_SLICES * len(np.unique(idx)) * row_b + idx.nbytes + b * 4,
                       b * TALL_SLICES * W * (k + 1))
        multi.append(dict(
            shape=f"row-major rm [{TALL_ROWS}, {TALL_SLICES}, {W}], B={b}, K={k}, {op}",
            ms=cuda_ms(lambda: kernels.gather_count_multi_rowmajor(op, rmr, idx)),
            plain_ms=cuda_ms(lambda: _chunked(
                lambda x: kernels.gather_count_multi_rowmajor_plain(op, rmr, x), idx),
                reps=2, warm=1),
            bound_ms=nb, bound_by=by,
            gathered_bound_ms=b * TALL_SLICES * k * row_b / PEAK_BYTES_S * 1e3,
        ))
    res["gather_count_multi_rowmajor"] = dict(multi[0], shapes=multi[1:])
    s, r = rm.shape[:2]
    nb, by = bound(s * r * row_b + s * row_b + r * 4, s * r * W * OPS_PER_WORD)
    res["topn_counts"] = dict(
        shape=f"rm [{s}, {r}, {W}] & src [{s}, {W}]",
        ms=cuda_ms(lambda: kernels.topn_counts(rm, stack)),
        plain_ms=cuda_ms(topn_plain, reps=2, warm=1),
        bound_ms=nb, bound_by=by,
    )

    # Slice-major vs row-major on identical inputs: the same rows and ids.
    sm = rmr.transpose(0, 1).contiguous()
    cases = [("pair, and", lambda: kernels.gather_count2("and", sm, pairs),
              lambda: kernels.gather_count2_rowmajor("and", rmr, pairs), pairs)]
    for op, idx in folds:
        cases.append((f"K={idx.shape[1]}, {op}",
                      lambda _o=op, _i=idx: kernels.gather_count_multi(_o, sm, _i),
                      lambda _o=op, _i=idx: kernels.gather_count_multi_rowmajor(_o, rmr, _i), idx))
    layout = []
    for what, slice_major, row_major, ids in cases:
        if not torch.equal(slice_major(), row_major()):
            raise AssertionError(f"layout {what}: slice-major and row-major counts differ")
        a1 = cuda_ms(slice_major)
        b1 = cuda_ms(row_major)
        b2 = cuda_ms(row_major)
        a2 = cuda_ms(slice_major)
        layout.append({
            "case": f"B={b}, {what}", "slice_major": f"[{TALL_SLICES}, {TALL_ROWS}, {W}]",
            "row_major": f"[{TALL_ROWS}, {TALL_SLICES}, {W}]",
            "slice_major_ms": [a1, a2], "row_major_ms": [b1, b2],
            "unique_rows": int(len(np.unique(ids))),
        })
    del rmr, sm
    torch.cuda.empty_cache()
    return res, layout


# ---------------------------------------------------------------------------
# phase 2c: the Gram kernel, the tensor-core probe, gather_count2's batches
# ---------------------------------------------------------------------------

# The Gram's exact grid: R x S, then a bucket of a pool with spare rows
# (300 of 512 rows, the executor's strided m[:, :bucket, :] view), a
# narrow strided view whose last word chunk is ragged (40 of 512 rows,
# 100 of W words, 3 slices), and a tall working set.
GRAM_ROWS = (1, 17, 64, 256)
GRAM_SLICES = (1, 7, 64)
GRAM_POOL_ROWS = 512
GRAM_STRIDED = (N_SLICES, 300)
GRAM_NARROW = (3, 40, 100)
GRAM_TALL = (16, 1024)
GRAM_SEED = SEED + 11
# The executor's Gram buckets (powers of two up to its 4,096-row ceiling)
# at the row pool's 2 GiB budget, each also held whole at its S and R over
# GRAM_BUCKET_CHECK_WORDS words (the plain version unpacks a slice to
# float32: 16 GiB at R = 4,096 and the full W).
GRAM_POOL_BYTES = 2 << 30
GRAM_BUCKETS = (64, 128, 512, 2048, 4096)
GRAM_BUCKET_CHECK_WORDS = 4096
# Steps each warp of the probe runs (16 products a step).
PROBE_ITERS = 4096


def b1_rate() -> dict:
    """Build ``csrc/mma_probe.cu`` and time its two loops of b1 AND-popc:
    mma.sync m16n8k256 from registers over 4 blocks an SM, and wgmma
    m64n128k256 from shared memory at pair_gram.cu's tile over 2 blocks
    (4 warpgroups) an SM.  Bit products a second of each and their share
    of the int8 peak's 2 ops a product; ``bit_products_per_s``, the
    ceiling of the Gram's products, is the faster of the two."""
    import ctypes

    src = os.path.join(kernels._CSRC, "mma_probe.cu")
    lib = os.path.join(kernels.BUILD_DIR, "libmma_probe.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    so = ctypes.CDLL(lib)
    sms = kernels.sm_count(torch.device("cuda"))
    rates = {}
    # (entry point, blocks an SM, bit products a block and step)
    for name, per_sm, products in (("mma_sync", 4, 8 * 16 * 32768),
                                   ("wgmma", 2, 2 * 4 * 64 * 128 * 256)):
        fn = getattr(so, f"pk_{name.replace('_sync', '')}_probe")
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        blocks = per_sm * sms
        out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")

        def run(fn=fn, blocks=blocks, out=out):
            err = fn(blocks, PROBE_ITERS, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mma_probe: cudaError {err}")

        ms = cuda_ms(run, reps=5)
        total = blocks * PROBE_ITERS * products
        rates[name] = {"ms": ms, "bit_products_per_s": total / ms * 1e3,
                       "share_of_int8_peak": 2 * total / ms * 1e3 / PEAK_INT8_OPS_S}
    faster = max(rates, key=lambda k: rates[k]["bit_products_per_s"])
    return dict(rates, faster=faster, bit_products_per_s=rates[faster]["bit_products_per_s"])


def gram_bound(s: int, r: int, w: int, b1_s: float) -> dict:
    """The Gram's bound: the larger of every word read once and the
    int64 R x R written once over the HBM rate, and the upper triangle's
    bit products (diagonal included) over the b1 rate ``b1_s``; beside
    it, the same products over the int8 tensor-core rate (2 ops each),
    which b1 outruns, so it bounds nothing."""
    nbytes = s * r * w * 4 + r * r * 8
    products = (r * (r + 1) // 2) * s * w * 32
    ms, by = bound(nbytes, products, b1_s)
    return {"bound_ms": ms, "bound_by": by, "bytes_bound_ms": nbytes / PEAK_BYTES_S * 1e3,
            "ops_bound_ms": products / b1_s * 1e3,
            "int8_ops_bound_ms": 2 * products / PEAK_INT8_OPS_S * 1e3}


def _int8_bits(rows: torch.Tensor) -> torch.Tensor:
    """int32[R, W] words as 0/1 int8[R, 32 W] (bytes, then bits: a
    permutation of the columns that both Gram operands share)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=rows.device)
    bits = (rows.view(torch.uint8).unsqueeze(-1) >> shifts) & 1
    return bits.view(torch.int8).reshape(rows.shape[0], -1)


def library_gram(m: torch.Tensor) -> torch.Tensor:
    """The yardstick (never called by the port): per slice, the bits
    unpacked to int8 and ``torch._int_mm``, summed in int32."""
    acc = torch.zeros((m.shape[1], m.shape[1]), dtype=torch.int32, device=m.device)
    for i in range(m.shape[0]):
        bits = _int8_bits(m[i])
        acc += torch._int_mm(bits, bits.t())
    return acc


def check_gram(diff) -> dict:
    """pair_gram == its plain version on the card, exactly, over the
    grid above; timed at the executor's shape (S=64, R=256) against the
    plain version and the library yardstick, and at the strided, tall and
    bucket shapes, each beside its bound at this run's faster b1 rate."""
    probe = b1_rate()
    b1_s = probe["bit_products_per_s"]
    gen = _gen(GRAM_SEED)
    pool = _rand_words(gen, (N_SLICES, GRAM_POOL_ROWS, W))
    checked = []
    for s in GRAM_SLICES:
        for r in GRAM_ROWS:
            m = pool[:s, :r].contiguous()
            diff("pair_gram", kernels.pair_gram(m), kernels.pair_gram_plain(m))
            checked.append({"S": s, "R": r})
            del m
    s, r = GRAM_STRIDED
    view = pool[:s, :r]
    diff("pair_gram", kernels.pair_gram(view), kernels.pair_gram_plain(view))
    checked.append({"S": s, "R": r, "pool_rows": GRAM_POOL_ROWS, "strided": True})
    s, r, w = GRAM_NARROW
    narrow = pool[:s, :r, :w]
    diff("pair_gram", kernels.pair_gram(narrow), kernels.pair_gram_plain(narrow))
    checked.append({"S": s, "R": r, "W": w, "strided": True})
    torch.cuda.synchronize()

    def entry(m, shape, plain_reps=2):
        e = dict(shape=shape, ms=cuda_ms(lambda: kernels.pair_gram(m), reps=5),
                 plain_ms=cuda_ms(lambda: kernels.pair_gram_plain(m), reps=plain_reps, warm=1))
        e.update(gram_bound(*m.shape, b1_s))
        return e

    strided = entry(view, f"[{GRAM_STRIDED[0]}, {GRAM_STRIDED[1]} of {GRAM_POOL_ROWS}, {W}] view")
    del view, narrow
    m = pool[:, :N_ROWS].contiguous()
    del pool
    torch.cuda.empty_cache()
    main = entry(m, f"[{N_SLICES}, {N_ROWS}, {W}] (executor pairs-2)")
    lib = library_gram(m)
    if not torch.equal(lib.long(), kernels.pair_gram_plain(m)):
        raise AssertionError("pair_gram: the library yardstick disagrees with the plain version")
    main["library_ms"] = cuda_ms(lambda: library_gram(m), reps=3, warm=1)
    bits = _int8_bits(m[0])
    main["int_mm_only_ms"] = N_SLICES * cuda_ms(lambda: torch._int_mm(bits, bits.t()), reps=5)
    del m, lib, bits
    torch.cuda.empty_cache()
    s, r = GRAM_TALL
    tall = _rand_words(gen, (s, r, W))
    diff("pair_gram", kernels.pair_gram(tall), kernels.pair_gram_plain(tall))
    checked.append({"S": s, "R": r})
    tall_e = entry(tall, f"[{s}, {r}, {W}]", plain_reps=1)
    del tall
    torch.cuda.empty_cache()
    # The executor's row buckets at the 2 GiB pool budget (S x R x W x 4
    # bytes): each held exactly whole at S x R x GRAM_BUCKET_CHECK_WORDS
    # (every tile pair, units whose runs cross slices) and on its first
    # slice at the full W, then timed at the full W.
    buckets = []
    for r in GRAM_BUCKETS:
        s = GRAM_POOL_BYTES // (r * W * 4)
        m = _rand_words(gen, (s, r, GRAM_BUCKET_CHECK_WORDS))
        diff("pair_gram", kernels.pair_gram(m), kernels.pair_gram_plain(m))
        checked.append({"S": s, "R": r, "W": GRAM_BUCKET_CHECK_WORDS})
        m = _rand_words(gen, (s, r, W))
        one = m[:1]
        diff("pair_gram", kernels.pair_gram(one), kernels.pair_gram_plain(one))
        buckets.append(dict(S=s, R=r, ms=cuda_ms(lambda: kernels.pair_gram(m), reps=3),
                            **gram_bound(*m.shape, b1_s)))
        del m, one
        torch.cuda.empty_cache()
    sched = kernels.gram_schedule(N_ROWS, N_SLICES, W, kernels.sm_count(torch.device("cuda")))
    main.update(checked=checked, schedule=sched, shapes=[strided, tall_e], buckets=buckets,
                b1_probe=probe)
    return {"pair_gram": main}


# Every pair batch the executor path hands dispatch, as (layout, S, R,
# pairs, the kernel dispatch picks): the batches time_gather2_paths rebuilds.
PAIR_SEEN: list = []


def record_pair_batches() -> None:
    """Wrap the two pair-count entry points so that each call appends its
    batch to PAIR_SEEN; the request records carry a summary."""
    from pilosa_tpu_torch.ops import dispatch

    def seen_slice(op, m, pairs, _fn=dispatch.gather_count):
        s, r, w = m.shape
        pick = "resident_count2" if dispatch.resident_strategy(r, w, len(pairs)) else "gather_count2"
        PAIR_SEEN.append({"layout": "slice", "S": s, "R": r, "pairs": np.array(pairs, np.int32),
                          "pick": pick})
        return _fn(op, m, pairs)

    def seen_row(op, m, pairs, _fn=dispatch.gather_count_rowmajor):
        r, s, _ = m.shape
        PAIR_SEEN.append({"layout": "row", "S": s, "R": r, "pairs": np.array(pairs, np.int32),
                          "pick": "gather_count2_rowmajor"})
        return _fn(op, m, pairs)

    dispatch.gather_count = seen_slice
    dispatch.gather_count_rowmajor = seen_row


def _pair_summary(b) -> dict:
    return {"layout": b["layout"], "S": b["S"], "R": b["R"], "B": len(b["pairs"]),
            "distinct": len(np.unique(b["pairs"])), "pick": b["pick"]}


# gather_count2's timed batches; 600 is past kernels.GATHER2_PARAM_PAIRS,
# so its ids take the device-array path.
GATHER2_BATCHES = (16, 64, 256, 600)


def host_ms(fn, n: int = 200) -> float:
    """Host time of one fn() call in ms: the host clock around n calls
    that do not wait for the card (the work a call puts in front of its
    launches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def count_times(a, b, op) -> dict:
    """count_rows on one stack: exact against its plain version, then the
    entry point's device time (its host work included, ``ms``), the
    launch's alone (``kernel_ms``) and the entry point's host work a call
    (``host_ms``), beside its byte bound (each row read once, the counts
    written)."""
    m, w = a.shape
    want = kernels.count_rows_plain(a, b, op)
    if not torch.equal(kernels.count_rows(a, b, op), want):
        raise AssertionError(f"count_rows [{m}, {w}] {op}: kernel differs from its plain version")
    out = torch.empty(m, dtype=torch.int32, device=a.device)
    n_seg, seg_vecs = kernels.count_rows_segments(m, w, kernels.sm_count(a.device))
    stride = 0 if b is None or b.dim() == 1 else w
    fn = kernels._fn("count_rows")
    stream = kernels._stream(a)

    def kernel_only():
        kernels._check(fn(a.data_ptr(), None if b is None else b.data_ptr(), stride, out.data_ptr(),
                          m, w, kernels.OPS[op], n_seg, seg_vecs, stream), "count_rows")

    kernel_only()
    if not torch.equal(out, want):
        raise AssertionError(f"count_rows [{m}, {w}]: kernel-only launch differs")
    nb, by = bound(a.numel() * 4 + (0 if b is None else b.numel() * 4) + m * 4,
                   m * w * (2 if b is None else OPS_PER_WORD))
    # Launches of 0.006-0.03 ms: 50 readings each, where one slow reading
    # moves a mean of 10 by a fifth.
    return {"M": m, "W": w, "n_seg": n_seg,
            "ms": cuda_ms(lambda: kernels.count_rows(a, b, op), reps=50),
            "kernel_ms": cuda_ms(kernel_only, reps=50),
            "host_ms": host_ms(lambda: kernels.count_rows(a, b, op)), "bound_ms": nb, "bound_by": by}


def gather2_times(op, m, pairs, sweep: bool = False) -> dict:
    """gather_count2 on one batch: exact against its plain version, then
    the entry point's device time (its host work included, as the path
    pays it), the launch's alone (ids ready, ``kernel_ms``) and the entry
    point's host work a call (``host_ms``), beside its byte bound (each
    named row once); ``sweep``: the launch alone at 1-16 segments a row
    too (``kernel_ms_by_n_seg``)."""
    s, r, w = m.shape
    a = np.ascontiguousarray(pairs, dtype=np.int32)
    want = torch.cat([kernels.gather_count2_plain(op, m, a[i:i + PAIR_BATCH])
                      for i in range(0, len(a), PAIR_BATCH)])
    if not torch.equal(kernels.gather_count2(op, m, a), want):
        raise AssertionError(f"gather_count2 B={len(a)}: kernel differs from its plain version")
    dev_pairs = kernels._ids(a, r, m.device, "pairs")
    ids = a.ctypes.data if len(a) <= kernels.GATHER2_PARAM_PAIRS else dev_pairs.data_ptr()
    out = torch.empty(len(a), dtype=torch.int32, device=m.device)
    sms = kernels.sm_count(m.device)
    n_seg, seg_vecs = kernels.gather2_segments(len(a), s, w, sms)
    fn = kernels._fn("gather_count2")
    stream = kernels._stream(m)

    def kernel_only():
        kernels._check(fn(m.data_ptr(), ids, out.data_ptr(), s, r, w, len(a), kernels.OPS[op],
                          n_seg, seg_vecs, stream), "gather_count2")

    kernel_only()
    if not torch.equal(out, want):
        raise AssertionError(f"gather_count2 B={len(a)}: kernel-only launch differs")
    nb, by = bound(s * len(np.unique(a)) * w * 4 + a.nbytes + len(a) * 4,
                   s * len(a) * w * OPS_PER_WORD)
    res = {"S": s, "R": r, "B": len(a), "distinct": len(np.unique(a)), "n_seg": n_seg,
           "ms": cuda_ms(lambda: kernels.gather_count2(op, m, a)), "kernel_ms": cuda_ms(kernel_only),
           "host_ms": host_ms(lambda: kernels.gather_count2(op, m, a)), "bound_ms": nb, "bound_by": by}
    if sweep:
        res["kernel_ms_by_n_seg"] = {}
        for n_seg in (1, 2, 4, 8, 16):
            seg_vecs = -(-(w // 4) // n_seg)
            kernel_only()
            res["kernel_ms_by_n_seg"][n_seg] = cuda_ms(kernel_only)
            if not torch.equal(out, want):
                raise AssertionError(f"gather_count2 B={len(a)} n_seg={n_seg}: differs")
        n_seg, seg_vecs = kernels.gather2_segments(len(a), s, w, sms)
    return res


def _time_path_batches(seen, seed: int, times) -> list:
    """``times(matrix, batch)`` at every recorded batch in ``seen``, each
    over random words at its own [S, R, W] (one matrix on the card at a
    time)."""
    out = []
    gen = _gen(seed)
    mats = {}
    for b in seen:
        key = (b["S"], b["R"])
        if key not in mats:
            mats.clear()
            torch.cuda.empty_cache()
            mats[key] = _rand_words(gen, (b["S"], b["R"], W))
        out.append(times(mats[key], b))
    mats.clear()
    torch.cuda.empty_cache()
    return out


def time_gather2_paths() -> list:
    """gather_count2 at every pair batch the executor path handed the
    gather kernel, and at the row-major pair batches (gather-2) as
    slice-major batches of the same pairs, each rebuilt over random words
    at its own matrix shape."""
    rebuilt = [b for b in PAIR_SEEN if b["pick"] in ("gather_count2", "gather_count2_rowmajor")]
    return _time_path_batches(rebuilt, SEED + 12, lambda m, b: dict(
        gather2_times("xor", m, b["pairs"]), path_layout=b["layout"]))


# ---------------------------------------------------------------------------
# phase 3: the main path through Executor.execute
# ---------------------------------------------------------------------------

def holder_slices(n_slices: int, n_rows: int, bits: int, seed: int):
    """The (rows, cols) pairs ``build_holder`` loads, one slice at a time
    in its order (row by row): every row gets ``bits`` distinct seeded
    random columns in every slice."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.uint64), bits)
    for s in range(n_slices):
        cols = np.concatenate(
            [rng.choice(SLICE_WIDTH, size=bits, replace=False) for _ in range(n_rows)]
        ).astype(np.uint64) + np.uint64(s * SLICE_WIDTH)
        yield rows, cols


def build_holder(path: str, n_slices: int, n_rows: int, bits: int, seed: int):
    """Index ``i``, frame ``f``; every row gets ``bits`` distinct seeded
    random columns in every slice (so every row counts exactly ``bits``
    per slice and the TopN candidate order is the same in every slice),
    loaded with ``Frame.import_bits``."""
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder

    h = Holder(path)
    h.open()
    idx = h.create_index("i")
    idx.create_frame("f", FrameOptions())
    fr = idx.frame("f")
    for rows, cols in holder_slices(n_slices, n_rows, bits, seed):
        fr.import_bits(rows, cols)
    return h


# Every multi-fold batch the paths hand the entry points, as (layout, op,
# B, K, distinct rows, matrix rows): the shapes multi_path_batches rebuilds.
MULTI_SEEN: list = []


def record_multi_batches() -> None:
    """Wrap the two multi-fold entry points so that each call appends its
    batch's shape to MULTI_SEEN; the request records carry their own."""
    from pilosa_tpu_torch.ops import dispatch

    for name, layout in (("gather_count_multi", "slice"), ("gather_count_multi_rowmajor", "row")):
        def seen(op, m, idx, _fn=getattr(dispatch, name), _layout=layout):
            ix = np.asarray(idx)
            MULTI_SEEN.append({"layout": _layout, "op": op, "B": ix.shape[0], "K": ix.shape[1],
                               "distinct": len(np.unique(ix)),
                               "rows": m.shape[0 if _layout == "row" else 1]})
            return _fn(op, m, idx)
        setattr(dispatch, name, seen)


def _norm(res):
    """Results as plain values (TopN pairs -> (id, count) tuples)."""
    return [[(p.id, p.count) for p in r] if isinstance(r, list) else r for r in res]


def run_request(records, name, ex, ex_ref, calls, sub=None, expect=(), sync=lambda: None,
                opt=None):
    """Execute the PQL ``calls`` as one request on ``ex``; check the
    answers at positions ``sub`` (all when None) against ``ex_ref`` run on
    those calls alone; append a record (wall ms, launches by kernel, bytes
    the engine uploaded).  Returns the answers."""
    before = dict(kernels.LAUNCHES)
    up0 = ex.engine.stat_upload_bytes
    n_seen, n_pairs, n_trees = len(MULTI_SEEN), len(PAIR_SEEN), len(TREE_SEEN)
    t0 = time.perf_counter()
    got = _norm(ex.execute("i", " ".join(calls), opt=opt))
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    upload = ex.engine.stat_upload_bytes - up0
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] > before[k]}
    pick = list(range(len(calls))) if sub is None else sub
    want = _norm(ex_ref.execute("i", " ".join(calls[i] for i in pick)))
    cmp = [got[i] for i in pick]
    if cmp != want:
        raise AssertionError(f"{name}: port answers differ from the numpy engine: {cmp[:4]} vs {want[:4]}")
    for k in expect:
        if not launched.get(k):
            raise AssertionError(f"{name}: expected {k} to launch, launches {launched}")
    records.append({"request": name, "ms": ms, "checked": len(cmp), "launches": launched,
                    "upload_bytes": upload})
    if len(MULTI_SEEN) > n_seen:
        records[-1]["multi_batches"] = MULTI_SEEN[n_seen:]
    if len(PAIR_SEEN) > n_pairs:
        records[-1]["pair_batches"] = [_pair_summary(b) for b in PAIR_SEEN[n_pairs:]]
    if len(TREE_SEEN) > n_trees:
        records[-1]["tree_batches"] = [_tree_summary(b) for b in TREE_SEEN[n_trees:]]
    return got


def _subset(rng, n: int) -> list[int]:
    return sorted(rng.choice(n, size=min(SUBSET, n), replace=False).tolist())


def _pair_calls(ops, pairs) -> list[str]:
    """One pair Count per row pair, the ops cycling in the given order."""
    return [f"Count({PQL_OPS[ops[i % len(ops)]]}({_bm(a)}, {_bm(b)}))"
            for i, (a, b) in enumerate(pairs)]


# The bits main_path sets in frame ``f`` beyond build_holder's, as (row,
# column): the bulk path replays them into ``fb``.
F_WRITES: list = []


def main_path(ex, ex_nogram, ex_ref, n_rows: int, sync=lambda: None) -> list[dict]:
    """Drive the requests; check every answer against ``ex_ref``.
    Returns per-request records (wall ms, launches by kernel)."""
    rng = np.random.default_rng(SEED + 1)
    records = []

    def run(name, executor, calls, sub=None, expect=()):
        return run_request(records, name, executor, ex_ref, calls, sub, expect, sync)

    def pair_request(name, executor, op, n, expect=()):
        # Full batches name every row (first operands walk a permutation),
        # so the pool's working set is whole from the first request and
        # the second request against it finds the cache box warm.
        pairs = rng.integers(0, n_rows, size=(n, 2))
        if n >= n_rows:
            pairs[:, 0] = np.resize(rng.permutation(n_rows), n)
        run(name, executor, _pair_calls((op,), pairs), _subset(rng, n), expect)

    # Batched pair Counts: the first takes the direct resident kernel;
    # once the pool entry has 2 hits the Gram builds and answers, then
    # the native lookup lane serves.
    pair_request("pairs-1 Intersect", ex, "and", PAIR_BATCH, expect=("resident_count2",))
    pair_request("pairs-2 Union", ex, "or", PAIR_BATCH, expect=("pair_gram",))
    pair_request("pairs-3 Difference", ex, "andnot", PAIR_BATCH)
    # A no-Gram executor: small batches against a taller pool gather.
    # Whether a batch pages through the slice-major or the row-major pool
    # depends on its distinct rows and the pool's capacity
    # (engine.prefer_rowmajor), so no kernel is fixed here; the record
    # says which ran.
    pair_request("gather-1 Xor", ex_nogram, "xor", GATHER_BATCH)
    pair_request("gather-2 Intersect", ex_nogram, "and", GATHER_BATCH)
    # Pair and nested Counts in one no-Gram body: a part carrying a tree
    # group keeps every group slice-major, so the pairs gather from the
    # slice-major pool.
    calls = _pair_calls(PAIR_OPS, rng.integers(0, n_rows, size=(GATHER_BATCH, 2)))
    calls += [_tree_call(rng, n_rows, i) for i in range(8)]
    run("gather-3 mixed", ex_nogram, calls, _subset(rng, len(calls)),
        expect=("gather_count2", "gather_count_tree"))
    # Single Counts take the sequential path (count kernel): the flat
    # lane fuses only multi-call bodies, and a write in the body keeps
    # the fused lanes off it.
    a, b = (int(x) for x in rng.integers(0, n_rows, size=2))
    one = f'Count(Intersect(Bitmap(rowID={a}, frame="f"), Bitmap(rowID={b}, frame="f")))'
    run("count-single", ex, [one], expect=("count_rows",))
    col = int(rng.integers(0, SLICE_WIDTH))
    F_WRITES.append((a, col))
    got = run("setbit+count", ex, [f'SetBit(rowID={a}, frame="f", columnID={col})', one],
              sub=[1], expect=("count_rows",))
    if not isinstance(got[0], bool):
        raise AssertionError(f"setbit+count: SetBit answered {got[0]!r}")
    # After the write: the pool patches the written row and repairs the
    # Gram (rank-k pair counts on the card) before serving.
    pair_request("pairs-4 Xor after write", ex, "xor", PAIR_BATCH)
    # TopN with a source bitmap: phase 1 scores each slice's candidates
    # (count kernel, shared src); the merged-id refetch asked by a second
    # slice upgrades to one all-slice launch (gather_src_counts).
    TOPN_ANSWER[:] = run("topn", ex, [TOPN_PQL], expect=("count_rows", "gather_src_counts"))
    return records


# ---------------------------------------------------------------------------
# phase 4: the HTTP path through the port's Server
# ---------------------------------------------------------------------------

def add_time_frame(h, n_slices: int, n_rows: int, bits: int, seed: int) -> None:
    """Frame ``t`` of index ``i`` with time quantum YMD: every row gets
    ``bits`` distinct seeded columns per slice, each stamped with one of
    STAMPS (so the standard view and the year / month / day views all
    hold data), loaded with ``Frame.import_bits``."""
    from pilosa_tpu_torch.core.frame import FrameOptions

    h.index("i").create_frame("t", FrameOptions(time_quantum="YMD"))
    fr = h.index("i").frame("t")
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.uint64), bits)
    for s in range(n_slices):
        cols = np.concatenate(
            [rng.choice(SLICE_WIDTH, size=bits, replace=False) for _ in range(n_rows)]
        ).astype(np.uint64) + np.uint64(s * SLICE_WIDTH)
        fr.import_bits(rows, cols, [STAMPS[i] for i in rng.integers(0, len(STAMPS), size=len(rows))])


def _bm(r, frame="f") -> str:
    return f'Bitmap(rowID={int(r)}, frame="{frame}")'


def _tree_call(rng, n_rows: int, i: int) -> str:
    """Nested Counts of depth 2, 3 and 4 and a 3-operand Xor, in turn."""
    def b():
        return _bm(rng.integers(0, n_rows))
    shapes = (
        lambda: f"Xor({b()}, {b()}, {b()})",
        lambda: f"Intersect(Union({b()}, {b()}), Difference({b()}, {b()}))",
        lambda: f"Union(Intersect(Xor({b()}, {b()}), {b()}), Difference({b()}, Union({b()}, {b()})))",
        lambda: (f"Xor(Union(Intersect(Xor({b()}, {b()}), {b()}), {b()}), "
                 f"Difference({b()}, Intersect({b()}, Union({b()}, {b()}))))"),
    )
    return f"Count({shapes[i % len(shapes)]()})"


def _range_call(row, span) -> str:
    return f'Count(Range(rowID={int(row)}, frame="t", start="{span[0]}", end="{span[1]}"))'


def http_path(host: str, ex_ref, n_rows: int, time_rows: int, engine) -> list[dict]:
    """POST the request batches to ``host``'s ``/index/i/query``; check a
    seeded subset of each answer against ``ex_ref``.  Returns per-request
    records (wall ms on the client's clock, launches by kernel, and the
    bytes the server's ``engine`` uploaded to the card)."""
    rng = np.random.default_rng(SEED + 2)
    records = []

    def run(name, calls, expect=()):
        before = dict(kernels.LAUNCHES)
        up0 = engine.stat_upload_bytes
        n_seen, n_trees = len(MULTI_SEEN), len(TREE_SEEN)
        req = urllib.request.Request(f"http://{host}/index/i/query",
                                     data=" ".join(calls).encode(), method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            body = r.read()
        ms = (time.perf_counter() - t0) * 1e3
        upload = engine.stat_upload_bytes - up0
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] > before[k]}
        got = json.loads(body)["results"]
        if len(got) != len(calls):
            raise AssertionError(f"{name}: {len(got)} answers for {len(calls)} calls")
        sub = _subset(rng, len(calls))
        want = ex_ref.execute("i", " ".join(calls[i] for i in sub))
        cmp = [got[i] for i in sub]
        if cmp != want:
            raise AssertionError(f"{name}: server answers differ from the numpy engine: {cmp[:4]} vs {want[:4]}")
        for k in expect:
            if not launched.get(k):
                raise AssertionError(f"{name}: expected {k} to launch, launches {launched}")
        records.append({"request": name, "ms": ms, "checked": len(cmp), "launches": launched,
                        "upload_bytes": upload})
        if len(MULTI_SEEN) > n_seen:
            records[-1]["multi_batches"] = MULTI_SEEN[n_seen:]
        if len(TREE_SEEN) > n_trees:
            records[-1]["tree_batches"] = [_tree_summary(b) for b in TREE_SEEN[n_trees:]]

    # The pair lanes behind the server: a cold pair batch naming every row
    # takes the resident kernel.
    pairs = rng.integers(0, n_rows, size=(PAIR_BATCH, 2))
    pairs[:, 0] = np.resize(rng.permutation(n_rows), PAIR_BATCH)
    run("http pairs Intersect", [f"Count(Intersect({_bm(a)}, {_bm(b)}))" for a, b in pairs],
        expect=("resident_count2",))
    for name, (op, idx) in nary_requests(n_rows).items():
        run(name, [f"Count({PQL_OPS[op]}({', '.join(_bm(r) for r in ids)}))" for ids in idx],
            expect=("gather_count_multi_mixed",))
    run("tree", [_tree_call(rng, n_rows, i) for i in range(FOLD_BATCH)], expect=("gather_count_tree",))
    # range-2 repeats range-1's spans, which answer from the cover memo;
    # its new spans' covers launch.  Each Range batch's Counts of one row
    # over overlapping spans share their views, so all three take the
    # staged kernel (dispatch.multi_strategy, multi_shares): range-1 and
    # range-2 at 10-12 distinct views a cover, range-wide at 16-19 over
    # 240 rows.
    one, two, wide = range_requests(time_rows)
    run("range-1", [_range_call(r, sp) for r, sp in one], expect=("resident_count_multi",))
    run("range-2", [_range_call(r, sp) for r, sp in two], expect=("resident_count_multi",))
    run("range-wide", [_range_call(r, sp) for r, sp in wide], expect=("resident_count_multi",))
    # Short August spans no earlier request asked: covers of 1-7 day
    # views, too few references for the staged gate, so the Range lane's
    # batch takes the gather multi kernel.
    run("range-short", [_range_call(r, sp) for r, sp in range_short(time_rows)],
        expect=("gather_count_multi",))
    # Nested Counts four times as many as "tree": buckets of 128 trees at
    # K=4 and 64 at K=8 and K=16, 1.1-2.3 live references a row: the
    # gather kernel (dispatch.tree_strategy).  The same over 64 hot rows:
    # the K=8 and K=16 buckets name each row 6 and 8 times with their
    # live leaves, enough for the staged tree kernel.
    run("tree-wide", [_tree_call(rng, n_rows, i) for i in range(TREE_WIDE_BATCH)],
        expect=("gather_count_tree",))
    run("tree-hot", [_tree_call(rng, TREE_HOT_ROWS, i) for i in range(TREE_WIDE_BATCH)],
        expect=("resident_count_tree",))
    return records


# ---------------------------------------------------------------------------
# phase 5: the tall path (row-major pool paging and slice streaming)
# ---------------------------------------------------------------------------

def _rm_pool(ex):
    """Paging counters of the executor's row-major pool (lane "rmgather")."""
    pools = [p for key, p in list(ex._matrix_cache.items()) if key[-1] == "rmgather"]
    if len(pools) != 1:
        raise AssertionError(f"expected one row-major pool, found {len(pools)}")
    p = pools[0]
    return {"cap": p.cap, "misses": p.stat_misses, "evictions": p.stat_evictions,
            "repairs": p.stat_repairs, "patch_planes": p.stat_patch_planes}


def tall_path(ex, ex_ref, n_rows: int, sync=lambda: None) -> list[dict]:
    """Drive a working set taller than one pool through the executor's
    row-major lane; check each answer against ``ex_ref``.  Returns
    per-request records, each with the row-major pool's counters after
    it."""
    from pilosa_tpu_torch.costs import CostLedger
    from pilosa_tpu_torch.executor import ExecOptions
    from pilosa_tpu_torch.planner import Planner

    rng = np.random.default_rng(SEED + 6)
    records = []

    def run(name, calls, sub=None, expect=(), opt=None):
        got = run_request(records, name, ex, ex_ref, calls, sub, expect, sync, opt)
        records[-1]["rm_pool"] = _rm_pool(ex)
        return got

    # 512 pair Counts naming every row once: the flat pair lane pages
    # them through the row-major pool in parts of at most 512 rows.
    pair_calls = _pair_calls(PAIR_OPS, rng.permutation(n_rows).reshape(-1, 2))
    run("tall-pairs", pair_calls, _subset(rng, len(pair_calls)), expect=("gather_count2_rowmajor",))
    if not records[-1]["rm_pool"]["evictions"]:
        raise AssertionError(f"tall-pairs: the pool never paged: {records[-1]}")
    # N-ary Counts with pair Xors among them, operands walking a
    # permutation of the rows: the AST fused path, paging in parts.
    nary = tall_nary_ops(n_rows)
    calls = [f"Count({PQL_OPS[op]}({', '.join(_bm(r) for r in rows)}))" for op, rows in nary]
    last = nary[-1][1]
    run("tall-nary", calls, _subset(rng, len(calls)),
        expect=("gather_count_multi_mixed", "gather_count2_rowmajor"))
    # One Union over more rows than the pool holds streams its slices
    # through row-major transients, one launch per slice chunk; checked
    # whole.  A pair Count rides beside it: the fused path takes bodies of
    # two or more Counts, and the pair is a part of its own.
    rows = rng.choice(n_rows, size=WIDE_UNION, replace=False)
    run("tall-wide-union", [f"Count(Union({', '.join(_bm(r) for r in rows)}))",
                            f"Count(Union({_bm(rows[0])}, {_bm(rows[1])}))"],
        expect=("gather_count_multi_rowmajor",))
    if records[-1]["launches"]["gather_count_multi_rowmajor"] < 2:
        raise AssertionError(f"tall-wide-union: no slice streaming: {records[-1]}")
    # A write to a row the pool holds, then the pair batch again: the pool
    # patches the written plane of its resident row before paging.
    col = int(rng.integers(0, SLICE_WIDTH))
    ex.execute("i", f'SetBit(rowID={last[-1]}, frame="f", columnID={col})')
    patched = records[-1]["rm_pool"]["patch_planes"]
    run("tall-pairs after write", pair_calls, _subset(rng, len(pair_calls)),
        expect=("gather_count2_rowmajor",))
    if records[-1]["rm_pool"]["patch_planes"] <= patched:
        raise AssertionError(f"tall-pairs after write: no plane refreshed: {records[-1]}")
    # The planner pinned to "rmgather": a batch whose rows fit one pool
    # (the static ladder would hand it to the Gram) runs row-major, and
    # the planner's ledger records that lane.
    planner = Planner(CostLedger(), pin="rmgather")
    half = pair_calls[len(pair_calls) // 2:]
    plan = planner.plan_for("i", " ".join(half).encode())
    ex.planner = planner
    try:
        run("tall-pinned rmgather", half, _subset(rng, len(half)),
            expect=("gather_count2_rowmajor",), opt=ExecOptions(plan=plan))
    finally:
        ex.planner = None
    seen = planner.ledger.peek(index="i", frame="", fp=plan["fp"], lane="rmgather")
    if plan["lane"] != "rmgather" or not seen:
        raise AssertionError(f"planner: plan {plan}, ledger {seen}")
    return records


# ---------------------------------------------------------------------------
# phase 2b: the differential sweep
# ---------------------------------------------------------------------------

def diffcheck_path() -> dict:
    """``ops/diffcheck.py`` on the card: every lane over 24 seeded cases,
    each equal to its numpy ground truth."""
    from pilosa_tpu_torch.ops import diffcheck

    t0 = time.perf_counter()
    failures = diffcheck.run_lanes(seed=2026, cases_per_lane=24, device="cuda")
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"diffcheck: {len(failures)} failures: {failures[:8]}")
    return {"lanes": len(diffcheck.lane_names()), "cases": 24, "failures": 0,
            "s": time.perf_counter() - t0}


def paths_data(d: str):
    """The executor and HTTP paths' holder in directory ``d``: frame
    ``f`` and the time frame ``t``."""
    t0 = time.perf_counter()
    h = build_holder(d, N_SLICES, N_ROWS, BITS_PER_ROW, SEED)
    print(f"holder_s {time.perf_counter() - t0:.3f} ({N_SLICES} slices x {N_ROWS} rows)", flush=True)
    t0 = time.perf_counter()
    add_time_frame(h, N_SLICES, TIME_ROWS, BITS_PER_ROW, SEED + 4)
    print(f"time_frame_s {time.perf_counter() - t0:.3f} ({N_SLICES} slices x {TIME_ROWS} rows, YMD)",
          flush=True)
    return h


def build_data(kind: str, path: str) -> int:
    """``--build-data KIND DIR``: the executor and HTTP paths' holder
    (``paths``: ``paths_data``) or the tall path's (``tall``) built in
    DIR and closed, on the host alone (no card)."""
    if kind == "paths":
        paths_data(path).close()
        return 0
    t0 = time.perf_counter()
    build_holder(path, TALL_SLICES, TALL_ROWS, TALL_BITS, SEED + 5).close()
    print(f"tall_holder_s {time.perf_counter() - t0:.3f} ({TALL_SLICES} slices x {TALL_ROWS} rows)",
          flush=True)
    return 0


def start_data_builds(paths_dir: str, tall_dir: str) -> list:
    """Both data directories built by processes of their own on the host,
    while the kernel phases run on the card."""
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build-data", kind, path],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for kind, path in (("paths", paths_dir), ("tall", tall_dir))]


def open_built(proc, path: str):
    """Wait for a data build, print its output, and open its holder."""
    from pilosa_tpu_torch.core.holder import Holder

    out, _ = proc.communicate()
    print(out, end="", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the data build of {path} failed (rc {proc.returncode})")
    h = Holder(path)
    h.open()
    return h


def executor_path(h) -> tuple[list, dict]:
    """``main_path`` through ``Executor(h)`` (the default engine, on the
    card); closes ``h``.  Returns its records and the launches it made."""
    from pilosa_tpu_torch.executor import Executor

    ex = Executor(h)  # engine "auto": TorchEngine("cuda")
    ex_nogram = Executor(h, no_gram=True)
    ex_ref = Executor(h, engine="numpy")
    if ex.engine.name != "torch" or ex.engine.device.type != "cuda":
        raise AssertionError(f"default engine is {ex.engine.name} on {ex.engine.device}")
    if not ex.engine.supports_row_major_gather:
        raise AssertionError("TorchEngine on the card must take the row-major lane")
    kernels.reset_launches()
    records = main_path(ex, ex_nogram, ex_ref, N_ROWS, sync=torch.cuda.synchronize)
    launches = dict(kernels.LAUNCHES)
    h.close()
    del ex, ex_nogram, ex_ref
    torch.cuda.empty_cache()
    return records, launches


def server_path(d: str) -> tuple[list, dict]:
    """``http_path`` against the port's server with its default config
    over the data directory ``d``.  Returns its records and the launches
    it made."""
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.server.server import Server

    t0 = time.perf_counter()
    srv = Server(Config(data_dir=d, host="127.0.0.1:0"))
    srv.open()
    try:
        print(f"server_open_s {time.perf_counter() - t0:.3f} on {srv.host}", flush=True)
        if srv.executor.engine.name != "torch" or srv.executor.engine.device.type != "cuda":
            raise AssertionError(f"server engine is {srv.executor.engine.name}")
        ex_ref = Executor(srv.holder, engine="numpy")
        kernels.reset_launches()
        records = http_path(srv.host, ex_ref, N_ROWS, TIME_ROWS, srv.executor.engine)
        launches = dict(kernels.LAUNCHES)
    finally:
        srv.close()
    del srv, ex_ref
    torch.cuda.empty_cache()
    return records, launches


def requests_of(root: str) -> int:
    """The executor and HTTP paths' requests driven with the package of
    the checkout at ``root`` (put first on the import path at import), no
    kernel checked or timed beside them; prints their records last."""
    card = probe()
    kernels.build()
    with tempfile.TemporaryDirectory() as d:
        records, _ = executor_path(paths_data(d))
        http_records, _ = server_path(d)
    print(json.dumps({"card": card, "root": root, "requests": {"executor": records, "http": http_records}}),
          flush=True)
    return 0


# Request-level ABBA rounds of --requests-against: each round drives the
# paths in four processes, the other checkout's, this one's twice, the
# other's.
REQUEST_ABBA_ROUNDS = 1


def requests_against(other_root: str) -> int:
    """Wall ms of every executor and HTTP request, this checkout against
    the checkout at ``other_root``: ``requests_of`` in a process of its
    own for each, in the order other, this, this, other
    (REQUEST_ABBA_ROUNDS times); each process checks its answers against
    the numpy engine."""
    card = probe()
    here = os.path.dirname(os.path.abspath(__file__))
    readings = {"other": [], "this": []}
    for _ in range(REQUEST_ABBA_ROUNDS):
        for side in ("other", "this", "this", "other"):
            root = other_root if side == "other" else here
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--requests", root],
                                 capture_output=True, text=True, timeout=1200)
            if run.returncode != 0:
                raise AssertionError(f"requests of {root}: exit {run.returncode}: {run.stderr[-4000:]}")
            readings[side].append(json.loads(run.stdout.strip().splitlines()[-1])["requests"])
    rows = []
    for path, recs in readings["this"][0].items():
        for i, rec in enumerate(recs):
            rows.append({"path": path, "request": rec["request"],
                         "other_ms": [r[path][i]["ms"] for r in readings["other"]],
                         "ms": [r[path][i]["ms"] for r in readings["this"]],
                         "launches": rec["launches"]})
    print(json.dumps({"card": card, "other": other_root, "requests_against": rows}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the bulk build kernel (build_planes) against its plain version
# ---------------------------------------------------------------------------

# The build's timed shapes (pairs N, groups G): the bulk path's chunk
# (131,072 of build_holder's pairs, 66 (slice, row) groups), bench.py's
# bulk shape (a million pairs over 64 rows x 4 slices), and a 512 MiB arena.
BUILD_TIMED = ((131072, 66), (1 << 20, 256), (1 << 23, 4096))
BUILD_SEED = SEED + 17


def build_cases() -> dict:
    """The build lane's edge cases, (rows, cols) uint64 each:
    tests/test_bulk.py's ragged case (seed 5, 3,000 pairs, 100 duplicates,
    a lone pair in slice 5), one pair, all 32 bits of one word (twice,
    shuffled), local = 2^20 - 1, one group, and slice and row ids past
    2^22 (group_pairs' lexsort branch)."""
    u = lambda a: np.asarray(a, dtype=np.uint64)  # noqa: E731
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 6, size=3000).astype(np.uint64)
    cols = rng.integers(0, 2 * SLICE_WIDTH, size=3000).astype(np.uint64)
    rng = np.random.default_rng(BUILD_SEED)
    word = np.tile(np.arange(64, 96, dtype=np.uint64) + np.uint64(3 * SLICE_WIDTH), 2)
    big = rng.integers(0, 2, size=300).astype(np.uint64) + np.uint64(1 << 23)
    return {
        "ragged": (np.concatenate([rows, rows[:100], u([2])]),
                   np.concatenate([cols, cols[:100], u([5 * SLICE_WIDTH + 17])])),
        "one_pair": (u([3]), u([SLICE_WIDTH + 40])),
        "one_word": (np.full(64, 9, dtype=np.uint64), rng.permutation(word)),
        "last_bit": (u([0, 1, 1]), u([SLICE_WIDTH - 1, 2 * SLICE_WIDTH - 1, 8 * SLICE_WIDTH - 1])),
        "one_group": (np.full(500, 4, dtype=np.uint64),
                      rng.integers(0, SLICE_WIDTH, size=500).astype(np.uint64)),
        "big_ids": (rng.integers(0, 3, size=300).astype(np.uint64) + np.uint64((1 << 23) + 5),
                    big * np.uint64(SLICE_WIDTH)
                    + rng.integers(0, SLICE_WIDTH, size=300).astype(np.uint64)),
    }


def build_timed_pairs(n: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """The pairs of a timed shape: the path's chunk is the first BULK_CHUNK
    of build_holder's; the others draw rows and columns at random (seeded)
    over g // 4 rows x 4 slices, so every group is hit."""
    if (n, g) == BUILD_TIMED[0]:
        rows, cols = next(holder_slices(1, N_ROWS, BITS_PER_ROW, SEED))
        return rows[:n], cols[:n]
    rng = np.random.default_rng(BUILD_SEED + g)
    return (rng.integers(0, g // 4, size=n).astype(np.uint64),
            rng.integers(0, 4 * SLICE_WIDTH, size=n).astype(np.uint64))


def _keys(rows, cols):
    """group_pairs' table and each sorted pair's key on the card."""
    from pilosa_tpu_torch.bulk import build

    sl, rw, gid, local = build.group_pairs(rows, cols)
    host = gid * SLICE_WIDTH + local
    return sl, rw, host, torch.from_numpy(host).cuda()


def _build_launcher(keys: torch.Tensor, g: int):
    """One build_planes launch into a preallocated arena and its flags
    (the launch alone), and the arena and flags it fills."""
    sched = kernels.build_schedule(g, kernels.sm_count(keys.device))
    buf = torch.empty(g * W + sched["n_blocks"], dtype=torch.int32, device="cuda")
    fn = kernels._fn("build_planes")
    stream = kernels._stream(keys)

    def launch():
        kernels._check(fn(keys.data_ptr(), keys.numel(), buf.data_ptr(), g * W,
                          buf[g * W:].data_ptr(), sched["n_blocks"], stream),
                       "build_planes")

    return launch, buf[:g * W].view(g, W), buf[g * W:]


def build_times(rows, cols) -> dict:
    """build_planes at one shape: the entry point's device time (its
    output allocation included, ``ms``), the launch alone on a preallocated
    arena (``kernel_ms``), the plain version's, the planes' copy to the
    host through pinned and pageable memory, and the bound: the arena
    written once (G x 128 KiB) and the keys read once (8 bytes a pair),
    at 3.35 TB/s."""
    sl, _, host, keys = _keys(rows, cols)
    n, g = len(host), len(sl)
    launch, out, flags = _build_launcher(keys, g)
    launch()
    if not torch.equal(out, kernels.build_planes_plain(keys, g)) or flags.any():
        raise AssertionError(f"build_planes N={n} G={g}: launch alone differs from its plain version")
    pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    nb, by = bound(g * W * 4 + n * 8, n)
    return {"shape": f"N={n} pairs, G={g} groups ({g * W * 4} arena bytes)",
            "ms": cuda_ms(lambda: kernels.build_planes(keys, g)),
            "kernel_ms": cuda_ms(launch),
            "plain_ms": cuda_ms(lambda: kernels.build_planes_plain(keys, g), reps=3),
            "download_pinned_ms": cuda_ms(lambda: pinned.copy_(out)),
            "download_pageable_ms": cuda_ms(lambda: out.cpu()),
            "bound_ms": nb, "bound_by": by}


def _built(keys: torch.Tensor, g: int) -> torch.Tensor:
    """build_planes' planes, its descent flags all clear."""
    planes, descents = kernels.build_planes(keys, g)
    if descents.any():
        raise AssertionError(f"build_planes G={g}: descent flags set on ascending keys")
    return planes


def check_build_planes(diff) -> dict:
    """build_planes == its plain version on the card, exactly, on the edge
    cases, keys outside the arena and the timed shapes; the whole device
    lane (``build_planes_torch``) == the host lane (``build_planes_numpy``);
    unsorted keys set a descent flag and raise; G = 0 launches nothing.
    Returns the kernels line's timings."""
    from pilosa_tpu_torch.bulk import build

    cases = build_cases()
    cases.update({f"timed_{n}x{g}": build_timed_pairs(n, g) for n, g in BUILD_TIMED})
    for name, (rows, cols) in cases.items():
        sl, _, _, keys = _keys(rows, cols)
        diff("build_planes", _built(keys, len(sl)), kernels.build_planes_plain(keys, len(sl)))
        for got, want in zip(build.build_planes_torch(rows, cols, "cuda"),
                             build.build_planes_numpy(rows, cols)):
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(f"build_planes_torch differs from build_planes_numpy: {name}")
    # Keys with repeats and keys outside the arena (dropped), ascending;
    # then unsorted (a descent in the middle and one among the dropped
    # keys past the arena): a flag is set and the caller raises.
    rng = np.random.default_rng(BUILD_SEED)
    k = rng.integers(0, 3 * SLICE_WIDTH, size=5000)
    k = np.concatenate([k, k[:500], [-1, -7, 3 * SLICE_WIDTH, 1 << 40]]).astype(np.int64)
    keys = torch.from_numpy(np.sort(k)).cuda()
    diff("build_planes", _built(keys, 3), kernels.build_planes_plain(keys, 3))
    tail = np.sort(k)
    tail[-2:] = tail[-2:][::-1].copy()
    for bad in (k, tail):
        _, descents = kernels.build_planes(torch.from_numpy(bad).cuda(), 3)
        try:
            kernels.raise_on_descent(descents.cpu().numpy())
        except ValueError:
            continue
        raise AssertionError("build_planes: unsorted keys did not raise")
    before = kernels.LAUNCHES["build_planes"]
    empty = build.build_planes_torch(np.zeros(0, np.uint64), np.zeros(0, np.uint64), "cuda")
    if empty[2].shape != (0, W) or kernels.build_planes(keys[:0], 0)[0].shape != (0, W):
        raise AssertionError("build_planes: G = 0 must give [0, W]")
    if kernels.LAUNCHES["build_planes"] != before:
        raise AssertionError("build_planes: G = 0 launched")
    torch.cuda.synchronize()
    first, *rest = (build_times(*build_timed_pairs(n, g)) for n, g in BUILD_TIMED)
    return {"build_planes": dict(
        first, shapes=rest,
        checked=sorted(cases) + ["out_of_range", "unsorted_raises", "unsorted_tail_raises", "empty"],
        library_ms=None,
        library_note="no PyTorch call computes a scatter-OR (scatter_reduce has no OR)")}


# ---------------------------------------------------------------------------
# phase 6: the bulk door (POST /bulk -> TorchEngine.build_planes)
# ---------------------------------------------------------------------------

# build_holder's pairs go to frame ``fb`` through Client.bulk_stream in
# chunks of 131,072 pairs: 2 MiB on the packed wire (16 bytes a pair),
# half of the chunk wire's default 4 MiB ceiling ([ingest] chunk-bytes).
# In build_holder's order (slice by slice, row by row) that is 250 chunks
# of about 66 (slice, row) groups, one build_planes launch each.
BULK_FRAME = "fb"
BULK_CHUNK = 131072
BULK_SEED = SEED + 16
# The inverse-enabled frame: 4 slices x 64 rows x 64 bits a row, drawn from
# 512 columns a slice, in 4,096-pair chunks (test_bulk.py:333-365's chunk
# size).  An inverse chunk builds one plane per distinct column (the
# inverse view's rows), so the pool bounds its arena (512 planes, 64 MiB).
INV_SLICES, INV_ROWS, INV_BITS, INV_POOL, INV_CHUNK = 4, 64, 64, 512, 4096

# (pairs, groups) of every TorchEngine.build_planes call; one record for
# each bulk chunk the server applies (apply_bulk), holding the (start,
# end) host-clock stamps of its steps; the seconds of every chunk's
# decode and of every transfer's completion.
BULK_SEEN: list = []
BULK_CHUNKS: list = []
BULK_DECODE_S: list = []
BULK_COMPLETE_S: list = []
# The record of the chunk being applied, while apply_bulk runs.
_BULK_OPEN: list = []


def record_bulk_builds() -> None:
    """Time the bulk door's steps inside the server, on the chunks it
    applies: ingest.decode_packed (decode) and ingress.complete_bulk (the
    transfer's completion) by their seconds; within each ingress.apply_bulk
    call, a record of build.group_pairs, kernels.build_planes (with a
    synchronize on each side, so the time from group_pairs' end to the
    launch is the keys' upload, and from the launch's end to
    TorchEngine.build_planes' end the planes' download),
    TorchEngine.build_planes, Fragment.bulk_set_planes (the commit, once
    a slice) and Executor.note_external_write (the write note).
    TorchEngine.build_planes also appends its pairs and groups to
    BULK_SEEN."""
    from pilosa_tpu_torch import ingest
    from pilosa_tpu_torch.bulk import build, ingress
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.engine import TorchEngine
    from pilosa_tpu_torch.executor import Executor

    def stamped(fn, step, sync=False):
        def call(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            if _BULK_OPEN:
                _BULK_OPEN[-1].setdefault(step, []).append((t0, time.perf_counter()))
            return out
        return call

    def seconds(fn, into):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            into.append(time.perf_counter() - t0)
            return out
        return call

    def apply(*a, _fn=ingress.apply_bulk, **k):
        _BULK_OPEN.append({})
        t0 = time.perf_counter()
        try:
            return _fn(*a, **k)
        finally:
            rec = _BULK_OPEN.pop()
            rec["apply"] = [(t0, time.perf_counter())]
            BULK_CHUNKS.append(rec)

    def seen(self, rows, cols, _fn=stamped(TorchEngine.build_planes, "build")):
        out = _fn(self, rows, cols)
        BULK_SEEN.append((len(rows), len(out[0])))
        return out

    ingest.decode_packed = seconds(ingest.decode_packed, BULK_DECODE_S)
    ingress.complete_bulk = seconds(ingress.complete_bulk, BULK_COMPLETE_S)
    ingress.apply_bulk = apply
    build.group_pairs = stamped(build.group_pairs, "group_pairs")
    kernels.build_planes = stamped(kernels.build_planes, "launch", sync=True)
    TorchEngine.build_planes = seen
    Fragment.bulk_set_planes = stamped(Fragment.bulk_set_planes, "commit")
    Executor.note_external_write = stamped(Executor.note_external_write, "note")


def chunk_steps(chunks: list, decode_s: list) -> dict:
    """A chunk's ms by step, from the server's own chunks (one
    group_pairs, launch and build each): decode, group_pairs, upload,
    launch (memset and kernel), download, commit, the write note, and
    ``apply_rest`` (apply_bulk's time less its timed steps: its own
    lines, among them the np.unique of the rows that the note takes);
    median and mean over the chunks, and apply_bulk's whole time."""
    span = lambda r, k: sum(b - a for a, b in r.get(k, ()))  # noqa: E731
    steps = {k: [] for k in ("group_pairs", "upload", "launch", "download", "commit", "note",
                             "apply_rest", "apply")}
    for r in chunks:
        if not all(len(r.get(k, ())) == 1 for k in ("group_pairs", "launch", "build", "apply")):
            raise AssertionError(f"bulk chunk steps: {sorted((k, len(v)) for k, v in r.items())}")
        (g0, g1), (k0, k1), (b0, b1) = r["group_pairs"][0], r["launch"][0], r["build"][0]
        got = {"group_pairs": g1 - g0, "upload": k0 - g1, "launch": k1 - k0, "download": b1 - k1,
               "commit": span(r, "commit"), "note": span(r, "note"), "apply": span(r, "apply")}
        got["apply_rest"] = got["apply"] - sum(v for k, v in got.items() if k != "apply")
        for k, v in got.items():
            steps[k].append(v * 1e3)
    steps["decode"] = [x * 1e3 for x in decode_s]
    return {"median": {k: float(np.median(v)) for k, v in steps.items()},
            "mean": {k: float(np.mean(v)) for k, v in steps.items()},
            "apply_quantiles": [float(np.quantile(steps["apply"], q)) for q in (0, 0.5, 1)]}


def inverse_pairs() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(BULK_SEED)
    rows, cols = [], []
    for s in range(INV_SLICES):
        pool = rng.choice(SLICE_WIDTH, size=INV_POOL, replace=False)
        for r in range(INV_ROWS):
            rows.append(np.full(INV_BITS, r, dtype=np.uint64))
            cols.append(rng.choice(pool, size=INV_BITS, replace=False).astype(np.uint64)
                        + np.uint64(s * SLICE_WIDTH))
    return np.concatenate(rows), np.concatenate(cols)


def _http_query(host: str, pql: str) -> list:
    req = urllib.request.Request(f"http://{host}/index/i/query", data=pql.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        got = json.loads(r.read())["results"]
    # TopN answers as (id, count) pairs, as _norm gives the executor's.
    return [[(p["id"], p["count"]) for p in g] if isinstance(g, list) else g for g in got]


def bulk_path(d: str) -> tuple[dict, dict]:
    """Drive the bulk door of the port's server (default config, engine on
    the card) over the data directory ``d``: build_holder's pairs into
    frame ``fb`` through ``Client.bulk_stream``; then, before any roaring
    materialization (and after main_path's writes to ``f`` are replayed
    into ``fb`` through the same door), a 16-pair Count batch, a Count and a TopN with a src
    on ``fb``, each equal to the same on ``f`` and to the numpy engine's
    answer on ``fb`` (the TopN's: the executor path's numpy answer for
    the same TopN on ``f``, TOPN_ANSWER); every fragment checksum of ``fb`` equal to ``f``'s;
    a small inverse-enabled frame equal in both views to its twin built
    through the streamed ``/ingest`` door; and, where pyarrow is present,
    the Arrow export of ``fb``'s slice 0 re-ingested through ``/bulk``
    exporting the same bytes.  Returns the "bulk" line and the launches of
    the build and of the reads."""
    from pilosa_tpu_torch import ingest
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.server.client import Client, ClientError
    from pilosa_tpu_torch.server.server import Server

    t_phase = time.perf_counter()
    parts = list(holder_slices(N_SLICES, N_ROWS, BITS_PER_ROW, SEED))
    rows = np.concatenate([r for r, _ in parts])
    cols = np.concatenate([c for _, c in parts])
    del parts
    gen_s = time.perf_counter() - t_phase
    n_chunks = -(-len(rows) // BULK_CHUNK)
    srv = Server(Config(data_dir=d, host="127.0.0.1:0"))
    srv.open()
    try:
        eng = srv.executor.engine
        if eng.name != "torch" or eng.device.type != "cuda":
            raise AssertionError(f"server engine is {eng.name} on {eng.device}")
        c = Client(srv.host)
        c.create_frame("i", BULK_FRAME)
        n_seen, n_chunk, n_decode, n_complete = (len(BULK_SEEN), len(BULK_CHUNKS), len(BULK_DECODE_S),
                                                 len(BULK_COMPLETE_S))
        up0 = eng.stat_upload_bytes
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = c.bulk_stream("i", BULK_FRAME, rows, cols, chunk_pairs=BULK_CHUNK)
        send_s = time.perf_counter() - t0
        launches = {"bulk": dict(kernels.LAUNCHES)}
        builds = BULK_SEEN[n_seen:]
        steps = chunk_steps(BULK_CHUNKS[n_chunk:], BULK_DECODE_S[n_decode:])
        complete_s = sum(BULK_COMPLETE_S[n_complete:])
        if not out.get("done") or out.get("ops") != len(rows):
            raise AssertionError(f"bulk stream: {out}")
        if launches["bulk"]["build_planes"] != n_chunks or len(builds) != n_chunks:
            raise AssertionError(f"bulk: {launches['bulk']['build_planes']} build_planes launches, "
                                 f"{len(builds)} builds for {n_chunks} chunks")
        upload = eng.stat_upload_bytes - up0
        # The executor path's writes to f, replayed into fb through the door.
        if F_WRITES:
            wr, wc = (np.array(x, dtype=np.uint64) for x in zip(*F_WRITES))
            c.bulk_stream("i", BULK_FRAME, wr, wc, chunk_pairs=BULK_CHUNK)

        # Reads of the overlay, before any roaring materialization.
        ex_ref = Executor(srv.holder, engine="numpy")
        fb_view = srv.holder.index("i").frame(BULK_FRAME).view("standard")
        f_view = srv.holder.index("i").frame("f").view("standard")
        rng = np.random.default_rng(BULK_SEED)
        pairs = rng.integers(0, N_ROWS, size=(GATHER_BATCH, 2))
        r0, _r1 = (int(x) for x in rng.integers(0, N_ROWS, size=2))
        requests = {
            "pairs": lambda fr: [f"Count(Intersect({_bm(a, fr)}, {_bm(b, fr)}))" for a, b in pairs],
            "count": lambda fr: [f"Count({_bm(r0, fr)})"],
            # The executor path's TopN (src row 0): its numpy answer on f
            # (TOPN_ANSWER) is fb's, whose bits are f's (checksums below).
            "topn": lambda fr: [f'TopN({_bm(0, fr)}, frame="{fr}", n=10)'],
        }
        reads = []
        t_reads = time.perf_counter()
        kernels.reset_launches()
        for name, calls in requests.items():
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            got = _http_query(srv.host, " ".join(calls(BULK_FRAME)))
            ms = (time.perf_counter() - t0) * 1e3
            launched = {k: kernels.LAUNCHES[k] - before[k] for k in before
                        if kernels.LAUNCHES[k] > before[k]}
            t0 = time.perf_counter()
            on_f = _http_query(srv.host, " ".join(calls("f")))
            f_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            if name == "topn" and TOPN_ANSWER and calls("f") == [TOPN_PQL]:
                want, numpy_ms = TOPN_ANSWER, None
            else:
                want = _norm(ex_ref.execute("i", " ".join(calls(BULK_FRAME))))
                numpy_ms = (time.perf_counter() - t0) * 1e3
            if got != on_f or got != want:
                raise AssertionError(f"bulk {name}: fb {got[:4]} vs f {on_f[:4]} vs numpy {want[:4]}")
            if not launched:
                raise AssertionError(f"bulk {name}: no kernel launched")
            reads.append({"request": name, "ms": ms, "f_ms": f_ms, "numpy_ms": numpy_ms,
                          "checked": len(got), "launches": launched})
        launches["bulk_reads"] = dict(kernels.LAUNCHES)
        reads_s = time.perf_counter() - t_reads
        lazy = sum(1 for s in fb_view.fragments if fb_view.fragment(s)._bulk_planes)
        if lazy != N_SLICES:
            raise AssertionError(f"bulk: {N_SLICES - lazy} fragments of fb materialized by reads")

        t0 = time.perf_counter()
        if sorted(fb_view.fragments) != sorted(f_view.fragments) or len(f_view.fragments) != N_SLICES:
            raise AssertionError(f"bulk: fb slices {sorted(fb_view.fragments)}")
        diff = [s for s in sorted(f_view.fragments)
                if fb_view.fragment(s).checksum() != f_view.fragment(s).checksum()]
        if diff:
            raise AssertionError(f"bulk: fb checksums differ from f's in slices {diff}")
        checksum_s = time.perf_counter() - t0

        # The inverse-enabled frame against its twin through /ingest.
        t0 = time.perf_counter()
        ir, ic = inverse_pairs()
        for fr in ("fi", "fs"):
            c.create_frame("i", fr, {"inverseEnabled": True})
        before = kernels.LAUNCHES["build_planes"]
        c.bulk_stream("i", "fi", ir, ic, chunk_pairs=INV_CHUNK)
        inv_launches = kernels.LAUNCHES["build_planes"] - before
        if inv_launches != 2 * -(-len(ir) // INV_CHUNK):
            raise AssertionError(f"bulk inverse: {inv_launches} build_planes launches")
        c.ingest_stream("i", "fs", ir, ic, chunk_pairs=INV_CHUNK)
        idx = srv.holder.index("i")
        inverse = {"pairs": len(ir), "chunks": -(-len(ir) // INV_CHUNK), "launches": inv_launches}
        for vname in ("standard", "inverse"):
            vb, vs = idx.frame("fi").view(vname), idx.frame("fs").view(vname)
            if sorted(vb.fragments) != sorted(vs.fragments) or not vb.fragments:
                raise AssertionError(f"bulk inverse {vname}: {sorted(vb.fragments)} vs {sorted(vs.fragments)}")
            bad = [s for s in vb.fragments if vb.fragment(s).checksum() != vs.fragment(s).checksum()]
            if bad:
                raise AssertionError(f"bulk inverse {vname}: checksums differ in slices {bad}")
            inverse[f"{vname}_fragments"] = len(vb.fragments)
        inverse["s"] = time.perf_counter() - t0

        # The Arrow round trip, where pyarrow is importable.
        t0 = time.perf_counter()
        if ingest.arrow_available():
            a = c.export_arrow("i", BULK_FRAME, "standard", 0)
            c.create_frame("i", "fr")
            r2, c2 = ingest.decode_arrow(a)
            c.bulk_stream("i", "fr", r2, c2, chunk_pairs=BULK_CHUNK, arrow=True)
            if c.export_arrow("i", "fr", "standard", 0) != a:
                raise AssertionError("bulk arrow: the re-ingested export differs")
            arrow = {"case": "pyarrow present: export, re-ingest, export byte-identical",
                     "bytes": len(a), "pairs": len(r2)}
        else:
            try:
                c.export_arrow("i", BULK_FRAME, "standard", 0)
            except ClientError as e:
                if e.status != 415:
                    raise
            else:
                raise AssertionError("bulk arrow: export answered without pyarrow")
            arrow = {"case": "no pyarrow: the Arrow export answered 415, round trip not run"}
        arrow["s"] = time.perf_counter() - t0
        print(f"arrow: {arrow['case']}", flush=True)
        t0 = time.perf_counter()
    finally:
        srv.close()
    close_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # group_pairs on the first chunks again, with the server closed: the
    # sort's own time beside its time inside the server (chunk_steps).
    from pilosa_tpu_torch.bulk import build

    idle = []
    for i in range(10):
        t0 = time.perf_counter()
        build.group_pairs(rows[i * BULK_CHUNK:(i + 1) * BULK_CHUNK], cols[i * BULK_CHUNK:(i + 1) * BULK_CHUNK])
        idle.append((time.perf_counter() - t0) * 1e3)
    groups = [g for _, g in builds]
    line = {
        "pairs": len(rows), "chunks": n_chunks, "chunk_pairs": BULK_CHUNK,
        "build_planes_launches": launches["bulk"]["build_planes"],
        "pairs_per_s": len(rows) / send_s, "send_s": send_s,
        "chunk_ms": send_s / n_chunks * 1e3, "complete_s": complete_s,
        "apply_ms": steps["apply_quantiles"],
        "chunk_steps_ms": {"median": steps["median"], "mean": steps["mean"]},
        "group_pairs_idle_ms": float(np.median(idle)),
        "groups_per_chunk": [min(groups), float(np.mean(groups)), max(groups)],
        "wire_bytes": 8 * n_chunks + 16 * len(rows), "upload_bytes": upload,
        "download_bytes": sum(groups) * W * 4,
        "reads": reads, "reads_s": reads_s, "checksum_s": checksum_s, "close_s": close_s, "slices_equal": N_SLICES,
        "inverse": inverse, "arrow": arrow, "gen_s": gen_s, "replayed_writes": len(F_WRITES),
        "phase_s": time.perf_counter() - t_phase,
    }
    return line, launches


# ---------------------------------------------------------------------------
# phase 8: the mesh (parallel/, MeshEngine, the lockstep service)
# ---------------------------------------------------------------------------

# Two lockstep ranks share the one card (gloo: NCCL refuses two ranks on
# one device), each holding its half of the slice axis.
MESH_RANKS = 2
MESH_SEED = SEED + 18
# The lockstep job's bulk load (8 chunks of BULK_CHUNK pairs over 64 rows)
# goes to frame fm; the NCCL rank's, through the MeshEngine in process,
# to fw.  The single-GPU path loads the same pairs into the smoke's own
# holder's fm (the lockstep job's reference).
MESH_BULK_FRAME, MESH_WS1_BULK_FRAME = "fm", "fw"
# The frames the lockstep ranks' copies of the data directory hold.
MESH_FRAMES = ("f", "t", MESH_BULK_FRAME)
# The mesh phase's depth: its holder (the NCCL rank's, the single-GPU
# reference's and the ranks' copies) keeps f's and t's first 16 of the
# 64 slices, int32[8, 256, 32768] a rank, so that the fleet phase after
# it fits the script's time (at 32 slices the script took 1,081.5 s on
# one H100 host, against a 1,200 s budget); every width is the paths' own.
MESH_SLICES = 16
MESH_BULK_CHUNKS, MESH_BULK_ROWS = 8, 64
# The gather batch names 16 distinct rows: its fresh pool holds 16, two
# per pair, so dispatch takes the gather kernel.
MESH_GATHER_PAIRS = 8
# Rows the collective self-check (POST /debug/mesh-check) names.
MESH_CHECK_ROWS = 16
# Queries of each mesh request held against the numpy engine (the whole
# answer is held against the single-GPU executor's).
MESH_SUBSET = 4
# The kernels the mesh path runs ("yes" in PERF.md's table): each must
# launch on every rank.
MESH_KERNELS = ("count_rows", "resident_count2", "gather_count2", "gather_src_counts",
                "gather_count_multi_mixed", "resident_count_multi", "gather_count_tree",
                "resident_count_tree", "topn_counts", "pair_gram", "build_planes")
# main_path's TopN (checked there against the numpy engine): f is not
# written between it and the fleet phase, whose groups hold all 64 slices,
# so the fleet's TopN is held to the same answer without a second numpy
# TopN (the mesh, at MESH_SLICES, takes its own).
TOPN_PQL = 'TopN(Bitmap(rowID=0, frame="f"), frame="f", n=10)'
TOPN_ANSWER: list = []
# Batches the MeshEngine hands the dispatch entries and kernels during the
# NCCL rank's requests (while _MESH_REC[0]), rebuilt at the two-rank
# shard shape for the plain-version checks.
MESH_BATCHES: list = []
_MESH_REC = [False]


def record_mesh_batches() -> None:
    """Wrap the entries the MeshEngine calls so that, while _MESH_REC[0]
    is set, each call appends its kind, matrix rows and ids to
    MESH_BATCHES."""
    from pilosa_tpu_torch.ops import dispatch

    def wrap(mod, name, rec):
        fn = getattr(mod, name)

        def call(*a, **k):
            if _MESH_REC[0]:
                MESH_BATCHES.append(rec(*a))
            return fn(*a, **k)
        setattr(mod, name, call)

    wrap(dispatch, "gather_count", lambda op, m, p: ("pair", op, m.shape[1], np.array(p, np.int32)))
    wrap(dispatch, "gather_count_multi",
         lambda op, m, ix: ("multi", op, m.shape[1], np.array(ix, np.int32)))
    wrap(dispatch, "gather_count_multi_mixed",
         lambda m, groups, row_major=False: ("mixed", None, m.shape[1],
                            tuple((op, np.array(ix, np.int32)) for op, ix in groups)))
    wrap(dispatch, "gather_count_tree",
         lambda m, lv, oc: ("tree", None, m.shape[1], (np.array(lv, np.int32), np.array(oc, np.int32))))
    wrap(dispatch, "topn_scorer_counts", lambda m, pos, s: ("scorer", None, m.shape[1],
                                                            np.array(pos, np.int32)))
    wrap(dispatch, "count", lambda x: ("count", None, tuple(x.shape), None))
    wrap(dispatch, "batch_intersection_count", lambda r, s: ("count_src", None, tuple(r.shape), None))
    wrap(kernels, "pair_gram", lambda m: ("gram", None, m.shape[1], None))
    wrap(kernels, "topn_counts", lambda m, s: ("topn", None, m.shape[1], None))


def mesh_requests(n_rows: int, time_rows: int) -> list:
    """(name, calls, executor flavour, kernels it must launch) in order:
    a gather batch (no Gram), a cold and a warm pair batch (resident,
    then the Gram), an N-ary batch (the gather fold), the HTTP path's
    range-wide batch (the staged fold; its range-1, whose cold Range
    matrix takes 7-13 s a run, is left out), nested trees (gather and
    staged), and a TopN with a src."""
    rng = np.random.default_rng(MESH_SEED)
    gather = rng.permutation(n_rows)[: 2 * MESH_GATHER_PAIRS].reshape(-1, 2)
    pairs = rng.integers(0, n_rows, size=(PAIR_BATCH, 2))
    pairs[:, 0] = np.resize(rng.permutation(n_rows), PAIR_BATCH)
    op, idx = nary_requests(n_rows)["nary-or"]
    _one, _two, wide = range_requests(time_rows)
    return [
        ("gather", _pair_calls(("xor", "and"), gather), "nogram", ("gather_count2",)),
        ("pairs cold", _pair_calls(("and",), pairs), "gram", ("resident_count2",)),
        ("pairs warm", _pair_calls(("or",), pairs), "gram", ("pair_gram",)),
        ("nary", [f"Count({PQL_OPS[op]}({', '.join(_bm(r) for r in ids)}))" for ids in idx],
         "gram", ("gather_count_multi_mixed",)),
        ("range-wide", [_range_call(r, sp) for r, sp in wide], "gram", ("resident_count_multi",)),
        ("tree", [_tree_call(rng, n_rows, i) for i in range(FOLD_BATCH)], "gram",
         ("gather_count_tree",)),
        ("tree-hot", [_tree_call(rng, TREE_HOT_ROWS, i) for i in range(TREE_WIDE_BATCH)], "gram",
         ("resident_count_tree",)),
        ("topn", [TOPN_PQL], "gram", ("gather_src_counts",)),
    ]


def mesh_bulk_pairs(n_slices: int = MESH_SLICES) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(MESH_SEED + 1)
    n = MESH_BULK_CHUNKS * BULK_CHUNK
    return (rng.integers(0, MESH_BULK_ROWS, size=n).astype(np.uint64),
            rng.integers(0, n_slices * SLICE_WIDTH, size=n).astype(np.uint64))


def mesh_check_want(h, rows, src) -> dict:
    """The collective self-check's answers on the host (numpy) over every
    slice of ``h``'s frame f."""
    from pilosa_tpu_torch.ops.bitwise import np_popcount

    n = h.index("i").max_slice() + 1
    block = np.zeros((n, len(rows), W), dtype=np.uint32)
    srcb = np.zeros((n, W), dtype=np.uint32)
    for s in range(n):
        frag = h.fragment("i", "f", "standard", s)
        for k, r in enumerate(rows):
            block[s, k] = frag.row_dense(r)
        srcb[s] = frag.row_dense(src)
    pc = lambda x: np_popcount(x).astype(np.int64)  # noqa: E731
    scorer = pc(block & srcb[:, None]).sum(axis=2)
    k = len(rows)
    first = block[:, 0]
    return {
        "slices": n, "rows": list(rows), "src": src,
        "topn": scorer.sum(axis=0).tolist(), "scorer": scorer.tolist(),
        "pairs": [int(pc(block[:, i] & block[:, (i + 1) % k]).sum()) for i in range(k)],
        "fold_or": [int(pc(np.bitwise_or.reduce(block, axis=1)).sum())],
        "count": {"and": int(pc(first & srcb).sum()), "or": int(pc(first | srcb).sum()),
                  "xor": int(pc(first ^ srcb).sum()), "andnot": int(pc(first & ~srcb).sum())},
    }


def _check_numpy(name, got, calls, ex_ref, rng, topn=None) -> int:
    """A seeded subset of MESH_SUBSET of the answers ``got`` to ``calls``
    == the numpy engine ``ex_ref``'s; returns the answers checked.  The
    TopN (TOPN_PQL) is held in full to ``topn``, its numpy answer on the
    same holder, computed once by the caller."""
    if calls == [TOPN_PQL]:
        if not topn or got != topn:
            raise AssertionError(f"{name}: {got} vs the numpy engine's {topn}")
        return 1
    if calls[0].startswith("SetBit"):
        # The write already landed on the reference holder (the single-GPU
        # executor shares it): hold the reads that follow it.
        want = _norm(ex_ref.execute("i", " ".join(calls[1:])))
        if got[1:] != want:
            raise AssertionError(f"{name}: {got} vs the numpy engine's {want}")
        return len(want)
    sub = sorted(rng.choice(len(calls), size=min(MESH_SUBSET, len(calls)), replace=False).tolist())
    want = _norm(ex_ref.execute("i", " ".join(calls[i] for i in sub)))
    if [got[i] for i in sub] != want:
        raise AssertionError(f"{name}: differs from the numpy engine")
    return len(sub)


def _timed(ex, pql: str):
    t0 = time.perf_counter()
    got = _norm(ex.execute("i", pql))
    torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) * 1e3


def _bulk_in_process(ex, frame: str, rows, cols) -> float:
    """Load (rows, cols) into ``frame`` through the bulk door's commit
    (ingress.apply_bulk, BULK_CHUNK pairs a call, then the completion)
    with ``ex``'s engine; returns the ms."""
    from pilosa_tpu_torch.bulk import ingress

    fr = ex.holder.index("i").frame(frame)
    t0 = time.perf_counter()
    for i in range(0, len(rows), BULK_CHUNK):
        ingress.apply_bulk(fr, rows[i:i + BULK_CHUNK], cols[i:i + BULK_CHUNK],
                           engine=ex.engine, executor=ex, index="i")
    ingress.complete_bulk(fr, 0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def mesh_nccl_path(h) -> tuple[dict, dict, dict]:
    """One NCCL rank (world size 1) in this process: Executor(h,
    engine=MeshEngine) drives mesh_requests beside the single-GPU
    executor on the same holder, the collective self-check runs through
    the lockstep service's own method, and a bulk load goes through the
    MeshEngine.  Every answer equals the single-GPU path's and the numpy
    engine's.  Returns the record (per request: mesh wall ms, its kernel
    step's and collectives' ms between synchronizations, the single-GPU
    ms, the launches), the mesh-only launches, and each request's
    single-GPU answer and ms by name."""
    from datetime import timedelta

    import torch.distributed as dist

    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.engine import MeshEngine
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel.service import LockstepService
    from pilosa_tpu_torch.parallel.sharded import SliceMesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                            rank=0, timeout=timedelta(seconds=300))
    try:
        mesh = SliceMesh(device="cuda", timing=True)
        if mesh.backend != "nccl" or mesh.n_devices != 1:
            raise AssertionError(f"mesh: backend {mesh.backend}, {mesh.n_devices} ranks")
        engines = {"gram": MeshEngine(mesh), "nogram": MeshEngine(mesh)}
        ex = {"gram": Executor(h, engine=engines["gram"]),
              "nogram": Executor(h, engine=engines["nogram"], no_gram=True)}
        single = {"gram": Executor(h), "nogram": Executor(h, no_gram=True)}
        ex_ref = Executor(h, engine="numpy")
        rng = np.random.default_rng(MESH_SEED + 2)
        launches = dict.fromkeys(kernels.KERNELS, 0)
        records, answers = [], {}

        def on_mesh(fn, eng):
            before = dict(kernels.LAUNCHES)
            l0, c0, n0 = eng.stat_local_s, eng.mesh.stat_collective_s, eng.mesh.stat_collectives
            _MESH_REC[0] = True
            try:
                out = fn()
            finally:
                _MESH_REC[0] = False
            got = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] > before[k]}
            for k, n in got.items():
                launches[k] += n
            return out, {"local_ms": (eng.stat_local_s - l0) * 1e3,
                         "collective_ms": (eng.mesh.stat_collective_s - c0) * 1e3,
                         "collectives": eng.mesh.stat_collectives - n0, "launches": got}

        topn = []
        for name, calls, flavour, expect in mesh_requests(N_ROWS, TIME_ROWS):
            pql = " ".join(calls)
            (got, ms), rec = on_mesh(lambda: _timed(ex[flavour], pql), engines[flavour])
            single_got, single_ms = _timed(single[flavour], pql)
            if got != single_got:
                raise AssertionError(f"mesh {name}: differs from the single-GPU path: "
                                     f"{got[:4]} vs {single_got[:4]}")
            t = time.perf_counter()
            if calls == [TOPN_PQL]:
                # The numpy engine's TopN on this holder (the executor
                # path's is over all 64 slices).
                topn = _norm(ex_ref.execute("i", TOPN_PQL))
            checked = _check_numpy(f"mesh {name}", got, calls, ex_ref, rng, topn)
            numpy_ms = (time.perf_counter() - t) * 1e3
            answers[name] = (single_got, single_ms)
            for k in expect:
                if not rec["launches"].get(k):
                    raise AssertionError(f"mesh {name}: expected {k} to launch, launches {rec['launches']}")
            if not rec["collectives"]:
                raise AssertionError(f"mesh {name}: no collective ran")
            records.append(dict(request=name, ms=ms, single_ms=single_ms, checked=checked,
                                numpy_ms=numpy_ms, **rec))

        # The collective self-check, through the service's own method on
        # this rank (the lockstep job runs it on every rank).
        svc = LockstepService(h, control_addr=("127.0.0.1", 0), device="cuda")
        spec = {"frame": "f", "rows": list(range(MESH_CHECK_ROWS)), "src": 0}
        t0 = time.perf_counter()
        got, rec = on_mesh(lambda: svc._do_mesh_check("i", json.dumps(spec)), svc.engine)
        ms = (time.perf_counter() - t0) * 1e3
        t = time.perf_counter()
        want = answers["mesh-check"] = mesh_check_want(h, spec["rows"], spec["src"])
        if any(got[k] != want[k] for k in want):
            raise AssertionError(f"mesh-check: {got} vs numpy {want}")
        records.append(dict(request="mesh-check", ms=ms, single_ms=None, checked=1,
                            numpy_ms=(time.perf_counter() - t) * 1e3, **rec))

        # A bulk load through the MeshEngine (fw), against the same pairs
        # through the single-GPU engine (the smoke's fm, the lockstep
        # job's reference).
        idx = h.index("i")
        idx.create_frame(MESH_WS1_BULK_FRAME, FrameOptions())
        rows, cols = mesh_bulk_pairs()
        ms, rec = on_mesh(lambda: _bulk_in_process(ex["gram"], MESH_WS1_BULK_FRAME, rows, cols),
                          engines["gram"])
        single_ms = _bulk_in_process(single["gram"], MESH_BULK_FRAME, rows, cols)
        # Row for row on the dense reads, which merge the overlays without
        # materializing them.
        t = time.perf_counter()
        fw = idx.frame(MESH_WS1_BULK_FRAME).view("standard")
        fm = idx.frame(MESH_BULK_FRAME).view("standard")
        if sorted(fw.fragments) != sorted(fm.fragments) or any(
                not np.array_equal(fw.fragment(s).row_dense(r), fm.fragment(s).row_dense(r))
                for s in fm.fragments for r in range(MESH_BULK_ROWS)):
            raise AssertionError("mesh bulk: fw's rows differ from the single-GPU load's")
        records.append(dict(request=f"bulk {len(rows)} pairs", ms=ms, single_ms=single_ms,
                            checked=len(fm.fragments), numpy_ms=(time.perf_counter() - t) * 1e3,
                            **rec))
        missing = [k for k in MESH_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"mesh (NCCL, 1 rank): kernels never launched: {missing}")
        out = {"backend": mesh.backend, "ranks": 1, "requests": records,
               "collectives": mesh.stat_collectives}
    finally:
        dist.destroy_process_group()
    del ex, single, engines
    torch.cuda.empty_cache()
    return out, launches, answers


def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _lockstep_ranks(dirs: list, http: int) -> list:
    """Start the job as ``pilosa_tpu_torch.cli lockstep`` starts it on each
    rank (one process a rank, its own copy of the data directory; the
    card's default engine), with the per-batch timing on; stdout and
    stderr to files."""
    root = os.path.dirname(os.path.abspath(__file__))
    control, coord = _free_port(), _free_port()
    env = dict(os.environ, PILOSA_TPU_MESH_TIMING="1")
    env.pop("PILOSA_ENGINE", None)
    procs = []
    for r, d in enumerate(dirs):
        out, err = open(d + ".out", "w+"), open(d + ".err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "lockstep", "--data-dir", d,
             "--host", f"127.0.0.1:{http}", "--control", f"127.0.0.1:{control}",
             "--coordinator", f"127.0.0.1:{coord}", "--num-processes", str(len(dirs)),
             "--process-id", str(r)],
            cwd=root, env=env, stdout=out, stderr=err, text=True), out, err))
    return procs


def _rank_tail(procs) -> str:
    tails = []
    for r, (_, out, err) in enumerate(procs):
        for f in (out, err):
            f.flush()
            f.seek(0)
            tails.append(f"rank {r}: {f.read()[-3000:]}")
    return "\n".join(tails)


def mesh_lockstep_path(procs: list, http: int, t_start: float, dirs: list, h,
                       answers: dict) -> tuple[dict, list]:
    """Two lockstep ranks on the one card over the copies ``dirs`` of the
    data directory: the requests of mesh_requests, the collective
    self-check, a SetBit and a Count, and a bulk load of 8 chunks through
    rank 0's HTTP door.  Each of mesh_requests' answers equals in full the
    single-GPU executor's answer in the NCCL phase (``answers``: name ->
    (answer, ms), itself held to the numpy engine there); the later ones
    equal the single-GPU executor's on ``h`` (which replays the same
    writes) and the numpy engine's.  At the end the ranks' holders digest
    alike.  Returns the record and each rank's launches."""
    import signal

    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.server.client import Client

    single = {"gram": Executor(h), "nogram": Executor(h, no_gram=True)}
    ex_ref = Executor(h, engine="numpy")
    rng = np.random.default_rng(MESH_SEED + 3)
    host = f"127.0.0.1:{http}"
    records, lines = [], []
    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                with urllib.request.urlopen(f"http://{host}/status", timeout=5) as r:
                    status = json.loads(r.read())["status"]
                break
            except OSError:
                if time.monotonic() > deadline or any(p.poll() is not None for p, _, _ in procs):
                    raise AssertionError(f"lockstep job never served:\n{_rank_tail(procs)}")
                time.sleep(0.5)
        start_s = time.perf_counter() - t_start
        if status["ranks"] != len(dirs):
            raise AssertionError(f"lockstep status: {status}")

        def run(name, calls, flavour="gram"):
            pql = " ".join(calls)
            t = time.perf_counter()
            got = _http_query(host, pql)
            ms = (time.perf_counter() - t) * 1e3
            if name in answers:
                single_got, single_ms = answers[name]
                if got != single_got:
                    raise AssertionError(f"lockstep {name}: differs from the single-GPU path")
                checked = len(calls)
            else:
                single_got, single_ms = _timed(single[flavour], pql)
                if got != single_got:
                    raise AssertionError(f"lockstep {name}: differs from the single-GPU path")
                checked = _check_numpy(f"lockstep {name}", got, calls, ex_ref, rng)
            records.append({"request": name, "q": pql[:60], "ms": ms, "single_ms": single_ms,
                            "checked": checked})

        for name, calls, flavour, _expect in mesh_requests(N_ROWS, TIME_ROWS):
            # The lockstep executor keeps its Gram: its gather batch comes
            # first, on a fresh pool, where dispatch gathers.
            run(name, calls, flavour)
        spec = {"rows": list(range(MESH_CHECK_ROWS)), "src": 0}
        t = time.perf_counter()
        req = urllib.request.Request(
            f"http://{host}/debug/mesh-check?index=i&frame=f&src=0&rows="
            + ",".join(map(str, spec["rows"])), data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            got = json.loads(r.read())
        ms = (time.perf_counter() - t) * 1e3
        want = answers["mesh-check"]  # f is as the NCCL rank read it
        if got["ranks"] != len(dirs) or any(got[k] != want[k] for k in want):
            raise AssertionError(f"lockstep mesh-check: {got} vs numpy {want}")
        records.append({"request": "mesh-check", "q": "\x00mesh-check\x00"[:60], "ms": ms,
                        "single_ms": None, "checked": 1})
        # A write and a read of it: replayed on every rank and on h.
        a, b = (int(x) for x in rng.integers(0, N_ROWS, size=2))
        col = int(rng.integers(0, MESH_SLICES * SLICE_WIDTH))
        run("setbit+count", [f'SetBit(rowID={a}, frame="f", columnID={col})',
                             f"Count(Intersect({_bm(a)}, {_bm(b)}))"])
        # The bulk load through rank 0's door; the single-GPU reference
        # loaded the same pairs into h's fm in the NCCL phase.
        rows, cols = mesh_bulk_pairs()
        t = time.perf_counter()
        out = Client(host).bulk_stream("i", MESH_BULK_FRAME, rows, cols, chunk_pairs=BULK_CHUNK)
        ms = (time.perf_counter() - t) * 1e3
        if not out.get("done"):
            raise AssertionError(f"lockstep bulk: {out}")
        records.append({"request": f"bulk {len(rows)} pairs", "q": "\x00bulk-apply\x00", "ms": ms,
                        "single_ms": None, "checked": 0})
        run("bulk counts", [f'Count(Bitmap(rowID={r}, frame="{MESH_BULK_FRAME}"))'
                            for r in range(MESH_BULK_ROWS)])
        # Shut the job down as an operator would: SIGINT to rank 0.
        procs[0][0].send_signal(signal.SIGINT)
        for p, out_f, _ in procs:
            p.wait(timeout=300)
            if p.returncode:
                raise AssertionError(f"lockstep rank exited {p.returncode}:\n{_rank_tail(procs)}")
            out_f.flush()
            out_f.seek(0)
            lines.append(json.loads(out_f.read().strip().splitlines()[-1]))
    finally:
        for p, out_f, err_f in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
            out_f.close()
            err_f.close()
    # Each rank digests its holder as it exits (its exit line).
    digests = [ln["digest"] for ln in lines]
    if len(set(digests)) != 1:
        raise AssertionError(f"lockstep ranks' holders differ: {digests}")
    # Each rank's batch log, matched to the requests in order (a bulk load
    # is its chunks' entries and the completion's).
    for ln in lines:
        log = list(ln["batch_log"])
        for rec in records:
            mine = []
            while log and (log[0]["q"].startswith(rec["q"][:40]) or (
                    rec["q"].startswith("\x00bulk") and log[0]["q"].startswith("\x00bulk"))):
                mine.append(log.pop(0))
                if not rec["q"].startswith("\x00bulk"):
                    break
            if not mine:
                raise AssertionError(f"rank {ln['lockstep_rank']}: no batch for {rec['request']}")
            rec.setdefault("ranks", []).append({
                "batches": len(mine), "ms": sum(m["ms"] for m in mine),
                "local_ms": sum(m["local_ms"] for m in mine),
                "collective_ms": sum(m["collective_ms"] for m in mine),
                "collectives": sum(m["collectives"] for m in mine),
                "launches": {k: sum(m["launches"].get(k, 0) for m in mine)
                             for k in {k for m in mine for k in m["launches"]}},
            })
        if log:
            raise AssertionError(f"rank {ln['lockstep_rank']}: unmatched batches {log[:2]}")
    for rec in records:
        rec.pop("q")
    by_rank = [ln["launches"] for ln in lines]
    for r, got in enumerate(by_rank):
        missing = [k for k in MESH_KERNELS if not got.get(k)]
        if missing:
            raise AssertionError(f"lockstep rank {r}: kernels never launched: {missing} ({got})")
    return ({"backend": "gloo", "ranks": len(dirs), "served_after_s": start_s,
             "digests_equal": True, "requests": records,
             "collectives": [ln["collectives"] for ln in lines],
             "note": "two ranks share one card: no multi-GPU speed"}, by_rank)


def check_shard_kernels() -> dict:
    """Every kernel the mesh path launched, held exactly against its plain
    version at the two-rank shard's shapes ([MESH_SLICES / MESH_RANKS, R,
    W], this phase's, and [N_SLICES / MESH_RANKS, R, W], the whole data's;
    random words) with each batch the NCCL rank's requests handed it."""
    checked: dict = {}
    shards = sorted({MESH_SLICES // MESH_RANKS, N_SLICES // MESH_RANKS})
    for s in shards:
        _check_shard(s, checked)
        torch.cuda.empty_cache()
    return {"shards": [[s, "R", W] for s in shards], "batches": checked}


def _check_shard(s: int, checked: dict) -> None:
    from pilosa_tpu_torch.ops import dispatch

    gen = _gen(MESH_SEED)
    mats: dict = {}

    def mat(r):
        if r not in mats:
            mats[r] = _rand_words(gen, (s, r, W))
        return mats[r]

    src = _rand_words(gen, (s, W))
    seen = set()
    for kind, op, r, ids in MESH_BATCHES:
        if kind == "mixed":
            raw = b"".join(op.encode() + ix.tobytes() for op, ix in ids)
        else:
            raw = b"" if ids is None else b"".join(np.ascontiguousarray(x).tobytes()
                                                  for x in (ids if kind == "tree" else (ids,)))
        key = (kind, op, r, raw)
        if key in seen:
            continue
        seen.add(key)
        # Each entry against the plain version of the kernel it picks (the
        # staged and gather variants share one plain version).
        if kind == "pair":
            got = dispatch.gather_count(op, mat(r), ids)
            want = kernels.gather_count2_plain(op, mat(r), ids)
        elif kind == "multi":
            got = dispatch.gather_count_multi(op, mat(r), ids)
            want = _chunked(lambda ix: kernels.gather_count_multi_plain(op, mat(r), ix), ids)
        elif kind == "mixed":
            got = dispatch.gather_count_multi_mixed(mat(r), ids)
            want = torch.cat([_chunked(lambda ix, _op=op: kernels.gather_count_multi_plain(_op, mat(r), ix),
                                       idx) for op, idx in ids])
        elif kind == "tree":
            lv, oc = ids
            got = dispatch.gather_count_tree(mat(r), lv, oc)
            want = _chunked(lambda a, b: kernels.gather_count_tree_plain(mat(r), a, b), lv, oc)
        elif kind == "scorer":
            got = dispatch.topn_scorer_counts(mat(r), ids, src)
            want = kernels.gather_src_counts_plain(mat(r), ids, src)
        elif kind == "gram":
            got, want = kernels.pair_gram(mat(r)), kernels.pair_gram_plain(mat(r))
        elif kind == "topn":
            got, want = kernels.topn_counts(mat(r), src), kernels.topn_counts_plain(mat(r), src)
        elif kind == "count":
            a = _rand_words(gen, (s,) + tuple(r[1:]) if r[0] == MESH_SLICES else r)
            got, want = dispatch.count(a), kernels.count_rows_plain(a.reshape(-1, a.shape[-1]))
        elif kind == "count_src":
            a = _rand_words(gen, r)
            got = dispatch.batch_intersection_count(a, src[0])
            want = kernels.count_rows_plain(a.reshape(-1, a.shape[-1]), src[0], "and")
        else:
            raise AssertionError(kind)
        if not torch.equal(got.long().cpu(), want.long().cpu()):
            raise AssertionError(f"shard check S={s} {kind} {op} R={r}: kernel differs from its "
                                 "plain version")
        checked[kind] = checked.get(kind, 0) + 1


def mesh_path(d: str, card: str) -> tuple[dict, dict]:
    """The mesh phase over the first MESH_SLICES slices of the paths' data
    directory ``d`` (a copy holding f, t and an empty fm): the NCCL rank
    in process, then the two-rank lockstep job over copies of it, then
    the kernels held at the shard's shapes.  The ranks start (imports,
    the card, the group, the holder) while the NCCL rank runs.  Returns
    the "mesh" line and the launches by run."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="mesh-", dir=os.path.dirname(d))
    src = os.path.join(base, "src")
    dirs = [os.path.join(base, f"rank{r}") for r in range(MESH_RANKS)]
    # The mesh serves the frames its requests read (f, t and the empty
    # fm), not the bulk path's frames, and their first MESH_SLICES slices.
    idx_dir = os.path.join(d, "i")

    def skip(path, names):
        if os.path.abspath(path) == os.path.abspath(idx_dir):
            return [n for n in names if os.path.isdir(os.path.join(path, n)) and n not in MESH_FRAMES]
        if os.path.basename(path) == "fragments":
            return [n for n in names if int(n.split(".")[0]) >= MESH_SLICES]
        return []

    t = time.perf_counter()
    shutil.copytree(d, src, ignore=skip)
    h = Holder(src)
    h.open()
    h.index("i").create_frame(MESH_BULK_FRAME, FrameOptions())
    h.close()
    with ThreadPoolExecutor(len(dirs)) as pool:
        for f in [pool.submit(shutil.copytree, src, dd) for dd in dirs]:
            f.result()
    copy_s = time.perf_counter() - t
    procs = []
    try:
        http = _free_port()
        t_start = time.perf_counter()
        procs = _lockstep_ranks(dirs, http)
        h = Holder(src)
        h.open()
        record_mesh_batches()
        t = time.perf_counter()
        ws1, ws1_launches, answers = mesh_nccl_path(h)
        ws1["s"] = time.perf_counter() - t
        print(json.dumps({"card": card, "mesh_nccl": ws1}), flush=True)
        t = time.perf_counter()
        lock, rank_launches = mesh_lockstep_path(procs, http, t_start, dirs, h, answers)
        lock["s"] = time.perf_counter() - t
        h.close()
        t = time.perf_counter()
        shard = check_shard_kernels()
        shard["s"] = time.perf_counter() - t
    finally:
        for p, out_f, err_f in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
            out_f.close()
            err_f.close()
        shutil.rmtree(base, ignore_errors=True)
    launches = {"mesh": ws1_launches}
    for r, got in enumerate(rank_launches):
        launches[f"lockstep_rank{r}"] = dict(dict.fromkeys(kernels.KERNELS, 0), **got)
    line = {"nccl_world1": ws1, "lockstep": lock, "shard_checks": shard, "copy_s": copy_s,
            "slices": MESH_SLICES, "s": time.perf_counter() - t_phase}
    return line, launches


# ---------------------------------------------------------------------------
# the fleet phase: replica groups on the card behind the replica router
# ---------------------------------------------------------------------------

FLEET_SEED = SEED + 19
# Three groups: a majority of three is two, so one group down still
# commits writes and its catch-up is exercised.
FLEET_GROUPS = 3
# The groups hold the data directory: f, t, fb and the bulk path's small
# frames.  An open fragment holds three descriptors (its lock, its op log
# and its storage mapping's own), so three holders of t's 38 views a
# slice (about 2,570 fragments a holder) need over 23,000, past the
# limit measured on an H100 host (20,000, soft and hard).  Where the limit, raised to its hard
# limit first, is short of three descriptors a fragment a group and
# FLEET_FD_SPARE more (the frames the phase creates, sockets), t keeps
# FLEET_T_VIEWS: its standard view and January's, which the range-wide
# batch reads (its spans lie in January).
FLEET_FD_SPARE = 2048
FLEET_T_VIEWS = ("standard", "standard_2017", "standard_201701", "standard_20170101",
                 "standard_20170115")
# SetBit bursts go to fl (rows 0..FLEET_WRITE_ROWS-1); the bulk load
# through the router to fk.
FLEET_WRITE_FRAME, FLEET_BULK_FRAME = "fl", "fk"
FLEET_WRITE_ROWS = 8
FLEET_BURST = 256
FLEET_BURST_CALLS = 32
# The partitioned router's frame: SetBits over every slice, in requests
# of FLEET_SHARD_CALLS.
FLEET_SHARD_FRAME, FLEET_SHARD_ROWS = "fp", 16
FLEET_SHARD_BITS, FLEET_SHARD_CALLS = 8192, 512
# mesh_requests' reads, each sent FLEET_SENDS times through the router;
# its round robin spreads them over the groups (each group fills its
# pool once; the second warm pair batch lands on g0, warm: the Gram).
FLEET_READS = ("pairs cold", "pairs warm", "nary", "tree", "range-wide", "topn")
FLEET_SENDS = 2
# The router's own cost: each of these, once warm on every group, goes
# FLEET_HOP_SENDS times through the router, each time followed by the
# same request straight to the door of the group that served it.
FLEET_DIRECT = ("pairs warm", "nary", "tree", "range-wide")
FLEET_HOP_SENDS = 6
# The kernels this phase runs ("yes" in PERF.md's table): each must launch.
FLEET_KERNELS = ("count_rows", "resident_count2", "gather_src_counts", "gather_count_multi_mixed",
                 "resident_count_multi", "gather_count_tree", "pair_gram", "build_planes")
# Each wait (a group's readiness, a replay, a resync) and each request.
FLEET_WAIT_S = 300
FLEET_REQUEST_S = 300
# TorchEngine.build_planes calls by engine (id), so a bulk write fanned
# to every group can be attributed to each.
FLEET_BUILDS: dict = {}


def record_fleet_builds() -> None:
    from pilosa_tpu_torch.engine import TorchEngine

    fn = TorchEngine.build_planes

    def counted(self, rows, cols):
        FLEET_BUILDS[id(self)] = FLEET_BUILDS.get(id(self), 0) + 1
        return fn(self, rows, cols)
    TorchEngine.build_planes = counted


def _fleet_req(base: str, method: str, path: str, body: bytes | None = None,
               timeout: float = FLEET_REQUEST_S) -> tuple[int, bytes, dict, float]:
    rq = urllib.request.Request(base + path, data=body, method=method)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(rq, timeout=timeout) as r:
            out = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        out = e.code, e.read(), dict(e.headers)
    return out + ((time.perf_counter() - t0) * 1e3,)


def _fleet_query(base: str, pql: str) -> tuple[list, str, float]:
    """POST one query; (answers as _norm gives them, the serving group, ms)."""
    st, body, hdrs, ms = _fleet_req(base, "POST", "/index/i/query", pql.encode())
    if st != 200:
        raise AssertionError(f"fleet: {base} answered {st}: {body[:300]!r}")
    got = json.loads(body)["results"]
    got = [[(p["id"], p["count"]) for p in g] if isinstance(g, list) else g for g in got]
    return got, hdrs.get("X-Pilosa-Group", ""), ms


def _fleet_wait(pred, what: str, timeout: float = FLEET_WAIT_S) -> float:
    """Poll ``pred`` until true; its seconds.  A stuck step fails the run."""
    t0 = time.perf_counter()
    while True:
        if pred():
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"fleet: {what} not done after {timeout} s")
        time.sleep(0.1)


def _fleet_server(data_dir: str, port: int, group: str):
    """One group: a port Server with its default config (engine on the
    card) but the query cache off, as the reference's group workers run
    (tests/replica_group_worker.py), so repeated reads execute."""
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.server.server import Server

    srv = Server(Config(data_dir=data_dir, host=f"127.0.0.1:{port}", replica_group=group,
                        qcache_enabled=False))
    srv.open()
    eng = srv.executor.engine
    if eng.name != "torch" or eng.device.type != "cuda":
        raise AssertionError(f"fleet group {group}: engine {eng.name} on {eng.device}")
    return srv


class _Router:
    """``python -m pilosa_tpu_torch.cli replica-router`` as a user starts
    it, in a process of its own; SIGINT stops it."""

    def __init__(self, args: list, log: str, env_extra: dict | None = None):
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, **(env_extra or {}))
        env.pop("PILOSA_ENGINE", None)
        self.log = open(log, "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "replica-router",
             "--port", str(self.port), *args],
            cwd=root, env=env, stdout=self.log, stderr=subprocess.STDOUT, text=True)

    def status(self) -> dict:
        st, body, _, _ = _fleet_req(self.base, "GET", "/replica/status", timeout=30)
        if st != 200:
            raise AssertionError(f"router status {st}")
        return json.loads(body)

    def stats(self) -> dict:
        return json.loads(_fleet_req(self.base, "GET", "/debug/vars", timeout=30)[1])

    def group(self, name: str) -> dict:
        return next(g for g in self.status()["groups"] if g["name"] == name)

    def ready(self, name: str, epoch: str = "") -> bool:
        g = self.group(name)
        return (g["healthy"] and g["caughtUp"] and not g["stale"]
                and (not epoch or g["epoch"] == epoch))

    def wait_up(self, n_groups: int) -> float:
        def up():
            if self.proc.poll() is not None:
                raise AssertionError(f"router exited: {self.tail()}")
            try:
                st = self.status()
            except OSError:
                return False
            return len(st["groups"]) == n_groups and all(g["healthy"] for g in st["groups"])
        return _fleet_wait(up, "the router's start", timeout=120)

    def tail(self) -> str:
        self.log.flush()
        self.log.seek(0)
        return self.log.read()[-3000:]

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=60)
        self.log.close()


def _digests(servers) -> list[dict]:
    """Each group's ``/replica/digest`` body (its holder's digest), the
    groups side by side."""
    from concurrent.futures import ThreadPoolExecutor

    def one(srv):
        st, body, _, _ = _fleet_req(f"http://{srv.host}", "GET", "/replica/digest")
        if st != 200:
            raise AssertionError(f"digest of {srv.host}: {st}")
        return json.loads(body)
    with ThreadPoolExecutor(len(servers)) as pool:
        return list(pool.map(one, servers))


def _equal_digests(servers, what: str) -> tuple[str, float]:
    t0 = time.perf_counter()
    ds = _digests(servers)
    if any(d["digest"] != ds[0]["digest"] or d["fragments"] != ds[0]["fragments"] for d in ds):
        diff = sorted(k for k in ds[0]["fragments"]
                      if any(d["fragments"].get(k) != ds[0]["fragments"][k] for d in ds))
        raise AssertionError(f"fleet {what}: digests differ ({len(diff)} fragments: {diff[:5]})")
    return ds[0]["digest"], time.perf_counter() - t0


def _fleet_descriptors(d: str) -> dict:
    """Raise the process's open-file limit to its hard limit and count the
    fragments of ``d``; if FLEET_GROUPS holders of them would pass the
    limit, drop t's views but FLEET_T_VIEWS from ``d`` (the directory
    goes, as ``Index.delete_frame`` removes a frame's).  Returns the
    limits, the fragments and the views dropped."""
    import resource
    import shutil

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    limit = resource.getrlimit(resource.RLIMIT_NOFILE)[0]

    def fragments():
        return sum(1 for _root, _dirs, files in os.walk(os.path.join(d, "i"))
                   for n in files if n.isdigit())
    out = {"nofile_was": [soft, hard], "nofile": limit, "fragments": fragments(), "t_views_dropped": 0}
    if 3 * FLEET_GROUPS * out["fragments"] + FLEET_FD_SPARE > limit:
        views_dir = os.path.join(d, "i", "t", "views")
        views = [v for v in os.listdir(views_dir) if v not in FLEET_T_VIEWS]
        for v in views:
            shutil.rmtree(os.path.join(views_dir, v))
        out["t_views_dropped"], out["fragments_kept"] = len(views), fragments()
    return out


def _burst(rng, n: int) -> tuple[list, dict]:
    """``n`` SetBits on fl's rows, spread over every slice, in requests of
    FLEET_BURST_CALLS; the request bodies and the columns by row."""
    rows = rng.integers(0, FLEET_WRITE_ROWS, size=n)
    cols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=n)
    calls = [f'SetBit(rowID={r}, frame="{FLEET_WRITE_FRAME}", columnID={c})' for r, c in zip(rows, cols)]
    bodies = [" ".join(calls[i:i + FLEET_BURST_CALLS]) for i in range(0, n, FLEET_BURST_CALLS)]
    by_row: dict = {}
    for r, c in zip(rows.tolist(), cols.tolist()):
        by_row.setdefault(r, set()).add(c)
    return bodies, by_row


def fleet_path(d: str, card: str) -> tuple[dict, dict]:
    """The fleet phase over the paths' data directory ``d`` (see the module
    docstring, step 9).  Each read's first answer is held against the
    numpy engine on a seeded subset (the TopN: the executor path's numpy
    answer), and every other answer to the same request, through the
    router or straight to a group's door, equals it in full.  Returns
    the "fleet" line and the launches by part (a: the reads through the
    router, b: the writes and their reads, c: catch-up, resync, the
    resynced group's reads and the partitioned router)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.server.client import Client

    t_phase = time.perf_counter()
    line: dict = {"card": card}
    part_s: dict = {}
    t_lap = [t_phase]

    def lap(name):
        now = time.perf_counter()
        part_s[name] = now - t_lap[0]
        t_lap[0] = now
    launches = {k: dict.fromkeys(kernels.KERNELS, 0) for k in ("fleet_a", "fleet_b", "fleet_c")}
    part = ["fleet_a"]

    def launched(fn):
        before = dict(kernels.LAUNCHES)
        out = fn()
        got = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] > before[k]}
        for k, n in got.items():
            launches[part[0]][k] += n
        return out, got

    line["descriptors"] = _fleet_descriptors(d)
    base_dir = tempfile.mkdtemp(prefix="fleet-", dir=os.path.dirname(d))
    dirs = [d] + [os.path.join(base_dir, f"g{i}") for i in range(1, FLEET_GROUPS)]
    t = time.perf_counter()
    with ThreadPoolExecutor(FLEET_GROUPS - 1) as pool:
        for f in [pool.submit(shutil.copytree, d, dd) for dd in dirs[1:]]:
            f.result()
    line["copy_s"] = time.perf_counter() - t
    lap("copy")
    ports = [_free_port() for _ in range(FLEET_GROUPS)]
    wal_dir = os.path.join(base_dir, "wal")
    servers: list = []
    routers: list = []
    try:
        t = time.perf_counter()
        for i in range(FLEET_GROUPS):
            servers.append(_fleet_server(dirs[i], ports[i], f"g{i}@1"))
        line["open_s"] = time.perf_counter() - t
        groups = ",".join(f"g{i}=127.0.0.1:{p}" for i, p in enumerate(ports))
        router = _Router(["--groups", groups, "--wal-dir", wal_dir, "--probe-interval", "0.2"],
                         os.path.join(base_dir, "router.log"))
        routers.append(router)
        line["router_start_s"] = router.wait_up(FLEET_GROUPS)
        lap("start")
        ex_ref = Executor(servers[0].holder, engine="numpy")
        rng = np.random.default_rng(FLEET_SEED)

        # a. Reads through the router, each kind FLEET_SENDS times.
        kernels.reset_launches()
        requests = {name: calls for name, calls, _flavour, _expect in mesh_requests(N_ROWS, TIME_ROWS)}
        expects = {name: expect for name, _c, _f, expect in mesh_requests(N_ROWS, TIME_ROWS)}
        reads, served, firsts = [], {}, {}
        for name in FLEET_READS:
            calls, pql = requests[name], " ".join(requests[name])
            rec = {"request": name, "router_ms": [], "groups": [], "launches": []}
            first = None
            for _ in range(FLEET_SENDS):
                (got, grp, ms), got_l = launched(lambda: _fleet_query(router.base, pql))
                rec["router_ms"].append(ms)
                rec["groups"].append(grp)
                rec["launches"].append(got_l)
                if got_l:
                    served[grp] = served.get(grp, 0) + 1
                if first is None:
                    first = firsts[name] = got
                    rec["checked"] = _check_numpy(f"fleet {name}", got, calls, ex_ref, rng,
                                                  TOPN_ANSWER)
                elif got != first:
                    raise AssertionError(f"fleet {name}: {grp}'s answer differs from the first group's")
            union = {k for g in rec["launches"] for k in g}
            missing = [k for k in expects[name] if k not in union]
            if missing:
                raise AssertionError(f"fleet {name}: {missing} never launched ({rec['launches']})")
            reads.append(rec)
        if len(served) != FLEET_GROUPS:
            raise AssertionError(f"fleet: reads that launched kernels by group: {served}")
        # The router's own cost: each FLEET_DIRECT request goes once to
        # every group's door (warming the groups that have not served it),
        # then through the router, each time followed by the same request
        # at the serving group's door; the median of the differences.
        doors = {f"g{i}": f"http://{srv.host}" for i, srv in enumerate(servers)}
        hops = {}
        for rec in reads:
            name = rec["request"]
            if name not in FLEET_DIRECT:
                continue
            pql = " ".join(requests[name])
            hop = {"warm_ms": {}, "router_ms": [], "door_ms": [], "groups": []}
            for g, door in doors.items():
                got, _grp, hop["warm_ms"][g] = _fleet_query(door, pql)
                if got != firsts[name]:
                    raise AssertionError(f"fleet {name}: {g}'s door differs from the router's answer")
            for _ in range(FLEET_HOP_SENDS):
                got, grp, ms = _fleet_query(router.base, pql)
                got_d, _grp, ms_d = _fleet_query(doors[grp.split("@")[0]], pql)
                if got != firsts[name] or got_d != firsts[name]:
                    raise AssertionError(f"fleet {name}: {grp}'s answer differs from the first one")
                hop["router_ms"].append(ms)
                hop["door_ms"].append(ms_d)
                hop["groups"].append(grp)
            hop["median_hop_ms"] = hops[name] = float(np.median(
                [a - b for a, b in zip(hop["router_ms"], hop["door_ms"])]))
            rec["hop"] = hop
        line["reads"], line["served"], line["router_hop_ms"] = reads, served, hops
        lap("reads")

        # b. Writes through the router: a SetBit burst, a Count from each
        # group (read-your-writes), a bulk load every group builds.
        part[0] = "fleet_b"
        t = time.perf_counter()
        st = _fleet_req(router.base, "POST", f"/index/i/frame/{FLEET_WRITE_FRAME}", b"{}")[0]
        if st != 200:
            raise AssertionError(f"fleet: create frame {FLEET_WRITE_FRAME}: {st}")
        bodies, by_row = _burst(rng, FLEET_BURST)
        burst_ms = []
        for body in bodies:
            (got, grp, ms), _l = launched(lambda: _fleet_query(router.base, body))
            if grp != "all" or not all(isinstance(x, bool) for x in got):
                raise AssertionError(f"fleet burst: {grp} {got[:4]}")
            burst_ms.append(ms)
        count_pql = " ".join(f'Count(Bitmap(rowID={r}, frame="{FLEET_WRITE_FRAME}"))'
                             for r in range(FLEET_WRITE_ROWS))
        want = [len(by_row.get(r, ())) for r in range(FLEET_WRITE_ROWS)]
        ryw = []
        for _ in range(FLEET_GROUPS):
            (got, grp, ms), got_l = launched(lambda: _fleet_query(router.base, count_pql))
            if got != want:
                raise AssertionError(f"fleet read-your-writes on {grp}: {got} vs {want}")
            ryw.append({"group": grp, "ms": ms, "launches": got_l})
        if len({r["group"] for r in ryw}) != FLEET_GROUPS:
            raise AssertionError(f"fleet read-your-writes: served by {ryw}")
        st = _fleet_req(router.base, "POST", f"/index/i/frame/{FLEET_BULK_FRAME}", b"{}")[0]
        if st != 200:
            raise AssertionError(f"fleet: create frame {FLEET_BULK_FRAME}: {st}")
        rows, cols = mesh_bulk_pairs(N_SLICES)
        builds0 = {id(s.executor.engine): FLEET_BUILDS.get(id(s.executor.engine), 0) for s in servers}
        t0 = time.perf_counter()
        out, bulk_l = launched(lambda: Client(router.base[len("http://"):]).bulk_stream(
            "i", FLEET_BULK_FRAME, rows, cols, chunk_pairs=BULK_CHUNK))
        bulk_ms = (time.perf_counter() - t0) * 1e3
        if not out.get("done") or out.get("ops") != len(rows):
            raise AssertionError(f"fleet bulk: {out}")
        builds = [FLEET_BUILDS.get(id(s.executor.engine), 0) - builds0[id(s.executor.engine)]
                  for s in servers]
        n_chunks = -(-len(rows) // BULK_CHUNK)
        if builds != [n_chunks] * FLEET_GROUPS or bulk_l.get("build_planes", 0) < FLEET_GROUPS * n_chunks:
            raise AssertionError(f"fleet bulk: builds by group {builds}, launches {bulk_l}")
        digest, digest_s = _equal_digests(servers, "after the writes")
        fk = {k: v for k, v in _digests(servers[:1])[0]["fragments"].items()
              if k.startswith(f"i/{FLEET_BULK_FRAME}/")}
        line["writes"] = {"burst_requests_ms": burst_ms, "read_your_writes": ryw,
                          "bulk": {"pairs": len(rows), "chunks": n_chunks, "ms": bulk_ms,
                                   "builds_by_group": builds, "launches": bulk_l,
                                   "fragments": len(fk)},
                          "digest": digest, "digest_s": digest_s,
                          "s": time.perf_counter() - t}

        lap("writes")

        # c. Catch-up: g2 misses a burst that commits on two of three,
        # then returns on its directory and gets the suffix replayed.
        part[0] = "fleet_c"
        stats0 = router.stats()
        servers[2].close()
        bodies, _by_row = _burst(rng, FLEET_BURST)
        for body in bodies:
            st, resp, _h, _ms = _fleet_req(router.base, "POST", "/index/i/query", body.encode())
            if st != 200:
                raise AssertionError(f"fleet: a write with g2 down answered {st}: {resp[:200]!r}")
        t0 = time.perf_counter()
        servers[2] = _fleet_server(dirs[2], ports[2], "g2@2")
        open_s = time.perf_counter() - t0
        try:
            wait_s = _fleet_wait(lambda: router.ready("g2", "g2@2"), "g2's catch-up")
        except AssertionError as e:
            raise AssertionError(f"{e}: {router.group('g2')}\n{router.tail()}") from None
        stats1 = router.stats()
        replayed = stats1.get("replica.replayed", 0) - stats0.get("replica.replayed", 0)
        if replayed < len(bodies):
            raise AssertionError(f"fleet catch-up: {replayed} records replayed for {len(bodies)} writes")
        digest, digest_s = _equal_digests(servers, "after the catch-up")
        line["catchup"] = {"writes": len(bodies), "setbits": FLEET_BURST, "replayed": replayed,
                           "open_s": open_s, "ms": (open_s + wait_s) * 1e3,
                           "ready_after_open_ms": wait_s * 1e3, "digest": digest,
                           "digest_s": digest_s}

        lap("catchup")

        # Resync: g2 returns on an empty directory and is streamed every
        # fragment of every frame from a donor.
        def blank_resync(epoch: int, rt) -> dict:
            s0 = rt.stats()
            servers[2].close()
            # Writes g2 misses (and must not lose): the router marks it down.
            for body in _burst(rng, 2 * FLEET_BURST_CALLS)[0]:
                if _fleet_req(rt.base, "POST", "/index/i/query", body.encode())[0] != 200:
                    raise AssertionError("fleet: a write with g2 down failed")
            blank = os.path.join(base_dir, f"g2-blank{epoch}")
            os.makedirs(blank)
            t0 = time.perf_counter()
            servers[2] = _fleet_server(blank, ports[2], f"g2@{epoch}")
            open_s = time.perf_counter() - t0
            eng = servers[2].executor.engine
            try:
                wait_s = _fleet_wait(lambda: rt.ready("g2", f"g2@{epoch}"), f"g2@{epoch}'s resync")
            except AssertionError as e:
                raise AssertionError(f"{e}: {rt.group('g2')} {rt.stats()}\n{rt.tail()}") from None
            s1 = rt.stats()
            moved = {k: s1.get(k, 0) - s0.get(k, 0) for k in
                     ("replica.resync.g2", "replica.resync_bytes", "replica.resync_fragments",
                      "replica.resync_columnar", "replica.resync_columnar_fallback")}
            if moved["replica.resync.g2"] < 1 or moved["replica.resync_bytes"] <= 0:
                raise AssertionError(f"fleet resync g2@{epoch}: {moved}")
            digest, digest_s = _equal_digests(servers, f"after g2@{epoch}'s resync")
            ms = (open_s + wait_s) * 1e3
            return {"epoch": epoch, "bytes": moved["replica.resync_bytes"], "moved": moved,
                    "ms": ms, "mb_s": moved["replica.resync_bytes"] / 1e6 / (wait_s or 1e-9),
                    "builds": FLEET_BUILDS.get(id(eng), 0), "digest": digest, "digest_s": digest_s}

        resync, rs_l = launched(lambda: blank_resync(3, router))
        lap("resync")
        resync["launches"] = rs_l
        # The resynced group serves from the card: a cold pair batch and
        # the TopN straight to its door.
        direct = []
        for name in ("pairs cold", "topn"):
            calls = requests[name]
            (got, _grp, ms), got_l = launched(lambda: _fleet_query(f"http://{servers[2].host}",
                                                                   " ".join(calls)))
            if got != firsts[name]:
                raise AssertionError(f"fleet resynced {name}: differs from the first group's answer")
            checked = _check_numpy(f"fleet resynced {name}", got, calls, ex_ref, rng, TOPN_ANSWER)
            if not all(got_l.get(k) for k in expects[name]):
                raise AssertionError(f"fleet resynced g2 {name}: launches {got_l}")
            direct.append({"request": name, "ms": ms, "checked": checked, "launches": got_l})
        resync["reads_on_g2"] = direct
        line["resync"] = resync
        lap("resynced_reads")

        # A second blank resync over the columnar lane (Arrow from the
        # donor, the laggard's /bulk door builds the planes on the card),
        # where pyarrow imports: the router restarts on its WAL with
        # replica_resync_columnar on.
        try:
            import pyarrow  # noqa: F401
            have_arrow = True
        except ImportError:
            have_arrow = False
        if have_arrow:
            router.stop()
            router = _Router(["--groups", groups, "--wal-dir", wal_dir, "--probe-interval", "0.2"],
                             os.path.join(base_dir, "router-columnar.log"),
                             env_extra={"PILOSA_TPU_REPLICA_RESYNC_COLUMNAR": "1"})
            routers.append(router)
            router.wait_up(FLEET_GROUPS)
            col, col_l = launched(lambda: blank_resync(4, router))
            col["launches"] = col_l
            if col["moved"]["replica.resync_columnar"] < 1 or col["builds"] < 1 or \
                    not col_l.get("build_planes"):
                raise AssertionError(f"fleet columnar resync: {col}")
            line["resync_columnar"] = col
        else:
            line["resync_columnar"] = "not run: pyarrow does not import"
        lap("resync_columnar")
        wal_bytes = sum(os.path.getsize(os.path.join(wal_dir, f)) for f in os.listdir(wal_dir))
        line["wal_bytes"] = wal_bytes
        line["digests"] = [x["digest"] for x in _digests(servers)]
        router.stop()

        # Partitioned: a second router over g0 and g1 with a shard map.  A
        # shard's group answers for the slices it holds, so the sharded
        # reads go to frame fs, written through the sharded router (each
        # SetBit lands on its slice's owner only); the same writes go
        # straight to g2, whose numpy engine gives the answers.
        split = N_SLICES // 2
        shard_map = (f"a=0-{split}:g0=127.0.0.1:{ports[0]};"
                     f"b={split}-:g1=127.0.0.1:{ports[1]}")
        sharded = _Router(["--shard-map", shard_map, "--probe-interval", "0.2"],
                          os.path.join(base_dir, "router-sharded.log"))
        routers.append(sharded)
        sharded.wait_up(2)
        s0 = sharded.stats()
        g2_base = f"http://{servers[2].host}"
        for base in (sharded.base, g2_base):
            st = _fleet_req(base, "POST", f"/index/i/frame/{FLEET_SHARD_FRAME}", b"{}")[0]
            if st != 200:
                raise AssertionError(f"fleet: create frame {FLEET_SHARD_FRAME} on {base}: {st}")
        srows = rng.integers(0, FLEET_SHARD_ROWS, size=FLEET_SHARD_BITS)
        scols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=FLEET_SHARD_BITS)
        calls = [f'SetBit(rowID={r}, frame="{FLEET_SHARD_FRAME}", columnID={c})'
                 for r, c in zip(srows, scols)]
        t0 = time.perf_counter()
        for i in range(0, len(calls), FLEET_SHARD_CALLS):
            body = " ".join(calls[i:i + FLEET_SHARD_CALLS])
            for base in (sharded.base, g2_base):
                got, _grp, _ms = _fleet_query(base, body)
                if not all(isinstance(x, bool) for x in got):
                    raise AssertionError(f"fleet sharded writes on {base}: {got[:4]}")
        write_ms = (time.perf_counter() - t0) * 1e3
        ex2 = Executor(servers[2].holder, engine="numpy")
        bm = lambda r: _bm(r, FLEET_SHARD_FRAME)  # noqa: E731
        spairs = rng.integers(0, FLEET_SHARD_ROWS, size=(64, 2))
        sets = rng.integers(0, FLEET_SHARD_ROWS, size=(FLEET_SHARD_ROWS, 4))
        sreads = {
            "pairs": [f"Count({PQL_OPS[('and', 'or')[i % 2]]}({bm(a)}, {bm(b)}))"
                      for i, (a, b) in enumerate(spairs)],
            "nary": [f"Count({PQL_OPS[('or', 'and')[i % 2]]}({', '.join(bm(r) for r in ids)}))"
                     for i, ids in enumerate(sets)],
        }
        merged = []
        for name, scalls in sreads.items():
            (got, grp, ms), got_l = launched(lambda: _fleet_query(sharded.base, " ".join(scalls)))
            want = _norm(ex2.execute("i", " ".join(scalls)))
            if got != want or grp != "all":
                raise AssertionError(f"fleet sharded {name} ({grp}): {got[:4]} vs numpy {want[:4]}")
            merged.append({"request": name, "ms": ms, "checked": len(want), "launches": got_l})
        row = FLEET_WRITE_ROWS  # a row no burst wrote
        for sl in (1, split + 1):
            pql = f'SetBit(rowID={row}, frame="{FLEET_WRITE_FRAME}", columnID={sl * SLICE_WIDTH + 7})'
            got, _grp, _ms = _fleet_query(sharded.base, pql)
            if got != [True]:
                raise AssertionError(f"fleet sharded SetBit in slice {sl}: {got}")
        s1 = sharded.stats()
        shard_stats = {k: s1.get(k, 0) - s0.get(k, 0) for k in s1
                       if k.startswith("replica.shard.") and isinstance(s1[k], int)}
        owned = [_fleet_query(f"http://{servers[i].host}",
                              f'Bitmap(rowID={row}, frame="{FLEET_WRITE_FRAME}")')[0][0]["bits"]
                 for i in (0, 1)]
        n_req = -(-len(calls) // FLEET_SHARD_CALLS)
        # Each shard: the frame's creation, its half of every split burst
        # request, and its one SetBit.
        want_writes = {"replica.shard.writes.a": n_req + 2, "replica.shard.writes.b": n_req + 2,
                       "replica.shard.split_writes": n_req}
        if any(shard_stats.get(k) != n for k, n in want_writes.items()) or \
                owned != [[1 * SLICE_WIDTH + 7], [(split + 1) * SLICE_WIDTH + 7]]:
            raise AssertionError(f"fleet sharded writes: {shard_stats}, bits by group {owned}")
        line["sharded"] = {"map": shard_map, "setbits": len(calls), "write_ms": write_ms,
                           "reads": merged, "stats": shard_stats, "bits_by_group": owned}
        lap("sharded")
    finally:
        for rt in routers:
            rt.stop()
        for srv in servers:
            try:
                srv.close()
            except Exception:  # noqa: BLE001 — closed already
                pass
        shutil.rmtree(base_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    total = {k: sum(launches[p][k] for p in launches) for k in kernels.KERNELS}
    missing = [k for k in FLEET_KERNELS if not total[k]]
    if missing:
        raise AssertionError(f"fleet: kernels never launched: {missing} ({total})")
    line["launches"] = {p: {k: n for k, n in v.items() if n} for p, v in launches.items()}
    line["s"] = time.perf_counter() - t_phase
    line["part_s"] = part_s
    return line, launches


# ---------------------------------------------------------------------------
# the analysis phase: the project linter, the interleaving explorer, and the
# runtime lock checker over cold concurrent requests on the card
# ---------------------------------------------------------------------------

ANALYSIS_SLICES = 8
ANALYSIS_THREADS = 4
ANALYSIS_SEED = SEED + 20
ANALYSIS_READS = ("pairs", "nary", "tree", "topn")
# The kernels the reads reach on the card, as the HTTP path's expect at
# the same batch shapes: pairs, N-ary, tree, and TopN's two.
ANALYSIS_KERNELS = ("resident_count2", "gather_count_multi_mixed", "gather_count_tree", "count_rows",
                    "gather_src_counts")
ANALYSIS_TIMEOUT_S = 600


def analysis_copy(d: str) -> str:
    """A copy of frame ``f`` of the paths' data directory ``d``, its first
    ANALYSIS_SLICES slices, in a new directory beside ``d``."""
    import shutil

    base = tempfile.mkdtemp(prefix="analysis-", dir=os.path.dirname(d))
    idx_dir = os.path.join(d, "i")

    def skip(path, names):
        if os.path.abspath(path) == os.path.abspath(idx_dir):
            return [n for n in names if os.path.isdir(os.path.join(path, n)) and n != "f"]
        if os.path.basename(path) == "fragments":
            return [n for n in names if int(n.split(".")[0]) >= ANALYSIS_SLICES]
        return []

    shutil.copytree(d, os.path.join(base, "data"), ignore=skip)
    return base


def analysis_bodies() -> tuple[dict, list]:
    """The lock-check requests: one PQL body for each read, and for each
    client thread a write body (a SetBit in frame ``w``, which no read
    names, then a Count that reads it back against a row of ``f``)."""
    rng = np.random.default_rng(ANALYSIS_SEED)
    pairs = rng.integers(0, N_ROWS, size=(PAIR_BATCH, 2))
    pairs[:, 0] = np.resize(rng.permutation(N_ROWS), PAIR_BATCH)
    op, idx = nary_requests(N_ROWS)["nary-and"]
    reads = {
        "pairs": [f"Count(Intersect({_bm(a)}, {_bm(b)}))" for a, b in pairs],
        "nary": [f"Count({PQL_OPS[op]}({', '.join(_bm(r) for r in ids)}))" for ids in idx],
        "tree": [_tree_call(rng, N_ROWS, i) for i in range(FOLD_BATCH)],
        "topn": [TOPN_PQL],
    }
    writes = []
    for k in range(ANALYSIS_THREADS):
        col = int(rng.integers(0, ANALYSIS_SLICES * SLICE_WIDTH))
        row = int(rng.integers(0, N_ROWS))
        writes.append([f'SetBit(rowID={k}, frame="w", columnID={col})',
                       f'Count(Intersect({_bm(k, "w")}, {_bm(row)}))'])
    return reads, writes


def lock_check_requests(data_dir: str) -> int:
    """Run in a fresh process with PILOSA_TPU_LOCK_CHECK=1: the port's
    ``Server`` (default config, engine on the card) over ``data_dir``;
    ANALYSIS_THREADS client threads start together from cold, thread k
    sending the reads rotated by k (so the first wave is one of each and
    the kernels' first loads race) and then its write body.  Every answer
    must equal the numpy engine's on the same holder, every kernel of
    ANALYSIS_KERNELS must launch, and the lock checker must record
    nothing.  Prints one JSON line; exits 1 on a violation."""
    import threading

    from pilosa_tpu_torch.analysis import lockcheck
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.server.server import Server

    if not lockcheck.enabled():
        raise AssertionError(f"lock check: {lockcheck.ENV_VAR} did not enable the checker")
    t0 = time.perf_counter()
    srv = Server(Config(data_dir=data_dir, host="127.0.0.1:0"))
    srv.open()
    try:
        open_s = time.perf_counter() - t0
        if srv.executor.engine.name != "torch" or srv.executor.engine.device.type != "cuda":
            raise AssertionError(f"lock check: server engine is {srv.executor.engine.name}")
        base = f"http://{srv.host}"
        st, body, _, _ = _fleet_req(base, "POST", "/index/i/frame/w", b"{}")
        if st != 200:
            raise AssertionError(f"lock check: frame w answered {st}: {body[:200]!r}")
        reads, writes = analysis_bodies()
        kernels.reset_launches()
        barrier = threading.Barrier(ANALYSIS_THREADS)
        got: list = []
        errors: list = []

        def client(k: int) -> None:
            try:
                order = list(ANALYSIS_READS[k:] + ANALYSIS_READS[:k])
                barrier.wait()
                for name in order + ["write"]:
                    calls = writes[k] if name == "write" else reads[name]
                    st, body, _, ms = _fleet_req(base, "POST", "/index/i/query",
                                                 " ".join(calls).encode())
                    if st != 200:
                        raise AssertionError(f"lock check: {name} answered {st}: {body[:200]!r}")
                    res = json.loads(body)["results"]
                    res = [[(p["id"], p["count"]) for p in r] if isinstance(r, list) else r
                           for r in res]
                    got.append((k, name, res, ms))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                barrier.abort()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(ANALYSIS_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        requests_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        launches = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        ex_ref = Executor(srv.holder, engine="numpy")
        want = {name: _norm(ex_ref.execute("i", " ".join(calls))) for name, calls in reads.items()}
        checked = 0
        for k, name, res, _ms in got:
            if name == "write":
                if res[0] is not True:
                    raise AssertionError(f"lock check: thread {k}'s SetBit answered {res[0]!r}")
                res, expect = res[1:], _norm(ex_ref.execute("i", writes[k][1]))
            else:
                expect = want[name]
            if res != expect:
                raise AssertionError(f"lock check: thread {k}'s {name} differs from the numpy "
                                     f"engine: {res[:4]} vs {expect[:4]}")
            checked += len(res)
        numpy_s = time.perf_counter() - t0
    finally:
        srv.close()
    violations = lockcheck.take_violations()
    missing = [k for k in ANALYSIS_KERNELS if not launches[k]]
    # The acquisition-order edges the checker saw: the kernels' build lock
    # filling the loaded-kernel global shows that the card-only build and
    # load ran checked.
    chk = lockcheck.checker()
    with chk._mu:
        edges = sorted(f"{a} -> {b}" for a, bs in chk._edges.items() for b in bs)
    if "ops.kernels._build_mu -> ops.kernels.fns" not in edges:
        raise AssertionError(f"lock check: the kernels' build ran unchecked: {edges}")
    print(json.dumps({"lock_check": {
        "violations": len(violations), "threads": ANALYSIS_THREADS, "requests": len(got),
        "order_edges": edges,
        "answers_checked": checked, "slices": ANALYSIS_SLICES,
        "launches": {k: n for k, n in launches.items() if n},
        "missing_launches": missing, "open_s": open_s, "requests_s": requests_s,
        "request_ms": {f"{k}:{name}": ms for k, name, _r, ms in got}, "numpy_s": numpy_s,
    }}), flush=True)
    for v in violations:
        print(v.describe(), file=sys.stderr, flush=True)
    return 1 if violations or missing else 0


def _analysis_counts(out: str) -> dict:
    """The explorer's summary lines as numbers."""
    res = {"scenarios": 0, "schedules": 0, "truncated": 0, "violations": 0}
    for m in re.finditer(r"^(\S+): (\d+) schedule\(s\) at preemption bound (\d+), (\d+) truncated, "
                         r"(\d+) violation\(s\)$", out, re.MULTILINE):
        res["scenarios"] += 1
        res["schedules"] += int(m.group(2))
        res["truncated"] += int(m.group(4))
        res["violations"] += int(m.group(5))
    m = re.search(r"^replica-protocol model: (\d+) states explored, (\d+) violation\(s\)$", out,
                  re.MULTILINE)
    if not m or not res["scenarios"]:
        raise AssertionError(f"analysis: no explorer summary in:\n{out[-2000:]}")
    res["model_states"], res["model_violations"] = int(m.group(1)), int(m.group(2))
    return res


def analysis_path(base: str) -> tuple[dict, dict]:
    """The analysis phase.  Three processes start together: the project
    linter over the package (``python -m pilosa_tpu_torch.analysis``,
    exit 0 and "0 NEW"), the interleaving explorer's live suite and the
    protocol model check (``--explore all``, exit 0), and the lock-check
    requests over the copy of frame ``f`` in ``base`` with
    PILOSA_TPU_LOCK_CHECK=1 (``lock_check_requests``).  Any failure
    raises.  Returns the "analysis" line and the launches of the lock
    check."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    env = dict(os.environ)
    env.pop("PILOSA_TPU_LOCK_CHECK", None)
    lock_env = dict(env, PILOSA_TPU_LOCK_CHECK="1")
    cmds = {
        "gate": ([sys.executable, "-m", "pilosa_tpu_torch.analysis"], env),
        "explore": ([sys.executable, "-m", "pilosa_tpu_torch.analysis", "--explore", "all"], env),
        "lock_check": ([sys.executable, os.path.join(root, "chip_smoke.py"), "--lock-check",
                        os.path.join(base, "data")], lock_env),
    }
    procs = {}
    try:
        for name, (cmd, e) in cmds.items():
            procs[name] = (subprocess.Popen(cmd, cwd=root, env=e, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           time.perf_counter())
        out = {}
        for name, (p, t0) in procs.items():
            so, se = p.communicate(timeout=ANALYSIS_TIMEOUT_S)
            out[name] = (p.returncode, so, se, time.perf_counter() - t0)
    finally:
        for p, _t0 in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        shutil.rmtree(base, ignore_errors=True)
    for name, (rc, so, se, _s) in out.items():
        if rc != 0:
            raise AssertionError(f"analysis: {name} exited {rc}:\n{so[-3000:]}\n{se[-3000:]}")
    rc, so, _se, gate_s = out["gate"]
    m = re.search(r"^analysis: (\d+) finding\(s\) over (\d+) rule\(s\) — (\d+) suppressed, "
                  r"(\d+) baselined, (\d+) NEW$", so, re.MULTILINE)
    if not m or m.group(5) != "0":
        raise AssertionError(f"analysis: the gate did not report 0 NEW:\n{so[-2000:]}")
    gate = {"rc": rc, "findings": int(m.group(1)), "rules": int(m.group(2)),
            "suppressed": int(m.group(3)), "baselined": int(m.group(4)), "new": 0, "s": gate_s}
    rc, so, _se, explore_s = out["explore"]
    explore = dict(_analysis_counts(so), rc=rc, s=explore_s)
    rc, so, _se, lock_s = out["lock_check"]
    lock = json.loads(so.strip().splitlines()[-1])["lock_check"]
    lock.update(rc=rc, s=lock_s)
    launches = dict(dict.fromkeys(kernels.KERNELS, 0), **lock["launches"])
    line = {"gate": gate, "explore": explore, "lock_check": lock,
            "lock_violations": lock["violations"], "s": time.perf_counter() - t_phase}
    return line, {"analysis": launches}


def main() -> int:
    card = probe()
    # The paths' data directories build on the host, in processes of
    # their own, while the kernels build and the card runs the kernel
    # phases.
    tmp, tmp2 = tempfile.TemporaryDirectory(), tempfile.TemporaryDirectory()
    builds = start_data_builds(tmp.name, tmp2.name)
    try:
        return _main(card, builds, tmp.name, tmp2.name)
    finally:
        for p in builds:
            if p.poll() is None:
                p.kill()
            p.wait()
        tmp.cleanup()
        tmp2.cleanup()


def _main(card: str, builds: list, d: str, d2: str) -> int:
    phase_s = {}
    t_phase = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now

    t0 = time.perf_counter()
    per_source = kernels.build()
    print(f"build_s {time.perf_counter() - t0:.3f} per-source {json.dumps(per_source)}", flush=True)
    ptx = ptxas_usage((
        "count_rows", "resident_count2", "gather_count_multi", "gather_count_tree", "resident_count_tree",
        "gather_count2_rowmajor", "gather_count_multi_rowmajor", "topn_counts",
        "resident_count_multi", "pair_gram", "gather_count2", "build_planes",
        "gather_count_multi_mixed"))
    print(json.dumps({"ptxas": ptx}), flush=True)

    lap("build")
    timings, layout, gate, multi = check_kernels()
    print("kernels match their plain versions on the card", flush=True)
    print(json.dumps({"card": card, "layout": layout}), flush=True)
    print(json.dumps({"card": card, "tree_gate": gate}), flush=True)
    print(json.dumps({"card": card, "multi_paths": multi["paths"]}), flush=True)
    print(json.dumps({"card": card, "multi_tilings": multi["tilings"]}), flush=True)
    print(json.dumps({"card": card, "multi_gate": multi["gate"]}), flush=True)

    lap("kernels")
    kernels.reset_launches()
    sweep = diffcheck_path()
    launches = {"diffcheck": dict(kernels.LAUNCHES)}
    print(json.dumps({"card": card, "diffcheck": sweep}), flush=True)

    record_multi_batches()
    record_pair_batches()
    record_tree_batches()
    record_bulk_builds()
    record_fleet_builds()

    lap("diffcheck")
    h = open_built(builds[0], d)
    lap("holder")
    records, launches["executor"] = executor_path(h)
    print(json.dumps({"card": card, "gather2_paths": time_gather2_paths()}), flush=True)
    lap("executor")
    http_records, launches["http"] = server_path(d)
    print(json.dumps({"card": card, "tree_paths": time_tree_paths()}), flush=True)
    lap("http")
    bulk, bulk_launches = bulk_path(d)
    launches.update(bulk_launches)
    print(json.dumps({"card": card, "bulk": bulk}), flush=True)
    lap("bulk")
    mesh, mesh_launches = mesh_path(d, card)
    launches.update(mesh_launches)
    print(json.dumps({"card": card, "mesh": mesh}), flush=True)
    lap("mesh")
    fleet, fleet_launches = fleet_path(d, card)
    launches.update(fleet_launches)
    print(json.dumps({"card": card, "fleet": fleet}), flush=True)
    lap("fleet")
    analysis_base = analysis_copy(d)

    # The tall path, in a data directory of its own.
    from pilosa_tpu_torch.executor import Executor

    h2 = open_built(builds[1], d2)
    ex2 = Executor(h2)
    ex2_ref = Executor(h2, engine="numpy")
    kernels.reset_launches()
    tall_records = tall_path(ex2, ex2_ref, TALL_ROWS, sync=torch.cuda.synchronize)
    launches["tall"] = dict(kernels.LAUNCHES)
    h2.close()
    del ex2, ex2_ref
    torch.cuda.empty_cache()

    lap("tall")
    analysis, analysis_launches = analysis_path(analysis_base)
    launches.update(analysis_launches)
    print(json.dumps({"card": card, "analysis": analysis}), flush=True)
    lap("analysis")
    print(json.dumps({"card": card, "phase_s": phase_s}), flush=True)
    missing = [k for k, path in PATH_OF.items() if launches[path][k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing} ({launches})")

    line = []
    for name in kernels.KERNELS:
        t = timings[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[PATH_OF[name]][name],
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "shape": t["shape"],
        }
        for extra in ("count_path", "floor", "shapes", "gathered_bound_ms", "all_rows_floor_ms",
                      "all_leaves_bound_ms", "live_leaves", "distinct_live",
                      "chunk_words", "stages", "smem_bytes", "kernel_ms", "n_seg",
                      "kernel_ms_by_n_seg", "host_ms", "bytes_bound_ms", "ops_bound_ms",
                      "int8_ops_bound_ms", "int_mm_only_ms", "checked", "schedule", "buckets",
                      "b1_probe", "library_note", "download_pinned_ms", "download_pageable_ms",
                      "groups", "groups_ms", "wall_ms", "groups_wall_ms", "groups_host_ms",
                      "distinct", "single_group", "requests"):
            if extra in t:
                entry[extra] = t[extra]
        if name in ptx:
            entry["ptxas"] = ptx[name]
        line.append(entry)
    print(json.dumps({"card": card, "path": "executor", "requests": records}), flush=True)
    print(json.dumps({"card": card, "path": "http", "requests": http_records}), flush=True)
    print(json.dumps({"card": card, "path": "tall", "requests": tall_records}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resident-against"]:
        sys.exit(resident_against(sys.argv[2]))
    if sys.argv[1:2] == ["--build-data"]:
        sys.exit(build_data(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--multi-against"]:
        sys.exit(multi_against_only(sys.argv[2]))
    if sys.argv[1:2] == ["--requests-against"]:
        sys.exit(requests_against(sys.argv[2]))
    if sys.argv[1:2] == ["--requests"]:
        sys.exit(requests_of(sys.argv[2]))
    if sys.argv[1:2] == ["--lock-check"]:
        probe()
        sys.exit(lock_check_requests(sys.argv[2]))
    sys.exit(main())
