"""Compute engines for batched slice evaluation.

The executor evaluates a PQL bitmap-call tree over a *batch* of slices at
once: leaves gather dense rows into a ``[n_slices, W]`` word matrix and
set ops/counts apply to the whole stack in one call.  The engine decides
where that matrix lives:

- `TorchEngine` — int32 word tensors on a torch device.  On ``cuda`` the
  fused counts run the hand-written kernels (ops/kernels.py via
  ops/dispatch.py); on ``cpu`` their plain PyTorch versions.  This is the
  production path: one device dispatch per query stage for *all* local
  slices.
- `MeshEngine` — the TorchEngine of one rank of a multi-GPU job: the
  slice axis of every stack is split over the ranks of a
  ``torch.distributed`` process group, each rank runs the kernels on its
  block, and a collective merges (parallel/).
- `NumpyEngine` — pure numpy; the reference the tests and the card's
  smoke run hold the torch engine against.

All satisfy the same small protocol; results surface as numpy (counts
as int64, words as uint32).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitwise, dispatch, kernels
from pilosa_tpu_torch.parallel.sharded import SliceMesh, _local
from pilosa_tpu_torch.roaring import _POPCNT8

# Pair-op table for the numpy engine (numpy operators; kept apart from
# ops.bitwise.apply_pair_op so this engine reads as a self-contained
# host reference).
_NP_OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "andnot": lambda a, b: a & ~b,
}

# Tree-fold opcodes by id (ops.bitwise.gather_count_tree encoding);
# opcode 4 = PASS (take the left child — perfect-tree padding).
_TREE_NP_OPS = {
    0: _NP_OPS["and"],
    1: _NP_OPS["or"],
    2: _NP_OPS["xor"],
    3: _NP_OPS["andnot"],
    4: lambda a, b: a,
}


def nbytes(*arrays) -> int:
    """Total byte size of the given arrays (None entries skipped) — the
    dispatch meter's operand/transfer accounting.  Works for numpy
    arrays and torch tensors alike (both expose .nbytes)."""
    total = 0
    for a in arrays:
        if a is None:
            continue
        n = getattr(a, "nbytes", None)
        if n is None:
            n = getattr(a, "size", 0) * getattr(a, "itemsize", 0)
        total += int(n)
    return total


class NumpyEngine:
    name = "numpy"
    # No jit: callers may use exact (ragged) dispatch shapes freely.
    wants_static_shapes = False
    # Host == device on numpy: nothing ever crosses a transfer boundary,
    # so the upload ledger stays at zero (class attr, never mutated).
    stat_upload_bytes = 0

    def stack(self, rows: list[np.ndarray]) -> np.ndarray:
        return np.stack(rows) if rows else np.zeros((0, 0), dtype=np.uint32)

    def stack_rows(self, rows: list) -> np.ndarray:
        """Stack engine-resident rows (same as stack on numpy)."""
        return self.stack(rows)

    def stack_slices(self, stacks: list) -> np.ndarray:
        """Stack along the SLICE axis (mesh engines shard this one)."""
        return self.stack(stacks)

    def asarray(self, x: np.ndarray):
        return np.asarray(x)

    def matrix(self, host_matrix: np.ndarray):
        """Move a fully-assembled host row matrix [n_slices, n_rows, W]
        into engine storage in ONE transfer (vs per-row uploads)."""
        return host_matrix

    def gather_count_and(self, row_matrix, pairs) -> np.ndarray:
        """Batched Count(Intersect) over [n_slices, n_rows, W] for int32[B,2]
        row-index pairs; returns int64[B]."""
        return self.gather_count("and", row_matrix, pairs)

    def gather_count(self, op: str, row_matrix, pairs) -> np.ndarray:
        """Batched Count(<op>(...)) — and/or/xor/andnot pair counts."""
        a = row_matrix[:, pairs[:, 0], :]
        b = row_matrix[:, pairs[:, 1], :]
        r = _NP_OPS[op](a, b)
        return self.count(r).sum(axis=0)

    def gather_count_multi(self, op: str, row_matrix, idx) -> np.ndarray:
        """Batched Count over a left-fold of K gathered rows — N-operand
        Intersect/Union/Difference and the fused Range cover (op="or").
        idx: int32[B, K], padded with fold-idempotent ids.  Returns
        int64[B].

        Chunked over the batch so the gathered [S, chunk, K, W] stays a
        few MB — one shot over the whole batch would materialize
        S*B*K*W*4 bytes (easily hundreds of MB) for nothing.
        """
        from pilosa_tpu_torch.pilosa import OR_MULTI_BUDGET_HOST, or_multi_chunk_size

        s, _, w = row_matrix.shape
        k = idx.shape[1]
        chunk = or_multi_chunk_size(s, k, w, OR_MULTI_BUDGET_HOST)
        out = np.empty(idx.shape[0], dtype=np.int64)
        for i in range(0, idx.shape[0], chunk):
            g = row_matrix[:, idx[i : i + chunk], :]
            if op == "or":
                acc = np.bitwise_or.reduce(g, axis=2)
            elif op == "and":
                acc = np.bitwise_and.reduce(g, axis=2)
            elif op == "andnot":
                acc = g[:, :, 0] & ~np.bitwise_or.reduce(g[:, :, 1:], axis=2)
            else:
                raise ValueError(f"unsupported multi-op {op!r}")
            out[i : i + chunk] = self.count(acc).sum(axis=0)
        return out

    def gather_count_or_multi(self, row_matrix, idx) -> np.ndarray:
        return self.gather_count_multi("or", row_matrix, idx)

    def gather_count_tree(self, row_matrix, leaves, opc) -> np.ndarray:
        """Batched Count over arbitrary nested expression trees (perfect-
        tree encoding, see ops.bitwise.gather_count_tree).  Chunked over
        the batch like gather_count_multi (same transient bound).

        Implemented inline (not via ops.bitwise): per-node opcode
        GROUPING does one bitwise pass per node — the where-select form
        evaluates all four ops per node, which a host loop pays for real.
        """
        from pilosa_tpu_torch.pilosa import OR_MULTI_BUDGET_HOST, or_multi_chunk_size

        s, _, w = row_matrix.shape
        b, k = leaves.shape
        chunk = or_multi_chunk_size(s, k, w, OR_MULTI_BUDGET_HOST)
        out = np.empty(b, dtype=np.int64)
        for i in range(0, b, chunk):
            g = row_matrix[:, leaves[i : i + chunk], :]  # [S, c, K, W]
            oc = opc[i : i + chunk]
            off = 0
            n = k // 2
            while n >= 1:
                a = g[:, :, 0::2]
                bb = g[:, :, 1::2]
                nxt = np.empty_like(a)
                for t in range(n):
                    col = oc[:, off + t]
                    for o in np.unique(col):
                        m = col == o
                        nxt[:, m, t] = _TREE_NP_OPS[int(o)](a[:, m, t], bb[:, m, t])
                g = nxt
                off += n
                n //= 2
            out[i : i + chunk] = self.count(g[:, :, 0]).sum(axis=0)
        return out

    def gather_count_dev(self, op: str, row_matrix, pairs):
        """Like gather_count but returns an ENGINE array without forcing a
        host sync — slice-streaming accumulates these so the next chunk's
        upload overlaps the previous chunk's compute."""
        return self.gather_count(op, row_matrix, pairs)

    def gather_count_multi_dev(self, op: str, row_matrix, idx):
        return self.gather_count_multi(op, row_matrix, idx)

    def gather_count_multi_mixed_dev(self, row_matrix, groups, row_major: bool = False):
        """The counts of fold groups ``[(op, idx int[B_g, K_g])]`` ->
        int64[sum B_g] in group order (one ``gather_count_multi`` a group:
        on the host a launch costs nothing)."""
        return np.concatenate([self.gather_count_multi(op, row_matrix, idx) for op, idx in groups])

    def gather_count_tree_dev(self, row_matrix, leaves, opc):
        return self.gather_count_tree(row_matrix, leaves, opc)

    def bit_and(self, a, b):
        return a & b

    def bit_or(self, a, b):
        return a | b

    def bit_xor(self, a, b):
        return a ^ b

    def bit_andnot(self, a, b):
        return a & ~b

    def zeros_like(self, a):
        return np.zeros_like(a)

    def count(self, batch) -> np.ndarray:
        """Per-slice popcounts over the last axis (LUT-based, vectorized)."""
        if batch.size == 0:
            return np.zeros(batch.shape[:-1], dtype=np.int64)
        counts = _POPCNT8[np.ascontiguousarray(batch).view(np.uint8)]
        return counts.reshape(*batch.shape[:-1], -1).sum(axis=-1, dtype=np.int64)

    def batch_intersection_count(self, rows, src, tiled: bool = False) -> np.ndarray:
        if tiled:  # trailing [W/128, 128] word axes -> logical [..., W]
            rows = rows.reshape(*rows.shape[:-2], -1)
            src = src.reshape(*src.shape[:-2], -1)
        return self.count(rows & src)

    # Row-major gather lane: no benefit on host (numpy transposes are
    # views), so the executor keeps slice-major transients.
    supports_row_major_gather = False

    def update_slices(self, matrix, slice_idxs, planes):
        """Functionally replace whole slice planes of a row matrix
        (incremental refresh of a cached matrix after writes)."""
        out = matrix.copy()
        out[list(slice_idxs)] = planes
        return out

    def append_rows(self, matrix, block):
        """Append new rows (axis 1) to a row matrix: [S, R, W] + [S, R', W]."""
        return np.concatenate([matrix, block], axis=1)

    def set_rows(self, matrix, row_start: int, block):
        """Functionally write a block of rows at [.., row_start:, ..] —
        fills preallocated capacity without changing the matrix shape
        (shape changes would recompile jitted kernels downstream)."""
        out = matrix.copy()
        out[:, row_start : row_start + block.shape[1], :] = block
        return out

    def set_rows_at(self, matrix, slots, block):
        """Functionally write rows into ARBITRARY slots (row-pool paging:
        a miss batch scatters into freed slots in one call)."""
        out = matrix.copy()
        out[:, list(slots), :] = block
        return out

    def grow_rows(self, matrix, n: int):
        """Append n zero rows of capacity (row-pool doubling)."""
        s, _, w = matrix.shape
        return np.concatenate(
            [matrix, np.zeros((s, n, w), dtype=matrix.dtype)], axis=1
        )

    def set_plane_rows(self, matrix, slice_idxs, slots, block):
        """Functionally write block[i, j] into (slice_idxs[i], slots[j]) —
        the stale-plane refresh touches only RESIDENT slots, transferring
        resident-rows x stale-slices bytes, not whole capacity planes."""
        out = matrix.copy()
        out[np.ix_(list(slice_idxs), list(slots))] = block
        return out

    def build_planes(self, rows, cols):
        """Bulk sort/segment/scatter build: (row, col) uint64 columns ->
        ``(slice_ids, row_ids, planes uint32[G, W])`` — the device-layout
        word planes the bulk ingest door commits into fragments.  Host
        twin (vectorized numpy); the torch engine runs the same contract on
        device."""
        from pilosa_tpu_torch.bulk.build import build_planes_numpy

        return build_planes_numpy(rows, cols)

    def build_words(self, rows, cols):
        """Sparse form of :meth:`build_planes` (CSR over nonzero plane
        words) — the commit path prefers it on host, where scattering
        a chunk's few-hundred touched words per plane beats
        materializing full planes.  Device engines do NOT implement
        this: a device scatter's output is born dense."""
        from pilosa_tpu_torch.bulk.build import build_words_numpy

        return build_words_numpy(rows, cols)

    def pair_gram(self, matrix):
        """All-pairs AND-count Gram, or None when unsupported (host
        all-pairs popcount would dwarf the direct path)."""
        return None

    def gram_update_rows(self, matrix, gram, slots, old_matrix=None, slice_idxs=None):
        """Rank-k repair of a host AND-count Gram after in-place row
        rewrites: recompute ONLY the dirty rows/columns with one batched
        pair-count pass against the (already patched) resident matrix —
        O(K*R*W) instead of the O(R^2*W) full rebuild.  Returns a NEW
        array (copy-on-write: readers holding the old Gram keep a
        consistent pre-write snapshot; AND is symmetric, so one K x R
        count block fills both the rows and the columns).

        Per-(row, slice) delta mode: with ``old_matrix`` (the pre-patch
        snapshot) and ``slice_idxs`` (the slice planes actually written),
        the dirty rows' counts are ADJUSTED by (new - old) restricted to
        those slices instead of recomputed over the whole span —
        unchanged slices cancel out of the difference, so the dispatch
        covers K x R x |dirty slices| instead of K x R x S.  Falls back
        to the full recompute when the restriction wouldn't pay
        (>= half the slices dirty)."""
        slots = np.asarray(sorted({int(s) for s in slots}), dtype=np.int64)
        n = gram.shape[0]
        pairs = np.empty((len(slots) * n, 2), dtype=np.int32)
        pairs[:, 0] = np.repeat(slots.astype(np.int32), n)
        pairs[:, 1] = np.tile(np.arange(n, dtype=np.int32), len(slots))
        si = sorted({int(s) for s in slice_idxs}) if slice_idxs is not None else None
        if old_matrix is not None and si and 2 * len(si) < matrix.shape[0]:
            new_c = np.asarray(self.gather_count("and", matrix[si], pairs))
            old_c = np.asarray(self.gather_count("and", old_matrix[si], pairs))
            delta = (new_c.astype(np.int64) - old_c.astype(np.int64)).reshape(
                len(slots), n
            )
            block = (np.asarray(gram)[slots, :] + delta).astype(gram.dtype)
        else:
            block = (
                np.asarray(self.gather_count("and", matrix, pairs))
                .reshape(len(slots), n)
                .astype(gram.dtype)
            )
        out = np.array(gram, copy=True)
        out[slots, :] = block
        out[:, slots] = block.T
        return out

    def to_numpy(self, x) -> np.ndarray:
        return np.asarray(x)


class TorchEngine:
    """Word tensors (int32, a bit-exact view of uint32) on one torch device.

    ``device="cuda"`` is the product path: every fused count runs its
    hand-written CUDA kernel.  ``device="cpu"`` runs the same calls on
    the kernels' plain PyTorch versions (the CPU tests).  Asking for
    ``cuda`` without a CUDA device raises — there is no fallback.

    Storage is a plain ``[S, R, W]`` int32 tensor.  Every storage update
    (``set_rows_at``, ``set_plane_rows``, ``update_slices``, ``set_rows``,
    ``grow_rows``, ``append_rows``) returns a NEW tensor and leaves its
    input untouched: the row pool hands readers an unchanging
    ``(positions, matrix)`` snapshot (rowpool.py), which the reference's
    functional array updates gave for free.  A transient peak of two
    pool matrices is the price, as it was there.
    """

    name = "torch"
    # Eager torch does not recompile per shape: exact dispatch shapes.
    wants_static_shapes = False
    # TopN candidate scoring: phase-1 chunks score one slice; a candidate
    # set asked again by a second slice upgrades to one all-slice launch.
    row_scorer_all_slices = True
    supports_single_slice_score = True

    def __init__(self, device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine(device='cuda'): torch.cuda.is_available() is False; "
                "pass device='cpu' (or engine='numpy') to run on the host"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchEngine: unsupported device {dev}")
        self.device = dev
        # Running host->device transfer ledger (bytes), bumped at every
        # upload seam (matrix/block/src uploads).
        self.stat_upload_bytes = 0

    # -- host <-> device ------------------------------------------------

    def _up(self, host) -> torch.Tensor:
        """Upload host words (uint32 or int32 numpy) as int32 on device."""
        a = np.ascontiguousarray(host)
        if a.dtype not in (np.uint32, np.int32):
            raise TypeError(f"TorchEngine: word arrays are uint32, got {a.dtype}")
        self.stat_upload_bytes += a.nbytes
        return bitwise.to_words(a, self.device)

    def _idx(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)

    def asarray(self, x):
        if torch.is_tensor(x):
            return x.to(self.device)
        return self._up(x)

    def to_numpy(self, x) -> np.ndarray:
        """Host copy: int32 word tensors come back as uint32 words, other
        tensors keep their dtype; numpy input passes through (the Gram
        path hands numpy arrays here)."""
        if not torch.is_tensor(x):
            return np.asarray(x)
        out = x.detach().cpu().numpy()
        return out.view(np.uint32) if out.dtype == np.int32 else out

    @staticmethod
    def _counts(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().astype(np.int64)

    def stack(self, rows: list):
        if not rows:
            return torch.zeros((0, 0), dtype=torch.int32, device=self.device)
        return torch.stack([self.asarray(r) for r in rows])

    def stack_rows(self, rows: list):
        """Stack engine-resident rows without a host round trip."""
        return self.stack(rows)

    def stack_slices(self, stacks: list):
        """Stack along the SLICE axis."""
        return self.stack(stacks)

    def matrix(self, host_matrix: np.ndarray):
        """One host->device transfer for an assembled [S, R, W] row matrix."""
        return self._up(host_matrix)

    # -- fused pair counts ----------------------------------------------

    def gather_count_and(self, row_matrix, pairs) -> np.ndarray:
        return self.gather_count("and", row_matrix, pairs)

    def gather_count(self, op: str, row_matrix, pairs) -> np.ndarray:
        """Batched Count(<op>(...)) pair counts -> int64[B] (resident or
        gather kernel; the executor keeps its own cached Gram)."""
        return self._counts(self.gather_count_dev(op, row_matrix, pairs))

    def gather_count_dev(self, op: str, row_matrix, pairs):
        """Like gather_count, but the counts stay on device (int64) so a
        slice-streaming loop can queue the next chunk's upload."""
        return dispatch.gather_count(op, row_matrix.contiguous(), pairs).long()

    def gather_count_multi(self, op: str, row_matrix, idx) -> np.ndarray:
        return self._counts(self.gather_count_multi_dev(op, row_matrix, idx))

    def gather_count_multi_dev(self, op: str, row_matrix, idx):
        return dispatch.gather_count_multi(op, row_matrix.contiguous(), idx).long()

    def gather_count_multi_mixed_dev(self, row_matrix, groups, row_major: bool = False):
        """The counts of fold groups ``[(op, idx int[B_g, K_g])]`` on the
        device (int64[sum B_g], group order): one launch of the mixed
        kernel for every group the staged gate declines
        (``dispatch.gather_count_multi_mixed``); ``row_major`` for a
        row-major [R, S, W] matrix."""
        return dispatch.gather_count_multi_mixed(row_matrix.contiguous(), groups, row_major).long()

    def gather_count_or_multi(self, row_matrix, idx) -> np.ndarray:
        return self.gather_count_multi("or", row_matrix, idx)

    def gather_count_tree(self, row_matrix, leaves, opc) -> np.ndarray:
        return self._counts(self.gather_count_tree_dev(row_matrix, leaves, opc))

    def gather_count_tree_dev(self, row_matrix, leaves, opc):
        return dispatch.gather_count_tree(row_matrix.contiguous(), leaves, opc).long()

    # -- row-major gather lane (tall working sets) -----------------------

    @property
    def supports_row_major_gather(self) -> bool:
        """True exactly where the row-major kernels run (a CUDA device).
        On the CPU the lane would only transpose back to slice-major per
        call, so the executor keeps slice-major matrices there."""
        return self.device.type == "cuda"

    def matrix_rows(self, host_matrix: np.ndarray):
        """Upload a ROW-MAJOR [R, S, W] host block."""
        return self._up(host_matrix)

    def rowmajor_ok(self, n_slices: int, words: int, k: int = 2) -> bool:
        return dispatch.rowmajor_ok(n_slices, words, k)

    def prefer_rowmajor(
        self, n_rows: int, n_slices: int, words: int, n_pairs: int, max_k: int
    ) -> bool:
        """Whether a resident working set of ``n_rows`` rows should live
        in a ROW-MAJOR pool: exactly when dispatch would pick the gather
        kernel for its pair groups (the resident predicate says no) and
        the row-major kernels take this slice count.  Multi-fold groups
        always gather, so parts without pair groups prefer row-major
        whenever the gate allows."""
        return not dispatch.resident_strategy(n_rows, words, n_pairs) and self.rowmajor_ok(
            n_slices, words, max_k
        )

    def gather_count_rowmajor_dev(self, op: str, row_major, pairs):
        return dispatch.gather_count_rowmajor(op, row_major, pairs).long()

    def gather_count_multi_rowmajor_dev(self, op: str, row_major, idx):
        return dispatch.gather_count_multi_rowmajor(op, row_major, idx).long()

    def grow_rows_rm(self, matrix, n: int):
        """Append n zero SLOTS to a row-major [cap, S, W] pool matrix."""
        z = torch.zeros((n,) + tuple(matrix.shape[1:]), dtype=matrix.dtype, device=self.device)
        return torch.cat([matrix, z], dim=0)

    def set_rows_at_rm(self, matrix, slots, block):
        out = matrix.clone()
        out[self._idx(slots)] = self._up(block)
        return out

    def set_plane_rows_rm(self, matrix, slice_idxs, slots, block):
        out = matrix.clone()
        sl, si = self._idx(slots), self._idx(slice_idxs)
        out[sl[:, None], si[None, :]] = self._up(block)
        return out

    # -- TopN candidate scoring -----------------------------------------

    def prepare_topn_src(self, src_stack: np.ndarray):
        """Upload a host [S, W] src stack once per TopN query."""
        return self._up(src_stack)

    def topn_scorer_counts(self, matrix, pos, src_dev) -> np.ndarray:
        """int64[S, K] candidate counts in one launch (gather_src_counts)."""
        return self._counts(dispatch.topn_scorer_counts(matrix, pos, src_dev))

    # -- elementwise + counts -------------------------------------------

    def bit_and(self, a, b):
        return a & b

    def bit_or(self, a, b):
        return a | b

    def bit_xor(self, a, b):
        return a ^ b

    def bit_andnot(self, a, b):
        return a & ~b

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def count(self, batch) -> np.ndarray:
        """Per-row popcounts over the last axis -> int64 (count_rows)."""
        if batch.numel() == 0:
            return np.zeros(tuple(batch.shape[:-1]), dtype=np.int64)
        return self._counts(dispatch.count(batch))

    def batch_intersection_count(self, rows, src, tiled: bool = False) -> np.ndarray:
        """|rows[k] & src| -> int64[K] (count_rows against a shared src).
        Torch matrices are 3-D, so the executor never passes tiled rows."""
        if tiled:
            raise ValueError("TorchEngine stores [S, R, W] matrices: no tiled rows")
        return self._counts(dispatch.batch_intersection_count(rows, src))

    # -- storage updates (copy-on-write, see the class docstring) -------

    def update_slices(self, matrix, slice_idxs, planes):
        out = matrix.clone()
        out[self._idx(slice_idxs)] = self._up(planes)
        return out

    def append_rows(self, matrix, block):
        return torch.cat([matrix, self._up(block)], dim=1)

    def set_rows(self, matrix, row_start: int, block):
        out = matrix.clone()
        out[:, row_start : row_start + block.shape[1]] = self._up(block)
        return out

    def set_rows_at(self, matrix, slots, block):
        out = matrix.clone()
        out[:, self._idx(slots)] = self._up(block)
        return out

    def grow_rows(self, matrix, n: int):
        s, _, w = matrix.shape
        z = torch.zeros((s, n, w), dtype=matrix.dtype, device=self.device)
        return torch.cat([matrix, z], dim=1)

    def set_plane_rows(self, matrix, slice_idxs, slots, block):
        out = matrix.clone()
        si, sl = self._idx(slice_idxs), self._idx(slots)
        out[si[:, None], sl[None, :]] = self._up(block)
        return out

    def build_planes(self, rows, cols):
        """Bulk build lane: ``(slice_ids, row_ids, planes uint32[G, W])``
        with the planes packed on this engine's device
        (``bulk.build.build_planes_torch``: the build_planes kernel on
        the card).  The engine has no ``build_words``, so the bulk door
        commits these dense planes, as on the reference's device engine."""
        from pilosa_tpu_torch.bulk.build import build_planes_torch

        out = build_planes_torch(rows, cols, self.device)
        if len(out[0]):
            self.stat_upload_bytes += 8 * len(rows)
        return out

    # -- all-pairs Gram -------------------------------------------------

    def pair_gram(self, matrix):
        """All-pairs AND-count Gram -> C-contiguous int64[R, R] on the host
        (``kernels.pair_gram``: the tensor-core kernel on the card, the
        plain fp32 product steps on the CPU)."""
        return np.ascontiguousarray(kernels.pair_gram(matrix).cpu().numpy())

    def gram_update_rows(self, matrix, gram, slots, old_matrix=None, slice_idxs=None):
        """Rank-k Gram repair after row rewrites (see
        NumpyEngine.gram_update_rows): one batched pair-count dispatch
        recomputes the dirty rows/columns, or — with ``old_matrix`` and
        ``slice_idxs`` — adjusts them by (new - old) over the written
        slices only when fewer than half the slices are dirty.  Returns a
        new array; the old Gram is untouched."""
        slots = np.asarray(sorted({int(s) for s in slots}), dtype=np.int64)
        n = gram.shape[0]
        pairs = np.empty((len(slots) * n, 2), dtype=np.int32)
        pairs[:, 0] = np.repeat(slots.astype(np.int32), n)
        pairs[:, 1] = np.tile(np.arange(n, dtype=np.int32), len(slots))
        si = sorted({int(s) for s in slice_idxs}) if slice_idxs is not None else None
        if old_matrix is not None and si and 2 * len(si) < matrix.shape[0]:
            sel = self._idx(si)
            new_c = self.gather_count("and", matrix[sel], pairs)
            old_c = self.gather_count("and", old_matrix[sel], pairs)
            delta = (new_c - old_c).reshape(len(slots), n)
            block = (np.asarray(gram)[slots, :] + delta).astype(gram.dtype)
        else:
            block = (
                self.gather_count("and", matrix, pairs)
                .reshape(len(slots), n)
                .astype(gram.dtype)
            )
        out = np.array(gram, copy=True)
        out[slots, :] = block
        out[:, slots] = block.T
        return out


class SliceShard(torch.Tensor):
    """A tensor whose axis 0 is this rank's contiguous block of a
    slice-sharded stack (``MeshEngine``): the global stack has
    ``shape[0] * n`` slices over the mesh's ``n`` ranks, and this rank
    holds ``[rank * shape[0], (rank + 1) * shape[0])``.  The type rides
    every torch op (views, clones, concatenations keep it), so a
    matrix the executor slices (``m[:, :bucket]``) stays known as a
    shard; the engine strips it before any kernel or collective."""


class MeshEngine(TorchEngine):
    """TorchEngine whose slice stacks are sharded over a job of ranks.

    One process drives one GPU.  Every rank holds the same holder and
    executes the same requests in the same order (the lockstep service);
    the leading (slice) axis of every stack and row matrix is split into
    contiguous blocks, one per rank (``parallel.sharded.SliceMesh``), so
    each rank uploads and computes only its block with the port's
    hand-written kernels, and a collective merges: all_reduce for counts
    and the Gram, all_gather for per-slice results and host fetches —
    the multi-GPU analog of the reference's goroutine-per-slice fan-out
    (executor.go:1209-1244).

    A stack whose slice axis does not divide evenly over the ranks (or
    has fewer than 2 slices) is replicated instead: every rank computes
    it whole, with no collective.  Every choice between the two reads
    shapes only, so all ranks make it alike and reach every collective
    in the same order.  On a CUDA device each kernel runs or raises; on
    the CPU (gloo ranks, the tests) the plain versions run, as
    everywhere else in the port.
    """

    name = "mesh"
    # Meshes shard the SLICE axis; a row-major layout would shard rows
    # instead — streaming transients stay slice-major.
    supports_row_major_gather = False
    supports_row_scorer = True
    # TopN scoring always goes through the executor's all-slice scorer;
    # single-slice launches index one slice of a matrix, which only a
    # job of one rank holds whole.
    row_scorer_all_slices = True

    def __init__(self, mesh=None, device=None, timing: bool = False):
        """``mesh``: the rank's ``SliceMesh`` (default: one over the
        initialized process group on ``device``, with ``timing``)."""
        if mesh is None:
            mesh = SliceMesh(device=device, timing=timing)
        super().__init__(mesh.device)
        self.mesh = mesh
        self.timing = mesh.timing
        # Telemetry (never read back into a decision): with the mesh's
        # ``timing``, the local step's wall time between device
        # synchronizations; the collectives' are the mesh's.
        self.stat_local_s = 0.0

    @property
    def supports_single_slice_score(self) -> bool:
        return self.mesh.n_devices == 1

    def prefer_rowmajor(self, n_rows, n_slices, words, n_pairs, max_k) -> bool:
        return False

    # -- shards ------------------------------------------------------------

    def _span(self, local_slices: int) -> tuple[int, int]:
        lo = self.mesh.rank * local_slices
        return lo, lo + local_slices

    def _shards(self, n_slices: int, ndim: int) -> bool:
        """Whether a stack of ``n_slices`` slices is sharded (else
        replicated): the reference's rule, a slice axis of 2 or more that
        divides evenly over the ranks."""
        return ndim >= 2 and n_slices >= 2 and n_slices % self.mesh.n_devices == 0

    def _shard_stack(self, x):
        """Upload (host array) or cut (device tensor) this rank's block of
        a slice stack, or the whole stack where it does not shard."""
        if not self._shards(x.shape[0], x.ndim):
            return self._up(x) if isinstance(x, np.ndarray) else x
        per = x.shape[0] // self.mesh.n_devices
        lo, hi = self._span(per)
        if isinstance(x, np.ndarray):
            t = self._up(x[lo:hi])
        else:
            t = _local(x)[lo:hi].contiguous()
        return t.as_subclass(SliceShard)

    def _block(self, shard, host):
        """The rows of a host array that span the whole slice axis which
        fall in ``shard``'s block."""
        lo, hi = self._span(shard.shape[0])
        return host[lo:hi]

    def _local_sel(self, shard, slice_idxs):
        """(positions into ``slice_idxs``, local slice indices) of the
        global slice indices that fall in ``shard``'s block."""
        lo, hi = self._span(shard.shape[0])
        pos = [i for i, s in enumerate(slice_idxs) if lo <= int(s) < hi]
        return pos, [int(slice_idxs[i]) - lo for i in pos]

    def _timed(self, fn):
        """Run the local step; with ``timing``, between synchronizations."""
        if not self.timing:
            return fn()
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        self.stat_local_s += time.perf_counter() - t0
        return out

    # -- host <-> device ---------------------------------------------------

    def to_numpy(self, x) -> np.ndarray:
        if isinstance(x, SliceShard):
            x = self.mesh.all_gather_cat(_local(x))
        return super().to_numpy(x)

    def stack(self, rows: list):
        return self.stack_slices(rows)

    def stack_slices(self, stacks: list):
        n = len(stacks)
        if not stacks or not self._shards(n, 2):
            return super().stack(stacks)
        lo, hi = self._span(n // self.mesh.n_devices)
        return super().stack(stacks[lo:hi]).as_subclass(SliceShard)

    def matrix(self, host_matrix: np.ndarray):
        """One transfer of this rank's block of an [S, R, W] row matrix."""
        return self._shard_stack(host_matrix)

    # -- elementwise + counts ----------------------------------------------

    def _align(self, a, b):
        """Operands of an elementwise op: a replicated whole stack beside
        a shard is cut to the shard's block."""
        sa, sb = isinstance(a, SliceShard), isinstance(b, SliceShard)
        if sa and not sb and b.dim() >= 2:
            b = self._block(a, b)
        elif sb and not sa and a.dim() >= 2:
            a = self._block(b, a)
        return a, b

    def bit_and(self, a, b):
        a, b = self._align(a, b)
        return a & b

    def bit_or(self, a, b):
        a, b = self._align(a, b)
        return a | b

    def bit_xor(self, a, b):
        a, b = self._align(a, b)
        return a ^ b

    def bit_andnot(self, a, b):
        a, b = self._align(a, b)
        return a & ~b

    def count(self, batch) -> np.ndarray:
        """Per-slice popcounts: ``count_rows`` on the block, all_gather."""
        if not isinstance(batch, SliceShard):
            return super().count(batch)
        local = self._timed(lambda: dispatch.count(_local(batch)))
        return self._counts(self.mesh.all_gather_cat(local))

    def batch_intersection_count(self, rows, src, tiled: bool = False) -> np.ndarray:
        # Single-slice scoring: only a job of one rank takes this path.
        return super().batch_intersection_count(_local(rows), _local(src), tiled)

    # -- fused counts --------------------------------------------------------

    def gather_count_dev(self, op: str, row_matrix, pairs):
        if not isinstance(row_matrix, SliceShard):
            return super().gather_count_dev(op, row_matrix, pairs)
        local = self._timed(lambda: dispatch.gather_count(op, _local(row_matrix).contiguous(), pairs))
        return self.mesh.all_reduce_sum(local.long())

    def gather_count_multi_dev(self, op: str, row_matrix, idx):
        if not isinstance(row_matrix, SliceShard):
            return super().gather_count_multi_dev(op, row_matrix, idx)
        local = self._timed(
            lambda: dispatch.gather_count_multi(op, _local(row_matrix).contiguous(), idx))
        return self.mesh.all_reduce_sum(local.long())

    def gather_count_multi_mixed_dev(self, row_matrix, groups, row_major: bool = False):
        """The local mixed launch on the block and ONE all_reduce for
        every group (the groups' order is the executor's, the same on
        every rank)."""
        if not isinstance(row_matrix, SliceShard):
            return super().gather_count_multi_mixed_dev(row_matrix, groups, row_major)
        local = self._timed(
            lambda: dispatch.gather_count_multi_mixed(_local(row_matrix).contiguous(), groups))
        return self.mesh.all_reduce_sum(local.long())

    def gather_count_tree_dev(self, row_matrix, leaves, opc):
        if not isinstance(row_matrix, SliceShard):
            return super().gather_count_tree_dev(row_matrix, leaves, opc)
        local = self._timed(
            lambda: dispatch.gather_count_tree(_local(row_matrix).contiguous(), leaves, opc))
        return self.mesh.all_reduce_sum(local.long())

    # -- TopN candidate scoring ---------------------------------------------

    def prepare_topn_src(self, src_stack: np.ndarray):
        return self._shard_stack(np.ascontiguousarray(src_stack))

    def topn_scorer_counts(self, matrix, pos, src_dev) -> np.ndarray:
        """int64[S, K] candidate counts: ``gather_src_counts`` on the
        block, all_gather over the slice axis."""
        if not isinstance(matrix, SliceShard):
            return super().topn_scorer_counts(matrix, pos, _local(src_dev))
        local = self._timed(
            lambda: dispatch.topn_scorer_counts(_local(matrix), pos, _local(src_dev)))
        return self._counts(self.mesh.all_gather_cat(local))

    # -- all-pairs Gram -------------------------------------------------------

    def pair_gram(self, matrix):
        """``kernels.pair_gram`` on the block (its int32 counts widened to
        int64 on the card), then an all_reduce of the int64 [R, R]: no
        per-pair sum can overflow at any slice count."""
        if not isinstance(matrix, SliceShard):
            return super().pair_gram(matrix)
        local = self._timed(lambda: kernels.pair_gram(_local(matrix)))
        return np.ascontiguousarray(self.mesh.all_reduce_sum(local.long()).cpu().numpy())

    def gram_update_rows(self, matrix, gram, slots, old_matrix=None, slice_idxs=None):
        # No restricted-slice delta on meshes: a subset of the slice axis
        # does not split evenly over the ranks.  The full recompute is
        # one sharded pair batch on every rank.
        return super().gram_update_rows(matrix, gram, slots)

    # -- storage updates (copy-on-write) -------------------------------------

    def update_slices(self, matrix, slice_idxs, planes):
        if not isinstance(matrix, SliceShard):
            return super().update_slices(matrix, slice_idxs, planes)
        pos, local = self._local_sel(matrix, slice_idxs)
        if not pos:
            return matrix
        return super().update_slices(matrix, local, np.asarray(planes)[pos])

    def set_plane_rows(self, matrix, slice_idxs, slots, block):
        if not isinstance(matrix, SliceShard):
            return super().set_plane_rows(matrix, slice_idxs, slots, block)
        pos, local = self._local_sel(matrix, slice_idxs)
        if not pos:
            return matrix
        return super().set_plane_rows(matrix, local, slots, np.asarray(block)[pos])

    def set_rows_at(self, matrix, slots, block):
        if isinstance(matrix, SliceShard):
            block = self._block(matrix, block)
        return super().set_rows_at(matrix, slots, block)

    def set_rows(self, matrix, row_start: int, block):
        if isinstance(matrix, SliceShard):
            block = self._block(matrix, block)
        return super().set_rows(matrix, row_start, block)

    def append_rows(self, matrix, block):
        if isinstance(matrix, SliceShard):
            block = self._block(matrix, block)
        return super().append_rows(matrix, block)


def new_engine(name: str = "auto"):
    """Engine factory: "torch" and "auto" are ``TorchEngine("cuda")`` (which
    raises without CUDA), "mesh" a ``MeshEngine`` on the card over the
    initialized process group (a job of one without one), "numpy" the
    host engine, and "torch:cpu" / "mesh:cpu" the torch engines on the
    CPU (plain versions; only when asked for)."""
    if name in ("auto", "torch"):
        return TorchEngine("cuda")
    if name == "torch:cpu":
        return TorchEngine("cpu")
    if name == "mesh":
        return MeshEngine(device="cuda")
    if name == "mesh:cpu":
        return MeshEngine(device="cpu")
    if name == "numpy":
        return NumpyEngine()
    raise ValueError(f"unknown engine: {name!r}")
