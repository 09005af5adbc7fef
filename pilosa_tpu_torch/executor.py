"""Query executor: PQL call trees over batched, slice-stacked bitmaps.

Reference analog: executor.go (1305 LoC).  The reference maps every call
over slices with a goroutine per slice and per node (executor.go:1115-1244)
and reduces channel results.  Here the map phase over *local* slices is a
single batched evaluation: bitmap leaves gather dense rows into a
``uint32[n_slices, W]`` stack and each set-op/count applies to the whole
stack in one engine call (a CUDA kernel on the card — the per-slice loop
becomes a vectorized axis, the device-native shape of the same mapReduce).

Remote slices (multi-node) go through ``self.cluster`` /
``self.client_factory`` exactly like the reference's remote exec
(executor.go:1009-1091): the call tree is forwarded with opt.remote=True
and the peer executes its own slice batch.

Dispatch table (executor.go:156-179): Bitmap, Intersect, Union,
Difference, Xor(n/a in reference v0 — kept local), Range, Count, TopN,
SetBit, ClearBit, SetRowAttrs, SetColumnAttrs.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import OrderedDict
from functools import partial
from dataclasses import dataclass, field, replace as dc_replace
from datetime import datetime
from typing import Any, Optional, Sequence

import numpy as np

from pilosa_tpu_torch import native as native_mod
from pilosa_tpu_torch import pql
from pilosa_tpu_torch.analysis import lockcheck
from pilosa_tpu_torch import qcache as qcache_mod
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core.fragment import TopOptions
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core.view import VIEW_INVERSE, VIEW_STANDARD
from pilosa_tpu_torch.engine import new_engine
from pilosa_tpu_torch.rowpool import DeviceRowPool, chunk_queries, pool_capacity
from pilosa_tpu_torch.pilosa import (
    ErrFrameInverseDisabled,
    ErrFrameNotFound,
    ErrIndexNotFound,
    ErrQueryRequired,
    ErrTooManyWrites,
    PilosaError,
    SLICE_WIDTH,
)

# Frame used when a call doesn't specify one (executor.go:33-35).
DEFAULT_FRAME = "general"


_WORDS = SLICE_WIDTH // 32
# Bytes of one row in one slice: a launch's floor is its distinct rows x
# slices x this (the launch spans' ``bytes_read``, ``fused``'s
# ``need_bytes``).
_ROW_SLICE_BYTES = SLICE_WIDTH // 8

# Device kernels accumulate counts in int32: one dispatch may cover at
# most this many slices, since a full-density count is n_slices * 2^20 per
# query and 2047 * 2^20 < 2^31.  Wider spans chunk the slice axis and sum
# the per-chunk partials in int64 HOST-side (same bound as the Gram's
# _GRAM_SLICES_MAX).
_INT32_SAFE_SLICES = 2047


# --- fused tree compilation helpers (executor.go:261-276, fused) -----------
#
# An arbitrary nested Count tree compiles to a PERFECT binary tree:
# ``leaves`` = 2^D gathered row ids in-order, ``opc`` = 2^D - 1 internal
# node opcodes level-major bottom-up (ops.bitwise.gather_count_tree
# documents the encoding).  N-ary associative nodes (Intersect/Union/Xor)
# balance into log-depth subtrees; n-ary Difference rewrites as
# a &~ (b | c | ...) — identical to the left fold a &~ b &~ c.  PASS
# nodes (take the left child) pad odd arities and unbalanced nesting.

_TREE_OP_IDS = {"and": 0, "or": 1, "xor": 2, "andnot": 3}
_TREE_PASS = 4
# 16 leaves per query; deeper trees take the sequential path (a single
# PQL call nested past depth 4 is vanishingly rare — dashboards batch
# WIDE, not deep).
_TREE_DEPTH_MAX = 4


class _TreeUnfusable(Exception):
    """Tree shape outside the fused lane (not an error — sequential path)."""


# First frame reference in a request (double-quoted, single-quoted, or
# bare identifier) — picks the serve-state candidate in the fast lane.
_FRAME_SNIFF_RX = re.compile(
    r'frame\s*=\s*(?:"([a-z][a-z0-9_-]{0,64})"'
    r"|'([a-z][a-z0-9_-]{0,64})'"
    r"|([a-z][a-z0-9_-]{0,64}))"
)


def _group_sort_key(kv):
    """Deterministic dispatch order over mixed group keys: plain-op
    groups key on (op-string, arity); tree groups on ("tree", K)."""
    op, kb = kv[0]
    return (str(op[0]) if isinstance(op, tuple) else op, kb)


def _launch_batches(groups: dict) -> list:
    """A resident part's launches, in ``_group_sort_key`` order: each
    pair (K = 2) and tree group alone, and every N-ary group together in
    one batch (one launch of the mixed kernel), at the first one's place.
    Each batch is a list of ``(group key, call indices)``."""
    out, nary = [], None
    for gk, op_idxs in sorted(groups.items(), key=_group_sort_key):
        op, kb = gk
        if kb == 2 or isinstance(op, tuple):
            out.append([(gk, op_idxs)])
            continue
        if nary is None:
            nary = []
            out.append(nary)
        nary.append((gk, op_idxs))
    return out


def _fold_ids(op: str, kb: int, op_idxs, matched, id_pos, bb: int) -> np.ndarray:
    """int32[bb, kb]: each call's operand positions, padded to ``kb``
    with an operand the fold ignores (and / or: the first; andnot: the
    second), and rows past the calls repeating the first call's."""
    rows = [[id_pos[x] for x in matched[i][3]] for i in op_idxs]
    if bb == len(rows) and all(len(pos) == kb for pos in rows):
        return np.array(rows, dtype=np.int32)  # exact arities: nothing to pad
    idx_arr = np.zeros((bb, kb), dtype=np.int32)
    for r, pos in enumerate(rows):
        idx_arr[r, : len(pos)] = pos
        idx_arr[r, len(pos):] = pos[0] if op != "andnot" else pos[1]
    idx_arr[len(rows):] = idx_arr[0]
    return idx_arr


def _tree_depth(node) -> int:
    if isinstance(node, int):
        return 0
    return 1 + max(_tree_depth(node[1]), _tree_depth(node[2]))


def _tree_balanced(op_id: int, nodes: list):
    """Balanced combine under one associative op (the left-fold semantics
    of n-ary Intersect/Union/Xor are order-independent)."""
    while len(nodes) > 1:
        nxt = [
            (op_id, nodes[i], nodes[i + 1]) for i in range(0, len(nodes) - 1, 2)
        ]
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


def _tree_fill(d: int, fill: int):
    """A perfect PASS-subtree of depth d over the fill leaf."""
    if d == 0:
        return fill
    sub = _tree_fill(d - 1, fill)
    return (_TREE_PASS, sub, sub)


def _tree_pad(node, d: int, fill: int):
    """Pad a tree to PERFECT depth d (PASS nodes keep the left value)."""
    if d == 0:
        return node
    if isinstance(node, int):
        return (_TREE_PASS, _tree_pad(node, d - 1, fill), _tree_fill(d - 1, fill))
    return (node[0], _tree_pad(node[1], d - 1, fill), _tree_pad(node[2], d - 1, fill))


def _tree_flatten(node, d: int) -> tuple[list[int], list[int]]:
    """(leaves in-order, opcodes level-major bottom-up) of a perfect tree."""
    leaves: list[int] = []
    levels: list[list[int]] = [[] for _ in range(d)]

    def walk(n, h):
        if h == 0:
            leaves.append(n)
            return
        op, l, r = n
        levels[h - 1].append(op)  # DFS keeps each level left-to-right
        walk(l, h - 1)
        walk(r, h - 1)

    walk(node, d)
    return leaves, [o for lv in levels for o in lv]


@dataclass
class ExecOptions:
    """Execution options (executor.go ExecOptions)."""

    remote: bool = False
    exclude_attrs: bool = False
    # Request deadline (qos.Deadline): checked at cheap checkpoints
    # between calls and between fan-out slice chunks, and forwarded to
    # remote nodes as the remaining budget.  None = unbounded.
    deadline: Any = None
    # Per-request qcache bypass (X-Pilosa-No-Cache: the request neither
    # reads nor stores a query-result cache entry) — the A/B lever for
    # hit-rate measurement and stale-read debugging.
    no_cache: bool = False
    # Request trace span (trace.Span): the root the serving door opened
    # for a SAMPLED request.  None (the common case) keeps every
    # instrumentation site a single branch — the tracing-off path adds
    # no objects and no calls.
    span: Any = None
    # Strategy plan from the cost-based planner (planner.Planner
    # plan_for): {"fp", "lane", "src", "confidence"}, JSON-clean so the
    # lockstep service ships it on the batch wire entry like the expiry
    # and sampling flags — the executor APPLIES plans but never makes
    # them, so every rank runs rank 0's decision.  None (and a plan
    # whose lane is None) keeps the static strategy ladder bit-exact.
    plan: Any = None


class QueryBitmap:
    """A bitmap query result: per-slice dense segments + optional attrs.

    Reference analog: bitmap.go's segment-list Bitmap (bitmap.go:27-134).
    Segments map slice -> uint32[W] packed words in *slice-local* bit
    positions; global column = slice*SLICE_WIDTH + local position.
    """

    def __init__(self, segments: Optional[dict[int, np.ndarray]] = None, attrs: Optional[dict] = None):
        self.segments = segments or {}
        self.attrs = attrs or {}

    def bits(self) -> list[int]:
        out = []
        from pilosa_tpu_torch.ops.bitwise import unpack_positions

        for slice_i in sorted(self.segments):
            pos = unpack_positions(self.segments[slice_i])
            out.extend((pos + np.uint64(slice_i * SLICE_WIDTH)).tolist())
        return out

    def count(self) -> int:
        from pilosa_tpu_torch.roaring import _popcount_words

        return sum(_popcount_words(words) for words in self.segments.values())

    def merge(self, other: "QueryBitmap") -> "QueryBitmap":
        """OR-merge segments (distributed reduce; bitmap.go Merge)."""
        segs = dict(self.segments)
        for s, words in other.segments.items():
            segs[s] = (segs[s] | words) if s in segs else words
        out = QueryBitmap(segs, dict(self.attrs) or dict(other.attrs))
        return out

    def to_json(self) -> dict:
        return {"attrs": self.attrs, "bits": self.bits()}


BITMAP_CALLS = frozenset({"Bitmap", "Intersect", "Union", "Difference", "Xor", "Range"})


def needs_slices(calls: Sequence[pql.Call]) -> bool:
    return any(c.name in BITMAP_CALLS or c.name in ("Count", "TopN") for c in calls)


@lockcheck.guarded_class
class Executor:
    # Lockset race detector declarations: the device-state pools move
    # under their dedicated leaf locks.  These fields are containers
    # mutated in place, so the static guarded-fields rule carries most
    # of the enforcement (the runtime half sees rebinds only).
    _guarded_by_ = {
        "_matrix_cache": "executor._matrix_mu",
        "_multi_matrix_cache": "executor._matrix_mu",
        "_serve_states": "executor._matrix_mu",
        "_dirty_rows": "executor._dirty_mu",
        # Monotonic invalidation counter for the per-thread armed lane
        # tables (each thread's tables are private; only the epoch is
        # shared, written on frame/index drops).
        "_lane_epoch": "executor._matrix_mu",
    }

    def __init__(
        self,
        holder,
        engine: str = "auto",
        cluster=None,
        client_factory=None,
        host: str = "",
        max_writes_per_request: int = 0,
        write_queue: bool = False,
        serve_state_cache: int = 0,
        repair_rows_max: Optional[int] = None,
        gram_rows_max: int = 0,
        no_gram: Optional[bool] = None,
        stream_bytes: int = 0,
        slice_chunk: int = 0,
        matrix_cache_entries: int = 0,
        matrix_rows_max: int = 0,
        qcache: Any = "env",
        stats=None,
    ):
        self.holder = holder
        self.engine = new_engine(engine) if isinstance(engine, str) else engine
        self.cluster = cluster  # cluster.Cluster; None = single node
        self.client_factory = client_factory  # host -> client with .query()
        self.host = host
        self.max_writes_per_request = max_writes_per_request
        # Device-resident row matrices for the fused count-intersect path,
        # keyed by (index, frame, view, slices) and validated by per-fragment
        # write generations — steady-state fused requests cost zero
        # host→device row traffic.
        self._matrix_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        # Multi-view matrices for the fused Range path, keyed by
        # (index, frame, views, slices); validated the same way.
        self._multi_matrix_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._matrix_mu = lockcheck.named_lock("executor._matrix_mu")
        # Tuning-knob precedence, uniform across every routed knob below:
        # constructor arg (the server passes Config fields, which already
        # fold CLI > env > config file) > raw env var (deprecated spelling
        # for directly-constructed executors) > default.
        self._matrix_cache_entries = matrix_cache_entries or int(
            os.environ.get("PILOSA_TPU_MATRIX_CACHE_ENTRIES", "4")  # analysis-ok: env-knob-outside-config: deprecated spelling for directly-constructed executors
        )
        self._matrix_rows_max = matrix_rows_max or int(
            os.environ.get("PILOSA_TPU_MATRIX_ROWS_MAX", "1024")  # analysis-ok: env-knob-outside-config: deprecated spelling for directly-constructed executors
        )
        # Group-commit micro-batching for singleton SetBit requests (the
        # server enables this; see pilosa_tpu_torch/ingest.py), and read
        # COALESCING for concurrent flat-lane count requests: under
        # thread contention the rotating leader concatenates many
        # requests' pair arrays into ONE vectorized evaluation (one
        # native gram-lane call for the union), instead of N threads
        # fighting over the interpreter per request.
        self._write_queue = None
        self._serve_queue = None
        # Per-THREAD armed tables for the write lanes (the table-per-
        # thread registry extending PR-10's armed-table validity rule):
        # each serving thread owns a private {(index, frame) -> arm}
        # pair — (idx_obj, frame_obj) tuples for the singleton regex
        # lane, armed request dicts for the native write lane — so
        # concurrent writers neither share nor lock one table.  Every
        # entry is still identity-revalidated per request (frame
        # deletion/recreation yields new objects; the per-fragment
        # container table's own validity lives in Fragment._writelane),
        # so a stale entry is never wrong, just a wasted probe; the
        # epoch below exists to release dead index/frame objects
        # promptly on explicit drops.
        self._lane_local = threading.local()
        self._lane_epoch = 0
        self._writelane_env: Optional[bool] = None  # lazy env-gate read
        self._fastwrite_env: Optional[bool] = None  # lazy env-gate read
        # Cached serve states for the single-call native read lane
        # (_flat_fast_path), keyed (index, frame) in a small LRU so a
        # workload alternating between a few frames' dashboards doesn't
        # thrash one slot.  Each entry is captured when a warm Gram
        # answers a single-frame flat batch, revalidated per request by
        # fragment generations + max_slice, dropped on any mismatch.
        self._serve_states: "OrderedDict[tuple[str, str], dict]" = OrderedDict()
        # LRU capacity: constructor arg (server passes Config.serve_state_cache)
        # > PILOSA_SERVE_STATE_CACHE env > default 4 entries.  One entry per
        # (index, frame) dashboard; size for the number of frames a workload
        # alternates between.
        if serve_state_cache <= 0:
            serve_state_cache = int(os.environ.get("PILOSA_SERVE_STATE_CACHE", "4"))
        self._serve_states_max = max(1, serve_state_cache)
        # Warm-state repair budget: a write burst touching at most this many
        # distinct rows gets the PATCH lane (in-place matrix row rewrite +
        # rank-k Gram repair); bigger deltas fall back to the full
        # invalidate-and-rebuild.  0 disables repair entirely (A/B lever;
        # bench_mixed uses it for the rebuild baseline).  Precedence
        # matches serve_state_cache: constructor arg (server passes
        # Config.repair_rows_max) > PILOSA_TPU_REPAIR_ROWS_MAX env >
        # default 64 (None = not configured; 0 is meaningful).
        if repair_rows_max is None:
            # analysis-ok: env-knob-outside-config: deprecated spelling for directly-constructed executors
            repair_rows_max = int(os.environ.get("PILOSA_TPU_REPAIR_ROWS_MAX", "64"))
        self._repair_rows_max = repair_rows_max
        # Gram row ceiling override (same precedence; 0 = env/default,
        # resolved lazily in _gram_env alongside the NO_GRAM switch).
        self._gram_rows_max_cfg = gram_rows_max
        # Routed strategy knobs (ctor > env > default; None/0 = fall
        # through to the deprecated env spelling).
        self._no_gram_cfg = no_gram
        self._stream_bytes_cfg = int(stream_bytes)
        self._slice_chunk_cfg = int(slice_chunk)
        # Cost-based strategy planner (planner.Planner) and background
        # pre-armer (planner.PreArmer).  The executor never CONSULTS the
        # planner — plans arrive on ExecOptions.plan from the front door
        # — it only folds outcomes back (record) and signals the
        # pre-armer from its serve/invalidate seams.  None (the default
        # everywhere but the configured server) keeps each seam one
        # branch, the same contract as the meter and tracing.
        self.planner = None
        self.prearmer = None
        # Per-(index, frame) dirty-row ledger fed by the write paths: the
        # serve-state patch lane's cheap budget precheck (the exact
        # generation-anchored delta comes from the fragment dirty-row
        # journals, which also cover non-executor writers).  Value None =
        # saturated (a burst blew past the budget; rebuild, don't walk
        # journals).
        self._dirty_rows: dict[tuple[str, str], Optional[set]] = {}
        self._dirty_mu = lockcheck.named_lock("executor._dirty_mu")
        self._gram_env_cache: Optional[tuple[bool, int]] = None  # lazy env read
        # Generation-keyed query result cache (qcache.QueryCache), the
        # whole-query memoization layer in front of every read path.
        # Default sentinel "env" = enabled only when PILOSA_TPU_QCACHE is
        # truthy, so directly-constructed executors (tests, benches,
        # embedders) keep pre-qcache behavior; the server and lockstep
        # service pass a configured instance (or None = disabled).
        if qcache == "env":
            qcache = qcache_mod.from_env()
        self.qcache = qcache
        # Device-side cost attribution (costs.DispatchMeter): the engine
        # dispatch seams — gram / gather / stream / native — emit
        # per-dispatch wall time + transfer bytes as tagged histograms
        # and, for traced requests, "device" child spans.  None (the
        # default for directly-constructed executors) keeps every seam a
        # single ``meter is None`` branch, the same contract as tracing.
        self.meter = None
        if stats is not None:
            from pilosa_tpu_torch import costs as costs_mod

            self.meter = costs_mod.DispatchMeter(stats, engine=self.engine)
        if write_queue:
            from pilosa_tpu_torch.ingest import WriteQueue

            self._write_queue = WriteQueue(self._apply_queued_writes)
            self._serve_queue = WriteQueue(self._apply_queued_reads, max_batch=64)

    def _lane_tables(self):
        """This thread's private armed write-lane tables:
        ``(fastwrite, writelane)`` dicts keyed (index, frame).

        Thread-private, so no lock and no cross-thread mutation; a
        drop_frame_state/drop_index_state bumps ``_lane_epoch`` and
        every thread discards its own tables at next access.  A thread
        racing the bump may finish one more request on a stale entry —
        harmless, because both lanes revalidate index/frame object
        identity (and the fragment container table its generation)
        before every use.
        """
        loc = self._lane_local
        epoch = self._lane_epoch
        if getattr(loc, "epoch", None) != epoch:
            loc.epoch = epoch
            loc.fastwrite = {}
            loc.writelane = {}
        return loc.fastwrite, loc.writelane

    # -- top level (executor.go:65-153) ----------------------------------

    def execute(
        self,
        index: str,
        query,
        slices: Optional[Sequence[int]] = None,
        opt: Optional[ExecOptions] = None,
    ) -> list[Any]:
        if opt is not None and opt.deadline is not None:
            # Door checkpoint: an already-expired request never touches
            # the serve lane (fast paths included).
            opt.deadline.check("pre-execution")
        # Request trace span (None = unsampled: every site below is one
        # branch).  Tags record the cache disposition and which strategy
        # lane answered; child spans time the stages.
        span = opt.span if opt is not None else None
        qtoken = None
        if isinstance(query, str):
            # Query result cache: a valid generation-keyed entry answers
            # the whole request here — no parse, no dispatch, no device
            # work.  A cacheable miss carries a _Pending token through
            # execution; the read return paths below commit it (errors
            # propagate past the commit, so they are never cached).
            if self.qcache is not None:
                remote = bool(opt is not None and opt.remote)
                if opt is not None and opt.no_cache:
                    self.qcache.note_bypass()
                    if span is not None:
                        span.tags["qcache"] = "bypass"
                elif query[:64].lstrip()[:9].startswith(("SetBit(", "ClearBit(")):
                    # Cheap write sniff: a body whose first call mutates
                    # is write-bearing and can never be cached — skip
                    # the eligibility probe's memoized parse so the
                    # write lanes never pay it (every write body is a
                    # distinct string, so the memo never hits for them).
                    self.qcache.note_ineligible()
                    if span is not None:
                        span.tags["qcache"] = "ineligible"
                elif self.cluster is not None and not remote:
                    # Multi-node coordinator scope: the answer covers
                    # remotely-owned slices, but cluster writes apply
                    # only on owner nodes — the LOCAL generation vector
                    # can never see them, so such an entry would serve
                    # stale reads forever.  Remote sub-requests (explicit
                    # locally-owned slices, whose writes always land
                    # locally on every owner) stay cacheable.
                    self.qcache.note_ineligible()
                    if span is not None:
                        span.tags["qcache"] = "ineligible"
                else:
                    # Order-insensitive slice-set key; an explicit empty
                    # list stays distinct from None (= all slices).
                    skey = None if slices is None else tuple(sorted(slices))
                    qsp = span.child("qcache.lookup") if span is not None else None
                    cached, qtoken = self.qcache.lookup(
                        self.holder, index, query, skey, remote=remote, span=qsp,
                    )
                    if qsp is not None:
                        qsp.finish()
                        # qtoken None without a hit = the lookup judged
                        # the query ineligible (write-bearing tree, ...).
                        span.tags["qcache"] = (
                            "hit" if cached is not None
                            else "miss" if qtoken is not None
                            else "ineligible"
                        )
                    if cached is not None:
                        return cached
            # Singleton lane first: for n=1 the regex + fused
            # pn_array_add_logged path is already one crossing and
            # beats pn_write_batch's 22-arg marshalling; the native
            # batch lane owns everything the singleton shape declines
            # (multi-call bodies, ClearBit batches, NO_FASTWRITE A/B).
            w = self._singleton_write_fast(index, query, slices, opt)
            if w is not None:
                if span is not None:
                    span.tags["lane"] = "write_fast"
                return w
            w = self._write_fast_lane(index, query, slices, opt)
            if w is not None:
                if span is not None:
                    span.tags["lane"] = "write_native"
                return w
            flsp = span.child("flat") if span is not None else None
            fast = self._flat_fast_path(index, query, slices, opt, flsp)
            if flsp is not None:
                flsp.finish()
                # The compiled lanes tag the one they try ("lane"); the
                # last one tried declined when nothing answered.
                tried = flsp.tags.pop("lane", "none")
                flsp.tags["lane" if fast is not None else "declined"] = tried
            if fast is not None:
                if span is not None:
                    # The compiled-query lane answered (native serve /
                    # Gram / gather kernels behind one entry point).
                    span.tags["lane"] = "flat"
                if qtoken is not None:
                    self._qcache_commit(qtoken, fast, span)
                return fast
            psp = span.child("parse") if span is not None else None
            query = pql.parse_cached(query, psp)
            if psp is not None:
                psp.finish()
        if not query.calls:
            raise ErrQueryRequired("query required")
        if self.max_writes_per_request and query.write_call_n() > self.max_writes_per_request:
            raise ErrTooManyWrites(
                f"too many write commands: {query.write_call_n()} > {self.max_writes_per_request}"
            )
        idx = self.holder.index(index)
        if idx is None:
            raise ErrIndexNotFound(index)
        opt = opt or ExecOptions()

        std_slices = list(slices) if slices else None
        inv_slices = None
        if std_slices is None and needs_slices(query.calls):
            std_slices = list(range(idx.max_slice() + 1))
            inv_slices = list(range(idx.max_inverse_slice() + 1))

        if (
            self._write_queue is not None
            and not opt.remote
            and len(query.calls) == 1
            and query.calls[0].name == "SetBit"
        ):
            # Singleton SetBit: group-commit through the ingest queue.
            # Args are parsed HERE (one client's malformed call raises on
            # its own request, never poisoning a shared batch) and the
            # parsed tuple rides along so the committer doesn't re-parse.
            try:
                parsed = self._set_bit_args(index, query.calls[0])
            except (PilosaError, ValueError):
                pass  # sequential path surfaces the exact error
            else:
                return [self._write_queue.submit((index, query.calls[0], parsed))]

        batched_writes = self._fuse_set_bit_batch(index, query.calls, opt)
        if batched_writes is not None:
            return batched_writes

        fsp = span.child("fused") if span is not None else None
        fused = self._fuse_count_pair_batch(
            index, query.calls, std_slices, inv_slices, opt, fsp
        )
        if fused is None:
            fused = self._fuse_count_range_batch(index, query.calls, std_slices, opt, fsp)
        if fsp is not None:
            fsp.finish()
            if fused is None:
                # No fused group matched: the span only measured the
                # (cheap) match attempt — drop it from the tree.
                span.children.remove(fsp)
            else:
                fsp.tags["calls"] = len(fused)
                fsp.tags["slices"] = len(std_slices or [])
                span.tags["lane"] = "fused"

        results = []
        for i, call in enumerate(query.calls):
            if opt.deadline is not None and i:
                # Cancellation checkpoint between calls: an expired
                # request stops here instead of finishing the batch.
                opt.deadline.check("between calls")
            if fused is not None and i in fused:
                results.append(fused[i])
                continue
            csp = span.child(f"call.{call.name}") if span is not None else None
            call_slices = std_slices
            if call.supports_inverse() and std_slices is not None and inv_slices is not None:
                frame_name = call.string_arg("frame") or DEFAULT_FRAME
                frame = self.holder.frame(index, frame_name)
                if frame is None:
                    raise ErrFrameNotFound(frame_name)
                if call.is_inverse(frame.row_label, idx.column_label):
                    call_slices = inv_slices
            # The call's fan-out/remote spans nest under the call span
            # (shallow option copy — opt itself is shared state).
            call_opt = opt if csp is None else dc_replace(opt, span=csp)
            results.append(self._execute_call(index, call, call_slices, call_opt))
            if csp is not None:
                csp.finish()
        if qtoken is not None:
            self._qcache_commit(qtoken, results, span)
        return results

    def _qcache_commit(self, qtoken, results, span) -> None:
        """Admit an executed miss to the query cache (a ``qcache.commit``
        span under a traced request's root)."""
        csp = span.child("qcache.commit") if span is not None else None
        self.qcache.commit(self.holder, qtoken, results)
        if csp is not None:
            csp.finish()

    # -- query-batch fusion ------------------------------------------------

    def _fuse_set_bit_batch(
        self, index: str, calls, opt: ExecOptions
    ) -> Optional[list[bool]]:
        """Batch an all-SetBit request into vectorized per-frame writes.

        The write-path analog of the count-intersect fusion: a request
        carrying N SetBit calls costs one fragment pass + one WAL append
        per touched (view, slice) — and one forwarded request per remote
        owner node — instead of N of each (executor.go:675-698 does N).
        Only fires when the WHOLE request is SetBit calls, so per-call
        ordering against reads is preserved; per-call changed bools are
        identical to the sequential path (first duplicate wins).

        Failure semantics differ from sequential on purpose: local writes
        are all applied first, then remote forwards — so a node failure
        leaves every locally-owned bit committed (sequential leaves a
        call-order prefix).  SetBit is idempotent, so a client retry
        converges to the same state on either path.
        """
        if len(calls) < 2 or any(c.name != "SetBit" for c in calls):
            return None
        try:
            parsed = [self._set_bit_args(index, c) for c in calls]
        except (PilosaError, ValueError):
            # Surface the error through the sequential path, which also
            # preserves its partial-commit semantics (calls before the bad
            # one take effect, exactly as if executed one by one).
            return None
        return self._commit_set_bits(index, calls, parsed, opt)

    def _commit_set_bits(self, index: str, calls, parsed, opt: ExecOptions) -> list[bool]:
        """Apply pre-parsed SetBit tuples: vectorized local writes + one
        forwarded request per remote owner node (shared by the fused
        batch path and the ingest queue's committer)."""
        changed = [False] * len(calls)

        # Ownership split: local writes for slices this node owns, one
        # batched forward per remote owner node.
        by_node: dict[str, list[int]] = {}
        if opt.remote or self.cluster is None or self.client_factory is None:
            local_idx = list(range(len(calls)))
        else:
            local_idx = []
            for i, (_, _, col_id, _) in enumerate(parsed):
                for node in self.cluster.fragment_nodes(index, col_id // SLICE_WIDTH):
                    if node.host == self.host:
                        local_idx.append(i)
                    else:
                        by_node.setdefault(node.host, []).append(i)

        by_frame: dict[Any, list[int]] = {}
        for i in local_idx:
            by_frame.setdefault(parsed[i][0], []).append(i)
        for frame, idxs in by_frame.items():
            rows = np.array([parsed[i][1] for i in idxs], dtype=np.uint64)
            cols = np.array([parsed[i][2] for i in idxs], dtype=np.uint64)
            stamps = [parsed[i][3] for i in idxs]
            ch = frame.set_bits(VIEW_STANDARD, rows, cols, stamps)
            if ch.any():
                self._note_dirty_rows(index, frame.name, rows[ch].tolist())
            if frame.inverse_enabled:
                ch |= frame.set_bits(VIEW_INVERSE, cols, rows, stamps)
            for k, i in enumerate(idxs):
                if ch[k]:
                    changed[i] = True

        for host, idxs in by_node.items():
            client = self.client_factory(host)
            q = pql.Query(calls=[calls[i] for i in idxs])
            res = client.execute_remote(index, q, deadline=opt.deadline)
            for k, i in enumerate(idxs):
                if res and res[k]:
                    changed[i] = True
        return changed

    def _apply_queued_writes(self, items) -> list:
        """Commit one drained queue batch: [(index, call, parsed)] ->
        per-item changed bools, via the fused vectorized write path (one
        fragment pass + one WAL append per touched view/slice, cluster
        forwarding included).  Uses the parse results captured at submit;
        a frame deleted/recreated in between is caught by ONE re-resolve
        per (index, frame) group and that item re-parsed (an error becomes
        that item's result only — never the batch's)."""
        by_index: dict[str, list[int]] = {}
        for i, (idx_name, _, _) in enumerate(items):
            by_index.setdefault(idx_name, []).append(i)
        results: list = [None] * len(items)
        opt = ExecOptions()
        for idx_name, positions in by_index.items():
            calls = [items[i][1] for i in positions]
            parsed = [items[i][2] for i in positions]
            live = {}
            for k, p in enumerate(parsed):
                fr = p[0]
                ok = live.get(id(fr))
                if ok is None:
                    ok = live[id(fr)] = (
                        self.holder.frame(idx_name, fr.name) is fr
                    )
                if not ok:
                    try:  # stale frame object: re-parse against the holder
                        parsed[k] = self._set_bit_args(idx_name, calls[k])
                    except (PilosaError, ValueError) as e:
                        parsed[k] = e
            ok_pos = [k for k, p in enumerate(parsed) if not isinstance(p, BaseException)]
            for k, p in enumerate(parsed):
                if isinstance(p, BaseException):
                    results[positions[k]] = p  # raised on that submitter only
            if ok_pos:
                res = self._commit_set_bits(
                    idx_name,
                    [calls[k] for k in ok_pos],
                    [parsed[k] for k in ok_pos],
                    opt,
                )
                for j, k in enumerate(ok_pos):
                    results[positions[k]] = res[j]
        return results

    # PQL pair-op -> kernel op for the fused batch path.
    _FUSABLE_OPS = {
        "Intersect": "and",
        "Union": "or",
        "Difference": "andnot",
        "Xor": "xor",
    }
    # The canonical singleton-write shape clients emit (and the reference
    # bench tool generates, ctl/bench.go:71-102): ONE SetBit/ClearBit with
    # positional-canonical args and no timestamp.  Anything else declines
    # to the general path.
    _SINGLETON_WRITE_RX = re.compile(
        r'^\s*(SetBit|ClearBit)\(\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(\d+)\s*,'
        r'\s*frame\s*=\s*"([a-z][a-z0-9_-]{0,64})"\s*,'
        r'\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(\d+)\s*\)\s*$'
    )

    # First frame= reference in a canonical write body (quoted or bare).
    _WRITE_FRAME_SNIFF_RX = re.compile(
        r'frame\s*=\s*(?:"([^"\\]*)"|\'([^\'\\]*)\'|([A-Za-z][A-Za-z0-9._-]*))'
    )

    def _write_fast_lane(self, index: str, src: str, slices, opt) -> Optional[list]:
        """Native write request lane: a canonical all-SetBit/ClearBit
        request body — singleton or batch — runs parse + sorted
        container inserts + WAL group commit in ONE GIL-released
        ``pn_write_batch`` crossing against the armed fragment
        (Fragment.write_batch), the write-side twin of the
        ``pn_serve_pairs`` read lane.  A structurally-declined batch
        still reuses the native PARSE: the ops apply through the
        vectorized Python batch path without ever touching the Python
        tokenizer.  Returns None for anything outside the exact shape —
        clusters, explicit slices, inverse frames, multi-slice frames,
        non-canonical bodies — so the general lane keeps every behavior
        and error message (it is also the differential-test oracle:
        both lanes must produce identical fragment bytes, WAL frames,
        and changed vectors).
        """
        if self.cluster is not None or slices:
            return None
        no_lane = self._writelane_env
        if no_lane is None:
            # Read once per executor (~2 us/op otherwise); tests that
            # toggle the env construct a fresh Executor (or reset
            # _writelane_env to None).
            # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
            no_lane = self._writelane_env = os.environ.get(
                "PILOSA_TPU_NO_WRITELANE", ""
            ).lower() in ("1", "true", "yes")
        if no_lane:
            return None
        head = src[:64].lstrip()[:9]
        if not head.startswith(("SetBit(", "ClearBit(")):
            return None
        if native_mod.load() is None:
            return None
        if self.max_writes_per_request:
            # Exact per canonical shape (one "Bit(" per call); checked
            # BEFORE any mutation so the over-limit error keeps the
            # general path's raise-before-write semantics.
            if src.count("Bit(") > self.max_writes_per_request:
                return None  # general path raises ErrTooManyWrites
        m = self._WRITE_FRAME_SNIFF_RX.search(src, 0, 256)
        if m is None:
            return None
        fname = m.group(1) or m.group(2) or m.group(3)
        _, writelane = self._lane_tables()  # this thread's private table
        st = writelane.get((index, fname))
        if st is None or self.holder.index(index) is not st["idx_obj"]:
            writelane.pop((index, fname), None)
            idx_obj = self.holder.index(index)
            if idx_obj is None:
                return None  # general path raises in canonical order
            frame = idx_obj.frame(fname)
            if frame is None:
                return None
            try:
                st = {
                    "idx_obj": idx_obj,
                    "frame": frame,
                    "frame_b": fname.encode("utf-8"),
                    "rowkey_b": frame.row_label.encode("utf-8"),
                    "colkey_b": idx_obj.column_label.encode("utf-8"),
                    "frag": None,
                }
            except UnicodeEncodeError:
                return None
            writelane[(index, fname)] = st
        idx_obj, frame = st["idx_obj"], st["frame"]
        if idx_obj.frame(fname) is not frame:
            writelane.pop((index, fname), None)
            return None
        if frame.inverse_enabled:
            return None  # dual-view writes: general path
        view = frame.view(VIEW_STANDARD)
        frags = view.fragments if view is not None else {}
        frag = st["frag"]
        if frag is None or frags.get(frag.slice) is not frag:
            # Arm the fragment: the lane serves the canonical single-
            # slice shape (one standard-view fragment); multi-slice
            # frames take the general path.
            if len(frags) != 1:
                st["frag"] = None
                return None
            frag = next(iter(frags.values()))
            st["frag"] = frag
        try:
            raw = src.encode("utf-8")
        except UnicodeEncodeError:
            return None
        if self.meter is not None:
            span = opt.span if opt is not None else None
            with self.meter.measure("native", span) as d:
                res = frag.write_batch(
                    raw, st["frame_b"], st["rowkey_b"], st["colkey_b"]
                )
                d.add_bytes(len(raw))
        else:
            res = frag.write_batch(
                raw, st["frame_b"], st["rowkey_b"], st["colkey_b"]
            )
        if res is None:
            return None
        changed, types, rows, cols = res
        if changed is not None:
            if len(changed) == 1:  # singleton hot path: no numpy work
                ch = bool(changed[0])
                if ch:
                    self._note_dirty_rows(index, fname, (int(rows[0]),))
                return [ch]
            if changed.any():
                self._note_dirty_rows(
                    index, fname, np.unique(rows[changed]).tolist()
                )
            return changed.tolist()
        # Parsed-only: apply through the vectorized Python batch path
        # (sequential scalar path for mixed set/clear bodies, whose
        # in-batch ordering matters).
        if (types == 0).all():
            ch = frame.set_bits(VIEW_STANDARD, rows, cols)
            if ch.any():
                self._note_dirty_rows(index, fname, rows[ch].tolist())
            return ch.tolist()
        out: list[bool] = []
        touched: list[int] = []
        for t, r, c in zip(types.tolist(), rows.tolist(), cols.tolist()):
            if t == 0:
                ok = frame.set_bit(VIEW_STANDARD, r, c)
            else:
                ok = frame.clear_bit(VIEW_STANDARD, r, c)
            if ok:
                touched.append(r)
            out.append(ok)
        if touched:
            self._note_dirty_rows(index, fname, touched)
        return out

    def _singleton_write_fast(self, index: str, src: str, slices, opt) -> Optional[list]:
        """Durable singleton SetBit/ClearBit with minimal per-request
        Python: one regex + cached (index, frame) resolution + the scalar
        frame write.  The general path costs ~10x more per op in parse +
        queue + batched-commit machinery that buys nothing for a single
        bit; under concurrent clients the GIL makes that per-op Python
        THE write-throughput ceiling (BASELINE.md round-4 waiver note).

        Declines (returns None) for anything beyond the simple local
        shape: clusters (owner forwarding), inverse-enabled frames (dual
        writes), non-canonical arg names/order, timestamps, remote opts.
        """
        if self.cluster is not None or slices:
            return None
        no_fast = self._fastwrite_env
        if no_fast is None:
            # A/B lever (BENCH_CONFIG=writelane): disable the regex
            # singleton lane so singletons flow to the native batch
            # lane / general path.  Read once per executor.
            # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
            no_fast = self._fastwrite_env = os.environ.get(
                "PILOSA_TPU_NO_FASTWRITE", ""
            ).lower() in ("1", "true", "yes")
        if no_fast:
            return None
        m = self._SINGLETON_WRITE_RX.match(src)
        if m is None:
            return None
        name, k1, v1, fname, k2, v2 = m.groups()
        fastwrite, _ = self._lane_tables()  # this thread's private table
        cached = fastwrite.get((index, fname))
        if cached is None or self.holder.index(index) is not cached[0]:
            fastwrite.pop((index, fname), None)  # no dead pins
            idx_obj = self.holder.index(index)
            if idx_obj is None:
                return None  # general path raises in canonical order
            frame = idx_obj.frame(fname)
            if frame is None:
                return None
            cached = (idx_obj, frame)
            fastwrite[(index, fname)] = cached
        idx_obj, frame = cached
        if idx_obj.frame(fname) is not frame:
            fastwrite.pop((index, fname), None)
            return None
        if (
            frame.inverse_enabled
            or k1 != frame.row_label
            or k2 != idx_obj.column_label
        ):
            return None
        row_id, col_id = int(v1), int(v2)
        if name == "SetBit":
            ch = frame.set_bit(VIEW_STANDARD, row_id, col_id)
        else:
            ch = frame.clear_bit(VIEW_STANDARD, row_id, col_id)
        if ch:
            self._note_dirty_rows(index, fname, (row_id,))
        return [ch]

    def _flat_fast_path(self, index: str, src: str, slices, opt, fsp=None) -> Optional[list]:
        """Compiled-query lane: serve an all-``Count(<op>(Bitmap,Bitmap))``
        request straight from the native matcher's pair arrays — no Token
        stream, no Call objects, no per-call Python work (the dominant
        host costs of a large batched request).  Returns None for
        ANYTHING outside the exact shape — other calls, inverse views,
        unusual args, parse errors — so the normal parse path keeps every
        behavior and error message.

        ``fsp``: a traced request's ``flat`` span; each compiled lane
        tags it (``lane``) as it is tried, and its dispatches' ``device``
        spans nest under it.
        """
        # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
        if os.environ.get("PILOSA_TPU_NO_FASTLANE", "").lower() in ("1", "true", "yes"):
            return None
        from pilosa_tpu_torch import native

        try:
            raw = src.encode("utf-8")
        except UnicodeEncodeError:
            return None
        opt = opt or ExecOptions()
        local = slices is None and not self._is_distributed(opt)
        # Planner plan, applied at every exit of this lane: the armed
        # native serve path IS the gram strategy family, so a forced
        # "rmgather" plan must skip it (or the alternate lane could
        # never run once a state arms) and every native answer folds
        # back under lane "gram" — steady-state costs keep flowing into
        # the ledger after arming, not just the cold passes.  A lane of
        # None (static/empty ledger) leaves every branch below exactly
        # as it was — the static-parity contract.
        plan = opt.plan
        forced = plan.get("lane") if plan is not None else None
        rec = self.planner is not None and plan is not None
        # Single-call serving lane: with a valid cached serve state the
        # WHOLE request — parse, frame/row-label validation, Gram count
        # identities — runs inside one GIL-released native call
        # (pn_serve_pairs), the steady-state product loop with no
        # per-request Python beyond the validity token check
        # (server.go:150 + executor.go:1209-1244's concurrent serving,
        # compiled).  Concurrent clients call it directly — the native
        # call holds no Python state, so threads overlap inside it
        # (measured: a spinner thread retains full throughput during the
        # call; sustained 16-thread load shows no inversion) — and any
        # decline falls through to the general lane, which refreshes the
        # state.  The serve QUEUE below only coalesces the cold/unarmed
        # path, where per-request Python still dominates.
        if local and self._serve_states and forced != "rmgather":
            # Pick the candidate state by SNIFFING the first frame
            # reference (cheap regex over the request head) instead of
            # trying every armed state — each native attempt re-parses
            # the whole batch, so a decline ladder would tax alternating
            # multi-frame dashboards with a full wasted parse per
            # request.  A servable request is single-frame anyway (the C
            # validator enforces it), so the first reference decides.
            sn = _FRAME_SNIFF_RX.search(src, 0, 512)
            fname = sn.group(1) or sn.group(2) or sn.group(3) if sn else DEFAULT_FRAME
            st = self._serve_states.get((index, fname))
            if st is not None and not self._serve_state_valid(st):
                # Patch lane: a small write repairs the warm state in
                # place (matrix rows + rank-k Gram + glut) and re-arms;
                # only structural or over-budget deltas pop the entry
                # and pay the full rebuild through the general lane.
                st = self._serve_state_repair((index, fname), st)
                if st is None:
                    with self._matrix_mu:
                        self._serve_states.pop((index, fname), None)
            if st is not None:
                t0 = time.perf_counter() if rec else 0.0
                if fsp is not None:
                    fsp.tags["lane"] = "serve"
                if self.meter is not None:
                    with self.meter.measure("native", fsp) as d:
                        counts = native.serve_pairs(
                            raw, st["frame_b"], st["allow_default"],
                            st["rowkey_b"], st["rs"], st["ps"], st["gram"],
                        )
                        d.add_bytes(len(raw))
                else:
                    counts = native.serve_pairs(
                        raw, st["frame_b"], st["allow_default"], st["rowkey_b"],
                        st["rs"], st["ps"], st["gram"],
                    )
                if counts is not None:
                    if opt.span is not None:
                        # Frame attribution for the cost ledger: the
                        # serve lane is single-frame by construction.
                        opt.span.tags["frame"] = fname
                    # Guard: a concurrent invalidation/eviction during
                    # the GIL-released call may have removed the key.
                    # LRU maintenance under _matrix_mu like every other
                    # serve-state mutation (guarded-fields declaration);
                    # the native call above runs outside any lock.
                    with self._matrix_mu:
                        if (index, fname) in self._serve_states:
                            self._serve_states.move_to_end((index, fname))
                    if rec:
                        self.planner.record(
                            index=index, fp=plan.get("fp", ""), lane="gram",
                            ms=(time.perf_counter() - t0) * 1e3, plan=plan,
                        )
                    return counts.tolist()
            # Multi-frame breadth: a batch spanning SEVERAL armed frames
            # (the single-state path above only ever serves one) still
            # answers in one crossing — pn_serve_multi evaluates each
            # call against its frame's glut.  Also covers the case where
            # the sniffed frame's state was just invalidated but the
            # batch's other frames are warm: the native validator simply
            # declines on the missing frame and the general lane re-arms.
            # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
            if len(self._serve_states) > 1 and os.environ.get(
                "PILOSA_TPU_NO_SERVEMULTI", ""
            ).lower() not in ("1", "true", "yes"):
                t0 = time.perf_counter() if rec else 0.0
                if fsp is not None:
                    fsp.tags["lane"] = "serve_multi"
                counts = self._serve_multi_counts(index, raw, opt, fsp)
                if counts is not None:
                    if rec:
                        self.planner.record(
                            index=index, fp=plan.get("fp", ""), lane="gram",
                            ms=(time.perf_counter() - t0) * 1e3, plan=plan,
                        )
                    return counts
        if fsp is not None:
            fsp.tags["lane"] = "pairs"
        m = native.pql_match_pairs(raw)
        if m is None:
            # Not an all-pairs body: the breadth lanes own the other
            # compiled shapes before the tokenizer runs — nested op
            # trees straight off the armed container table, then
            # all-Count(Range(...)) batches through the fused multi-view
            # evaluator with the parse already native.
            if local:
                if fsp is not None:
                    fsp.tags["lane"] = "tree"
                tree = self._tree_fast_path(index, raw, src, opt, fsp)
                if tree is not None:
                    return tree
                if fsp is not None:
                    fsp.tags["lane"] = "range"
                return self._range_fast_path(index, raw, opt)
            return None
        op_ids, frame_ids, key_ids, r1, r2, frames_b, keys_b = m

        # Validate each distinct (frame, row-key) combo once: the key must
        # be the frame's row label (standard view; inverse and unknown
        # labels take the slow path, missing frames raise there too).
        frame_names = [b.decode("utf-8") for b in frames_b]
        key_names = [b.decode("utf-8") for b in keys_b]
        for f_id, k_id in sorted(set(zip(frame_ids.tolist(), key_ids.tolist()))):
            fname = frame_names[f_id] if f_id >= 0 else DEFAULT_FRAME
            fr = self.holder.frame(index, fname)
            if fr is None or key_names[k_id] != fr.row_label:
                return None
        # Index resolution AFTER shape matching keeps error precedence
        # identical to the normal path (shape mismatches never raise here).
        idx_obj = self.holder.index(index)
        if idx_obj is None:
            return None  # normal path raises ErrIndexNotFound in order
        std_slices = list(slices) if slices else list(range(idx_obj.max_slice() + 1))
        if not std_slices:
            return None
        if (
            pool_capacity(len(std_slices), _WORDS) < 64
            or len(std_slices) > _INT32_SAFE_SLICES
        ):
            # Slice-streaming regime (working set >> HBM pool budget) or a
            # slice span past the kernels' int32 count bound: the AST
            # fused path owns the slice-chunked accumulation loop; the
            # flat lane's whole point (skipping per-call Python) is noise
            # against per-chunk upload costs anyway.
            return None

        # A plan with a FORCED lane bypasses the coalescing queue: the
        # queue's fused evaluation is shared across requests (so it runs
        # planless, like the lockstep multi-request join), and a
        # planner-made pick must actually run — and fold back — on its
        # own lane.  Static plans (lane None) keep the queue, bit-exact.
        if self._serve_queue is not None and local and forced is None:
            # Read coalescing: hand the matched arrays to the serve queue;
            # the current leader concatenates every queued request with
            # the same (index, name tables, slice set) into one vectorized
            # evaluation.  Uncontended, the batch is just this request.
            return self._serve_queue.submit(
                (
                    index,
                    (op_ids, frame_ids, r1, r2),
                    (tuple(frames_b), tuple(keys_b)),
                    tuple(std_slices),
                )
            )
        if self._is_distributed(opt):
            # Cluster hop: build the matched dict + forwarded Query (from
            # the parse cache) and reuse the failover machinery.
            matched = {
                i: (
                    frame_names[frame_ids[i]] if frame_ids[i] >= 0 else DEFAULT_FRAME,
                    VIEW_STANDARD,
                    native.PQL_PAIR_OPS[op_ids[i]],
                    (int(r1[i]), int(r2[i])),
                )
                for i in range(len(op_ids))
            }
            idxs = list(range(len(op_ids)))
            return self._fused_dispatch(
                index, idxs, std_slices, opt,
                lambda: pql.parse_cached(src),
                lambda node_slices: self._fused_local_counts(
                    index, matched, idxs, node_slices, plan=opt.plan
                ),
            )
        return self._fused_local_counts_arrays(
            index, frame_names, op_ids, frame_ids, r1, r2, std_slices,
            plan=opt.plan,
        )

    def _serve_state_valid(self, st: dict) -> bool:
        """Cheap per-request token check for the cached serve state:
        index identity, unchanged max slice, and per-slice fragment
        identity + write generation (creation, recreation, and every
        write bump a token)."""
        idx_obj = st["idx_obj"]
        if self.holder.index(st["index"]) is not idx_obj:
            return False
        if idx_obj.max_slice() != st["max_slice"]:
            return False
        index, fname = st["index"], st["fname"]
        for s, frag, gen in st["slots"]:
            f = self.holder.fragment(index, fname, VIEW_STANDARD, s)
            if f is not frag or (f is not None and f.generation != gen):
                return False
        return True

    # -- serve-lane breadth (multi-frame / Range / nested-tree) -----------

    def _serve_multi_counts(self, index: str, raw: bytes, opt, fsp=None) -> Optional[list]:
        """Multi-frame one-call serving: bundle every VALID armed state
        for the index (names, row labels, glut base addresses) and hand
        the whole request to ``pn_serve_multi`` — parse, per-frame
        validation, and Gram count identities in one GIL-released
        crossing.  Any decline (unknown frame, cold frame, unknown row)
        returns None and the general lane re-arms per frame.
        """
        from pilosa_tpu_torch import native

        with self._matrix_mu:
            cands = [st for k, st in self._serve_states.items() if k[0] == index]
        states = [st for st in cands if self._serve_state_valid(st)][:16]
        if len(states) < 2:
            return None
        name_offs = np.zeros(len(states) + 1, dtype=np.int64)
        rlabel_offs = np.zeros(len(states) + 1, dtype=np.int64)
        default_sid = -1
        for i, st in enumerate(states):
            name_offs[i + 1] = name_offs[i] + len(st["frame_b"])
            rlabel_offs[i + 1] = rlabel_offs[i] + len(st["rowkey_b"])
            if st["allow_default"]:
                default_sid = i
        names_cat = b"".join(st["frame_b"] for st in states)
        rlabels_cat = b"".join(st["rowkey_b"] for st in states)
        # Raw glut addresses: the `states` list keeps every array alive
        # across the call; entries evicted concurrently stay pinned here.
        rs_addrs = np.array([st["rs"].ctypes.data for st in states], dtype=np.uint64)
        ps_addrs = np.array([st["ps"].ctypes.data for st in states], dtype=np.uint64)
        gram_addrs = np.array(
            [st["gram"].ctypes.data for st in states], dtype=np.uint64
        )
        n_rows = np.array([len(st["rs"]) for st in states], dtype=np.int64)
        gram_dims = np.array([st["gram"].shape[0] for st in states], dtype=np.int64)
        if self.meter is not None:
            with self.meter.measure("native", fsp) as d:
                counts = native.serve_multi(
                    raw, names_cat, name_offs, rlabels_cat, rlabel_offs,
                    default_sid, rs_addrs, ps_addrs, gram_addrs, n_rows, gram_dims,
                )
                d.add_bytes(len(raw))
        else:
            counts = native.serve_multi(
                raw, names_cat, name_offs, rlabels_cat, rlabel_offs,
                default_sid, rs_addrs, ps_addrs, gram_addrs, n_rows, gram_dims,
            )
        if counts is None:
            return None
        with self._matrix_mu:
            for st in states:
                k = (index, st["fname"])
                if self._serve_states.get(k) is st:
                    self._serve_states.move_to_end(k)
        return counts.tolist()

    def _tree_fast_path(self, index: str, raw: bytes, src: str, opt, fsp=None) -> Optional[list]:
        """Nested-tree serving: an all-Count(op-tree over Bitmap leaves)
        body evaluated straight off the fragment's armed container table
        (``pn_serve_tree`` — matcher and evaluator fused, intermediate id
        arrays never materialize).  Single-slice local indexes only: the
        armed table is per fragment and the whole call runs under that
        fragment's lock.  None for anything outside the shape.
        """
        # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
        if os.environ.get("PILOSA_TPU_NO_SERVETREE", "").lower() in (
            "1", "true", "yes",
        ):
            return None
        idx_obj = self.holder.index(index)
        if idx_obj is None or idx_obj.max_slice() != 0:
            return None
        sn = _FRAME_SNIFF_RX.search(src, 0, 512)
        fname = sn.group(1) or sn.group(2) or sn.group(3) if sn else DEFAULT_FRAME
        fr = self.holder.frame(index, fname)
        if fr is None:
            return None
        frag = self.holder.fragment(index, fname, VIEW_STANDARD, 0)
        if frag is None:
            return None
        try:
            frame_b = fname.encode("ascii")
            rowkey_b = fr.row_label.encode("ascii")
        except UnicodeEncodeError:
            return None
        if self.meter is not None:
            with self.meter.measure("native", fsp) as d:
                counts = frag.serve_tree(
                    raw, frame_b, fname == DEFAULT_FRAME, rowkey_b
                )
                d.add_bytes(len(raw))
        else:
            counts = frag.serve_tree(raw, frame_b, fname == DEFAULT_FRAME, rowkey_b)
        if counts is None:
            return None
        if opt.span is not None:
            opt.span.tags["frame"] = fname
        return counts.tolist()

    def _range_fast_path(self, index: str, raw: bytes, opt) -> Optional[list]:
        """Native Range cover lane: ``pn_pql_match_range`` parses an
        all-Count(Range(...)) body (rows + packed digit timestamps) so
        the batch skips the Python tokenizer and rides the existing fused
        multi-view evaluator.  Validation mirrors the AST fused path —
        any decline (unknown frame, label mismatch, calendar error,
        over-budget cover set) returns None so the sequential path keeps
        every behavior and error message.
        """
        # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
        if os.environ.get("PILOSA_TPU_NO_RANGELANE", "").lower() in (
            "1", "true", "yes",
        ):
            return None
        from pilosa_tpu_torch import native

        m = native.pql_match_range(raw)
        if m is None:
            return None
        frame_ids, key_ids, rows, starts, ends, frames_b, keys_b = m
        frame_names = [b.decode("utf-8") for b in frames_b]
        key_names = [b.decode("utf-8") for b in keys_b]
        frames: dict[int, tuple] = {}
        for f_id, k_id in sorted(set(zip(frame_ids.tolist(), key_ids.tolist()))):
            fname = frame_names[f_id] if f_id >= 0 else DEFAULT_FRAME
            fr = self.holder.frame(index, fname)
            if fr is None or key_names[k_id] != fr.row_label:
                return None
            frames[f_id] = (fname, fr)
        idx_obj = self.holder.index(index)
        if idx_obj is None:
            return None
        std_slices = list(range(idx_obj.max_slice() + 1))
        if len(std_slices) > _INT32_SAFE_SLICES:
            return None
        matched: dict[int, tuple[str, int, list[str]]] = {}
        for i in range(len(rows)):
            fname, fr = frames[int(frame_ids[i])]
            s, e = int(starts[i]), int(ends[i])
            try:
                # Packed digits -> datetime: calendar validation happens
                # HERE, so an invalid date declines to the Python parser
                # and surfaces its exact error.
                start = datetime(
                    s // 10**8, s // 10**6 % 100, s // 10**4 % 100,
                    s // 100 % 100, s % 100,
                )
                end = datetime(
                    e // 10**8, e // 10**6 % 100, e // 10**4 % 100,
                    e // 100 % 100, e % 100,
                )
            except ValueError:
                return None
            views = (
                tq.views_by_time_range(VIEW_STANDARD, start, end, fr.time_quantum)
                if fr.time_quantum
                else []
            )
            matched[i] = (fname, int(rows[i]), views)
        combos = {(f, v, r) for f, r, views in matched.values() for v in views}
        if len(combos) > self._matrix_rows_max:
            return None
        idxs = list(range(len(rows)))
        return self._fused_local_range_counts(index, matched, idxs, std_slices)

    # -- warm-state repair (delta patch instead of invalidate) ------------

    def _note_dirty_rows(self, index: str, fname: str, rows) -> None:
        """Accumulate the per-(index, frame) dirty-row ledger feeding the
        serve-state patch lane's budget precheck.  This is the ONLY
        per-write bookkeeping the coalescing pipeline does: the repair
        itself is deferred until a read needs the warm state, so a write
        burst costs one batched patch dispatch, not one per write.
        Saturates (value None) past 4x the repair budget so a burst
        can't grow it unbounded — saturation just means 'rebuild, don't
        walk journals'.  Skipped entirely while nothing is warm
        (pure-ingest workloads pay zero here) and when repair is
        disabled (the ledger's only consumer, _serve_state_repair, can
        never use it with a zero budget)."""
        if self.prearmer is not None:
            # Queue a background re-arm for this shape (cheap no-op when
            # the shape was never registered) BEFORE the repair gates:
            # pre-arming covers exactly the writes repair can't absorb.
            self.prearmer.note_invalidate(index, fname)
        if self._repair_rows_max <= 0:
            return
        if not self._serve_states and not self._matrix_cache:
            return
        key = (index, fname)
        cap = 4 * self._repair_rows_max + 16
        with self._dirty_mu:
            cur = self._dirty_rows.get(key, ())
            if cur is None:
                return  # already saturated
            if cur == ():
                cur = self._dirty_rows[key] = set()
            cur.update(int(r) for r in rows)
            if len(cur) > cap:
                self._dirty_rows[key] = None

    def note_external_write(self, index: str, fname: str, rows) -> None:
        """Public hook for non-executor write paths (the streaming
        ingest door and the device bulk-build door) to feed the
        dirty-row ledger, so warm serve state patches instead of
        rebuilding after an ingest burst.  Bulk overlay commits also
        journal their rows inside the fragment (``_log_dirty``), so the
        patch lane can rank-k-update exactly the planes a bulk batch
        touched even though the write bypassed the executor."""
        self._note_dirty_rows(index, fname, rows)

    def _journal_dirty_rows(self, frags, old_gens, new_gens) -> Optional[dict]:
        """The EXACT per-(row, slice) delta written between two generation
        vectors, from the fragment dirty-row journals, as a
        ``{slice_position: rows}`` mapping (positions index the ``frags``
        order, which is the pool's slice order) — or None when the delta
        is unenumerable (bulk import/restore, journal evicted, fragment
        deleted/recreated) or its row UNION is over the repair budget;
        callers then take the full rebuild path.  Keeping each
        fragment's rows separate (instead of the old flat union) is what
        lets the patch lane re-fetch and rank-k-update only the planes
        actually written.  Journals are maintained inside the fragment's
        own locked mutation methods, so this covers every writer — not
        just this executor's write paths."""
        budget = self._repair_rows_max
        if budget <= 0:
            return None
        dirty: dict[int, set] = {}
        union: set = set()
        for si, (f, g0, g1) in enumerate(zip(frags, old_gens, new_gens)):
            if g0 == g1:
                continue
            if f is None:
                return None  # fragment deleted since the state was recorded
            rows = f.rows_dirty_since(g0)
            if rows is None:
                return None
            if rows:
                dirty[si] = rows
                union |= rows
                if len(union) > budget:
                    return None
        return dirty if dirty else None

    def _serve_state_repair(self, key: tuple, st: dict) -> Optional[dict]:
        """The serve-state PATCH lane (the Roaring repair principle one
        level up): a state invalidated by a small write is repaired —
        the pool matrix's dirty rows rewritten in place, the Gram
        rank-k-updated, the glut re-derived — and re-captured with fresh
        validity tokens, instead of being popped and rebuilt from
        scratch.  Returns the re-captured state (read-your-writes: it
        serves post-write counts), or None when the delta is over the
        repair budget, unenumerable, or structural (index/frame/slice
        growth) — the caller pops and the general lane re-arms.
        """
        index, fname = key
        idx_obj = st["idx_obj"]
        if self.holder.index(index) is not idx_obj:
            return None
        if idx_obj.max_slice() != st["max_slice"]:
            return None  # slice/row-count growth: the state's span is wrong
        with self._dirty_mu:
            noted = self._dirty_rows.get(key, ())
        if noted is None or (noted and len(noted) > self._repair_rows_max):
            return None  # ledger precheck: saturated or clearly over budget
        slices: list[int] = []
        frags: list = []
        old_gens: list[int] = []
        new_gens: list[int] = []
        for s, frag, gen in st["slots"]:
            f = self.holder.fragment(index, fname, VIEW_STANDARD, s)
            if f is not frag:
                return None  # fragment created/replaced since capture
            slices.append(s)
            frags.append(f)
            old_gens.append(gen)
            new_gens.append(-1 if f is None else f.generation)
        dirty = self._journal_dirty_rows(frags, old_gens, new_gens)
        if dirty is None:
            return None
        # Drive the pool's patch lane: the per-(row, slice) delta is
        # complete for the (old -> new) span — the whole write burst
        # since capture coalesces into THIS one acquire (one pool
        # rewrite + one rank-k Gram dispatch), and only the planes
        # actually written are re-gathered.  The box (with its glut)
        # survives.
        pool = self._pool_for(index, fname, VIEW_STANDARD, slices)
        _, _, box = pool.acquire([], tuple(new_gens), dirty_rows=dirty)
        glut = box.get("gram_lut")
        if glut is None:
            return None  # box didn't survive (evicted/reset elsewhere)
        self._capture_serve_state(index, fname, slices, glut, box)
        return self._serve_states.get(key)

    def drop_frame_state(self, index: str, frame: str) -> None:
        """Drop every cached serving artifact for one (index, frame):
        serve states, device row pools (and their Grams), multi-view
        Range matrices, the fast-write pin, and the dirty ledger.  Called
        on frame deletion so a recreated namesake can never be served
        from (or pin the memory of) the old frame's device state; the
        generation/identity validity checks already guarantee
        correctness — this hook reclaims the memory eagerly."""
        with self._matrix_mu:
            for k in [k for k in self._matrix_cache if k[0] == index and k[1] == frame]:
                del self._matrix_cache[k]
            for k in [
                k for k in self._multi_matrix_cache if k[0] == index and k[1] == frame
            ]:
                del self._multi_matrix_cache[k]
            self._serve_states.pop((index, frame), None)
            # Per-thread armed lane tables can't be reached from here;
            # the epoch bump makes every thread clear its own at next
            # access (identity revalidation keeps the interim safe).
            self._lane_epoch += 1
        with self._dirty_mu:
            self._dirty_rows.pop((index, frame), None)
        if self.prearmer is not None:
            self.prearmer.forget(index, frame)
        if self.qcache is not None:
            # A recreated namesake frame gets fresh generations (the
            # counter never repeats), so validity already prevents stale
            # serving — the purge reclaims the bytes eagerly.
            self.qcache.purge_frame(index, frame)

    def drop_index_state(self, index: str) -> None:
        """Index-deletion analog of drop_frame_state (every frame)."""
        with self._matrix_mu:
            for k in [k for k in self._matrix_cache if k[0] == index]:
                del self._matrix_cache[k]
            for k in [k for k in self._multi_matrix_cache if k[0] == index]:
                del self._multi_matrix_cache[k]
            for k in [k for k in list(self._serve_states) if k[0] == index]:
                self._serve_states.pop(k, None)
            self._lane_epoch += 1  # see drop_frame_state
        with self._dirty_mu:
            for k in [k for k in self._dirty_rows if k[0] == index]:
                del self._dirty_rows[k]
        if self.prearmer is not None:
            self.prearmer.forget_index(index)
        if self.qcache is not None:
            self.qcache.purge_index(index)

    def _capture_serve_state(self, index: str, fname: str, slices, glut, box) -> None:
        """Snapshot the single-call serve lane's state after a warm-Gram
        single-frame batch: the glut arrays (sorted row ids, positions,
        Gram — immutable snapshots; writes build NEW boxes) plus the
        validity tokens.  Only a FULL contiguous slice range qualifies
        (partial slice sets come from remote/fan-out execution).

        Validity tokens come from ``box["gens"]`` — the generations the
        box's matrix content was validated against at ACQUIRE time — not
        from a fresh read: a write landing between the Gram serve and
        this capture would otherwise stamp post-write generations onto
        pre-write data and every later validity check would pass against
        stale counts.  A fragment replaced/created since acquire makes
        its stored token mismatch (the generation counter is global and
        never repeats), so the state conservatively invalidates.
        """
        idx_obj = self.holder.index(index)
        fr = self.holder.frame(index, fname)
        if idx_obj is None or fr is None:
            return
        gens = box.get("gens")
        if gens is None or len(gens) != len(slices):
            return
        if list(slices) != list(range(len(slices))) or (
            idx_obj.max_slice() != len(slices) - 1
        ):
            return
        try:
            frame_b = fname.encode("ascii")
            rowkey_b = fr.row_label.encode("ascii")
        except UnicodeEncodeError:
            return
        slots = []
        for s, g in zip(slices, gens):
            f = self.holder.fragment(index, fname, VIEW_STANDARD, s)
            slots.append((s, f, g))
        st = {
            "index": index,
            "fname": fname,
            "idx_obj": idx_obj,
            "frame_b": frame_b,
            "rowkey_b": rowkey_b,
            "allow_default": fname == DEFAULT_FRAME,
            "max_slice": len(slices) - 1,
            "slots": slots,
            "glut_id": glut,
            "rs": glut[0],
            "gram": glut[1],
            "ps": glut[2],
        }
        with self._matrix_mu:
            self._serve_states[(index, fname)] = st
            self._serve_states.move_to_end((index, fname))
            while len(self._serve_states) > self._serve_states_max:
                self._serve_states.popitem(last=False)
        # The fresh tokens make older ledger entries moot for THIS frame's
        # precheck; the journals stay authoritative for any other state.
        with self._dirty_mu:
            self._dirty_rows.pop((index, fname), None)

    def _apply_queued_reads(self, items) -> list:
        """Evaluate one drained serve-queue batch of flat-lane requests.

        Requests sharing (index, name tables, slices) concatenate their
        op/frame/row arrays and run through ONE
        ``_fused_local_counts_arrays`` pass — with a warm Gram that is a
        single native call answering every queued request — then split
        back per request.
        """
        results: list = [None] * len(items)
        groups: dict[tuple, list[int]] = {}
        for i, (index, _arrays, tables, slices) in enumerate(items):
            groups.setdefault((index, tables, slices), []).append(i)
        for (index, tables, slices), idxs in groups.items():
            frame_names = [b.decode("utf-8") for b in tables[0]]
            if len(idxs) == 1:
                arrs = items[idxs[0]][1]
                ops, fids, rr1, rr2 = arrs
            else:
                ops = np.concatenate([items[i][1][0] for i in idxs])
                fids = np.concatenate([items[i][1][1] for i in idxs])
                rr1 = np.concatenate([items[i][1][2] for i in idxs])
                rr2 = np.concatenate([items[i][1][3] for i in idxs])
            counts = self._fused_local_counts_arrays(
                index, frame_names, ops, fids, rr1, rr2, list(slices)
            )
            off = 0
            for i in idxs:
                n = len(items[i][1][0])
                results[i] = counts[off : off + n]
                off += n
        return results

    def _fused_local_counts_arrays(
        self, index: str, frame_names, op_ids, frame_ids, r1, r2, slices,
        plan=None, _prearm=False,
    ) -> list[int]:
        """Vectorized local evaluator for the compiled-query lane: group by
        (frame, op) with numpy masks, map row ids to matrix positions via
        searchsorted, and answer each group with one Gram lookup batch or
        kernel dispatch — no per-call Python loop.  With a warm Gram the
        whole batch collapses further into ONE native call
        (pn_gram_counts: binary-search position mapping + count
        identities in C++), the steady-state serving loop.

        ``plan`` is the front door's planner decision (ExecOptions.plan):
        a forced lane overrides the static rm_pool ladder below (the
        eligibility gates still apply), lane None changes nothing, and
        either way each chunk's observed cost folds back through
        Planner.record under the lane that actually ran.  ``_prearm``
        marks the PreArmer's background replay so it doesn't re-register
        itself as a hot shape.
        """
        from pilosa_tpu_torch import native
        from pilosa_tpu_torch.native import PQL_PAIR_OPS

        forced = plan.get("lane") if plan is not None else None
        rec = self.planner is not None and plan is not None and not _prearm
        out = np.zeros(len(op_ids), dtype=np.int64)
        for f_id in np.unique(frame_ids):
            fmask0 = frame_ids == f_id
            fname = frame_names[f_id] if f_id >= 0 else DEFAULT_FRAME
            pool = self._pool_for(index, fname, VIEW_STANDARD, slices)
            rows_all = np.unique(np.concatenate([r1[fmask0], r2[fmask0]]))
            if len(rows_all) <= pool.cap_max:
                qparts = [np.nonzero(fmask0)[0]]
            else:
                # Paging regime: partition the frame's queries so each
                # chunk's unique rows fit the pool; rows stream through
                # HBM chunk by chunk instead of falling back to host.
                qparts = [
                    np.asarray(p)
                    for p in chunk_queries(
                        np.nonzero(fmask0)[0].tolist(),
                        lambda qi: (int(r1[qi]), int(r2[qi])),
                        pool.cap_max,
                    )
                ]
            for qpart in qparts:
                t0 = time.perf_counter() if rec else 0.0
                fmask = np.zeros(len(op_ids), dtype=bool)
                fmask[qpart] = True
                fr1, fr2 = r1[fmask], r2[fmask]
                rows = np.unique(np.concatenate([fr1, fr2]))
                # Tall working sets relative to this chunk's batch hit the
                # gather kernels — page them through the ROW-MAJOR pool
                # lane (one contiguous DMA descriptor per operand row;
                # same choice as the AST fused path), UNLESS the Gram
                # could serve this working set (warm Gram lookups beat
                # any kernel; _gram_could_serve mirrors its gates).  In
                # the paging regime (multiple qparts) the Gram can never
                # WARM — each part switch remaps pool slots and kills the
                # cache box — so only a single-part working set may veto
                # the row-major lane.  Effective rows mirror the
                # slice-major pool's cap (dispatch sees the full matrix).
                # A planner-forced lane replaces this ladder (pin/ledger
                # decisions); the eligibility gates below still apply.
                if forced == "gram":
                    rm_pool = False  # slice-major family: always feasible
                elif forced == "rmgather":
                    rm_pool = getattr(
                        self.engine, "supports_row_major_gather", False
                    )
                else:
                    rm_pool = (
                        getattr(self.engine, "supports_row_major_gather", False)
                        and (
                            len(qparts) > 1
                            or not self._gram_could_serve(len(rows), len(slices))
                        )
                        and self.engine.prefer_rowmajor(
                            max(len(rows), pool.cap), len(slices), _WORDS,
                            int(fmask.sum()), 2,
                        )
                    )
                if rm_pool and len(rows) > self._peek_pool_cap(
                    index, fname, VIEW_STANDARD, slices, lane="rmgather"
                ):
                    rm_pool = False  # diverged lane caps: stay chunkable
                id_pos, matrix, box = self._frame_matrix(
                    index, fname, slices, set(rows.tolist()),
                    lane="rmgather" if rm_pool else "",
                )
                gram = None if rm_pool else self._frame_gram(matrix, box)
                if gram is not None:  # implies a live box (_frame_gram contract)
                    # Native lane: the gram_lut (sorted id table + positions)
                    # lives and dies with the cache box, like the Gram itself.
                    glut = box.get("gram_lut")
                    if glut is None:
                        rs = np.array(sorted(id_pos), dtype=np.int64)
                        ps = np.fromiter(
                            (id_pos[int(v)] for v in rs), dtype=np.int32, count=len(rs)
                        )
                        glut = box["gram_lut"] = (rs, np.ascontiguousarray(gram), ps)
                    # Mask indexing yields fresh C-contiguous arrays, so the
                    # raw pointers hand off to C directly.
                    counts = native.gram_counts(
                        op_ids[fmask], fr1, fr2, glut[0], glut[2], glut[1]
                    )
                    if counts is not None:
                        out[fmask] = counts
                        # Arm the single-call serve lane: this exact
                        # state (frame + glut) just served natively, so
                        # subsequent requests can skip straight to
                        # pn_serve_pairs — or, when a batch spans several
                        # frames, to pn_serve_multi (each frame group
                        # arms its own state here).  Unpaged working sets
                        # only; re-capture only when the glut changed.
                        st = self._serve_states.get((index, fname))
                        if (
                            len(qparts) == 1
                            and (st is None or st["glut_id"] is not glut)
                        ):
                            self._capture_serve_state(index, fname, slices, glut, box)
                        if rec:
                            self.planner.record(
                                index=index, fp=plan["fp"], lane="gram",
                                ms=(time.perf_counter() - t0) * 1e3, plan=plan,
                            )
                        continue
                lut = np.fromiter(
                    (id_pos[int(rv)] for rv in rows), dtype=np.int32, count=len(rows)
                )
                p1 = lut[np.searchsorted(rows, fr1)]
                p2 = lut[np.searchsorted(rows, fr2)]
                fops = op_ids[fmask]
                fout = np.zeros(len(fr1), dtype=np.int64)
                for op_id in np.unique(fops):
                    om = fops == op_id
                    pairs = np.stack([p1[om], p2[om]], axis=1).astype(np.int32)
                    op = PQL_PAIR_OPS[int(op_id)]
                    if gram is not None:
                        from pilosa_tpu_torch.ops.bitwise import gram_pair_counts

                        counts = gram_pair_counts(op, gram, pairs)
                    elif rm_pool:
                        counts = self.engine.to_numpy(
                            self.engine.gather_count_rowmajor_dev(op, matrix, pairs)
                        ).astype(np.int64)
                    else:
                        counts = self.engine.gather_count(op, matrix, pairs)
                    fout[om] = counts
                out[fmask] = fout
                if rec:
                    # Fold the chunk's cost back under the lane that
                    # ACTUALLY ran (an eligibility veto self-corrects).
                    self.planner.record(
                        index=index, fp=plan["fp"],
                        lane="rmgather" if rm_pool else "gram",
                        ms=(time.perf_counter() - t0) * 1e3, plan=plan,
                    )
        if self.prearmer is not None and not _prearm:
            # Register/refresh this batch as the (index, frame) replay
            # thunk: re-running it through the ordinary path re-arms
            # matrix, Gram, and serve state after an invalidating write.
            thunk = partial(
                self._fused_local_counts_arrays,
                index, frame_names, np.array(op_ids), np.array(frame_ids),
                np.array(r1), np.array(r2), list(slices), _prearm=True,
            )
            for f_id in np.unique(frame_ids):
                fname = frame_names[f_id] if f_id >= 0 else DEFAULT_FRAME
                self.prearmer.note_shape(index, str(fname), thunk)
        return out.tolist()

    def _tree_build(self, index: str, c: pql.Call, fv_box: dict):
        """Recursively compile a bitmap call tree to leaf/op-node form.

        Returns int (a Bitmap leaf's row id) or (op_id, left, right).
        Raises _TreeUnfusable for shapes outside the lane (Range leaves,
        <2-child nodes, mixed frame/view) and PilosaError for invalid
        leaves (callers abort the whole fuse so the sequential path
        surfaces the identical error)."""
        if c.name == "Bitmap":
            frame, view, row = self._resolve_bitmap_leaf(index, c)
            if fv_box["fv"] is None:
                fv_box["fv"] = (frame, view)
            elif fv_box["fv"] != (frame, view):
                raise _TreeUnfusable()
            return int(row)
        op = self._FUSABLE_OPS.get(c.name)
        if op is None or len(c.children) < 2:
            raise _TreeUnfusable()
        subs = [self._tree_build(index, ch, fv_box) for ch in c.children]
        if op == "andnot":
            # a &~ b &~ c ... == a & ~(b | c | ...) — the rest joins
            # under a balanced OR so Difference nests in log depth too.
            rest = (
                subs[1]
                if len(subs) == 2
                else _tree_balanced(_TREE_OP_IDS["or"], subs[1:])
            )
            return (_TREE_OP_IDS["andnot"], subs[0], rest)
        return _tree_balanced(_TREE_OP_IDS[op], subs)

    def _compile_count_tree(self, index: str, ch: pql.Call):
        """Compile one Count child tree for the fused tree lane.

        Returns (frame, view, ("tree", 2^D), leaves, opc) or None when the
        shape stays sequential; propagates PilosaError for invalid leaves.
        """
        box = {"fv": None}
        try:
            node = self._tree_build(index, ch, box)
        except _TreeUnfusable:
            return None
        if isinstance(node, int):
            return None
        d = _tree_depth(node)
        if d > _TREE_DEPTH_MAX:
            return None
        # Pad slots gather the leftmost REAL leaf so the unique-row
        # working set (pool capacity, Gram eligibility) never grows.
        fill = node
        while not isinstance(fill, int):
            fill = fill[1]
        leaves, opc = _tree_flatten(_tree_pad(node, d, fill), d)
        frame, view = box["fv"]
        return frame, view, ("tree", 1 << d), tuple(leaves), tuple(opc)

    def _fuse_count_pair_batch(
        self, index: str, calls, slices, inv_slices, opt: ExecOptions, fsp=None
    ) -> Optional[dict[int, int]]:
        """Run all Count(<op>(Bitmap, Bitmap, ...)) calls in a request as
        fused device dispatches (one per distinct op/arity group).

        The device-native replacement for issuing the hot query shapes
        (executor.go:576-605) one call at a time: row ids are gathered by
        the kernel straight from a device-resident row matrix
        (ops.dispatch.gather_count / gather_count_multi), so a request
        carrying a batch of count queries costs one kernel launch per
        op/arity group instead of per-call row uploads + reductions.
        Covers Intersect, Union, and Difference over 2+ Bitmap children
        (2-operand calls keep the Gram-eligible pair lane), Xor over
        exactly two — and, via the TREE lane, ARBITRARY nestings of the
        four ops (mixed Intersect(Union(...), ...) trees, multi-operand
        Xor) up to depth 4, compiled to per-query perfect-tree opcode
        programs and dispatched once per depth bucket
        (executor.go:261-276's uniform any-depth evaluation, fused).
        Distributed requests forward ONE batch per remote node and fuse
        locally per node.  ``fsp``: a traced request's ``fused`` span
        (children ``fused.match``, ``fused.plan`` and one ``device``
        span a launch).
        """
        if not slices:
            return None

        # call idx -> (frame, view, kernel_op, row-id tuple) for flat
        # calls, or (frame, view, ("tree", 2^D), leaves, opc) for nested
        # trees / multi-operand Xor (the fused tree lane).
        msp = fsp.child("fused.match") if fsp is not None else None
        matched: dict[int, tuple] = {}
        batch_view: Optional[str] = None
        for i, c in enumerate(calls):
            if c.name != "Count" or len(c.children) != 1:
                continue
            ch = c.children[0]
            if ch.name == "Bitmap":
                # Plain row count: |r| == |r & r| — rides the pair lane
                # (Gram diagonal) so a dashboard mixing row counts with
                # pair counts keeps the whole batch fused.
                try:
                    frame, view, row_id = self._resolve_bitmap_leaf(index, ch)
                except PilosaError:
                    return None  # surface the error through the normal path
                if batch_view is None:
                    batch_view = view
                elif view != batch_view:
                    return None
                matched[i] = (frame, view, "and", (row_id, row_id))
                continue
            op = self._FUSABLE_OPS.get(ch.name)
            if op is None or len(ch.children) < 2:
                continue
            entry = None
            if op != "xor" or len(ch.children) == 2:
                # Flat attempt first: the pair lane is Gram-eligible and
                # the multi-fold lane gathers K rows vs the tree lane's
                # 2^ceil(log2 K).
                leaves = []
                for leaf in ch.children:
                    if leaf.name != "Bitmap":
                        break
                    try:
                        frame, view, row_id = self._resolve_bitmap_leaf(index, leaf)
                    except PilosaError:
                        return None  # surface the error through the normal path
                    leaves.append((frame, view, row_id))
                if len(leaves) == len(ch.children) and all(
                    l[:2] == leaves[0][:2] for l in leaves[1:]
                ):
                    entry = (
                        leaves[0][0],
                        leaves[0][1],
                        op,
                        tuple(l[2] for l in leaves),
                    )
            if entry is None:
                # Nested / multi-Xor shapes: the tree lane (one dispatch
                # per depth bucket — executor.go:261-276's any-depth
                # uniformity, fused).
                try:
                    entry = self._compile_count_tree(index, ch)
                except PilosaError:
                    return None  # surface the error through the normal path
                if entry is None:
                    continue
            # Uniform view across the batch: the slice domain (standard vs
            # inverse axis) is per-mapReduce, so mixed-view requests take
            # the sequential path.
            if batch_view is None:
                batch_view = entry[1]
            elif entry[1] != batch_view:
                return None
            matched[i] = entry
        if msp is not None:
            msp.finish()
        # Fuse only when the WHOLE request is fusable reads: a write call
        # anywhere in the request must be observed by later Counts
        # (per-call ordering semantics), so mixed requests take the
        # sequential path.
        if len(matched) < 2 or len(matched) != len(calls):
            return None

        if batch_view != VIEW_STANDARD and inv_slices is not None:
            slices = inv_slices  # inverse axis has its own max slice
        if not slices:
            return None

        idxs = sorted(matched)
        totals = self._fused_dispatch(
            index, idxs, slices, opt,
            lambda: pql.Query(calls=[calls[i] for i in idxs]),
            # The span goes along only where the request is traced: an
            # untraced call is the one it always was.
            lambda node_slices: self._fused_local_counts(
                index, matched, idxs, node_slices, plan=opt.plan,
                **({} if fsp is None else {"span": fsp}),
            ),
        )
        return dict(zip(idxs, totals))

    def _fuse_count_range_batch(
        self, index: str, calls, slices, opt: ExecOptions, fsp=None
    ) -> Optional[dict[int, int]]:
        """Run an all-``Count(Range(...))`` request as fused device
        dispatches: the per-call view covers (time.go:95-167) become rows
        of ONE multi-view matrix and every query's union+popcount happens
        in one kernel batch (dispatch.gather_count_or_multi) instead of
        per-call view gathers and OR chains.  Same fusion contract as the
        pair path: only fires when the WHOLE request matches, everything
        else falls back to the sequential path with identical errors.
        """
        if not slices or len(calls) < 2:
            return None
        if len(slices) > _INT32_SAFE_SLICES:
            # One fused dispatch spans every slice; past the int32 count
            # bound the sequential per-call path (host-summed python ints)
            # keeps Range counts exact.
            return None
        msp = fsp.child("fused.match") if fsp is not None else None
        matched: dict[int, tuple[str, int, list[str]]] = {}
        for i, c in enumerate(calls):
            if c.name != "Count" or len(c.children) != 1:
                return None
            ch = c.children[0]
            if ch.name != "Range" or ch.children:
                return None
            try:
                frame_name, frame, row_id, start, end = self._parse_range_args(index, ch)
            except PilosaError:
                return None  # surface the error through the normal path
            views = (
                tq.views_by_time_range(VIEW_STANDARD, start, end, frame.time_quantum)
                if frame.time_quantum
                else []
            )
            matched[i] = (frame_name, row_id, views)
        if msp is not None:
            msp.finish()

        # Working-set guard: fusing pays through the cached multi-view
        # matrix; a request whose distinct (frame, view, row) combos
        # exceed the matrix row budget would rebuild+re-upload a giant
        # matrix every time, so it takes the sequential path instead
        # (per-fragment device row caches amortize there).
        combos = {(f, v, r) for f, r, views in matched.values() for v in views}
        if len(combos) > self._matrix_rows_max:
            return None

        idxs = sorted(matched)
        totals = self._fused_dispatch(
            index, idxs, slices, opt,
            lambda: pql.Query(calls=[calls[i] for i in idxs]),
            lambda node_slices: self._fused_local_range_counts(index, matched, idxs, node_slices),
        )
        return dict(zip(idxs, totals))

    def _fused_local_range_counts(
        self, index: str, matched: dict, idxs: list[int], slices
    ) -> list[int]:
        """Fused Range counts for a slice batch, aligned with idxs.

        Builds one matrix per frame whose rows are the distinct
        (view, row_id) combos referenced by the batch, pads each call's
        cover to the batch max by repeating its first row (OR-idempotent),
        and answers the whole frame group in one engine dispatch."""
        slices = list(slices or [])
        out: dict[int, int] = {}
        if not slices:
            return [0] * len(idxs)
        by_frame: dict[str, list[int]] = {}
        for i in idxs:
            by_frame.setdefault(matched[i][0], []).append(i)
        for frame_name, f_idxs in by_frame.items():
            live = [i for i in f_idxs if matched[i][2]]
            for i in f_idxs:
                if not matched[i][2]:
                    out[i] = 0  # no quantum / empty cover (zeros segment)
            if not live:
                continue
            combos = sorted(
                {(v, matched[i][1]) for i in live for v in matched[i][2]}
            )
            id_pos, matrix, memo = self._multi_view_matrix(index, frame_name, slices, combos)
            # Count memo: the memo dict lives and dies with the cache entry
            # (fresh on any write), so repeated ranges — the dashboard
            # steady state — are answered host-side with zero device work,
            # the Range analog of the Gram lane's count lookups.
            misses = []
            for i in live:
                _, row_id, views = matched[i]
                c = memo.get((row_id, tuple(views)))
                if c is None:
                    misses.append(i)
                else:
                    out[i] = c
            if misses:
                # On jitted engines, CANONICAL kernel shapes: the batch dim
                # is chunked to a fixed 128 (padded by repeating the first
                # miss's cover — extra counts computed and discarded) and
                # the cover width padded to one of {4, 16, 64}
                # (repeat-first-id padding is OR-idempotent).  Ragged
                # shapes would trigger a jit recompile per distinct
                # (miss count, max cover) pair — seconds each.  Engines
                # without jit (numpy) use exact shapes: padding there is
                # pure wasted gather/OR work.
                vmax = max(len(matched[i][2]) for i in misses)
                static = getattr(self.engine, "wants_static_shapes", False)
                if static:
                    vb = 4 if vmax <= 4 else 16 if vmax <= 16 else 64 if vmax <= 64 else vmax
                    BB = 128
                else:
                    vb, BB = vmax, len(misses)
                for c0 in range(0, len(misses), BB):
                    part = misses[c0 : c0 + BB]
                    idx_arr = np.zeros((BB, vb), dtype=np.int32)
                    for k, i in enumerate(part):
                        _, row_id, views = matched[i]
                        cover = [id_pos[(v, row_id)] for v in views]
                        idx_arr[k, : len(cover)] = cover
                        idx_arr[k, len(cover):] = cover[0]
                    idx_arr[len(part):] = idx_arr[0]
                    counts = self.engine.gather_count_or_multi(matrix, idx_arr)
                    for k, i in enumerate(part):
                        c = int(counts[k])
                        out[i] = c
                        if len(memo) < 65536:  # bound host memory vs adversarial
                            memo[(matched[i][1], tuple(matched[i][2]))] = c
        return [out[i] for i in idxs]

    def _multi_view_matrix(
        self, index: str, frame: str, slices, combos: list[tuple[str, int]]
    ) -> tuple[dict[tuple[str, int], int], object, dict]:
        """Engine matrix [n_slices, len(combos), W] whose row planes are
        (view, row_id) combos — the fused Range path's working set — plus
        a per-entry count memo for repeated covers.

        Cached like the single-view matrix (LRU, validated by the write
        generations of every (view, slice) fragment involved); rebuilt
        whole on any change (Range covers touch many small time views, so
        per-plane patching buys little).  The memo dict is shared across
        threads without a lock: entries are deterministic pure counts, so
        a racing double-compute stores the same value.
        """
        # Keyed by (index, frame, slices) — NOT the view set: a batch whose
        # union of Range covers introduces a new view must take the append
        # path below, not miss the whole entry (heterogeneous dashboard
        # batches cycle distinct view sets; per-view-set keys would thrash
        # the small LRU with rebuild+re-upload).  Views live inside the
        # (view, row) combo space; generations are tracked per (view,
        # slice) for every view resident in the matrix.
        key = (index, frame, tuple(slices))
        with self._matrix_mu:
            hit = self._multi_matrix_cache.get(key)
        old_id_pos = old_matrix = old_memo = None
        old_views: list[str] = []
        if hit is not None:
            old_gens, old_id_pos, old_matrix, old_memo = hit
            old_views = sorted(old_gens)
        views = sorted({v for v, _ in combos} | set(old_views))
        frags = {
            v: [self.holder.fragment(index, frame, v, s) for s in slices]
            for v in views
        }
        gens = {
            v: tuple(-1 if f is None else f.generation for f in frags[v])
            for v in views
        }
        missing: list[tuple[str, int]] = []
        if old_id_pos is not None:
            if all(gens[v] == old_gens[v] for v in old_views):
                missing = sorted(set(combos) - old_id_pos.keys())
                if not missing:
                    with self._matrix_mu:
                        if key in self._multi_matrix_cache:
                            self._multi_matrix_cache.move_to_end(key)
                    return old_id_pos, old_matrix, old_memo
            else:
                old_id_pos = None  # writes: rebuild, fresh memo

        def densify(combo_list, cap):
            """[n_slices, cap, W] host block; rows beyond the combo list
            stay zero (capacity padding — gathers never index them)."""
            planes = []
            for si in range(len(slices)):
                block = np.zeros((cap, _WORDS), dtype=np.uint32)
                for k, (v, r) in enumerate(combo_list):
                    f = frags[v][si]
                    if f is not None:
                        block[k] = f.row_dense(r)
                planes.append(block)
            return np.stack(planes)

        def pow2(n: int) -> int:
            return 1 << (n - 1).bit_length() if n > 1 else 1

        if old_id_pos is not None and len(old_id_pos) + len(missing) <= self._matrix_rows_max:
            # Generations unchanged, new combos only: write them into the
            # cached matrix's spare capacity, then append any overflow as a
            # new power-of-two capacity block — and KEEP the memo (its
            # counts are still valid).  Physical positions are assigned
            # where the rows actually land (spare rows first, then the
            # appended block), so id_pos always matches the matrix.
            # Power-of-two capacity keeps the matrix SHAPE stable across
            # most appends, so downstream jitted kernels rarely recompile.
            n_old = 1 + max(old_id_pos.values()) if old_id_pos else 0
            cap = old_matrix.shape[1]
            spare = missing[: cap - n_old]
            overflow = missing[len(spare):]
            matrix = old_matrix
            if spare:
                matrix = self.engine.set_rows(matrix, n_old, densify(spare, len(spare)))
            if overflow:
                new_cap = pow2(cap + len(overflow))
                matrix = self.engine.append_rows(
                    matrix, densify(overflow, new_cap - cap)
                )
            id_pos = dict(old_id_pos)
            for k, c in enumerate(spare):
                id_pos[c] = n_old + k
            for k, c in enumerate(overflow):
                id_pos[c] = cap + k
            memo = old_memo
            with self._matrix_mu:
                self._multi_matrix_cache[key] = (gens, id_pos, matrix, memo)
                self._multi_matrix_cache.move_to_end(key)
                while len(self._multi_matrix_cache) > self._matrix_cache_entries:
                    self._multi_matrix_cache.popitem(last=False)
            return id_pos, matrix, memo

        id_pos = {c: k for k, c in enumerate(combos)}
        matrix = self.engine.matrix(densify(combos, pow2(len(combos))))
        memo = {}
        # Store generations only for views actually resident in the matrix:
        # a rebuild drops old views whose combos this batch no longer
        # references, and tracking their gens would invalidate the entry on
        # writes to rows it doesn't even hold.
        store_gens = {v: gens[v] for v in sorted({vv for vv, _ in combos})}
        if len(combos) <= self._matrix_rows_max:
            with self._matrix_mu:
                self._multi_matrix_cache[key] = (store_gens, id_pos, matrix, memo)
                self._multi_matrix_cache.move_to_end(key)
                while len(self._multi_matrix_cache) > self._matrix_cache_entries:
                    self._multi_matrix_cache.popitem(last=False)
        return id_pos, matrix, memo

    def _is_distributed(self, opt: ExecOptions) -> bool:
        """Whether this executor coordinates a multi-node fan-out (shared
        by the AST fused path and the compiled-query lane)."""
        return (
            not opt.remote
            and self.cluster is not None
            and self.client_factory is not None
            and len(self.cluster.nodes) > 1
        )

    def _fused_dispatch(
        self, index: str, idxs: list[int], slices, opt: ExecOptions,
        batch_query_fn, local_fn,
    ) -> list[int]:
        """Run a matched fused count batch locally or cluster-wide.

        Distributed fusion: ONE forwarded batch request per remote node
        (N fused calls x M nodes = M requests, not N*M per-call forwards),
        local slices through the fused kernels via ``local_fn(slices)``
        (pair counts or Range covers), and the same mid-query replica
        failover as per-call mapReduce.  ``batch_query_fn`` builds the
        Query to forward — called only when a remote hop exists, so
        AST-free callers (the flat fast lane) stay AST-free single-node.
        The remote peer re-enters the fused path with opt.remote=True and
        fuses its own slice batch.
        """
        if not self._is_distributed(opt):
            return local_fn(slices)

        batch_query = batch_query_fn()

        def local_map(node_slices):
            return local_fn(node_slices)

        def remote_map(client, node_slices, trace_span=None):
            # Conditional kwargs: custom client factories (tests,
            # embedders) need not know the QoS/qcache kwargs.
            kw = {}
            if opt.deadline is not None:
                kw["deadline"] = opt.deadline
            if opt.no_cache:
                kw["no_cache"] = True  # a bypass bypasses peer caches too
            if trace_span is not None:
                kw["trace_span"] = trace_span
            res = client.execute_remote(index, batch_query, node_slices, **kw)
            if len(res) != len(idxs):
                raise PilosaError(
                    f"fused batch: peer returned {len(res)} results for {len(idxs)} calls"
                )
            return [int(r) for r in res]

        return self._map_reduce(
            index,
            None,
            slices,
            opt,
            local_map,
            lambda a, b: [x + y for x, y in zip(a, b)],
            [0] * len(idxs),
            remote_map=remote_map,
        )

    def _fused_local_counts(
        self, index: str, matched: dict, idxs: list[int], slices, plan=None, span=None
    ) -> list[int]:
        """Fused counts for the given slice batch, aligned with idxs.

        2-operand groups keep the pair lane (Gram-eligible); 3+-operand
        groups run the multi-fold kernels with the operand axis padded to
        a power-of-two bucket on jitted engines (fold-idempotent pad: the
        first operand for and/or, the second for andnot) so their shapes
        stay stable.  In the resident regime all of a part's 3+-operand
        groups share one launch of the mixed kernel (one fetch); the
        streaming regime launches each group alone.
        Batches whose unique row set exceeds the pool capacity are chunked
        (rows page through HBM per chunk) instead of falling back to host.

        ``plan`` (ExecOptions.plan, see _fused_local_counts_arrays): a
        forced lane overrides the resident-regime rm_pool ladder, and
        each resident part's cost folds back through Planner.record.
        The streaming regime has no lane choice to plan, so it neither
        applies nor records plans.

        ``span``: a traced request's ``fused`` span.  It gains
        ``need_bytes`` (the batch's distinct rows read once), a
        ``fused.plan`` child for each part's planning (grouping, pool,
        matrix, lane) and, in the resident regime, one ``device`` span a
        launch (``_group_counts``).
        """
        forced = plan.get("lane") if plan is not None else None
        rec = self.planner is not None and plan is not None
        slices = list(slices or [])
        out: dict[int, int] = {}
        if not slices:
            return [0] * len(idxs)
        static = getattr(self.engine, "wants_static_shapes", False)
        # One row pool per (frame, view): unique row ids -> device slots.
        by_fv: dict[tuple[str, str], list[int]] = {}
        for i in idxs:
            by_fv.setdefault(tuple(matched[i][:2]), []).append(i)
        if span is not None:
            rows = sum(len({x for i in f_idxs for x in matched[i][3]})
                       for f_idxs in by_fv.values())
            span.tags["need_bytes"] = (
                span.tags.get("need_bytes", 0) + rows * len(slices) * _ROW_SLICE_BYTES
            )
        for (frame, view), f_idxs in by_fv.items():
            # Each part's planning: the first part's includes the pool and
            # the chunking of the (frame, view)'s calls.
            psp = span.child("fused.plan") if span is not None else None
            pool = self._pool_for(index, frame, view, slices)
            # Row-chunk bound: the pool's budgeted capacity, but never so
            # small that chunking degenerates (at huge slice counts the
            # budget shrinks cap below usefulness — those shapes stream
            # the SLICE axis below instead of pooling).
            row_cap = max(64, pool.cap_max)
            # oversize_ok: one Count over more operands than row_cap has no
            # valid row-chunking — it becomes its own part and the
            # streaming branch below (which handles any row count) runs it.
            parts = list(chunk_queries(
                f_idxs, lambda i: matched[i][3], row_cap, oversize_ok=True
            ))
            for part in parts:
                if psp is None and span is not None:
                    psp = span.child("fused.plan")
                want = sorted({x for i in part for x in matched[i][3]})
                # Group calls by (op, operand-count bucket): one dispatch
                # each.  Jitted engines bucket the operand axis to powers
                # of two (stable shapes); the numpy engine uses exact
                # arities — padding there is pure wasted gather/fold work
                # (same policy as the fused Range lane).
                groups: dict[tuple, list[int]] = {}
                for i in part:
                    k = len(matched[i][3])
                    kb = 2 if k == 2 else (1 << (k - 1).bit_length()) if static else k
                    groups.setdefault((matched[i][2], kb), []).append(i)
                # Tree groups have no row-major kernel (their matrices
                # stay slice-major); a part carrying one keeps every
                # group on the slice-major lanes.
                has_tree = any(isinstance(g[0], tuple) for g in groups)

                if len(want) <= pool.cap_max and len(slices) <= _INT32_SAFE_SLICES:
                    # Resident regime: rows live (or page) in the pool.
                    # (Past _INT32_SAFE_SLICES the single-dispatch count
                    # could overflow the kernels' int32 accumulators at
                    # full density — those shapes stream the slice axis
                    # below, which chunks to the safe bound and sums in
                    # int64 host-side.)
                    # Tall working sets relative to the request batch hit
                    # the GATHER kernels: engines with row-major kernels
                    # page those parts through a ROW-MAJOR pool lane (each
                    # operand row's slices contiguous) instead.  The Gram
                    # never engages at these row counts (its all-pairs
                    # work would dwarf the batch).
                    n_pairs = sum(
                        len(v) for (_o, kb), v in groups.items() if kb == 2
                    )
                    # Effective row count mirrors what dispatch will see:
                    # the slice-major pool dispatches over its FULL cap
                    # (not just this part's rows), so a grown pool forces
                    # the gather kernels even for small wants.  Never
                    # displace a Gram-eligible working set — warm Gram
                    # serving (host lookups) beats any per-query kernel —
                    # but only a SINGLE-part working set may veto: in the
                    # paging regime each part switch remaps pool slots
                    # and kills the cache box, so the Gram never warms.
                    # A planner-forced lane replaces this ladder; tree
                    # groups (no row-major kernel) and engine support
                    # still gate it.
                    t0 = time.perf_counter() if rec else 0.0
                    if forced == "gram":
                        rm_pool = False  # slice-major: always feasible
                    elif forced == "rmgather":
                        rm_pool = not has_tree and getattr(
                            self.engine, "supports_row_major_gather", False
                        )
                    else:
                        rm_pool = (
                            not has_tree
                            and getattr(self.engine, "supports_row_major_gather", False)
                            and (
                                len(parts) > 1
                                or not self._gram_could_serve(len(want), len(slices))
                            )
                            and self.engine.prefer_rowmajor(
                                max(len(want), pool.cap), len(slices), _WORDS,
                                n_pairs, max(kb for _, kb in groups),
                            )
                        )
                    if rm_pool and len(want) > self._peek_pool_cap(
                        index, frame, view, slices, lane="rmgather"
                    ):
                        # Lane caps can diverge when one is overridden;
                        # never let the lane switch turn a chunkable part
                        # into an over-capacity error.
                        rm_pool = False
                    id_pos, matrix, box = self._frame_matrix(
                        index, frame, slices, set(want), view,
                        lane="rmgather" if rm_pool else "",
                    )
                    # The Gram only answers 2-operand counts — don't
                    # trigger its (expensive, cached) build for requests
                    # without a pair group.
                    gram = (
                        self._frame_gram(matrix, box)
                        if not rm_pool and any(kb == 2 for _, kb in groups)
                        else None
                    )
                    if psp is not None:
                        psp.finish()
                        psp = None
                    # One launch and one fetch for all of the part's
                    # N-ary groups (the mixed kernel); each pair and tree
                    # group keeps its own.
                    for batch in _launch_batches(groups):
                        counts = self.engine.to_numpy(
                            self._group_counts(
                                batch, matched, id_pos, matrix, static,
                                gram, row_major=rm_pool, span=span, mixed=True,
                            )
                        )
                        for k2, i in enumerate(i for _gk, op_idxs in batch for i in op_idxs):
                            out[i] = int(counts[k2])
                    if rec:
                        # Lane that ACTUALLY ran (a veto self-corrects).
                        self.planner.record(
                            index=index, fp=plan["fp"],
                            lane="rmgather" if rm_pool else "gram",
                            ms=(time.perf_counter() - t0) * 1e3, plan=plan,
                        )
                else:
                    # Streaming regime (SURVEY §7 hard part (d) at scale):
                    # the working set exceeds the HBM pool budget, so the
                    # SLICE axis is chunked — each chunk's rows are
                    # densified host-side, moved once, counted, and
                    # discarded; per-query counts accumulate across
                    # chunks.  Device results stay un-fetched inside the
                    # loop (gather_count_dev) so chunk k+1's upload
                    # pipelines behind chunk k's kernel.
                    if psp is not None:
                        psp.finish()
                        psp = None
                    id_pos = {r: k for k, r in enumerate(want)}
                    s_chunk = self._slice_chunk(len(want))
                    # Tall row sets hit the GATHER kernels; engines with
                    # row-major kernels take a row-major transient (each
                    # operand row's slices contiguous).  The widest
                    # group's operand count must fit those kernels' row
                    # buffers at this chunk's slice width.
                    row_major = (
                        not has_tree
                        and getattr(self.engine, "supports_row_major_gather", False)
                        and self.engine.rowmajor_ok(
                            min(s_chunk, len(slices)), _WORDS,
                            max(kb for _, kb in groups),
                        )
                    )
                    acc: dict[tuple, list] = {}
                    for c0 in range(0, len(slices), s_chunk):
                        matrix = self._transient_matrix(
                            index, frame, view, slices[c0 : c0 + s_chunk], want,
                            row_major=row_major,
                        )
                        for gk, op_idxs in sorted(groups.items(), key=_group_sort_key):
                            acc.setdefault(gk, []).append(
                                self._group_counts(
                                    [(gk, op_idxs)], matched, id_pos, matrix, static,
                                    None, row_major=row_major,
                                )
                            )
                    for gk, op_idxs in sorted(groups.items(), key=_group_sort_key):
                        total = sum(
                            self.engine.to_numpy(a).astype(np.int64) for a in acc[gk]
                        )
                        for k2, i in enumerate(op_idxs):
                            out[i] = int(total[k2])
        return [out[i] for i in idxs]

    def _group_counts(
        self, batch, matched, id_pos, matrix, static, gram, row_major=False,
        span=None, mixed=False,
    ):
        """One fused dispatch for a launch batch (``_launch_batches``):
        one (op, arity-bucket) call group ``[(gk, op_idxs)]``, or, with
        ``mixed`` (the resident regime), one or more N-ary groups that one
        launch of the mixed kernel folds together;
        returns the engine-native count array, the batch's calls in order
        (fetch deferred to the caller).  Metered as the "gather" lane
        (cost attribution): dispatch wall time + any host->device operand
        bytes the engine ledger sees.

        Under a traced request's ``span`` the dispatch is its launch span
        (``device``, ``costs._Measure``) and the fetch moves inside it: the
        counts come back on the host, the span's ``ms`` runs until they
        are there, and its kernels' device time (``device_ms``) can be read
        with no synchronisation of its own.  Tags: ``op`` (``mixed`` where
        the batch folds more than one), ``k`` (the largest operand
        bucket), ``groups`` (the (op, K) groups it folds), ``calls``,
        ``rows`` (distinct ids), ``slices`` and ``bytes_read`` (rows x
        slices x bytes a row a slice; 0 for a Gram answer, which reads the
        Gram, not the rows)."""
        if self.meter is None:
            return self._group_counts_inner(
                batch, matched, id_pos, matrix, static, gram, row_major, mixed,
            )
        with self.meter.measure("gather", span) as d:
            counts = self._group_counts_inner(
                batch, matched, id_pos, matrix, static, gram, row_major, mixed,
            )
            if span is not None:
                counts = self.engine.to_numpy(counts)
                ops = {op[0] if isinstance(op, tuple) else op for (op, _kb), _ in batch}
                rows = len({x for _gk, op_idxs in batch for i in op_idxs for x in matched[i][3]})
                n_slices = matrix.shape[1 if row_major else 0]
                (op, kb), _ = batch[0]
                reads = gram is None or kb != 2 or isinstance(op, tuple)
                d.dev_span.tags.update(
                    op=ops.pop() if len(ops) == 1 else "mixed",
                    k=max(kb for (_op, kb), _ in batch), groups=len(batch),
                    calls=sum(len(op_idxs) for _gk, op_idxs in batch), rows=rows,
                    slices=n_slices,
                    bytes_read=rows * n_slices * _ROW_SLICE_BYTES if reads else 0,
                )
        return counts

    def _group_counts_inner(
        self, batch, matched, id_pos, matrix, static, gram, row_major=False, mixed=False
    ):
        (op, kb), op_idxs = batch[0]
        if isinstance(op, tuple):  # ("tree", K): nested expression trees
            k = op[1]
            n = len(op_idxs)
            bb = (1 << (n - 1).bit_length()) if (static and n > 1) else n
            leaves = np.zeros((bb, k), dtype=np.int32)
            opc = np.zeros((bb, k - 1), dtype=np.int32)
            for r, i in enumerate(op_idxs):
                leaves[r] = [id_pos[x] for x in matched[i][3]]
                opc[r] = matched[i][4]
            leaves[n:] = leaves[0]  # pad rows repeat the first query
            opc[n:] = opc[0]
            return self.engine.gather_count_tree_dev(matrix, leaves, opc)
        if kb == 2:
            pairs = np.array(
                [
                    [id_pos[matched[i][3][0]], id_pos[matched[i][3][1]]]
                    for i in op_idxs
                ],
                dtype=np.int32,
            )
            if gram is not None:
                # Lazy import is cheap here: a non-None Gram implies the
                # device engine built it, so ops.bitwise is loaded.
                from pilosa_tpu_torch.ops.bitwise import gram_pair_counts

                return gram_pair_counts(op, gram, pairs)
            if row_major:
                return self.engine.gather_count_rowmajor_dev(op, matrix, pairs)
            return self.engine.gather_count_dev(op, matrix, pairs)
        if mixed:
            # One launch for every N-ary group, ragged (no batch padding:
            # the kernel takes any B and K).
            return self.engine.gather_count_multi_mixed_dev(
                matrix,
                [(gop, _fold_ids(gop, gkb, ixs, matched, id_pos, len(ixs)))
                 for (gop, gkb), ixs in batch],
                row_major=row_major,
            )
        # Jitted engines get a padded batch bucket too (pad rows repeat
        # the first call's operands; extra counts discarded) — ragged B
        # recompiles per group size.
        n = len(op_idxs)
        bb = (1 << (n - 1).bit_length()) if (static and n > 1) else n
        idx_arr = _fold_ids(op, kb, op_idxs, matched, id_pos, bb)
        if row_major:
            return self.engine.gather_count_multi_rowmajor_dev(op, matrix, idx_arr)
        return self.engine.gather_count_multi_dev(op, matrix, idx_arr)

    def _stream_bytes(self) -> int:
        """Per-chunk byte budget for slice-streaming transient matrices
        (ctor/Config > deprecated env spelling > default)."""
        if self._stream_bytes_cfg > 0:
            return self._stream_bytes_cfg
        # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
        return int(os.environ.get("PILOSA_TPU_STREAM_BYTES", str(1 << 31)))  # analysis-ok: env-knob-outside-config: deprecated spelling for directly-constructed executors

    def _slice_chunk(self, n_rows: int) -> int:
        """Slices per streaming chunk: the byte budget AND the int32
        count bound — a full-density chunk counts up to s_chunk * 2^20
        per query inside the kernels' int32 accumulators, so no chunk may
        span more than _INT32_SAFE_SLICES regardless of budget."""
        return max(
            1,
            min(
                self._stream_bytes() // max(1, n_rows * _WORDS * 4),
                _INT32_SAFE_SLICES,
            ),
        )

    def _densify_block(
        self, index, frame, view, chunk_slices, rows, row_major=False
    ) -> np.ndarray:
        """Host block of dense rows: uint32[len(chunk_slices), len(rows), W]
        (slice-major — pool fetches and transient streaming matrices), or
        [len(rows), len(chunk_slices), W] with ``row_major=True`` (the
        streaming gather lane: each row's slices contiguous for one-descriptor
        DMAs).  Filled directly in target order — no transpose copy."""
        if row_major:
            block = np.zeros((len(rows), len(chunk_slices), _WORDS), dtype=np.uint32)
        else:
            block = np.zeros((len(chunk_slices), len(rows), _WORDS), dtype=np.uint32)
        for bi, s in enumerate(chunk_slices):
            f = self.holder.fragment(index, frame, view, s)
            if f is not None:
                for k, r in enumerate(rows):
                    if row_major:
                        block[k, bi] = f.row_dense(r)
                    else:
                        block[bi, k] = f.row_dense(r)
        return block

    def _transient_matrix(
        self, index, frame, view, chunk_slices, rows_sorted, row_major=False
    ):
        """One slice chunk's transient matrix, built host-side and moved
        in a single transfer; NOT cached — streaming shapes would evict
        every steady-state pool for nothing."""
        block = self._densify_block(
            index, frame, view, chunk_slices, rows_sorted, row_major=row_major
        )
        if self.meter is not None:
            # Streaming lane: the chunk upload is the cost (the chunk's
            # dispatches meter separately as "gather").
            with self.meter.measure("stream"):
                if row_major:
                    return self.engine.matrix_rows(block)
                return self.engine.matrix(block)
        if row_major:
            return self.engine.matrix_rows(block)
        return self.engine.matrix(block)

    def _gram_env(self) -> tuple[bool, int]:
        """(no_gram, rows_max) — read once per Executor: these sit on the
        per-request serving path and os.environ lookups cost ~10 us each
        (same lazy-cache pattern as Fragment._max_opn_scale).  Process-
        lifetime settings; tests that toggle them build fresh Executors."""
        cached = self._gram_env_cache
        if cached is None:
            no_gram = self._no_gram_cfg
            if no_gram is None:
                # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
                no_gram = os.environ.get("PILOSA_TPU_NO_GRAM", "").lower() in (  # analysis-ok: env-knob-outside-config: deprecated spelling for directly-constructed executors
                    "1", "true", "yes",
                )
            cached = self._gram_env_cache = (
                bool(no_gram),
                self._gram_rows_max_cfg
                # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
                or int(os.environ.get("PILOSA_TPU_GRAM_ROWS_MAX", "4096")),  # analysis-ok: env-knob-outside-config: deprecated spelling for directly-constructed executors
            )
        return cached

    def _gram_rows_max(self) -> int:
        """Row ceiling for the cached-Gram strategy.  The Gram kernel
        (kernels.pair_gram) reads the packed words in place, so rows do
        not bound a build transient; what remains is the Gram matrix
        itself — R^2 int32 on device, fetched once to host for the native
        lookup lane (pn_gram_counts).  4096 rows = a 64 MiB Gram; the
        pool HBM budget bounds build FLOPs (R * S*R * 2^20 MACs with
        S*R capped by PILOSA_TPU_POOL_BYTES)."""
        return self._gram_env()[1]

    def _gram_could_serve(self, n_rows: int, n_slices: int) -> bool:
        """Whether the cached-Gram strategy is ELIGIBLE for a working set
        of this size (same gates as _frame_gram, sans warmth): the
        row-major gather lane must never displace it — warm Gram serving
        is host-side lookups, strictly faster than any per-query kernel."""
        no_gram, rows_max = self._gram_env()
        if no_gram:
            return False
        from pilosa_tpu_torch.ops.dispatch import _GRAM_SLICES_MAX

        bucket = 1 << max(0, n_rows - 1).bit_length()
        return bucket <= rows_max and n_slices <= _GRAM_SLICES_MAX

    def _frame_gram(self, matrix, box: Optional[dict]):
        """Cached all-pairs AND-count Gram for a fused-path row matrix.

        Computed lazily on the SECOND request against an unchanged cached
        matrix (cold single requests keep the cheaper direct kernels;
        steady-state dashboards upgrade to host-side count lookups, which
        answer every pair op via gram_pair_counts identities).  The box
        lives and dies with the cache entry, so any patch/append/rebuild
        invalidates the Gram with it.
        """
        if box is None or box.get("hits", 0) < 2:
            return None
        if self._gram_env()[0]:  # NO_GRAM
            return None
        gram = box.get("gram")
        if gram is not None:
            return gram
        shape = getattr(matrix, "shape", None)
        if not shape:
            return None
        # Pool matrices carry free capacity slots past n_used; the Gram
        # only needs the occupied slot range (power-of-two bucketed so the
        # matmul shape stays jit-stable).  Slot ids in id_pos are all
        # < n_used, so a gram over the truncated matrix answers every pair.
        n_used = box.get("n_used", shape[1])
        bucket = min(shape[1], 1 << max(0, (n_used - 1)).bit_length()) if n_used else 0
        if bucket == 0:
            return None
        # The Gram kernel (kernels.pair_gram) reads the view's packed
        # words in place, with its strides, so no unpacked copy is live;
        # the gates are the Gram matrix size (rows) and the int32 count
        # bound (slices).
        from pilosa_tpu_torch.ops.dispatch import _GRAM_SLICES_MAX

        if bucket > self._gram_rows_max() or shape[0] > _GRAM_SLICES_MAX:
            return None
        mu = box.get("mu")
        if mu is None or not mu.acquire(blocking=False):
            # Another request is already building this Gram; serve this one
            # through the direct kernels instead of piling up builders.
            return None
        try:
            gram = box.get("gram")
            if gram is None:
                m = matrix if bucket == shape[1] else matrix[:, :bucket, :]
                if self.meter is not None:
                    with self.meter.measure("gram") as d:
                        gram = self.engine.pair_gram(m)
                        if gram is not None:
                            # The R^2 count matrix fetched to host.
                            d.add_bytes(int(gram.nbytes))
                else:
                    gram = self.engine.pair_gram(m)
                if gram is None:
                    box["hits"] = -(1 << 30)  # engine can't: stop re-checking
                    return None
                box["gram"] = gram
            return gram
        finally:
            mu.release()

    def _peek_pool_cap(
        self, index: str, frame: str, view: str, slices, lane: str = ""
    ) -> int:
        """A lane pool's row capacity WITHOUT instantiating it or touching
        the LRU order — lane-choice probes must never evict a warm pool
        (and its cached Gram) for a lane that may not even be taken."""
        key = (index, frame, view, tuple(slices), lane)
        with self._matrix_mu:
            pool = self._matrix_cache.get(key)
            if pool is not None:
                return pool.cap_max
        return DeviceRowPool.default_cap(len(slices), _WORDS)

    def _pool_for(
        self, index: str, frame: str, view: str, slices, lane: str = ""
    ) -> "DeviceRowPool":
        """The paged device row pool for one (frame, view, slice batch).

        Pools live in the same small LRU the old fixed matrices did; each
        is bounded by the PILOSA_TPU_POOL_BYTES HBM budget and pages rows
        in/out on demand (rowpool.DeviceRowPool) — the row-count ceiling
        of the old design is gone.  ``lane`` separates workloads with
        different paging patterns (TopN candidate streams vs fused count
        working sets vs the row-major gather lane) so one can't evict
        another's residency.  Lanes holding the same frame's rows each
        carry the per-pool budget: a frame whose workload mixes
        Gram-scale and gather-scale requests keeps both lanes warm (up
        to 2x one pool's budget for that frame), bounded overall by
        this LRU's entry count — the cost of never paging one workload
        class's residency out for the other's.
        """
        key = (index, frame, view, tuple(slices), lane)
        row_major = lane == "rmgather"
        with self._matrix_mu:
            pool = self._matrix_cache.get(key)
            if pool is None:

                def fetch(row_ids, slice_idxs, _key=key, _rm=row_major):
                    # Re-resolves fragments per fetch (they may be created
                    # by a first write after the pool exists).
                    idx_n, frame_n, view_n, slc, _lane = _key
                    return self._densify_block(
                        idx_n, frame_n, view_n,
                        [slc[si] for si in slice_idxs], row_ids, row_major=_rm,
                    )

                pool = DeviceRowPool(
                    self.engine, len(slices), _WORDS, fetch, row_major=row_major
                )
                self._matrix_cache[key] = pool
            self._matrix_cache.move_to_end(key)
            while len(self._matrix_cache) > self._matrix_cache_entries:
                self._matrix_cache.popitem(last=False)
        return pool

    def _frame_matrix(
        self, index: str, frame: str, slices, want: set[int],
        view: str = VIEW_STANDARD, lane: str = "",
    ) -> tuple[dict[int, int], object, Optional[dict]]:
        """Device row matrix holding (at least) ``want`` for a frame view.

        Pool-backed: rows page into HBM slots on demand and stay resident
        across requests; the returned id_pos maps every RESIDENT row to
        its slot in the returned (immutable) matrix snapshot.  Generations
        are read BEFORE acquire: a concurrent mutation mid-fetch can only
        make the recorded generations stale, forcing a refresh next
        request — never a stale hit.
        """
        frags = [self.holder.fragment(index, frame, view, s) for s in slices]
        gens = tuple(-1 if f is None else f.generation for f in frags)
        pool = self._pool_for(index, frame, view, slices, lane=lane)
        # Dirty-row delta for the pool's PATCH lane: when the fragment
        # journals can enumerate everything written since the pool's
        # recorded generations (and it fits the repair budget), acquire
        # rewrites just those rows and rank-k-repairs the Gram instead of
        # refreshing whole planes and resetting the box.  The unlocked
        # pool.gens read is benign: a stale (older) base only widens the
        # delta — a superset patch is still correct.
        dirty = None
        pool_gens = pool.gens
        if pool_gens is not None and pool_gens != gens:
            dirty = self._journal_dirty_rows(frags, pool_gens, gens)
        out = pool.acquire(sorted(want), gens, dirty_rows=dirty)
        if self.meter is not None:
            self._note_resident()
        return out

    def _note_resident(self) -> None:
        """Gauge the HBM-resident working set (engine.hbm_bytes): the
        pooled row matrices plus their cached Grams.  An estimate — a
        concurrent eviction between snapshot and sum is acceptable for
        a gauge."""
        from pilosa_tpu_torch.engine import nbytes as _nbytes

        with self._matrix_mu:
            pools = list(self._matrix_cache.values()) + list(
                self._multi_matrix_cache.values()
            )
        total = 0
        for p in pools:
            m = getattr(p, "matrix", None)
            if m is None and isinstance(p, tuple):
                total += _nbytes(*[x for x in p if hasattr(x, "nbytes")])
                continue
            total += _nbytes(m)
            box = getattr(p, "box", None)
            if isinstance(box, dict):
                total += _nbytes(box.get("gram"))
        self.meter.resident(total)

    # -- call dispatch (executor.go:156-179) ------------------------------

    def _execute_call(self, index: str, c: pql.Call, slices, opt: ExecOptions) -> Any:
        if c.name == "Count":
            return self._execute_count(index, c, slices, opt)
        if c.name == "TopN":
            return self._execute_topn(index, c, slices, opt)
        if c.name == "SetBit":
            return self._execute_set_bit(index, c, opt)
        if c.name == "ClearBit":
            return self._execute_clear_bit(index, c, opt)
        if c.name == "SetRowAttrs":
            return self._execute_set_row_attrs(index, c, opt)
        if c.name in ("SetColumnAttrs", "SetProfileAttrs"):
            return self._execute_set_column_attrs(index, c, opt)
        if c.name in BITMAP_CALLS:
            return self._execute_bitmap_call(index, c, slices, opt)
        raise PilosaError(f"unknown call: {c.name}")

    # -- bitmap calls ------------------------------------------------------

    def _execute_bitmap_call(self, index: str, c: pql.Call, slices, opt: ExecOptions) -> QueryBitmap:
        def local_map(local_slices: list[int]) -> QueryBitmap:
            batch = self._eval_stack(index, c, local_slices)
            words = self.engine.to_numpy(batch)
            segs = {
                s: words[i]
                for i, s in enumerate(local_slices)
                if words[i].any()
            }
            return QueryBitmap(segs)

        result = self._map_reduce(
            index, c, slices, opt, local_map, lambda a, b: a.merge(b), QueryBitmap()
        )

        # Attach attributes at the coordinator (executor.go:166-177).
        if c.name == "Bitmap" and not opt.remote and not opt.exclude_attrs:
            idx = self.holder.index(index)
            frame = self.holder.frame(index, c.string_arg("frame") or DEFAULT_FRAME)
            if frame is not None:
                try:
                    row_id, row_ok = c.uint_arg(frame.row_label)
                    col_id, col_ok = c.uint_arg(idx.column_label)
                except TypeError:
                    row_ok = col_ok = False
                if row_ok:
                    result.attrs = frame.row_attr_store.attrs(row_id) or {}
                elif col_ok:
                    result.attrs = idx.column_attr_store.attrs(col_id) or {}
        return result

    def _eval_stack(self, index: str, c: pql.Call, slices: list[int]):
        """Evaluate a bitmap call tree to an engine batch uint32[k, W]."""
        if c.name == "Bitmap":
            return self._eval_bitmap_leaf(index, c, slices)
        if c.name == "Range":
            return self._eval_range(index, c, slices)
        children = [self._eval_stack(index, ch, slices) for ch in c.children]
        if c.name == "Intersect":
            if not children:
                raise PilosaError("empty Intersect query is currently not supported")
            out = children[0]
            for ch in children[1:]:
                out = self.engine.bit_and(out, ch)
            return out
        if c.name == "Union":
            if not children:
                return self.engine.asarray(np.zeros((len(slices), _WORDS), dtype=np.uint32))
            out = children[0]
            for ch in children[1:]:
                out = self.engine.bit_or(out, ch)
            return out
        if c.name == "Difference":
            if not children:
                raise PilosaError("empty Difference query is currently not supported")
            out = children[0]
            for ch in children[1:]:
                out = self.engine.bit_andnot(out, ch)
            return out
        if c.name == "Xor":
            if not children:
                raise PilosaError("empty Xor query is currently not supported")
            out = children[0]
            for ch in children[1:]:
                out = self.engine.bit_xor(out, ch)
            return out
        raise PilosaError(f"unknown bitmap call: {c.name}")

    def _resolve_bitmap_leaf(self, index: str, c: pql.Call) -> tuple[str, str, int]:
        """(frame, view, id) for a Bitmap() leaf (executor.go:428-473)."""
        idx = self.holder.index(index)
        if idx is None:
            raise ErrIndexNotFound(index)
        frame_name = c.string_arg("frame") or DEFAULT_FRAME
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            raise ErrFrameNotFound(frame_name)
        row_id, row_ok = c.uint_arg(frame.row_label)
        col_id, col_ok = c.uint_arg(idx.column_label)
        if row_ok and col_ok:
            raise PilosaError(
                f"Bitmap() cannot specify both {frame.row_label} and {idx.column_label} values"
            )
        if not row_ok and not col_ok:
            raise PilosaError(
                f"Bitmap() must specify either {frame.row_label} or {idx.column_label} values"
            )
        if col_ok:
            if not frame.inverse_enabled:
                raise ErrFrameInverseDisabled(
                    "Bitmap() cannot retrieve columns unless inverse storage enabled"
                )
            return frame_name, VIEW_INVERSE, col_id
        return frame_name, VIEW_STANDARD, row_id

    def _gather_rows(self, index: str, frame: str, view: str, row_id: int, slices: list[int]):
        rows = []
        zeros = None
        for s in slices:
            frag = self.holder.fragment(index, frame, view, s)
            if frag is None:
                if zeros is None:
                    zeros = self.engine.asarray(np.zeros(_WORDS, dtype=np.uint32))
                rows.append(zeros)
            else:
                # Device-cached row: hot rows stay resident in HBM across
                # queries instead of re-uploading every time.
                rows.append(frag.row_device(row_id, self.engine))
        return self.engine.stack_slices(rows)

    def _eval_bitmap_leaf(self, index: str, c: pql.Call, slices: list[int]):
        frame, view, id = self._resolve_bitmap_leaf(index, c)
        return self._gather_rows(index, frame, view, id, slices)

    def _parse_range_args(self, index: str, c: pql.Call):
        """(frame_name, frame, row_id, start, end) for a Range() call,
        with the sequential path's exact errors (executor.go:498-531)."""
        frame_name = c.string_arg("frame") or DEFAULT_FRAME
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            raise ErrFrameNotFound(frame_name)
        row_id, ok = c.uint_arg(frame.row_label)
        if not ok:
            raise PilosaError(f"Range() {frame.row_label} required")
        start_s = c.string_arg("start")
        end_s = c.string_arg("end")
        if not start_s:
            raise PilosaError("Range() start time required")
        if not end_s:
            raise PilosaError("Range() end time required")
        try:
            start = datetime.strptime(start_s, pql.TIME_FORMAT)
            end = datetime.strptime(end_s, pql.TIME_FORMAT)
        except ValueError:
            raise PilosaError("cannot parse Range() time")
        return frame_name, frame, row_id, start, end

    def _eval_range(self, index: str, c: pql.Call, slices: list[int]):
        """Range(): union of time-view rows covering [start, end)
        (executor.go:498-554)."""
        frame_name, frame, row_id, start, end = self._parse_range_args(index, c)
        out = self.engine.asarray(np.zeros((len(slices), _WORDS), dtype=np.uint32))
        if not frame.time_quantum:
            return out
        for view in tq.views_by_time_range(VIEW_STANDARD, start, end, frame.time_quantum):
            out = self.engine.bit_or(out, self._gather_rows(index, frame_name, view, row_id, slices))
        return out

    # -- Count (executor.go:576-605) ---------------------------------------

    def _execute_count(self, index: str, c: pql.Call, slices, opt: ExecOptions) -> int:
        if len(c.children) == 0:
            raise PilosaError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise PilosaError("Count() only accepts a single bitmap input")

        def local_map(local_slices: list[int]) -> int:
            batch = self._eval_stack(index, c.children[0], local_slices)
            return int(self.engine.count(batch).sum())

        return self._map_reduce(index, c, slices, opt, local_map, lambda a, b: a + b, 0)

    # -- TopN (executor.go:281-404) ----------------------------------------

    def _execute_topn(self, index: str, c: pql.Call, slices, opt: ExecOptions) -> list[cache_mod.Pair]:
        row_ids, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")
        pairs = self._execute_topn_slices(index, c, slices, opt)
        if not pairs or row_ids or opt.remote:
            return pairs
        # Phase 2: coordinator refetches exact counts for the merged id set
        # across all slices, then truncates (executor.go:299-317).
        other = c.clone()
        other.args["ids"] = sorted(p.id for p in pairs)
        trimmed = self._execute_topn_slices(index, other, slices, opt)
        if n:
            trimmed = trimmed[:n]
        return trimmed

    def _execute_topn_slices(self, index: str, c: pql.Call, slices, opt: ExecOptions) -> list[cache_mod.Pair]:
        def local_map(local_slices: list[int]) -> list[cache_mod.Pair]:
            return self._topn_local(index, c, local_slices)

        pairs = self._map_reduce(index, c, slices, opt, local_map, cache_mod.pairs_add, [])
        return cache_mod.pairs_sorted(pairs)

    def _topn_local(self, index: str, c: pql.Call, slices: list[int]) -> list[cache_mod.Pair]:
        frame_name = c.string_arg("frame") or DEFAULT_FRAME
        n, _ = c.uint_arg("n")
        field = c.string_arg("field")
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        filters = c.args.get("filters") or []
        tanimoto, _ = c.uint_arg("tanimotoThreshold")

        src_batch = None
        if c.children:
            if len(c.children) > 1:
                raise PilosaError("TopN() can only have one input bitmap")
            src_batch = self.engine.to_numpy(self._eval_stack(index, c.children[0], slices))

        scorer_for = self._topn_scorer_factory(index, frame_name, slices, src_batch)
        merged: list[cache_mod.Pair] = []
        for i, s in enumerate(slices):
            frag = self.holder.fragment(index, frame_name, VIEW_STANDARD, s)
            if frag is None:
                continue
            src_dense = src_batch[i] if src_batch is not None else None
            topt = TopOptions(
                n=int(n),
                src_dense=src_dense,
                scorer=scorer_for(i, src_dense),
                row_ids=row_ids,
                min_threshold=int(min_threshold),
                filter_field=field,
                filter_values=filters,
                tanimoto_threshold=int(tanimoto),
            )
            merged = cache_mod.pairs_add(merged, frag.top(topt))
        return merged

    def _topn_scorer_factory(self, index, frame_name, slices, src_batch):
        """Per-slice engine-backed |row & src| scorers for TopN candidates.

        The reference scores candidates with a per-row scalar loop
        (fragment.go:553-560); here each candidate chunk is one fused
        device dispatch against a paged device row pool.  The pool lives
        on its OWN lane key ("topn") so streaming tens of thousands of
        candidates through HBM pages against the scorer's slots without
        evicting the fused Count lane's hot rows or its Gram.  Chunks are
        padded to the fragment scoring chunk so jitted shapes never vary.
        Unbounded candidate sets just page (rank-cache scale included);
        the only host fallback left is an engine that can't score rows
        (numpy: the fragment's host path is the same math without an
        engine round trip) or a pool too small for even one chunk.
        """
        if (
            src_batch is None
            or self.engine.name == "numpy"
            or not getattr(self.engine, "supports_row_scorer", True)
        ):
            return lambda si, src_dense: None
        from pilosa_tpu_torch.core.fragment import TOPN_SCORE_CHUNK

        state = {"src_dev": {}}
        all_slices = list(slices)
        pool = self._pool_for(index, frame_name, VIEW_STANDARD, all_slices, lane="topn")
        if pool.cap_max < TOPN_SCORE_CHUNK:
            return lambda si, src_dense: None  # can't hold one chunk

        if getattr(self.engine, "row_scorer_all_slices", False):
            return self._topn_scorer_factory_all_slices(
                index, frame_name, all_slices, src_batch, pool
            )

        def scorer_for(si: int, src_dense):
            if src_dense is None:
                return None

            def score(ids):
                matrix, pos = self._topn_acquire_pos(
                    index, frame_name, all_slices, pool, ids
                )
                src_dev = state["src_dev"].get(si)
                if src_dev is None:
                    # Tiled to match rows sliced from the 4D pool matrix.
                    tile = getattr(self.engine, "tile_src", self.engine.asarray)
                    src_dev = state["src_dev"][si] = tile(src_dense)
                rows = matrix[si][pos]
                counts = self.engine.batch_intersection_count(
                    rows, src_dev, tiled=getattr(matrix, "ndim", 3) == 4
                )
                return counts[: len(ids)]

            return score

        return scorer_for

    def _topn_acquire_pos(self, index, frame_name, all_slices, pool, ids):
        """Shared scorer helper: page the candidate rows into the pool
        and map ids to matrix slots, padded to TOPN_SCORE_CHUNK so the
        jitted scorer shapes never vary (pad scores are discarded)."""
        from pilosa_tpu_torch.core.fragment import TOPN_SCORE_CHUNK

        frags = [
            self.holder.fragment(index, frame_name, VIEW_STANDARD, s)
            for s in all_slices
        ]
        gens = tuple(-1 if f is None else f.generation for f in frags)
        id_pos, matrix, _ = pool.acquire(sorted(set(ids)), gens)
        n = len(ids)
        padded = (
            list(ids) + [ids[0]] * (TOPN_SCORE_CHUNK - n)
            if n < TOPN_SCORE_CHUNK
            else list(ids)
        )
        pos = np.fromiter(
            (id_pos[i] for i in padded), dtype=np.int32, count=len(padded)
        )
        return matrix, pos

    def _topn_scorer_factory_all_slices(
        self, index, frame_name, all_slices, src_batch, pool
    ):
        """Hybrid memoizing scorer (round 5): phase-1 candidate chunks
        (each fragment's own rank-cache candidates, one consuming slice)
        dispatch just their slice; a candidate set re-asked by a SECOND
        slice (phase 2's merged-id refetch across every slice) upgrades
        to ONE all-slice launch (engine.topn_scorer_counts) memoized for
        the rest.  Multi-process meshes always use the SPMD all-slice
        dispatch (eager ``matrix[si]`` indexing would touch shards owned
        by other processes).  Falls back to the host loop for slice
        counts a mesh can't shard evenly."""
        n_dev = getattr(getattr(self.engine, "mesh", None), "n_devices", 1)
        if len(all_slices) % n_dev:
            return lambda si, src_dense: None
        # Single-slice dispatches are legal whenever every shard is
        # process-addressable (single-device engines); multi-process
        # meshes must always go through the SPMD all-slice dispatch.
        single_ok = bool(getattr(self.engine, "supports_single_slice_score", True))
        state: dict = {"src_dev": None, "src_si": {}}

        def all_src_dev():
            if state["src_dev"] is None:
                src_stack = np.stack(
                    [np.asarray(src_batch[i]) for i in range(len(all_slices))]
                )
                state["src_dev"] = self.engine.prepare_topn_src(src_stack)
            return state["src_dev"]

        memo: dict = {}  # ids -> int[S, K] all-slice counts
        seen: dict = {}  # ids -> first slice position that scored them

        def acquire_pos(ids):
            return self._topn_acquire_pos(index, frame_name, all_slices, pool, ids)

        def scorer_for(si: int, src_dense):
            if src_dense is None:
                return None

            def score(ids):
                key = tuple(ids)
                counts = memo.get(key)
                if counts is not None:
                    return counts[si, : len(ids)]
                if single_ok and seen.setdefault(key, si) == si:
                    # First sight of this candidate set (phase 1: each
                    # fragment scores its OWN rank-cache candidates):
                    # dispatch just this slice — the all-slice launch
                    # would do S x the compute for one consumed row.
                    matrix, pos = acquire_pos(ids)
                    tile = getattr(self.engine, "tile_src", self.engine.asarray)
                    src_dev = state["src_si"].get(si)
                    if src_dev is None:
                        src_dev = state["src_si"][si] = tile(src_dense)
                    rows = matrix[si][pos]
                    c = self.engine.batch_intersection_count(
                        rows, src_dev, tiled=getattr(matrix, "ndim", 3) == 4
                    )
                    return c[: len(ids)]
                # A SECOND slice asking for the same ids (phase 2's
                # merged-id refetch re-queries every slice): one
                # all-slice dispatch, memoized for the rest.
                matrix, pos = acquire_pos(ids)
                counts = memo[key] = self.engine.topn_scorer_counts(
                    matrix, pos, all_src_dev()
                )
                return counts[si, : len(ids)]

            return score

        return scorer_for

    # -- writes (executor.go:702-805) --------------------------------------

    def _set_bit_args(self, index: str, c: pql.Call):
        idx = self.holder.index(index)
        if idx is None:
            raise ErrIndexNotFound(index)
        frame_name = c.string_arg("frame")
        if not frame_name:
            raise PilosaError(f"{c.name}() field 'frame' required")
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            raise ErrFrameNotFound(frame_name)
        row_id, ok = c.uint_arg(frame.row_label)
        if not ok:
            raise PilosaError(f"{c.name}() field '{frame.row_label}' required")
        col_id, ok = c.uint_arg(idx.column_label)
        if not ok:
            raise PilosaError(f"{c.name}() field '{idx.column_label}' required")
        timestamp = None
        ts = c.string_arg("timestamp")
        if ts:
            timestamp = datetime.strptime(ts, pql.TIME_FORMAT)
        return frame, row_id, col_id, timestamp

    def _execute_set_bit(self, index: str, c: pql.Call, opt: ExecOptions) -> bool:
        return self._execute_bit_write(index, c, opt, clear=False)

    def _execute_clear_bit(self, index: str, c: pql.Call, opt: ExecOptions) -> bool:
        return self._execute_bit_write(index, c, opt, clear=True)

    def _execute_bit_write(self, index: str, c: pql.Call, opt: ExecOptions, clear: bool) -> bool:
        """Write a bit on every owner of its slice — locally only when this
        node is an owner, forwarding to the others (executor.go:675-698,
        780-805).  A forwarded call (opt.remote) only writes locally."""
        frame, row_id, col_id, timestamp = self._set_bit_args(index, c)

        def write_local() -> bool:
            if clear:
                changed = frame.clear_bit(VIEW_STANDARD, row_id, col_id)
                if frame.inverse_enabled and frame.clear_bit(VIEW_INVERSE, col_id, row_id):
                    changed = True
            else:
                changed = frame.set_bit(VIEW_STANDARD, row_id, col_id, timestamp)
                if frame.inverse_enabled and frame.set_bit(VIEW_INVERSE, col_id, row_id, timestamp):
                    changed = True
            if changed:
                self._note_dirty_rows(index, frame.name, (row_id,))
            return changed

        if opt.remote or self.cluster is None or self.client_factory is None:
            return write_local()

        changed = False
        slice_i = col_id // SLICE_WIDTH
        for node in self.cluster.fragment_nodes(index, slice_i):
            if node.host == self.host:
                if write_local():
                    changed = True
            else:
                client = self.client_factory(node.host)
                res = client.execute_remote(
                    index, pql.Query(calls=[c]), deadline=opt.deadline
                )
                if res and res[0]:
                    changed = True
        return changed

    # -- attrs (executor.go:808-1006) --------------------------------------

    def _execute_set_row_attrs(self, index: str, c: pql.Call, opt: ExecOptions) -> None:
        frame_name = c.string_arg("frame")
        if not frame_name:
            raise PilosaError("SetRowAttrs() frame required")
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            raise ErrFrameNotFound(frame_name)
        row_id, ok = c.uint_arg(frame.row_label)
        if not ok:
            raise PilosaError(f"SetRowAttrs() row field '{frame.row_label}' required")
        attrs = dict(c.args)
        attrs.pop("frame", None)
        attrs.pop(frame.row_label, None)
        frame.row_attr_store.set_attrs(row_id, attrs)
        if not opt.remote:
            self._broadcast_attrs(index, c)
        return None

    def _execute_set_column_attrs(self, index: str, c: pql.Call, opt: ExecOptions) -> None:
        idx = self.holder.index(index)
        if idx is None:
            raise ErrIndexNotFound(index)
        col_id, ok = c.uint_arg(idx.column_label)
        if not ok:
            raise PilosaError(f"SetColumnAttrs() field '{idx.column_label}' required")
        attrs = dict(c.args)
        attrs.pop(idx.column_label, None)
        attrs.pop("frame", None)
        idx.column_attr_store.set_attrs(col_id, attrs)
        if not opt.remote:
            self._broadcast_attrs(index, c)
        return None

    def _broadcast_attrs(self, index: str, c: pql.Call) -> None:
        """Attr writes go to every node (executor.go:845-861)."""
        if self.cluster is None or self.client_factory is None:
            return
        for node in self.cluster.nodes:
            if node.host == self.host:
                continue
            self.client_factory(node.host).execute_remote(index, pql.Query(calls=[c]))

    # -- mapReduce (executor.go:1115-1244) ----------------------------------

    def _map_reduce(
        self, index: str, c, slices, opt: ExecOptions, local_map, reduce_fn, zero,
        remote_map=None,
    ):
        """Fan the call out over slice owners and reduce.

        Local slices evaluate as ONE batched computation (local_map gets the
        whole list); remote nodes get the call forwarded once each with
        their slice list, mirroring the reference's per-node batching.
        ``remote_map(client, node_slices)`` overrides how a remote node is
        driven (the fused batch path forwards a whole Query instead of one
        call).
        """
        slices = list(slices or [])

        def local_chunked(node_slices):
            # Slice-axis chunking for LOCAL evaluation: an index bigger
            # than device memory executes as a sequence of bounded slice
            # batches folded through reduce_fn (reduce identities hold:
            # int sum, segment merge, Pairs.Add are all zero-safe).  The
            # reference's per-slice goroutine loop has no size limit
            # either (executor.go:1115-1244); this is its bounded-memory
            # analog.
            chunk = self._slice_chunk_cfg
            if chunk <= 0:
                # analysis-ok: lockstep-determinism: deployment config, launcher sets identical env on every rank
                chunk = int(os.environ.get("PILOSA_TPU_SLICE_CHUNK", "2048"))  # analysis-ok: env-knob-outside-config: deprecated spelling for directly-constructed executors
            span = opt.span
            if len(node_slices) <= chunk:
                if span is None:
                    return local_map(node_slices)
                csp = span.child("slices")
                csp.tags["n"] = len(node_slices)
                try:
                    return local_map(node_slices)
                finally:
                    csp.finish()
            result = zero
            for i in range(0, len(node_slices), chunk):
                if opt.deadline is not None and i:
                    # Cancellation checkpoint between slice chunks: a
                    # bigger-than-memory scan stops streaming once the
                    # request's budget is gone.
                    opt.deadline.check("between slice chunks")
                csp = None
                if span is not None:
                    # One span per slice chunk: the streaming regime's
                    # per-chunk upload+dispatch time is exactly where
                    # big-index requests go slow.
                    csp = span.child("slice_chunk")
                    csp.tags["start"] = i
                    csp.tags["n"] = len(node_slices[i : i + chunk])
                result = reduce_fn(result, local_map(node_slices[i : i + chunk]))
                if csp is not None:
                    csp.finish()
            return result

        if self.cluster is None or opt.remote or self.client_factory is None:
            return reduce_fn(zero, local_chunked(slices))

        import concurrent.futures

        def run_node(node, node_slices):
            if node.host == self.host:
                return local_chunked(node_slices)
            client = self.client_factory(node.host)
            rsp = None
            if opt.span is not None:
                # Remote hop span: the client forwards the trace id in
                # X-Pilosa-Trace and grafts the peer's span tree (from
                # X-Pilosa-Trace-Spans) under this span, so the
                # coordinator's trace shows the remote node's stages.
                rsp = opt.span.child("remote")
                rsp.tags["host"] = node.host
                rsp.tags["slices"] = len(node_slices)
            try:
                if remote_map is not None:
                    return remote_map(client, node_slices, trace_span=rsp)
                # Conditional kwargs only when set: custom client factories
                # (tests, embedders) need not know the QoS/qcache kwargs.
                kw = {}
                if opt.deadline is not None:
                    kw["deadline"] = opt.deadline
                if opt.no_cache:
                    kw["no_cache"] = True
                if rsp is not None:
                    kw["trace_span"] = rsp
                return client.execute_remote_call(index, c, node_slices, **kw)
            finally:
                if rsp is not None:
                    rsp.finish()

        # Mid-query node-failure retry (executor.go:1147-1159): when a
        # remote node becomes UNREACHABLE (transport-level OSError — refused
        # connection, reset, timeout), its slices are re-mapped onto the
        # remaining replica owners and re-dispatched; the query only fails
        # once some slice has no live owner left.  Application errors from a
        # reachable node (and all local errors) are query errors and
        # propagate immediately — retrying them on replicas would just
        # repeat a deterministic failure and mask the real message.
        result = zero
        pending = slices
        failed_hosts: set[str] = set()
        last_failure: Optional[BaseException] = None
        while pending:
            try:
                by_node = self.cluster.slices_by_node(
                    index, pending, exclude_down=True, exclude_hosts=failed_hosts
                )
            except RuntimeError as e:
                raise PilosaError(str(e)) from last_failure
            pending = []
            with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(by_node))) as pool:
                futs = {
                    pool.submit(run_node, node, node_slices): node
                    for node, node_slices in by_node.items()
                }
                for fut in concurrent.futures.as_completed(futs):
                    node = futs[fut]
                    try:
                        node_result = fut.result()
                    except OSError as e:
                        if node.host == self.host:
                            raise
                        last_failure = e
                        failed_hosts.add(node.host)
                        pending.extend(by_node[node])
                        continue
                    result = reduce_fn(result, node_result)
        return result
