"""Generation-keyed query result cache: exact whole-query memoization.

No reference analog — the reference re-executes every PQL request from
scratch.  Production bitmap-index traffic is heavily skewed toward
repeated queries (the same dashboards and segments hit over and over),
and the Roaring line of work wins precisely by never recomputing what
set algebra already knows; this subsystem applies the same principle
one level up, at whole-query granularity, in front of the executor.

Design:

- **Key**: canonical fingerprint of the parsed PQL call tree (the
  deterministic ``str(Query)`` rendering, memoized per raw request
  string) + the target index + the explicit slice set, so formatting
  variants of the same call tree share one entry and per-node remote
  sub-requests (``slices=[...]``) never collide with coordinator
  requests.
- **Validity**: the fragment *generation vector* the execution could
  have touched — every (view, slice) fragment generation of every
  frame the call tree references, plus the index/frame schema header
  (max slice, labels, time quantum).  Fragment generations come from a
  process-global counter bumped inside the fragment's own locked
  mutation methods, so ANY writer (executor paths, imports, restores,
  anti-entropy sync) invalidates matching entries with zero explicit
  invalidation traffic, and a deleted+recreated fragment can never
  revive an old entry (the counter never repeats).  The vector is
  snapshotted BEFORE execution and re-checked at store time: a write
  landing mid-execution skips the store rather than stamping post-write
  tokens onto possibly pre-write results (the same rule as the
  executor's serve-state capture).
- **Store**: byte-accounted LRU with cost-aware admission — only
  results whose measured execution cost clears ``min_cost_ms`` are
  admitted (cheap requests would pay more in cache bookkeeping than
  they save); errors are never cached (an exception never reaches the
  commit), and write-bearing or non-deterministic trees are never
  cached (see CACHEABLE_CALLS).

**What is cacheable**: every top-level call must be one of
``Count / Intersect / Union / Difference / Xor / Range``.  ``Bitmap``
is excluded at top level because it attaches row/column attributes,
which mutate without a generation bump (SetRowAttrs touches the attr
store only); ``TopN`` is excluded because its rank-cache ranking
recalculates on a time debounce, so a fresh execution may legitimately
differ without any write.  Bitmap leaves INSIDE set-op trees are fine —
only top-level Bitmap calls attach attrs.

**Multi-node clusters**: validity is judged against the LOCAL holder's
generation vector, but cluster writes are applied only on slice-owner
nodes (the coordinator forwards without a local write when it is not an
owner) — so a coordinator-scope result covering remotely-owned slices
could never be invalidated by those writes.  The executor therefore
caches only ``remote=True`` sub-requests when it has a cluster: those
execute purely over locally-owned slices, and every write to a locally
owned slice is applied locally on every owner, so local generations
fully cover them.  Coordinator-scope requests are counted ineligible
and always execute fresh (each peer's cached sub-answer still saves the
per-node work).

**Lockstep determinism**: hit/miss decisions depend only on replicated
state — the request strings (shipped in the batch entry), the mutation
order (the lockstep total order), and deterministic result sizes —
EXCEPT wall-clock cost admission, which is rank-local.  The lockstep
service therefore builds its cache with ``min_cost_ms=0`` (admit every
eligible read), making every decision a pure function of replicated
state: every rank hits or misses identically and no rank skips a
collective another rank runs (the same determinism rule as lockstep
error isolation and expired-request drops).
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch.analysis import lockcheck
import time
from collections import OrderedDict
from typing import Optional

# Per-request cache bypass header: the request neither reads nor stores
# a cache entry (A/B measurement, stale-read debugging).
NO_CACHE_HEADER = "X-Pilosa-No-Cache"

# Top-level call names whose results are pure functions of fragment
# contents (see module docstring for the Bitmap/TopN exclusions).
CACHEABLE_CALLS = frozenset(
    {"Count", "Intersect", "Union", "Difference", "Xor", "Range"}
)

# Call names that reference a frame (default frame when the arg is
# absent) anywhere in a tree.
_FRAME_CALLS = frozenset({"Bitmap", "Range", "TopN"})

DEFAULT_MAX_BYTES = 256 << 20
DEFAULT_MIN_COST_MS = 1.0

# Don't fingerprint megabyte request bodies (same bound as the parse
# cache): bulk-import-sized requests are never dashboard repeats.
_FINGERPRINT_MAX_LEN = 1 << 16


def referenced_frames(query) -> tuple:
    """Sorted tuple of frame names a parsed Query can touch."""
    from pilosa_tpu_torch.executor import DEFAULT_FRAME

    frames: set = set()

    def walk(call):
        if call.name in _FRAME_CALLS or "frame" in call.args:
            frames.add(call.string_arg("frame") or DEFAULT_FRAME)
        for ch in call.children:
            walk(ch)

    for c in query.calls:
        walk(c)
    return tuple(sorted(frames))


def generation_vector(holder, index: str, frames: tuple) -> Optional[tuple]:
    """The validity token for one (index, frame set): the schema header
    plus every existing fragment's write generation across ALL views of
    each referenced frame (standard, inverse, and time views — a
    superset of what any one execution reads, so invalidation is
    conservative but exactness never depends on knowing the exact view
    cover).  None when the index is gone (nothing to validate against).
    """
    idx = holder.index(index)
    if idx is None:
        return None
    vec: list = [
        (idx.max_slice(), idx.max_inverse_slice(), idx.column_label, idx.time_quantum)
    ]
    for fname in frames:
        fr = holder.frame(index, fname)
        if fr is None:
            vec.append((fname, None))
            continue
        vec.append((fname, fr.row_label, fr.inverse_enabled, fr.time_quantum))
        # list() snapshots: schema merges / writes may insert views or
        # fragments concurrently — a racing insert at worst makes this
        # vector stale, which is a conservative miss, never a stale hit.
        for vname, view in sorted(list(fr.views.items()), key=lambda kv: kv[0]):
            for s, frag in sorted(list(view.fragments.items()), key=lambda kv: kv[0]):
                if frag is not None:
                    vec.append((vname, s, frag.generation))
    return tuple(vec)


def result_nbytes(results) -> int:
    """Byte-accounting estimate for one result list (duck-typed so this
    module never imports the executor)."""
    n = 512  # key + vector + entry overhead
    for r in results:
        segments = getattr(r, "segments", None)
        if segments is not None:  # QueryBitmap
            n += 128 + sum(
                int(getattr(seg, "nbytes", 64)) + 96 for seg in segments.values()
            )
        elif isinstance(r, list):  # TopN pairs (excluded today, sized anyway)
            n += 64 + 96 * len(r)
        else:  # counts / bools
            n += 48
    return n


class _Pending:
    """A cacheable miss in flight: key + pre-execution validity tokens.
    Returned by :meth:`QueryCache.lookup`, consumed by :meth:`commit`."""

    __slots__ = ("key", "index", "frames", "vec0", "t0")

    def __init__(self, key, index, frames, vec0, t0):
        self.key = key
        self.index = index
        self.frames = frames
        self.vec0 = vec0
        self.t0 = t0


class _Entry:
    __slots__ = ("index", "frames", "vec", "results", "nbytes", "tenant")

    def __init__(self, index, frames, vec, results, nbytes, tenant=None):
        self.index = index
        self.frames = frames
        self.vec = vec
        self.results = results
        self.nbytes = nbytes
        # Billing owner under multi-tenancy (index→tenant map), None
        # when tenancy is off.
        self.tenant = tenant


@lockcheck.guarded_class
class QueryCache:
    """The byte-accounted, generation-validated query result LRU.

    Thread-safe.  Counters (``hits / misses / bypasses / ineligible /
    evictions / stores`` and the ``bytes`` gauge) are exposed both as
    attributes (tests, bench) and through the optional stats client
    (``qcache.hit`` etc. at /debug/vars).  ``bypasses`` counts ONLY
    client-requested skips (X-Pilosa-No-Cache) so the A/B hit-rate
    denominator stays clean; writes, unparseable queries, and
    cluster-scope requests count as ``ineligible``.
    """

    # Lockset race detector declarations: the store/canon LRUs and the
    # byte/hit accounting all move under ``_mu`` — the request path is
    # every HTTP handler thread at once, and a lost `bytes -=` is a
    # permanently wrong eviction budget.
    _guarded_by_ = {
        "_store": "qcache._mu",
        "_canon": "qcache._mu",
        "bytes": "qcache._mu",
        "tenant_bytes": "qcache._mu",
        "hits": "qcache._mu",
        "misses": "qcache._mu",
        "bypasses": "qcache._mu",
        "ineligible": "qcache._mu",
        "evictions": "qcache._mu",
        "stores": "qcache._mu",
    }

    def __init__(
        self,
        max_bytes: int = DEFAULT_MAX_BYTES,
        min_cost_ms: float = DEFAULT_MIN_COST_MS,
        stats=None,
        clock=time.perf_counter,
        tenancy=None,
    ):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.max_bytes = int(max_bytes)
        self.min_cost_ms = float(min_cost_ms)
        # Adaptive admission floor (planner.AdaptiveBudgets): when the
        # server wires one, commit() derives the floor from the measured
        # cost distribution instead of the static min_cost_ms (which
        # stays the anchor the adaptive value is clamped around).  The
        # lockstep service NEVER sets this — its floor is forced to 0
        # for determinism and must not regrow from rank-local wall time.
        self.budgets = None
        self.stats = stats if stats is not None else NOP_STATS
        # TenancyState: per-tenant byte quotas ([tenancy] qcache-share).
        # Entries bill to the index's tenant; over-quota tenants reclaim
        # from THEMSELVES first, so one tenant's store flood can never
        # flush another tenant's working set.  None = no quotas.
        self.tenancy = tenancy
        self._clock = clock
        self._mu = lockcheck.named_lock("qcache._mu")
        self._store: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # Raw request string -> (fingerprint, frames) for eligible
        # queries, or None for ineligible/unparseable ones; bounded LRU
        # so adversarial unique queries can't grow it without limit.
        self._canon: "OrderedDict[str, Optional[tuple]]" = OrderedDict()
        self._canon_max = 512
        self.bytes = 0
        # tenant -> resident bytes (entries removed at zero).
        self.tenant_bytes: dict = {}
        self.hits = 0
        self.misses = 0
        self.bypasses = 0
        self.ineligible = 0
        self.evictions = 0
        self.stores = 0

    # -- fingerprinting ---------------------------------------------------

    # Distinguishes "never memoized" from the memoized-None of an
    # ineligible query on the lock-free probe below.
    _CANON_MISS = object()

    def _canonical(self, query_str: str, span=None) -> Optional[tuple]:
        """(fingerprint, frames) for an eligible query string, None for
        write-bearing / non-cacheable / unparseable ones.  Memoized: the
        steady-state repeated request pays one dict lookup, not a parse
        + render.

        The hit probe is LOCK-FREE: memo values are immutable once
        stored (a tuple or None), so a concurrent insert/evict at worst
        misses and re-parses.  The trade is that a lock-free hit skips
        the LRU recency touch — a hot entry churned out by a flood of
        unique queries just re-parses and re-inserts itself.  All
        mutation stays under ``_mu`` (the lockset detector's contract
        for ``_canon``).

        ``span``: a traced request's ``qcache.lookup`` span; a memo miss
        parses under a ``parse`` child of it.
        """
        val = self._canon.get(query_str, self._CANON_MISS)
        if val is not self._CANON_MISS:
            return val
        info = None
        if len(query_str) <= _FINGERPRINT_MAX_LEN:
            from pilosa_tpu_torch import pql

            psp = span.child("parse") if span is not None else None
            try:
                q = pql.parse_cached(query_str, psp)
            # analysis-ok: exception-hygiene: fingerprint probe; the normal execution path raises the real parse error
            except Exception:  # noqa: BLE001 — normal path raises the real error
                q = None
            if psp is not None:
                psp.finish()
            if (
                q is not None
                and q.calls
                and all(c.name in CACHEABLE_CALLS for c in q.calls)
            ):
                info = (str(q), referenced_frames(q))
        with self._mu:
            self._canon[query_str] = info
            self._canon.move_to_end(query_str)
            while len(self._canon) > self._canon_max:
                self._canon.popitem(last=False)
        return info

    # -- the request path -------------------------------------------------

    def note_bypass(self) -> None:
        """A request that DECLINED the cache (X-Pilosa-No-Cache) —
        distinct from ineligible traffic so the A/B hit-rate denominator
        (hits / (hits + misses + bypasses)) measures only requests the
        cache could have served."""
        with self._mu:
            self.bypasses += 1
        self.stats.count("qcache.bypass")

    def note_ineligible(self) -> None:
        """A request the cache can never serve: a write-bearing or
        unparseable tree, or a cluster coordinator-scope request whose
        validity the local generation vector cannot cover."""
        with self._mu:
            self.ineligible += 1
        self.stats.count("qcache.ineligible")

    def lookup(self, holder, index: str, query_str: str, slices_key, remote: bool = False,
               span=None):
        """One request's cache probe.

        Returns ``(results, pending)``: a valid entry yields
        ``(list-copy of results, None)``; a cacheable miss yields
        ``(None, _Pending)`` for :meth:`commit` after execution; an
        ineligible request yields ``(None, None)`` and counts as
        ineligible (never a bypass — those are client-requested only).
        ``remote`` is part of the key: a remote-serving execution covers
        local slices only, never a coordinator's global answer (remote
        reads always carry explicit slices today — this keys the
        invariant rather than assuming it).  ``span``: a traced
        request's ``qcache.lookup`` span (see :meth:`_canonical`).
        """
        info = self._canonical(query_str, span)
        if info is None:
            self.note_ineligible()
            return None, None
        fp, frames = info
        key = (index, fp, slices_key, remote)
        # Lock-free probe: entries are immutable (_Entry is never
        # mutated after store) and the generation-vector re-check below
        # IS the validity gate, so reading a just-evicted or torn-LRU
        # view costs at most a spurious miss.  Store/evict (and the hit
        # accounting) stay under ``_mu``.
        entry = self._store.get(key)
        vec = generation_vector(holder, index, frames)
        if entry is not None:
            if vec is not None and vec == entry.vec:
                with self._mu:
                    if key in self._store:
                        self._store.move_to_end(key)
                    self.hits += 1
                self.stats.count("qcache.hit")
                return list(entry.results), None
            # Stale: a generation moved (or the schema did) — drop it
            # now rather than waiting for LRU churn.
            self._pop(key)
        with self._mu:
            self.misses += 1
        self.stats.count("qcache.miss")
        if vec is None:
            return None, None  # index missing: the execution will raise
        return None, _Pending(key, index, frames, vec, self._clock())

    def commit(self, holder, pending: _Pending, results) -> bool:
        """Admit one executed miss.  Declines when the measured cost is
        under ``min_cost_ms`` (not worth the bookkeeping) or a write
        landed mid-execution (the vector moved — storing would stamp
        pre-write results with post-write tokens).  Returns True when
        the entry was stored."""
        cost_ms = (self._clock() - pending.t0) * 1e3
        floor = (
            self.budgets.qcache_min_cost_ms()
            if self.budgets is not None
            else self.min_cost_ms
        )
        if cost_ms < floor:
            return False
        vec1 = generation_vector(holder, pending.index, pending.frames)
        if vec1 is None or vec1 != pending.vec0:
            return False
        nbytes = result_nbytes(results)
        if nbytes > self.max_bytes:
            return False
        tenant = (
            self.tenancy.tenant_of_index(pending.index)
            if self.tenancy is not None
            else None
        )
        entry = _Entry(
            pending.index, pending.frames, pending.vec0, list(results), nbytes,
            tenant=tenant,
        )
        with self._mu:
            old = self._store.pop(pending.key, None)
            if old is not None:
                self.bytes -= old.nbytes
                self._tenant_debit(old)
            self._store[pending.key] = entry
            self.bytes += nbytes
            if tenant is not None:
                self.tenant_bytes[tenant] = (
                    self.tenant_bytes.get(tenant, 0) + nbytes
                )
            self.stores += 1
            # Per-tenant quota: the committing tenant reclaims from its
            # OWN LRU entries first when it runs past its share, before
            # the global loop can touch anyone else's working set.
            if tenant is not None:
                quota = self.tenancy.qcache_quota(tenant, self.max_bytes)
                while quota > 0 and self.tenant_bytes.get(tenant, 0) > quota:
                    if not self._evict_tenant_locked(tenant):
                        break
            while self.bytes > self.max_bytes and self._store:
                # Under the global budget too, over-quota tenants pay
                # before anyone under quota loses an entry.
                if self.tenancy is not None and self._evict_over_quota_locked():
                    continue
                _, ev = self._store.popitem(last=False)
                self.bytes -= ev.nbytes
                self._tenant_debit(ev)
                self.evictions += 1
                self.stats.count("qcache.evict")
        self.stats.count("qcache.store")
        self.stats.gauge("qcache.bytes", self.bytes)
        return True

    def _tenant_debit(self, entry) -> None:
        """Return one removed entry's bytes to its tenant (``_mu``
        held by every caller)."""
        t = entry.tenant
        if t is None:
            return
        n = self.tenant_bytes.get(t, 0) - entry.nbytes  # analysis-ok: check-then-act: _mu held by every caller (commit/invalidate eviction paths); the _locked helper convention
        if n <= 0:
            self.tenant_bytes.pop(t, None)
        else:
            self.tenant_bytes[t] = n

    def _evict_tenant_locked(self, tenant) -> bool:
        """Evict ``tenant``'s least-recently-used entry (``_mu`` held).
        False when the tenant holds none."""
        for k, e in self._store.items():
            if e.tenant == tenant:
                self._store.pop(k)
                self.bytes -= e.nbytes  # analysis-ok: check-then-act: _mu held by every caller; the _locked helper convention
                self._tenant_debit(e)
                self.evictions += 1  # analysis-ok: check-then-act: _mu held by every caller; the _locked helper convention
                self.stats.count("qcache.evict")
                self.stats.count(f"tenancy.qcache_evict.{tenant}")
                return True
        return False

    def _evict_over_quota_locked(self) -> bool:
        """Evict the LRU entry of any tenant currently over its quota
        (``_mu`` held).  False when nobody is over."""
        for k, e in self._store.items():
            t = e.tenant
            if t is None:
                continue
            quota = self.tenancy.qcache_quota(t, self.max_bytes)
            if quota > 0 and self.tenant_bytes.get(t, 0) > quota:
                self._store.pop(k)
                self.bytes -= e.nbytes  # analysis-ok: check-then-act: _mu held by every caller; the _locked helper convention
                self._tenant_debit(e)
                self.evictions += 1  # analysis-ok: check-then-act: _mu held by every caller; the _locked helper convention
                self.stats.count("qcache.evict")
                self.stats.count(f"tenancy.qcache_evict.{t}")
                return True
        return False

    def tenant_bytes_snapshot(self) -> dict:
        """Per-tenant resident bytes (/debug/tenants)."""
        with self._mu:
            return dict(self.tenant_bytes)

    # -- invalidation hooks ------------------------------------------------

    def _pop(self, key) -> None:
        with self._mu:
            entry = self._store.pop(key, None)
            if entry is not None:
                self.bytes -= entry.nbytes
                self._tenant_debit(entry)
        self.stats.gauge("qcache.bytes", self.bytes)

    def purge_frame(self, index: str, frame: str) -> int:
        """Drop every entry that touches one (index, frame) — wired to
        frame deletion so a recreated namesake can never serve (or pin
        the memory of) the old frame's results.  Returns the count."""
        with self._mu:
            victims = [
                k
                for k, e in self._store.items()
                if e.index == index and frame in e.frames
            ]
            for k in victims:
                e = self._store.pop(k)
                self.bytes -= e.nbytes
                self._tenant_debit(e)
        if victims:
            self.stats.gauge("qcache.bytes", self.bytes)
        return len(victims)

    def purge_index(self, index: str) -> int:
        """Index-deletion analog of :meth:`purge_frame` (every frame)."""
        with self._mu:
            victims = [k for k, e in self._store.items() if e.index == index]
            for k in victims:
                e = self._store.pop(k)
                self.bytes -= e.nbytes
                self._tenant_debit(e)
        if victims:
            self.stats.gauge("qcache.bytes", self.bytes)
        return len(victims)

    def clear(self) -> None:
        with self._mu:
            self._store.clear()
            self.bytes = 0
            self.tenant_bytes.clear()
        self.stats.gauge("qcache.bytes", 0)

    def __len__(self) -> int:
        return len(self._store)


def from_env(min_cost_ms: Optional[float] = None, stats=None) -> Optional[QueryCache]:
    """Build a cache from ``PILOSA_TPU_QCACHE_*`` env, or None when not
    enabled — the default for directly-constructed executors, so
    embedders/tests/benches opt in explicitly (the server and CLI wire
    the ``[qcache]`` config instead).  ``min_cost_ms`` overrides the env
    (the lockstep service forces 0: wall-clock admission is rank-local,
    and a replicated decision needs a replicated input)."""
    import os

    if os.environ.get("PILOSA_TPU_QCACHE", "").lower() not in ("1", "true", "yes"):  # analysis-ok: env-knob-outside-config: from_env is the documented opt-in for direct embedders; the server wires [qcache] config
        return None
    max_bytes = int(os.environ.get("PILOSA_TPU_QCACHE_MAX_BYTES", str(DEFAULT_MAX_BYTES)))  # analysis-ok: env-knob-outside-config: from_env is the documented opt-in for direct embedders; the server wires [qcache] config
    if min_cost_ms is None:
        min_cost_ms = float(
            os.environ.get("PILOSA_TPU_QCACHE_MIN_COST_MS", str(DEFAULT_MIN_COST_MS))  # analysis-ok: env-knob-outside-config: from_env is the documented opt-in for direct embedders; the server wires [qcache] config
        )
    return QueryCache(max_bytes=max_bytes, min_cost_ms=min_cost_ms, stats=stats)
