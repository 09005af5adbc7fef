"""Per-fingerprint cost ledger + device-dispatch cost attribution.

No reference analog — the reference's observability stops at aggregate
expvar counters.  This module is the feedback substrate ROADMAP item 4's
trace-driven adaptive planner consumes: per-(index, frame, query
fingerprint, strategy lane) observed costs and fetch bandwidth, in one
queryable place (``/debug/costs``).

Two halves:

- :class:`DispatchMeter` — cost attribution at the engine dispatch
  seams (gram / gather / stream / native lanes).  Each metered dispatch
  emits a tagged histogram (``engine.dispatch_ms.<lane>``) and a
  transfer-byte counter (``engine.dispatch_bytes.<lane>``, read as a
  delta of the engine's host->device upload ledger plus explicitly
  reported operand bytes).  The histogram times the HOST's time in the
  metered block, not the device: CUDA launches return before the kernel
  runs.  When the request is traced the dispatch is also a ``device``
  child span tagged with the lane and bytes, and each kernel launched
  inside it is timed on the device between two CUDA events recorded at
  its launch (``ops.kernels._launch``); their sum, read once the
  caller's fetch has synchronised, is the span's ``device_ms`` tag.  A
  dispatch that launches no kernel (a Gram lookup, a native lane) has
  no such tag.  That tag is the device time; the span's ``ms`` stays
  host time.  The disabled path
  (``meter is None`` at every call site) adds one branch per site, the
  same contract as tracing.
- :class:`CostLedger` — a bounded LRU ring keyed by (index, frame,
  fingerprint, lane) folding finished traces into EWMA cost/bandwidth
  estimates.  The tracer calls :meth:`CostLedger.fold` from
  ``finish_request`` for every recorded trace (sampled or slow), so the
  ledger rides the existing trace stream: no new per-request work on
  the unsampled fast path.  Its device time is each ``device`` span's
  ``device_ms`` tag, or the span's host ``ms`` where it has none.

Enable/disable: the server and lockstep front end construct the meter
and ledger unless ``PILOSA_TPU_COSTS`` is falsy ("0"/"false"/"no"); the
bench overhead gate (bench.py costs_overhead_check) asserts the enabled
path costs <= 5% vs disabled, like the trace sample-rate bound.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Optional

from pilosa_tpu_torch.analysis import lockcheck

# Ledger capacity default: one entry per distinct (index, frame,
# fingerprint, lane); dashboards repeat a small set of shapes, so a few
# hundred entries cover steady state.
DEFAULT_CAP = 512
# EWMA smoothing: ~the last ~8 observations dominate.
DEFAULT_ALPHA = 0.25


def enabled_from_env() -> bool:
    import os

    return os.environ.get("PILOSA_TPU_COSTS", "").lower() not in ("0", "false", "no")


class _Measure:
    """One metered dispatch (context manager): wall time from enter to
    exit, transfer bytes = the engine upload-ledger delta plus anything
    the caller adds explicitly via :meth:`add_bytes`.  Under a traced
    span, the kernels launched inside the block are timed on the device
    (``ops.kernels.TIMED``) and their sum is the ``device`` span's
    ``device_ms`` where they have run by the exit: a caller that fetches
    the result inside the block has synchronised, so reading them adds
    no synchronisation, and one that does not leaves the tag out."""

    __slots__ = ("meter", "lane", "span", "t0", "extra_bytes", "up0", "dev_span",
                 "events", "outer")

    def __init__(self, meter: "DispatchMeter", lane: str, span):
        self.meter = meter
        self.lane = lane
        self.span = span
        self.extra_bytes = 0
        self.dev_span = None
        self.events = None

    def add_bytes(self, n: int) -> None:
        # analysis-ok: check-then-act: _Measure is a per-request stack object; it never crosses threads
        self.extra_bytes += int(n)

    def __enter__(self) -> "_Measure":
        if self.span is not None:
            from pilosa_tpu_torch.ops.kernels import TIMED

            self.dev_span = self.span.child("device")
            self.dev_span.tags["lane"] = self.lane
            self.outer = getattr(TIMED, "events", None)
            TIMED.events = self.events = []
        self.up0 = getattr(self.meter.engine, "stat_upload_bytes", 0)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt_ms = (time.perf_counter() - self.t0) * 1e3
        moved = (
            getattr(self.meter.engine, "stat_upload_bytes", 0) - self.up0
        ) + self.extra_bytes
        self.meter._record(self.lane, dt_ms, moved, self.dev_span)
        if self.events is not None:
            from pilosa_tpu_torch.ops.kernels import TIMED

            TIMED.events = self.outer
            if self.events and all(ev1.query() for _, ev1 in self.events):
                self.dev_span.tags["device_ms"] = round(
                    sum(ev0.elapsed_time(ev1) for ev0, ev1 in self.events), 3
                )
        return False


class DispatchMeter:
    """Per-dispatch device cost attribution (see module docstring).

    Thread-safe by construction: stats clients lock internally, span
    child creation is append-only under the GIL, and the engine upload
    ledger is a plain int read twice — a concurrent uploader can skew
    one dispatch's byte delta, which is acceptable for attribution."""

    __slots__ = ("stats", "engine")

    def __init__(self, stats=None, engine=None):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.stats = stats if stats is not None else NOP_STATS
        self.engine = engine

    def measure(self, lane: str, span=None) -> _Measure:
        return _Measure(self, lane, span)

    def _record(self, lane: str, dt_ms: float, moved: int, dev_span) -> None:
        self.stats.histogram(f"engine.dispatch_ms.{lane}", dt_ms)
        if moved > 0:
            self.stats.count(f"engine.dispatch_bytes.{lane}", int(moved))
        if dev_span is not None:
            dev_span.finish()
            if moved > 0:
                dev_span.tags["bytes"] = int(moved)

    def resident(self, hbm_bytes: int) -> None:
        """Gauge the engine's HBM-resident working set (the executor
        reports its matrix/serve-state cache totals after mutations)."""
        self.stats.gauge("engine.hbm_bytes", int(hbm_bytes))


@lockcheck.guarded_class
class CostLedger:
    """Bounded LRU of EWMA cost/bandwidth estimates keyed by
    (tenant, index, frame, fingerprint, lane) — the /debug/costs
    payload and the per-tenant ledger rows /debug/tenants bills from.

    The tenant dimension is real (not ``tenant or index`` conflated):
    two tenants sharing one index keep separate estimates.  Readers
    that don't know the tenant (the planner's peeks) resolve through a
    secondary (index, frame, fp, lane) -> full-key map that tracks the
    most recently observed tenant for each 4-tuple."""

    _guarded_by_ = {"_entries": "costs._mu", "_by4": "costs._mu"}

    def __init__(self, cap: int = DEFAULT_CAP, alpha: float = DEFAULT_ALPHA,
                 stats=None):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.cap = max(1, int(cap))
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self.stats = stats if stats is not None else NOP_STATS
        self._mu = lockcheck.named_lock("costs._mu")
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        # (index, frame, fp, lane) -> full 5-tuple key, MRU tenant wins.
        self._by4: dict[tuple, tuple] = {}

    def observe(
        self,
        *,
        tenant: str = "",
        index: str = "",
        frame: str = "",
        fp: str = "",
        lane: str = "",
        ms: float,
        bytes_moved: int = 0,
        device_ms: float = 0.0,
        wall_ts: Optional[float] = None,
    ) -> None:
        """Fold one observation into the (tenant, index, frame, fp,
        lane) entry.  Bandwidth (MB/s) only updates when the observation
        actually moved bytes, so transfer-free warm hits don't decay
        it."""
        key = (tenant, index, frame, fp, lane)
        # analysis-ok: lockstep-determinism: display-only last_ts metadata; lockstep folds happen on rank 0 alone (workers carry no planner) and never feed a wire decision
        ts = wall_ts if wall_ts is not None else time.time()
        a = self.alpha
        with self._mu:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = {
                    "n": 0,
                    "ewma_ms": float(ms),
                    "ewma_device_ms": float(device_ms),
                    "ewma_mbps": 0.0,
                    "last_ms": 0.0,
                    "last_ts": 0.0,
                }
                while len(self._entries) > self.cap:
                    old_key, _ = self._entries.popitem(last=False)
                    if self._by4.get(old_key[1:]) == old_key:
                        del self._by4[old_key[1:]]
                    self.stats.count("costs.evict")
            e["n"] += 1
            e["ewma_ms"] += a * (float(ms) - e["ewma_ms"])
            if device_ms > 0:
                e["ewma_device_ms"] += a * (float(device_ms) - e["ewma_device_ms"])
            if bytes_moved > 0 and ms > 0:
                mbps = bytes_moved / (ms / 1e3) / 1e6
                if e["ewma_mbps"] == 0.0:
                    e["ewma_mbps"] = mbps
                else:
                    e["ewma_mbps"] += a * (mbps - e["ewma_mbps"])
            e["last_ms"] = round(float(ms), 3)
            e["last_ts"] = round(ts, 3)
            self._entries.move_to_end(key)
            self._by4[key[1:]] = key
            n_entries = len(self._entries)
        self.stats.count("costs.fold")
        self.stats.gauge("costs.entries", n_entries)

    def fold(self, trace, dt_ms: float, body: bytes = b"") -> None:
        """Fold one finished trace (trace.Trace) into the ledger: the
        root's lane/tenant/frame tags key the entry; ``device`` child
        spans (the dispatch meter's) contribute device time (their
        ``device_ms`` tag, else their host ``ms``) and bytes.  Called by
        Tracer.finish_request for every recorded trace."""
        from pilosa_tpu_torch.trace import fingerprint

        root = trace.root
        tags = root.tags
        tenant = str(tags.get("tenant") or "")
        # Embedders that only tagged "tenant" (the pre-tenancy handler
        # wrote the index name there) keep their index keying.
        index = str(tags.get("index") or "") or tenant
        lane = str(tags.get("lane") or "general")
        frame = str(tags.get("frame") or "")
        fp = fingerprint(body)["fp"] if body else ""
        device_ms = 0.0
        bytes_moved = 0
        stack = [root]
        while stack:
            sp = stack.pop()
            children = (
                sp.get("children", []) if isinstance(sp, dict) else sp.children
            )
            for c in children:
                if isinstance(c, dict):
                    name, ms, ctags = c.get("name"), c.get("ms"), c.get("tags", {})
                else:
                    name, ms, ctags = c.name, c.ms, c.tags
                if name == "device":
                    device_ms += float(ctags.get("device_ms", ms) or 0.0)
                    bytes_moved += int(ctags.get("bytes") or 0)
                else:
                    stack.append(c)
        self.observe(
            tenant=tenant,
            index=index,
            frame=frame,
            fp=fp,
            lane=lane,
            ms=dt_ms,
            bytes_moved=bytes_moved,
            device_ms=device_ms,
            wall_ts=trace.wall_ts,
        )

    def peek(
        self, *, tenant: Optional[str] = None, index: str = "",
        frame: str = "", fp: str = "", lane: str = ""
    ) -> Optional[dict]:
        """One entry's current estimates (a copy), or None.  Pure read:
        the LRU order is NOT bumped — the planner consults on every
        request and must not pin its own keys hot.  ``tenant=None``
        (the planner's tenant-agnostic peeks) resolves through the
        MRU-tenant map for the 4-tuple."""
        with self._mu:
            if tenant is not None:
                e = self._entries.get((tenant, index, frame, fp, lane))
            else:
                full = self._by4.get((index, frame, fp, lane))
                e = self._entries.get(full) if full is not None else None
            return dict(e) if e is not None else None

    def entries(self, lane: Optional[str] = None) -> list[dict]:
        """Entry copies (optionally one lane's), unsorted and unrounded
        — the adaptive-budget derivations read these."""
        with self._mu:
            return [
                {"tenant": k[0], "index": k[1], "frame": k[2], "fp": k[3],
                 "lane": k[4], **v}
                for k, v in self._entries.items()
                if lane is None or k[4] == lane
            ]

    def by_tenant(self) -> dict:
        """Per-tenant ledger aggregates for /debug/tenants: entry count
        and total observed cost (n * ewma_ms, the billing proxy).
        Entries folded before the tenant dimension existed bill to
        their index (the pre-tenancy attribution)."""
        with self._mu:
            out: dict = {}
            for k, e in self._entries.items():
                t = k[0] or k[1] or ""
                row = out.setdefault(t, {"entries": 0, "cost_ms": 0.0})
                row["entries"] += 1
                row["cost_ms"] += e["n"] * e["ewma_ms"]
        for row in out.values():
            row["cost_ms"] = round(row["cost_ms"], 3)
        return out

    def state(self) -> dict:
        """Full restorable state (entries in LRU order).  With
        :meth:`restore` this makes the EWMA fold deterministic across a
        snapshot/restore cycle: folding the same observations into a
        restored ledger yields bit-identical estimates."""
        with self._mu:
            return {
                "cap": self.cap,
                "alpha": self.alpha,
                "entries": [[list(k), dict(v)] for k, v in self._entries.items()],
            }

    def restore(self, st: dict) -> None:
        self.cap = max(1, int(st.get("cap", self.cap)))
        self.alpha = min(1.0, max(0.01, float(st.get("alpha", self.alpha))))
        with self._mu:
            self._entries.clear()
            self._by4.clear()
            for k, v in st.get("entries", []):
                key = tuple(k)
                if len(key) == 4:
                    # Pre-tenancy snapshot: pad with an empty tenant.
                    key = ("",) + key
                self._entries[key] = dict(v)
                self._by4[key[1:]] = key

    def snapshot(self, limit: int = 0) -> dict:
        """The /debug/costs payload: entries sorted by EWMA cost
        descending (the planner's priority order)."""
        with self._mu:
            items = [
                {"tenant": k[0], "index": k[1], "frame": k[2], "fp": k[3],
                 "lane": k[4], **v}
                for k, v in self._entries.items()
            ]
        items.sort(key=lambda e: -e["ewma_ms"])
        if limit > 0:
            items = items[:limit]
        for e in items:
            e["ewma_ms"] = round(e["ewma_ms"], 3)
            e["ewma_device_ms"] = round(e["ewma_device_ms"], 3)
            e["ewma_mbps"] = round(e["ewma_mbps"], 3)
        return {"cap": self.cap, "alpha": self.alpha, "entries": items}

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)
