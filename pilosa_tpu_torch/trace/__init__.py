"""Request-scoped distributed tracing: spans, sampling, slow-query log.

No reference analog — the reference's observability stops at aggregate
expvar counters.  The stack already has counters/histograms (stats.py),
profiles (pprof.py), QoS shed/latency metrics, and qcache hit/miss
telemetry, but none of them can answer "where did THIS request's 72 ms
go?" across parse -> admission -> cache -> slice fan-out -> remote hop
-> device dispatch.  Per-op cost varies wildly with container density
and strategy lane (the same PQL shape can hit the Gram lane, the fused
gather kernels, or the Python general lane), so aggregate histograms
cannot localize a regression; this subsystem attributes time to stages
per request.

Design:

- **Span** — one timed stage: name, start offset, duration, a small tag
  dict (strategy lane, slice counts, cache outcome), children.  Spans
  form a tree rooted at the serving door (HTTP handler or the lockstep
  front end).  Child creation is append-only and thread-safe under the
  GIL, so fan-out worker threads attach their spans concurrently.
- **Head sampling** — the sample decision is made ONCE at the door
  (``Tracer.begin``): an inbound ``X-Pilosa-Trace`` header forces the
  trace (the client override and the cross-node hop), otherwise a coin
  flip against ``[trace] sample-rate`` decides.  An unsampled request
  builds NO span objects — every instrumentation site downstream guards
  on ``span is None``, so the off path is a single branch per site
  (the qcache bench asserts sample-rate 0.01 costs <= 5% vs disabled).
- **Slow-query bypass** — requests whose total duration exceeds
  ``[trace] slow-ms`` are recorded in the ring even when the sampler
  said no (a synthesized root-only trace carries the total + the
  request fingerprint), and ADDITIONALLY emit one structured log line
  on the ``pilosa_tpu_torch.slowquery`` logger: query fingerprint, per-stage
  ms breakdown (when the trace was sampled — head sampling cannot
  retroactively reconstruct stages for unsampled requests), and the
  cache/QoS disposition tags.  Force-sample a repro
  (``X-Pilosa-Trace: 1``) to get the full breakdown for a known-slow
  query.
- **One clock** — a span starts at ``time.perf_counter_ns()``, the
  clock a device profiler's window markers can be tied to; a recorded
  trace's root carries that absolute ``t0_ns``, its children their
  ``start_ms`` and ``ms`` relative to the root.
- **Collector pauses** — while at least one traced request is open,
  one ``gc.callbacks`` hook charges every pause of Python's collector
  to the traced request open on the thread that paused: root tags
  ``gc_ms``, ``gc_n`` and ``gc_full`` (full collections), so the
  slow-query line says when the collector made a request slow.
- **Cross-node propagation** — a coordinator's remote hop sends its
  trace id in ``X-Pilosa-Trace``; the peer (forced by the header)
  traces its own execution and returns the serialized span tree in the
  ``X-Pilosa-Trace-Spans`` response header, which the client grafts
  under the coordinator's ``remote`` span — one trace shows both sides
  of the hop.  All offsets are relative to each span's own start, so
  no clock sync is assumed (the same rule as QoS deadline hops).
- **Lockstep determinism** — in the lockstep service the sampling
  decision is made once on rank 0 at ship time and rides the batch
  wire entry as a per-request ``trace`` flag; every rank reads the
  same flag (never its own RNG), so the decision is identical
  everywhere — the same determinism rule as expired-request drops and
  error isolation.  Only rank 0 records spans (ship/execute phases);
  tracing never changes execution, so workers only count the flags.

Finished traces land in a bounded in-memory ring served at
``/debug/traces`` (JSON, newest-first, ``?min-ms=`` filter).  Config:
``[trace] sample-rate / slow-ms / ring`` TOML, ``PILOSA_TPU_TRACE_*``
env, wired through Config into the server, lockstep CLI, and handler.

Counts: ``trace.sampled`` and ``trace.slow`` (the stats client) are the
tracer's only counters.
"""

from __future__ import annotations

import gc
import json
import logging
import random
import threading

from pilosa_tpu_torch.analysis import lockcheck
import time
import uuid
from collections import deque
from typing import Any, Optional

# Request header: "1"/"true" = client force-sample override; any other
# value is a propagated trace id from an upstream hop (which also
# forces sampling, so the coordinator's trace always gets its sub-spans).
TRACE_HEADER = "X-Pilosa-Trace"
# Response header: the serialized span tree of a force-traced request,
# grafted by the caller under its remote-hop span.
TRACE_SPANS_HEADER = "X-Pilosa-Trace-Spans"

# Serialized span payloads ride an HTTP header (stdlib servers cap a
# header line at 64 KiB); past this the wire form degrades to the root
# span only rather than breaking the response.
_SPANS_HEADER_MAX = 30000

DEFAULT_RING = 256

_slow_logger = logging.getLogger("pilosa_tpu_torch.slowquery")


class Span:
    """One timed stage of a request.  Finish is idempotent; an
    unfinished span serializes with its duration measured at
    serialization time (a crash/timeout mid-stage still shows where
    the time went)."""

    __slots__ = ("name", "trace_id", "t0_ns", "ms", "tags", "children")

    def __init__(self, name: str, trace_id: str = ""):
        self.name = name
        self.trace_id = trace_id
        self.t0_ns = time.perf_counter_ns()
        self.ms: Optional[float] = None
        self.tags: dict = {}
        self.children: list = []

    def child(self, name: str) -> "Span":
        sp = Span(name, self.trace_id)
        self.children.append(sp)  # list.append: atomic under the GIL
        return sp

    def finish(self) -> "Span":
        if self.ms is None:
            self.ms = (time.perf_counter_ns() - self.t0_ns) / 1e6
        return self

    def annotate(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def graft(self, payload) -> None:
        """Attach a peer's already-serialized span tree (the decoded
        X-Pilosa-Trace-Spans JSON) under this span.  Stored verbatim —
        remote offsets are relative to the REMOTE request's start, so
        no clock translation is needed or attempted."""
        if isinstance(payload, list):
            self.children.extend(p for p in payload if isinstance(p, dict))
        elif isinstance(payload, dict):
            self.children.append(payload)

    def to_json(self, base_ns: Optional[int] = None) -> dict:
        base = self.t0_ns if base_ns is None else base_ns
        ms = self.ms
        if ms is None:  # still running at serialization time
            ms = (time.perf_counter_ns() - self.t0_ns) / 1e6
        out = {
            "name": self.name,
            "start_ms": round((self.t0_ns - base) / 1e6, 3),
            "ms": round(ms, 3),
        }
        if self.tags:
            out["tags"] = dict(self.tags)
        if self.children:
            out["children"] = [
                c if isinstance(c, dict) else c.to_json(base)
                for c in list(self.children)
            ]
        return out

    def stage_breakdown(self) -> dict:
        """{child name: total ms} over direct children (duplicate names
        sum) — the slow-query log's per-stage view."""
        out: dict = {}
        for c in list(self.children):
            if isinstance(c, dict):
                name, ms = c.get("name", "?"), float(c.get("ms", 0.0))
            else:
                name = c.name
                ms = c.ms if c.ms is not None else 0.0
            out[name] = round(out.get(name, 0.0) + ms, 3)
        return out


class Trace:
    """One sampled request: the root span plus door metadata."""

    __slots__ = ("id", "root", "forced", "propagate", "wall_ts",
                 "gc_t0_ns", "gc_ns", "gc_n", "gc_full")

    def __init__(self, name: str, trace_id: str = "", forced: bool = False,
                 propagate: bool = False):
        self.id = trace_id or uuid.uuid4().hex[:16]
        self.root = Span(name, self.id)
        self.forced = forced
        # An inbound X-Pilosa-Trace header means the caller wants the
        # span tree back in the response header (a hop, or a client
        # that will read /debug/traces anyway — the extra header is
        # harmless there).
        self.propagate = propagate
        self.wall_ts = time.time()
        # Collector pauses on the request's thread (_CollectorPauses).
        self.gc_t0_ns = self.gc_ns = self.gc_n = self.gc_full = 0

    def to_json(self, slow_ms: float = 0.0) -> dict:
        root = self.root.to_json()
        root["t0_ns"] = self.root.t0_ns
        return {
            "id": self.id,
            "name": self.root.name,
            "ts": round(self.wall_ts, 3),
            "ms": root["ms"],
            "forced": self.forced,
            "slow": bool(slow_ms > 0 and root["ms"] >= slow_ms),
            "spans": root,
        }


@lockcheck.guarded_class
class _CollectorPauses:
    """Python's collector pauses, charged to the traced request open on
    the thread that paused.  One ``gc.callbacks`` hook is installed while
    at least one traced request is open, and removed when the last one
    closes, so an untraced process pays nothing."""

    _guarded_by_ = {"_open": "trace._gc_mu"}

    def __init__(self):
        self._mu = lockcheck.named_lock("trace._gc_mu")
        self._open: dict = {}  # thread ident -> its open Trace
        self._hook = self._pause

    def open(self, trace: Trace) -> None:
        with self._mu:
            if not self._open:
                gc.callbacks.append(self._hook)
            self._open[threading.get_ident()] = trace

    def close(self, trace: Trace) -> None:
        tid = threading.get_ident()
        with self._mu:
            if self._open.get(tid) is not trace:
                return
            del self._open[tid]
            if not self._open:
                gc.callbacks.remove(self._hook)

    def _pause(self, phase: str, info: dict) -> None:
        # Lock-free: a collection can start on a thread that holds _mu.
        trace = self._open.get(threading.get_ident())
        if trace is None:
            return
        if phase == "start":
            trace.gc_t0_ns = time.perf_counter_ns()
        elif trace.gc_t0_ns:
            trace.gc_ns += time.perf_counter_ns() - trace.gc_t0_ns
            trace.gc_t0_ns = 0
            trace.gc_n += 1
            trace.gc_full += info.get("generation") == 2


_PAUSES = _CollectorPauses()


def fingerprint(body: bytes, max_snippet: int = 120) -> dict:
    """Stable identity for a (possibly huge) query body: short hash +
    readable snippet.  Used by the slow-query log so dashboards can
    group recurring slow shapes without storing whole requests."""
    import hashlib

    if not body:
        return {"fp": "", "snippet": ""}
    snippet = body[:max_snippet].decode("utf-8", errors="replace")
    return {
        "fp": hashlib.blake2b(body, digest_size=6).hexdigest(),
        "snippet": snippet,
    }


@lockcheck.guarded_class
class Tracer:
    """Sampling gate + bounded trace ring + slow-query log.

    Thread-safe.  Always constructible: with ``sample_rate=0`` and
    ``slow_ms=0`` only force-header requests trace (the production
    default — an operator can still ``X-Pilosa-Trace: 1`` a repro
    without a restart)."""

    _guarded_by_ = {"_ring": "trace._mu"}

    def __init__(
        self,
        sample_rate: float = 0.0,
        slow_ms: float = 0.0,
        ring: int = DEFAULT_RING,
        stats=None,
        rng: Optional[random.Random] = None,
        costs=None,
    ):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self.slow_ms = max(0.0, float(slow_ms))
        self.stats = stats if stats is not None else NOP_STATS
        # Per-fingerprint cost ledger (costs.CostLedger): every recorded
        # trace folds into EWMA cost/bandwidth estimates keyed by
        # (index, frame, fingerprint, lane).  None = ledger disabled.
        self.costs = costs
        self._rng = rng if rng is not None else random.Random()
        self._mu = lockcheck.named_lock("trace._mu")
        self._ring: "deque[dict]" = deque(maxlen=max(1, int(ring)))

    # -- the door ---------------------------------------------------------

    def decide(self, force: bool = False) -> bool:
        """The head-sampling coin flip (exposed separately for the
        lockstep service, which decides once on rank 0 at ship time)."""
        if force:
            return True
        return self.sample_rate > 0.0 and self._rng.random() < self.sample_rate

    def begin(self, headers=None, name: str = "request") -> Optional[Trace]:
        """The per-request entry: an inbound ``X-Pilosa-Trace`` header
        forces the trace (and carries the upstream trace id unless it is
        a bare "1"-style override); otherwise the sampler decides.
        Returns None for the (common) unsampled request — callers pass
        ``trace.root`` downstream only when a trace exists, so every
        downstream site stays a single ``span is None`` branch."""
        raw = (headers or {}).get(_TRACE_HEADER_L)
        if raw is None:
            if not (self.sample_rate > 0.0 and self._rng.random() < self.sample_rate):
                return None
            trace = Trace(name)
        else:
            tid = "" if raw.strip().lower() in ("1", "true", "yes") else raw.strip()
            trace = Trace(name, trace_id=tid, forced=True, propagate=True)
        _PAUSES.open(trace)
        self.stats.count("trace.sampled")
        return trace

    def release(self, trace: Optional[Trace]) -> None:
        """Stop charging collector pauses to ``trace`` (a no-op once
        done).  ``finish_request`` does it; a door does it in a
        ``finally`` too, so a request that raises before
        ``finish_request`` leaves no hook installed."""
        if trace is not None:
            _PAUSES.close(trace)

    # -- completion -------------------------------------------------------

    def finish_request(
        self,
        trace: Optional[Trace],
        *,
        name: str,
        dt_ms: float,
        body: bytes = b"",
        status: int = 0,
        tags: Optional[dict] = None,
    ) -> Optional[dict]:
        """Close out one request: record a sampled trace in the ring;
        detect slowness for EVERY request (sampled or not — the slow
        path bypasses sampling) and emit the slow-query log line; return
        extra response headers (the serialized span tree) when the
        caller asked for propagation.  The unsampled fast path is one
        comparison."""
        slow = self.slow_ms > 0.0 and dt_ms >= self.slow_ms
        if trace is None and not slow:
            return None
        if trace is None:
            # Unsampled but slow: synthesize a root-only trace so the
            # ring and the log still carry the event (head sampling
            # cannot reconstruct stages after the fact).
            trace = Trace(name)
            trace.root.ms = dt_ms
            trace.root.tags["unsampled"] = True
        else:
            _PAUSES.close(trace)
        root = trace.root
        root.finish()
        if trace.gc_n:
            root.tags["gc_ms"] = round(trace.gc_ns / 1e6, 3)
            root.tags["gc_n"] = trace.gc_n
            root.tags["gc_full"] = trace.gc_full
        if status:
            root.tags["status"] = status
        if tags:
            root.tags.update(tags)
        entry = self.record(trace)
        if self.costs is not None:
            self.costs.fold(trace, dt_ms, body)
        if slow:
            self._log_slow(trace, dt_ms, body)
        if trace.propagate:
            # The ring entry's tree, serialized once; the root's clock
            # is this process's own, so it stays out of the hop.
            tree = {k: v for k, v in entry["spans"].items() if k != "t0_ns"}
            payload = json.dumps([tree], separators=(",", ":"))
            if len(payload) > _SPANS_HEADER_MAX:
                # Header-size degradation: keep the root timing, drop
                # the tree rather than breaking the HTTP response.
                tree.pop("children", None)
                tree["truncated"] = True
                payload = json.dumps([tree], separators=(",", ":"))
            return {TRACE_SPANS_HEADER: payload}
        return None

    def record(self, trace: Trace) -> dict:
        """Put ``trace`` in the ring; returns its ring entry."""
        entry = trace.to_json(self.slow_ms)
        with self._mu:
            self._ring.appendleft(entry)
        return entry

    def _log_slow(self, trace: Trace, dt_ms: float, body: bytes) -> None:
        self.stats.count("trace.slow")
        rec = {
            "trace_id": trace.id,
            "name": trace.root.name,
            "ms": round(dt_ms, 3),
            **fingerprint(body),
            "stages": trace.root.stage_breakdown(),
            # Cache/QoS disposition tags land on the root span
            # (qcache=hit/miss/bypass/ineligible, qos=shed/expired,
            # lane=...) — surfaced flat so the log line is greppable.
            "tags": {k: v for k, v in trace.root.tags.items()},
        }
        _slow_logger.warning("slow-query %s", json.dumps(rec, separators=(",", ":")))

    # -- /debug/traces ----------------------------------------------------

    def traces_json(self, min_ms: float = 0.0, limit: int = 64) -> list[dict]:
        """Newest-first finished traces, optionally filtered by total
        duration (the /debug/traces payload)."""
        with self._mu:
            snap = list(self._ring)
        if min_ms > 0:
            snap = [t for t in snap if t["ms"] >= min_ms]
        return snap[: max(0, int(limit))]

    def __len__(self) -> int:
        return len(self._ring)


_TRACE_HEADER_L = TRACE_HEADER.lower()


def from_config(cfg, stats=None, costs=None) -> Tracer:
    """Build the server's tracer from Config ([trace] TOML +
    PILOSA_TPU_TRACE_* env, resolved by Config itself).  Always returns
    a Tracer: with the all-zero defaults only force-header requests
    trace, which costs one header lookup per request."""
    return Tracer(
        sample_rate=getattr(cfg, "trace_sample_rate", 0.0),
        slow_ms=getattr(cfg, "trace_slow_ms", 0.0),
        ring=getattr(cfg, "trace_ring", DEFAULT_RING),
        stats=stats,
        costs=costs,
    )


def from_env(stats=None, costs=None) -> Optional[Tracer]:
    """Env-only construction for direct embedders (the lockstep service
    when no ctor args are given); None when tracing is fully off so the
    service skips even the per-request header lookup."""
    import os

    rate = float(os.environ.get("PILOSA_TPU_TRACE_SAMPLE_RATE", "0") or 0)  # analysis-ok: env-knob-outside-config: from_env is the documented opt-in for direct embedders; the server wires [trace] config
    slow = float(os.environ.get("PILOSA_TPU_TRACE_SLOW_MS", "0") or 0)  # analysis-ok: env-knob-outside-config: from_env is the documented opt-in for direct embedders; the server wires [trace] config
    ring = int(os.environ.get("PILOSA_TPU_TRACE_RING", str(DEFAULT_RING)))  # analysis-ok: env-knob-outside-config: from_env is the documented opt-in for direct embedders; the server wires [trace] config
    if rate <= 0 and slow <= 0:
        return None
    return Tracer(sample_rate=rate, slow_ms=slow, ring=ring, stats=stats,
                  costs=costs)
