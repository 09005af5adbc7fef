"""Stats clients: counters/gauges/histograms with tag support.

Reference analog: stats.go — the StatsClient interface
(Count/Gauge/Histogram/Set/Timing/WithTags, stats.go:33-54), the
expvar-backed client (stats.go:70-130), MultiStatsClient (stats.go:133-185)
and the datadog statsd sink (datadog/datadog.go).  Here the statsd sink
speaks the plain UDP statsd wire format (datadog-compatible with |#tags).
"""

from __future__ import annotations

import random
import socket
import threading

from pilosa_tpu_torch.analysis import lockcheck
from collections import defaultdict
from typing import Iterable

# Per-series sample cap for the expvar histogram/timing reservoirs: a
# long-lived server records totals/min/max exactly and keeps a uniform
# Algorithm-R sample of this size for the percentiles, instead of
# appending every observation forever.
RESERVOIR_CAP = 4096

# A write shard self-flushes into the base maps once it holds this many
# pending histogram/timing samples, bounding per-thread memory between
# snapshots.
SHARD_FLUSH_CAP = 512


@lockcheck.guarded_class
class _StatsShard:
    """One thread's private write buffer inside ExpvarStatsClient.

    Writers touch only their own shard under its (uncontended) shard
    lock; the base maps are only reached by a drain, which holds the
    client lock THEN the shard lock.  The drain moves-and-zeroes the
    shard state in one shard-lock hold, so a given delta is merged into
    the base maps exactly once — a shard self-flushing mid-snapshot
    serializes on the client lock and cannot be double-counted.
    """

    _guarded_by_ = {
        "counters": "stats._shard",
        "hist_meta": "stats._shard",
        "hist_pending": "stats._shard",
        "timing_meta": "stats._shard",
        "timing_pending": "stats._shard",
        "pending_n": "stats._shard",
    }

    __slots__ = (
        "lock", "counters", "hist_meta", "hist_pending",
        "timing_meta", "timing_pending", "pending_n",
    )

    def __init__(self):
        self.lock = lockcheck.named_lock("stats._shard")
        with self.lock:
            self.counters: dict[str, int] = {}
            # Exact per-series deltas since the last drain: [count, min,
            # max, sum] for histograms, [count, sum] for timings, plus
            # every pending sample (fed through the base reservoir at
            # drain so sampling odds match the serialized client).
            self.hist_meta: dict[str, list[float]] = {}
            self.hist_pending: dict[str, list[float]] = {}
            self.timing_meta: dict[str, list[float]] = {}
            self.timing_pending: dict[str, list[float]] = {}
            self.pending_n = 0


class NopStatsClient:
    def with_tags(self, *tags: str) -> "NopStatsClient":
        return self

    def count(self, name: str, value: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def histogram(self, name: str, value: float) -> None:
        pass

    def set(self, name: str, value: str) -> None:
        pass

    def timing(self, name: str, value: float) -> None:
        pass


# Shared null-object instance: data-model objects coerce stats=None to
# this so emission sites need no truthiness guards.
NOP_STATS = NopStatsClient()


class ExpvarStatsClient:
    """In-process stats exposed at /debug/vars (stats.go:70-130).

    Counter/histogram/timing writes land in per-thread shards
    (_StatsShard) so N serving threads don't serialize on one client
    lock; snapshot()/snapshot_typed() drain every shard under the
    client lock and render from the merged base maps in the same hold —
    one consistent snapshot, totals exactly equal to the serialized
    client's.  Gauges and sets are last-writer-wins and stay under the
    client lock (cross-shard write ordering would be meaningless).
    """

    def __init__(self, tags: tuple[str, ...] = ()):
        self._lock = lockcheck.named_lock("stats._lock")
        self._counters: dict[str, int] = defaultdict(int)
        self._gauges: dict[str, float] = {}
        self._sets: dict[str, str] = {}
        # Bounded reservoirs (RESERVOIR_CAP samples) + exact running
        # metadata per series: [count, min, max, sum] for histograms,
        # [count, sum] for timings.
        self._histograms: dict[str, list[float]] = defaultdict(list)
        self._hist_meta: dict[str, list[float]] = {}
        self._timings: dict[str, list[float]] = defaultdict(list)
        self._timing_meta: dict[str, list[float]] = {}
        self._rng = random.Random(0)
        self._tags = tags
        self._children: dict[tuple[str, ...], ExpvarStatsClient] = {}
        # Per-thread write shards; the registry list is guarded by
        # _lock, each shard's contents by its own lock.  Tagged children
        # share both (keys embed the tags before they reach a shard).
        self._shards: list[_StatsShard] = []
        self._shard_local = threading.local()

    def _key(self, name: str) -> str:
        return f"{name}[{','.join(self._tags)}]" if self._tags else name

    def with_tags(self, *tags: str) -> "ExpvarStatsClient":
        key = tuple(sorted(set(self._tags) | set(tags)))
        # Locked lookup-or-create: every handler thread reaches here
        # (tenant/class tags), and the unlocked get-then-store lost a
        # child — or tears _children outright without the GIL.
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = ExpvarStatsClient(tags=key)
                # share the top-level maps so /debug/vars sees everything
                child._lock = self._lock
                child._counters = self._counters
                child._gauges = self._gauges
                child._sets = self._sets
                child._histograms = self._histograms
                child._hist_meta = self._hist_meta
                child._timings = self._timings
                child._timing_meta = self._timing_meta
                child._rng = self._rng
                child._shards = self._shards
                child._shard_local = self._shard_local
                self._children[key] = child
            return child

    def _shard(self) -> _StatsShard:
        sh = getattr(self._shard_local, "shard", None)
        if sh is None:
            sh = _StatsShard()
            with self._lock:
                self._shards.append(sh)
            self._shard_local.shard = sh
        return sh

    def shard_count(self) -> int:
        """Live write shards (== threads that have emitted); exported
        as the ``stats.shards`` gauge by the metrics endpoints."""
        with self._lock:
            return len(self._shards)

    def count(self, name: str, value: int = 1) -> None:
        sh = self._shard()
        with sh.lock:
            key = self._key(name)
            sh.counters[key] = sh.counters.get(key, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[self._key(name)] = value

    def _reservoir_add(self, samples: list[float], n_total: int, value: float) -> None:
        """Algorithm R: every observation has cap/n odds of residing in
        the sample once the reservoir is full — bounded memory, uniform
        percentiles."""
        if len(samples) < RESERVOIR_CAP:
            samples.append(value)
            return
        j = self._rng.randrange(n_total)
        if j < RESERVOIR_CAP:
            samples[j] = value

    def histogram(self, name: str, value: float) -> None:
        sh = self._shard()
        with sh.lock:
            key = self._key(name)
            meta = sh.hist_meta.get(key)
            if meta is None:
                meta = sh.hist_meta[key] = [0, value, value, 0.0]
            meta[0] += 1
            meta[1] = min(meta[1], value)
            meta[2] = max(meta[2], value)
            meta[3] += value
            sh.hist_pending.setdefault(key, []).append(value)
            sh.pending_n += 1
            flush = sh.pending_n >= SHARD_FLUSH_CAP
        if flush:
            self._flush_shard(sh)

    def set(self, name: str, value: str) -> None:
        with self._lock:
            self._sets[self._key(name)] = value

    def timing(self, name: str, value: float) -> None:
        sh = self._shard()
        with sh.lock:
            key = self._key(name)
            meta = sh.timing_meta.get(key)
            if meta is None:
                meta = sh.timing_meta[key] = [0, 0.0]
            meta[0] += 1
            meta[1] += value
            sh.timing_pending.setdefault(key, []).append(value)
            sh.pending_n += 1
            flush = sh.pending_n >= SHARD_FLUSH_CAP
        if flush:
            self._flush_shard(sh)

    def _flush_shard(self, sh: _StatsShard) -> None:
        """Writer-side self-flush (pending cap reached).  Same client →
        shard lock order as the snapshot drain, so a flush racing a
        snapshot merges the shard's deltas exactly once."""
        with self._lock:
            self._drain_shard_locked(sh)

    def _drain_shard_locked(self, sh: _StatsShard) -> None:
        """Merge one shard into the base maps.  Caller holds _lock; the
        shard state is moved-and-zeroed in a single shard-lock hold so
        no delta can be observed (or merged) twice."""
        with sh.lock:
            if not sh.counters and not sh.hist_meta and not sh.timing_meta:
                return
            counters = sh.counters
            sh.counters = {}
            hist_meta = sh.hist_meta
            sh.hist_meta = {}
            hist_pending = sh.hist_pending
            sh.hist_pending = {}
            timing_meta = sh.timing_meta
            sh.timing_meta = {}
            timing_pending = sh.timing_pending
            sh.timing_pending = {}
            sh.pending_n = 0
        for key, v in counters.items():
            self._counters[key] += v
        for key, d in hist_meta.items():
            meta = self._hist_meta.get(key)
            if meta is None:
                self._hist_meta[key] = list(d)
            else:
                meta[0] += d[0]
                meta[1] = min(meta[1], d[1])
                meta[2] = max(meta[2], d[2])
                meta[3] += d[3]
        for key, vals in hist_pending.items():
            # Replay through the reservoir at the merged running count
            # (every observation since the last drain is pending, so
            # base + i + 1 is the true stream position).
            samples = self._histograms[key]
            base = int(self._hist_meta[key][0]) - len(vals)
            for i, v in enumerate(vals):
                self._reservoir_add(samples, base + i + 1, v)
        for key, d in timing_meta.items():
            meta = self._timing_meta.get(key)
            if meta is None:
                self._timing_meta[key] = list(d)
            else:
                meta[0] += d[0]
                meta[1] += d[1]
        for key, vals in timing_pending.items():
            samples = self._timings[key]
            base = int(self._timing_meta[key][0]) - len(vals)
            for i, v in enumerate(vals):
                self._reservoir_add(samples, base + i + 1, v)

    def _drain_all_locked(self) -> None:
        for sh in self._shards:
            self._drain_shard_locked(sh)

    def snapshot(self) -> dict:
        with self._lock:
            self._drain_all_locked()
            out: dict = dict(self._counters)
            out.update(self._gauges)
            out.update(self._sets)
            for name, vals in self._histograms.items():
                if vals:
                    # count/min/max are exact totals; the percentiles
                    # (p50/p95/p99 — the dashboard set, so consumers of
                    # e.g. qos.latency_ms.<class> never re-derive them
                    # from raw samples) read the bounded reservoir.
                    n_total, lo, hi = self._hist_meta[name][:3]
                    s = sorted(vals)
                    out[name] = {
                        "count": int(n_total),
                        "min": lo,
                        "max": hi,
                        "p50": s[len(s) // 2],
                        "p95": s[min(len(s) - 1, int(len(s) * 0.95))],
                        "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
                    }
            for name, vals in self._timings.items():
                if vals:
                    n_total, total = self._timing_meta[name]
                    out[name + ".avg_ms"] = total / n_total * 1000
            return out

    def snapshot_typed(self) -> dict:
        """Kind-preserving snapshot for the Prometheus exposition
        (metrics.py): /debug/vars' flat snapshot() merges counters,
        gauges and sets into one dict, which cannot be mapped back to
        Prometheus metric types mechanically — this keeps each family
        separate.  Histogram entries carry the exact running
        count/min/max/sum plus reservoir percentiles; timings carry
        count/sum.  Shards are drained first, under the same single
        lock hold the render reads from — one consistent snapshot."""
        with self._lock:
            self._drain_all_locked()
            hists: dict = {}
            for name, vals in self._histograms.items():
                if vals:
                    n_total, lo, hi, total = self._hist_meta[name]
                    s = sorted(vals)
                    hists[name] = {
                        "count": int(n_total),
                        "min": lo,
                        "max": hi,
                        "sum": total,
                        "p50": s[len(s) // 2],
                        "p95": s[min(len(s) - 1, int(len(s) * 0.95))],
                        "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
                    }
            timings = {
                name: {"count": int(meta[0]), "sum": meta[1]}
                for name, meta in self._timing_meta.items()
                if meta[0]
            }
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "sets": dict(self._sets),
                "histograms": hists,
                "timings": timings,
            }


class StatsdStatsClient:
    """UDP statsd sink with datadog-style |#tag lists (datadog/datadog.go)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125, prefix: str = "pilosa.", tags: tuple[str, ...] = ()):
        self.addr = (host, port)
        self.prefix = prefix
        self._tags = tags
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def with_tags(self, *tags: str) -> "StatsdStatsClient":
        c = StatsdStatsClient.__new__(StatsdStatsClient)
        c.addr = self.addr
        c.prefix = self.prefix
        c._tags = tuple(sorted(set(self._tags) | set(tags)))
        c._sock = self._sock
        return c

    def _send(self, payload: str) -> None:
        if self._tags:
            payload += "|#" + ",".join(self._tags)
        try:
            self._sock.sendto(payload.encode(), self.addr)
        except OSError:
            pass

    def count(self, name: str, value: int = 1) -> None:
        self._send(f"{self.prefix}{name}:{value}|c")

    def gauge(self, name: str, value: float) -> None:
        self._send(f"{self.prefix}{name}:{value}|g")

    def histogram(self, name: str, value: float) -> None:
        self._send(f"{self.prefix}{name}:{value}|h")

    def set(self, name: str, value: str) -> None:
        self._send(f"{self.prefix}{name}:{value}|s")

    def timing(self, name: str, value: float) -> None:
        self._send(f"{self.prefix}{name}:{value * 1000:.3f}|ms")


class MultiStatsClient:
    """Fan out to several clients (stats.go:133-185)."""

    def __init__(self, clients: Iterable):
        self.clients = list(clients)

    def with_tags(self, *tags: str) -> "MultiStatsClient":
        return MultiStatsClient([c.with_tags(*tags) for c in self.clients])

    def count(self, name: str, value: int = 1) -> None:
        for c in self.clients:
            c.count(name, value)

    def gauge(self, name: str, value: float) -> None:
        for c in self.clients:
            c.gauge(name, value)

    def histogram(self, name: str, value: float) -> None:
        for c in self.clients:
            c.histogram(name, value)

    def set(self, name: str, value: str) -> None:
        for c in self.clients:
            c.set(name, value)

    def timing(self, name: str, value: float) -> None:
        for c in self.clients:
            c.timing(name, value)

    def snapshot(self) -> dict:
        for c in self.clients:
            if hasattr(c, "snapshot"):
                return c.snapshot()
        return {}

    def snapshot_typed(self) -> dict:
        for c in self.clients:
            if hasattr(c, "snapshot_typed"):
                return c.snapshot_typed()
        return {}


def new_stats_client(spec: str):
    """Build a stats client from a config string: "expvar" (default),
    "statsd[:host[:port]]", or "nop" (cmd/server.go stats wiring analog)."""
    spec = (spec or "expvar").strip()
    if spec in ("nop", "none", ""):
        return NopStatsClient()
    if spec == "expvar":
        return ExpvarStatsClient()
    if spec == "statsd" or spec.startswith("statsd:"):
        parts = spec.split(":")
        host = parts[1] if len(parts) > 1 and parts[1] else "127.0.0.1"
        port = int(parts[2]) if len(parts) > 2 else 8125
        return MultiStatsClient([ExpvarStatsClient(), StatsdStatsClient(host=host, port=port)])
    raise ValueError(f"unknown stats backend: {spec!r}")
