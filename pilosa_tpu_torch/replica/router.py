"""The replica read router: one front door over N serving groups.

The reference fans a read to ANY of a fragment's ``ReplicaN`` owners at
query time (executor.go:1147-1159) — replication buys read throughput,
not just durability.  This router is that idea at GROUP granularity:
each group is a complete serving unit (a lockstep job or a plain
server) holding a full copy of every slice, so ANY group can answer ANY
read and read QPS scales with group count.

Routing policy:

- CLASSIFY with the QoS classifier (``qos.classify_request`` — the same
  byte-scan the admission door uses, so a request is a write here iff
  it is a write there).  A false read->write positive only costs fan-out
  latency; a false negative is impossible for PQL mutating calls.
- READS (and admin GETs) go to ONE healthy, CAUGHT-UP group:
  least-inflight pick, ties broken by fewest-routed so an idle router
  round-robins.  On a connect failure or a 5xx answer the group is
  marked unhealthy and the read fails over ONCE to a sibling group
  (reads are side-effect-free, so the retry is safe; ``[replica]
  failover = false`` disables it).  A lagging group never serves reads
  — that is what preserves read-your-writes across groups now that a
  write can commit without it.
- WRITES (and mutating admin — schema must stay identical everywhere)
  run through ONE sequencer: each accepted write is assigned a
  monotonic sequence number and appended to the WRITE-AHEAD LOG
  (``replica/wal.py``) BEFORE any group sees it, then fanned to every
  in-rotation group with the sequence riding ``X-Pilosa-Write-Seq``.
  The sequencer lock is held for the whole fan-out, so every group
  applies every write in the same total order and the groups' fragment
  generation vectors advance identically — the invariant that keeps
  each group's qcache and serve-state repair read-your-writes correct
  with zero cross-group invalidation traffic.

Failure semantics (the durable-log upgrade of a full-set rule):

- QUORUM is now a MAJORITY of the configured groups.  A write COMMITS
  (2xx to the client) once >= majority of groups applied it; groups
  that are down, lagging, or failed mid-fan-out simply miss the write
  and accumulate a bounded backlog in the WAL instead of blocking the
  cluster — one dead group no longer 503s every write.  Writes refuse
  (503 + Retry-After, touching no group and appending nothing) only
  when fewer than a majority of groups are in rotation.
- A write that reached SOME group but fewer than a majority answers
  502 "may be partially applied": the record stays in the log, the
  laggards re-converge by replay, and the idempotent client retry is
  harmless.
- A write SHED by a group (429, or any answer carrying Retry-After —
  the admission door under load; one shared predicate,
  ``replica.write_not_applied``, decides "did not land" for the
  fan-out, the catch-up replay, and the group-side bookkeeping alike)
  is load-dependent, not deterministic: shed before ANY group
  committed — and with no AMBIGUOUS failure earlier in the fan-out —
  passes the backpressure through verbatim and ABORTS the log record
  (tombstoned — replay can never deliver a write no live group holds);
  shed after a sibling committed just makes the shedding group a
  laggard (demoted + replayed later), and the write still commits if a
  majority applied.
- A transport failure (or 5xx) is AMBIGUOUS: the socket may have died
  AFTER the group applied the write, so it never proves
  non-application.  Only provable refusals (shed / deterministic 4xx
  everywhere) tombstone the record; when every group failed
  ambiguously the record STAYS LIVE (502 "may be partially applied" to
  the client) and catch-up re-delivers it — idempotent re-apply is the
  contract, silent cross-group divergence is not.
- A read answered 504 spent ITS OWN deadline budget — request-scoped,
  not a group-health signal — so it returns to the client without
  demoting the group.
- RECOVERY is probe + replay: a background loop probes down/lagging
  groups with jittered exponential backoff per group (``[replica]
  probe-interval`` base, doubled per failed probe up to
  ``probe-max-interval``, reset on recovery — a dead group is not
  hammered in lockstep by every router).  A live group reporting a
  stale applied sequence gets the missed WAL suffix streamed in order
  (``replica/catchup.py``; epoch-guarded, so a restarted incarnation
  can't absorb a replay paced against its predecessor) and only
  rejoins the read rotation once FULLY caught up.  A laggard whose
  backlog would grow the WAL past ``wal-max-bytes`` is declared STALE
  (``replica.stale.<g>``): the log compacts past it, and the probe —
  which keeps visiting stale groups at ``probe-max-interval`` — drives
  an AUTOMATED RESYNC (``replica/resync.py``): digest diff against a
  healthy donor, differing fragments streamed as serialized roaring
  payloads, applied-sequence seeded under the sequencer lock, WAL
  catch-up for the final drain — no human in the loop.  A group
  reporting ``applied_seq=0`` over a non-empty sequence space (blank
  data dir) takes the same path.
- ANTI-ENTROPY: an optional background sweep (``[replica]
  anti-entropy-interval``, jittered, off by default) compares healthy
  groups' content digests under the sequencer lock and repairs any
  silently diverged fragment from the majority copy
  (``replica.divergence.<g>`` + one structured
  ``pilosa_tpu_torch.divergence`` log line per divergent sweep).

Observability: ``replica.routed.<group>`` / ``replica.failover`` /
``replica.write_fanout`` (+ refused/error/shed), per-group
``replica.healthy.<group>`` / ``replica.inflight.<group>`` /
``replica.lag.<group>`` gauges and ``replica.wal_bytes`` at the
router's own ``/debug/vars``; ``/replica/status`` returns the live
group table (health, applied sequence, lag, caught-up/stale flags) and
the WAL head/tail.  Routed requests tag their trace root with
``group=<g>`` and graft the group's span tree under the forward span.
Deterministic fault injection (``replica/faults.py``,
``PILOSA_TPU_FAULT_SPEC``) hooks the per-group forward and the WAL
append, so partial-failure orderings are reproducible in tests.

PARTITIONED REPLICA GROUPS: the router can run a 2-D
(slice-shard x replica) layout — a :class:`~pilosa_tpu_torch.replica.shards.ShardMap`
partitions the slice space into contiguous ranges, each shard owning
its own replica set and its OWN sequence space (:class:`ShardRuntime`:
per-shard WAL, per-shard sequencer lock, per-shard catch-up / resync /
compaction — the recovery machinery runs per shard UNCHANGED because
applied-seq marks and digests are keyed inside one shard's group set).
Reads compute the query's slice cover and fan out only to the shards
touched, merging results exactly like the executor's cluster fan-out;
PQL writes route to the one shard owning ``columnID``'s slice, so two
shards sequence writes CONCURRENTLY — write throughput scales with the
shard axis, which one global sequencer lock never allowed.  Live
resharding (``POST /replica/reshard``) splits a shard with zero
downtime: fragments pre-stream to the new owners while the old shard
keeps serving, then an EPOCH FENCE briefly holds new requests at the
routing gate, streams the delta, flips the map, clears the moved
range off the old owners, and compacts the old WAL — writes in the
moved range block for the fence and then land on the new shard; none
fail.  The default single-shard map is byte-for-byte the pre-shard
router: same lock, same WAL path, same status payloads.
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlencode, urlparse

from pilosa_tpu_torch import costs as costs_mod
from pilosa_tpu_torch import metrics as metrics_mod
from pilosa_tpu_torch import pql
from pilosa_tpu_torch import qos
from pilosa_tpu_torch.analysis import lockcheck
from pilosa_tpu_torch.analysis import spec
from pilosa_tpu_torch.pilosa import SLICE_WIDTH
from pilosa_tpu_torch.pql.ast import WRITE_CALL_NAMES
from pilosa_tpu_torch.qos import DEADLINE_HEADER
from pilosa_tpu_torch.replica import (
    APPLIED_SEQ_HEADER,
    GROUP_HEADER,
    REPLAY_HEADER,
    WRITE_SEQ_HEADER,
    write_not_applied,
)
from pilosa_tpu_torch.replica.catchup import CatchupManager
from pilosa_tpu_torch.replica.digest import (
    fragment_query,
    majority_plan,
    parse_fragment_path,
)
from pilosa_tpu_torch.replica.faults import FaultInjector, InjectedStatus, NOP_FAULTS
from pilosa_tpu_torch.replica.resync import ResyncAbort, ResyncManager
from pilosa_tpu_torch.replica.shards import (
    Shard,
    ShardMap,
    ShardMapError,
    parse_shard_map,
    single_shard_map,
    uniform_shard_map,
)
from pilosa_tpu_torch.replica.wal import WriteAheadLog
from pilosa_tpu_torch.stats import NOP_STATS
from pilosa_tpu_torch.trace import TRACE_HEADER, TRACE_SPANS_HEADER

# Structured divergence log: one line per anti-entropy sweep that found
# healthy groups disagreeing (the slowquery-logger pattern) — counted
# AND logged because divergence is a correctness event, not load noise.
_divergence_logger = logging.getLogger("pilosa_tpu_torch.divergence")

# Headers never forwarded on a hop: ownership is per-connection, the
# router recomputes lengths, deadline/trace headers are REWRITTEN
# (remaining budget, router trace id), and the write-sequence/replay
# headers are ROUTER-OWNED (a client must not be able to spoof a
# group's applied mark).
_HOP_HEADERS = frozenset(
    ("host", "content-length", "connection", "accept-encoding",
     DEADLINE_HEADER.lower(), TRACE_HEADER.lower(),
     WRITE_SEQ_HEADER.lower(), REPLAY_HEADER.lower())
)


@lockcheck.guarded_class
class GroupState:
    """Router-side record of one serving group."""

    __slots__ = ("name", "base", "healthy", "inflight", "routed", "epoch",
                 "applied_seq", "caught_up", "stale", "suspect",
                 "probe_delay", "probe_at", "__weakref__")

    # Lockset race detector declarations: the group table is written by
    # HTTP handler threads (reads, writes), the probe thread, and the
    # catch-up/resync/anti-entropy paths concurrently — every post-init
    # write must hold the router's table lock.  (The sequencer lock
    # alone is NOT enough: reads route off this state without it.)
    _guarded_by_ = {
        "healthy": "replica.router._mu",
        "inflight": "replica.router._mu",
        "routed": "replica.router._mu",
        "epoch": "replica.router._mu",
        "applied_seq": "replica.router._mu",
        "caught_up": "replica.router._mu",
        "stale": "replica.router._mu",
        "suspect": "replica.router._mu",
        "probe_delay": "replica.router._mu",
        "probe_at": "replica.router._mu",
    }

    def __init__(self, name: str, base: str):
        self.name = name
        if "://" not in base:
            base = "http://" + base
        self.base = base.rstrip("/")
        self.healthy = True
        self.inflight = 0
        self.routed = 0
        self.epoch: Optional[str] = None  # last X-Pilosa-Group seen
        # Durable-write bookkeeping: the highest WAL sequence this group
        # is known to have applied (advanced on write acks, read
        # passively off X-Pilosa-Applied-Seq, authoritative from the
        # health probe), whether it is fully caught up to the WAL head
        # (only caught-up groups serve reads or receive new writes),
        # and whether it fell so far behind the WAL compacted past it
        # (stale: operator resync required).
        self.applied_seq = 0
        self.caught_up = True
        self.stale = False
        # Content-suspect: the group answered a write with a 4xx a
        # sibling 2xx'd — for IDENTICAL replicated state that is
        # impossible, so its content is presumed diverged (blank data
        # dir, lost index) until a digest check against a healthy donor
        # clears it (or a resync round repairs it).
        self.suspect = False
        # Probe backoff (jittered exponential, per group).
        self.probe_delay = 0.0
        self.probe_at = 0.0

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "base": self.base,
            "healthy": self.healthy,
            "inflight": self.inflight,
            "routed": self.routed,
            "epoch": self.epoch,
            "appliedSeq": self.applied_seq,
            "caughtUp": self.caught_up,
            "stale": self.stale,
            "suspect": self.suspect,
        }


def _parse_group_spec(i: int, spec: str) -> GroupState:
    """``host:port`` or ``name=host:port`` (names default to g<i>)."""
    spec = spec.strip()
    if "=" in spec and "://" not in spec.split("=", 1)[0]:
        name, base = spec.split("=", 1)
        return GroupState(name.strip(), base.strip())
    return GroupState(f"g{i}", spec)


_QUERY_PATH_RE = re.compile(r"^/index/([^/]+)/query$")


def _merge_result_values(vals: list):
    """Merge one PQL call's per-shard results, mirroring the executor's
    cluster reduce: bools OR (mutations), counts SUM, bitmaps UNION
    bits + merged attrs, TopN pair lists SUM counts by id (descending
    count, id tiebreak — the executor's ordering)."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    v0 = vals[0]
    if isinstance(v0, bool):
        return any(vals)
    if isinstance(v0, (int, float)):
        return sum(vals)
    if isinstance(v0, dict) and "bits" in v0:
        bits: set = set()
        attrs: dict = {}
        for v in vals:
            bits.update(v.get("bits") or [])
            attrs.update(v.get("attrs") or {})
        return {"attrs": attrs, "bits": sorted(bits)}
    if isinstance(v0, list):
        counts: dict = {}
        for v in vals:
            for pair in v:
                if isinstance(pair, dict) and "id" in pair:
                    counts[pair["id"]] = (
                        counts.get(pair["id"], 0) + pair.get("count", 0)
                    )
        return [
            {"id": i, "count": c}
            for i, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        ]
    return v0


def _merge_query_payloads(payloads: list) -> bytes:
    """Merge per-shard ``/index/<i>/query`` JSON bodies into one
    response: results merged element-wise, columnAttrSets concatenated
    and deduplicated by id."""
    docs = []
    for p in payloads:
        try:
            docs.append(json.loads(p or b"{}"))
        except ValueError:
            docs.append({})
    n = max((len(d.get("results") or []) for d in docs), default=0)
    results = [
        _merge_result_values([
            (d.get("results") or [None] * n)[i] if i < len(d.get("results") or []) else None
            for d in docs
        ])
        for i in range(n)
    ]
    out: dict = {"results": results}
    attr_sets: list = []
    seen_ids: set = set()
    for d in docs:
        for cs in d.get("columnAttrSets") or []:
            key = cs.get("id") if isinstance(cs, dict) else None
            if key is not None and key in seen_ids:
                continue
            if key is not None:
                seen_ids.add(key)
            attr_sets.append(cs)
    if attr_sets:
        out["columnAttrSets"] = attr_sets
    return json.dumps(out).encode()


@lockcheck.guarded_class
class ShardRuntime:
    """One shard's serving state: a contiguous slice range, its replica
    set, and its OWN sequence space — WAL, sequencer lock, write
    high-water mark, catch-up, resync, compaction floors.

    This object IS the seam that lets the recovery machinery run
    per shard unchanged: :class:`CatchupManager` and
    :class:`ResyncManager` take it where they used to take the router,
    and it exposes the same attributes (``_forward`` / ``_mu`` /
    ``faults`` / ``_seq_mu`` / ``_resync_floor`` / ``catchup`` /
    ``wal``) scoped to this shard's groups and log.

    Every shard's sequencer lock carries the same lockcheck NAME
    (``replica.router._seq_mu``): the name identifies the lock's
    CONTRACT — the blocking allowlist pairs it with socket/fsync
    because holding the order lock across the fan-out IS the design —
    while each shard holds its own instance, so two shards sequence
    writes concurrently.  Shard sequencer locks never nest."""

    # Per-shard write-sequence high-water mark: part of the total order
    # THIS shard's sequencer lock defines.
    _guarded_by_ = {"write_seq": "replica.router._seq_mu"}

    def __init__(self, router: "ReplicaRouter", shard: Shard,
                 groups: list, wal: WriteAheadLog):
        self.router = router
        self.name = shard.name
        self.lo = shard.lo
        self.hi = shard.hi  # exclusive; None = open-ended
        self.group_specs = list(shard.group_specs)
        self.groups = groups
        self.wal = wal
        self.stats = router.stats
        self.faults = router.faults
        # The shared group-table lock (one per router — GroupState's
        # _guarded_by_ names it) and the per-shard sequencer instance.
        self._mu = router._mu
        self._seq_mu = lockcheck.named_lock("replica.router._seq_mu")
        self.write_seq = wal.last_seq
        # Per-group compaction floors for in-flight resync rounds on
        # THIS shard (guarded by the shared table lock).
        self._resync_floor: dict[str, int] = {}
        self.catchup = CatchupManager(self, wal, stats=router.stats,
                                      budgets=router.budgets)
        self.resync = ResyncManager(
            self, wal, stats=router.stats,
            chunk_bytes=router.resync_chunk_bytes,
            columnar=router.resync_columnar,
            budgets=router.budgets,
        )
        # A (re)start over a non-empty log: no group may be assumed
        # current (see ReplicaRouter.__init__).
        if wal.last_seq > 0:
            for g in groups:
                g.caught_up = False
        spec.emit("config", src=id(wal), shard=self.name,
                  groups=[g.name for g in groups], quorum=self.quorum)

    def owns(self, slice_i: int) -> bool:
        return slice_i >= self.lo and (self.hi is None or slice_i < self.hi)

    @property
    def _forward(self):
        """Live dereference of the router's forwarder — NOT captured at
        init, so a monkeypatched/fault-wrapped ``router._forward`` is
        seen by every shard and by catch-up/resync through the facade."""
        return self.router._forward

    @property
    def quorum(self) -> int:
        """Writes commit on a MAJORITY of THIS shard's group set."""
        return len(self.groups) // 2 + 1

    def _ready_groups(self) -> list:
        """This shard's write rotation: reachable, fully caught up to
        the shard's WAL head, and not stale."""
        with self._mu:
            return [
                g for g in self.groups
                if g.healthy and g.caught_up and not g.stale
            ]

    def quorate(self) -> bool:
        return len(self._ready_groups()) >= self.quorum

    def _pick(self, exclude=None) -> Optional[GroupState]:
        """Least-inflight healthy CAUGHT-UP group of this shard (ties:
        fewest routed).  A lagging group is invisible to reads until
        catch-up finishes — the read-your-writes rule, per shard."""
        with self._mu:
            live = [
                g for g in self.groups
                if g.healthy and g.caught_up and not g.stale
                and (exclude is None or g is not exclude)
            ]
            if not live:
                return None
            g = min(live, key=lambda g: (g.inflight, g.routed))
            g.routed += 1
            g.inflight += 1
            self.stats.gauge(f"replica.inflight.{g.name}", g.inflight)
            # Emitted under _mu so the (group, applied) observation is
            # consistent with the pick itself.
            spec.emit("read", src=id(self.wal), group=g.name,
                      applied=g.applied_seq)
        self.stats.count(f"replica.routed.{g.name}")
        return g

    def _mark_lagging(self, g: GroupState) -> None:
        """The group missed a sequenced write on this shard: out of the
        read rotation until catch-up replays it to the shard's head."""
        with self._mu:
            g.caught_up = False
        self.stats.gauge(
            f"replica.lag.{g.name}", max(0, self.wal.last_seq - g.applied_seq)
        )

    # -- the per-shard write sequencer ------------------------------------

    def sequence_write(self, method: str, path_qs: str, body: bytes,
                       headers: dict, deadline=None, trace=None):
        """Sequence one write into THIS shard's WAL, then total-ordered
        fan-out over this shard's groups.  The shard's sequencer lock is
        held end to end, so every group of the shard applies every one
        of its writes in one total order — while sibling shards
        sequence their own writes concurrently under their own locks.
        COMMIT RULE (unchanged from the single-sequencer router):
        >= majority applied -> 2xx; some but fewer -> 502 (record
        stays, laggards replay); PROVABLY none (shed / deterministic
        4xx everywhere, no ambiguous failure) -> the record is aborted
        and the refusal surfaces verbatim; applied nowhere but
        AMBIGUOUSLY -> the record stays live and replays, 502."""
        router = self.router
        with self._seq_mu:
            ready = self._ready_groups()
            if len(ready) < self.quorum:
                with self._mu:
                    out_names = [
                        g.name for g in self.groups
                        if not (g.healthy and g.caught_up and not g.stale)
                    ]
                self.stats.count("replica.write_refused")
                if trace is not None:
                    trace.root.tags["qos"] = "write_refused"
                return router._shed(
                    503,
                    f"write refused: shard {self.name} group set not quorate "
                    f"(need {self.quorum}/{len(self.groups)}, out: {', '.join(out_names)})",
                    retry_after=1.0,
                )
            # DURABILITY FIRST: the record is in the log (fsync-batched)
            # before any group sees the write — a router crash mid-fan-out
            # replays the tail instead of losing the order.
            try:
                seq = self.wal.append(
                    method, path_qs, body, headers.get("content-type", "")
                )
            except OSError as e:
                self.stats.count("replica.wal_error")
                return router._shed(
                    503, f"write log append failed: {e}", retry_after=1.0
                )
            self.write_seq = seq
            self.stats.count(f"replica.shard.writes.{self.name}")
            # Groups outside the rotation miss this sequence: their
            # backlog grows in the WAL until catch-up (or staleness).
            for g in self.groups:
                if g not in ready:
                    self._mark_lagging(g)
            first_out = None  # first answer of any kind
            first_ok = None  # first 2xx — the committed write's answer
            deterministic_4xx = None
            det4xx_groups: list = []  # groups that answered it
            applied = 0
            # Ambiguous failure: a transport error (or 5xx) proves
            # NOTHING about application — the group may have applied
            # the write before the socket died — so once one happens
            # the record can never be tombstoned this round.
            ambiguous = False
            for g in ready:
                sp = trace.root.child("forward") if trace is not None else None
                with self._mu:  # inflight is shared with _pick/_release
                    g.inflight += 1
                    self.stats.gauge(f"replica.inflight.{g.name}", g.inflight)
                try:
                    out = self._forward(
                        g, method, path_qs, body, headers, deadline=deadline,
                        trace_id=(trace.id if trace is not None else ""),
                        extra_headers={WRITE_SEQ_HEADER: str(seq)},
                    )
                except OSError as e:
                    if sp is not None:
                        sp.finish().annotate(group=g.name, error=str(e))
                    router._mark_unhealthy(g, str(e))
                    self._mark_lagging(g)
                    self.stats.count("replica.write_error")
                    ambiguous = True
                    continue
                finally:
                    router._release(g)
                if sp is not None:
                    sp.finish().annotate(group=g.name, status=out[0])
                # ONE predicate ("did the write land?") shared with the
                # catch-up replay and the group-side bookkeeping: a
                # shed (429, or any answer carrying Retry-After) is
                # LOAD-dependent, not deterministic — under load one
                # group can shed a write its siblings applied, so it
                # must never be ACKed as a success.
                missed = write_not_applied(out[0], out[3].get("Retry-After"))
                shed = missed and out[0] < 500
                if shed and applied == 0 and not ambiguous:
                    # Shed before ANY group committed, with no
                    # ambiguous failure earlier in the fan-out: nothing
                    # is applied anywhere, so abort the log record
                    # (replay must never deliver it) and pass the
                    # backpressure through verbatim — no demotion (the
                    # group is loaded, not broken); the client retries.
                    self.wal.abort(seq)
                    self.stats.count("replica.write_shed")
                    spec.emit("ack", src=id(self.wal), seq=seq,
                              status=out[0], applied=0)
                    extra = {GROUP_HEADER: g.name}
                    ra = out[3].get("Retry-After")
                    if ra:
                        extra["Retry-After"] = ra
                    return out[0], out[1], out[2], extra
                if missed:
                    # Failed (or shed) after a sibling committed or an
                    # ambiguous failure: this group missed sequence
                    # ``seq``.  Demote it — the probe + catch-up
                    # replays the suffix and only then re-admits it —
                    # and keep fanning: with the WAL holding the
                    # record, one group's failure no longer aborts the
                    # commit.
                    router._mark_unhealthy(g, f"HTTP {out[0]} on write")
                    self._mark_lagging(g)
                    self.stats.count("replica.write_error")
                    if out[0] >= 500:
                        ambiguous = True
                    continue
                with self._mu:
                    g.applied_seq = max(g.applied_seq, seq)
                spec.emit("apply", src=id(self.wal), group=g.name, seq=seq,
                          ok=out[0] < 300)
                if out[0] < 300:
                    applied += 1
                    if first_ok is None:
                        first_ok = out
                else:
                    # Deterministic 4xx (parse/schema: 400/404/409)
                    # answers identically on every group (identical
                    # schema + total order) — keep fanning so a
                    # mutating call that DID apply elsewhere stays
                    # aligned; the group's applied mark still advances
                    # (replaying it would just re-answer the same 4xx).
                    # If a SIBLING 2xx'd this very write the premise is
                    # broken — see the suspect check below the loop.
                    if deterministic_4xx is None:
                        deterministic_4xx = out
                    det4xx_groups.append(g)
                if first_out is None:
                    first_out = out
            if applied > 0 and det4xx_groups:
                # A 4xx is only "deterministic" while every replica
                # answers it.  One group 4xx-ing a write a sibling
                # APPLIED means its content diverged (a blank data dir
                # 404s the index every sibling holds; a half-applied
                # create 409s) — silently counting it applied is
                # exactly the latent divergence this tier exists to
                # kill.  Mark it SUSPECT and pull it from rotation: the
                # probe digest-checks it against a healthy donor and
                # either clears the flag (retried creates legitimately
                # answer 409 on the groups that already applied them)
                # or drives a resync round that repairs it.
                for sg in det4xx_groups:
                    with self._mu:
                        sg.suspect = True
                        sg.caught_up = False
                    self.stats.count(f"replica.suspect.{sg.name}")
                    router._mark_unhealthy(
                        sg, f"divergent answer on write {seq}"
                    )
            if applied >= self.quorum:
                # COMMITTED: a majority holds the write; any laggard
                # re-converges from the log.
                self.stats.count("replica.write_fanout")
                status, ctype, payload, _rh = first_ok or first_out
                spec.emit("ack", src=id(self.wal), seq=seq, status=status,
                          applied=applied)
                result = (status, ctype, payload, {GROUP_HEADER: "all"})
            elif applied == 0 and deterministic_4xx is not None and not ambiguous:
                # Every in-rotation group answered the same
                # deterministic 4xx: PROVABLY applied nowhere, nothing
                # to replay — tombstone the record and surface the
                # answer.
                self.wal.abort(seq)
                status, ctype, payload, _rh = deterministic_4xx
                spec.emit("ack", src=id(self.wal), seq=seq, status=status,
                          applied=0)
                result = (status, ctype, payload, {GROUP_HEADER: "all"})
            else:
                # Reached some group but not a majority — or applied
                # nowhere WE CAN PROVE (every group transport-failed /
                # 5xx'd, or shed after one did; a socket that died
                # after the request was sent may still have delivered
                # the write).  Tombstoning here could hide a write one
                # group actually holds — replay would then never
                # deliver it to the siblings, permanent cross-group
                # divergence — so the record STAYS LIVE: every demoted
                # group gets it re-delivered by catch-up (idempotent
                # re-apply is the contract) and the client hears 502
                # "may be partially applied" (retry is harmless).
                failed_names = ", ".join(
                    g.name for g in ready if g.applied_seq < seq
                )
                spec.emit("ack", src=id(self.wal), seq=seq, status=502,
                          applied=applied)
                result = router._partial_write(failed_names or "unknown")
        self._maybe_compact()
        return result

    # -- per-shard WAL compaction / backlog bound -------------------------

    def _maybe_compact(self) -> None:
        """Advance this shard's log past the min-applied watermark once
        it has grown past a quarter of its bound; a laggard that would
        pin it past the bound goes STALE (the automated resync streams
        it fragments instead) so the backlog stays bounded.  In-flight
        resync rounds FLOOR the watermark at their seed sequence."""
        router = self.router
        if self.wal.size_bytes <= max(self.wal.max_bytes // 4, 1 << 16):
            return
        while True:
            with self._mu:
                tracked = [g for g in self.groups if not g.stale]
                floors = list(self._resync_floor.values())
                snapshot = {g.name: g.applied_seq for g in tracked}
            if not tracked and not floors:
                spec.emit("compact_plan", src=id(self.wal),
                          floor=self.wal.last_seq, tracked={}, floors=[])
                self.wal.compact(self.wal.last_seq)
                return
            min_applied = min(
                [g.applied_seq for g in tracked] + floors
            )
            spec.emit("compact_plan", src=id(self.wal), floor=min_applied,
                      tracked=snapshot, floors=floors)
            self.wal.compact(min_applied)
            if self.wal.size_bytes <= self.wal.max_bytes:
                return
            laggards = [
                g for g in tracked
                if g.applied_seq == min_applied and g.applied_seq < self.wal.last_seq
            ]
            if not laggards:
                return  # the head itself exceeds the bound; nothing to drop
            for g in laggards:
                self.stats.count(f"replica.stale.{g.name}")
                self.stats.set(
                    "replica.last_failure",
                    f"{g.name}: lag exceeded wal-max-bytes; marked stale "
                    "(automated resync scheduled)",
                )
                router._mark_unhealthy(g, "stale: WAL compacted past its lag")
                with self._mu:
                    # Stale groups stay in the probe rotation at the MAX
                    # interval — the automated resync's (and a hand-
                    # resynced group's) live door back in, rather than
                    # dropping them from probing forever.
                    g.stale = True
                    g.probe_delay = router.probe_max_interval_s
                    g.probe_at = time.monotonic() + g.probe_delay * router._rng.uniform(0.5, 1.0)

    def wal_json(self) -> dict:
        return {
            "firstSeq": self.wal.first_seq,
            "lastSeq": self.wal.last_seq,
            "bytes": self.wal.size_bytes,
            "durable": self.wal.path is not None,
        }

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "slices": {"lo": self.lo, "hi": self.hi},
            "writeSeq": self.write_seq,
            "quorum": self.quorum,
            "quorate": self.quorate(),
            "groups": [g.name for g in self.groups],
            "wal": self.wal_json(),
        }


@lockcheck.guarded_class
class ReplicaRouter:
    """HTTP front door fanning reads over replica serving groups."""

    # /debug/fleet's scrape cache is shared between handler threads.
    # (The write-sequence high-water marks moved to ShardRuntime with
    # the sequence spaces themselves — see its _guarded_by_.)
    _guarded_by_ = {
        "_fleet_cache": "replica.router._fleet_mu",
    }

    def __init__(
        self,
        groups=None,
        host: str = "127.0.0.1",
        port: int = 0,
        failover: bool = True,
        default_deadline_ms: float = 0.0,
        timeout: float = 30.0,
        probe_interval_s: float = 1.0,
        probe_max_interval_s: float = 30.0,
        wal: Optional[WriteAheadLog] = None,
        faults: Optional[FaultInjector] = None,
        stats=None,
        tracer=None,
        anti_entropy_interval_s: float = 0.0,
        resync_chunk_bytes: int = 256 << 10,
        resync_columnar: bool = False,
        shard_map: Optional[ShardMap] = None,
        wal_dir: Optional[str] = None,
        wal_max_bytes: Optional[int] = None,
        admission=None,
        tenancy=None,
    ):
        if shard_map is None:
            if not groups:
                raise ValueError("replica router needs at least one group")
            shard_map = single_shard_map(list(groups))
        elif groups:
            raise ValueError(
                "pass groups through the shard map, not both arguments"
            )
        self.host = host
        self.port = port
        self.failover = failover
        self.default_deadline_ms = default_deadline_ms
        self.timeout = timeout
        self.probe_interval_s = probe_interval_s
        self.probe_max_interval_s = probe_max_interval_s
        self.stats = stats if stats is not None else NOP_STATS
        self.tracer = tracer
        # [tenancy]: weighted fair-share admission at the ROUTER door —
        # the same class doors the per-server handler runs, so a hostile
        # tenant flooding the fleet front door sheds at ITS share before
        # its requests ever fan out to a group.  None (the default)
        # keeps the routed path byte-identical to the pre-tenancy
        # router: no door, no extra lock hop.
        self.tenancy = tenancy
        self.admission = admission
        self.faults = faults if faults is not None else (
            FaultInjector.from_env() or NOP_FAULTS
        )
        self.resync_chunk_bytes = resync_chunk_bytes
        # Router-local adaptive-budget loop (planner.AdaptiveBudgets over
        # a router-local CostLedger): catch-up replay and resync push
        # costs observed by the managers feed back into the drain-batch
        # and chunk sizes they use next round.  Same gate as serve-side
        # cost accounting (PILOSA_TPU_COSTS) so a cost-free deploy stays
        # cost-free here too; the static knobs above remain the floor
        # and the fallback.
        self.budgets = None
        if costs_mod.enabled_from_env():
            from pilosa_tpu_torch import planner as planner_mod

            self.budgets = planner_mod.AdaptiveBudgets(
                costs_mod.CostLedger(stats=self.stats),
                resync_chunk_bytes=resync_chunk_bytes,
                stats=self.stats,
            )
        # Columnar resync negotiation: movers may fetch a fragment the
        # laggard lacks ENTIRELY as Arrow record batches and push it
        # through the laggard's device-build /bulk door (the bulk OR
        # equals replacement only over an empty target); any refusal on
        # either side degrades to the roaring byte stream.
        self.resync_columnar = resync_columnar
        # Where NEW shard WALs land (auto-split maps, live resharding);
        # None keeps them in-memory like the default single WAL.
        self._wal_dir = wal_dir
        self._wal_max_bytes = wal_max_bytes
        # Cross-group anti-entropy sweep cadence (0 = off, the test
        # default): healthy groups' digests compared, divergence counted
        # + logged + repaired from the majority copy.
        self.anti_entropy_interval_s = anti_entropy_interval_s
        # Bound on one sweep's repair work under the sequencer lock.
        self.anti_entropy_budget_s = 30.0
        self._mu = lockcheck.named_lock("replica.router._mu")  # group table (health/inflight/epoch)
        # /debug/fleet scrape cache: the last SUCCESSFUL per-group scrape
        # keeps serving (stamped stale, with its age) while a group is
        # down, so the fleet view degrades to partial instead of losing
        # the dead group entirely.
        self._fleet_mu = lockcheck.named_lock("replica.router._fleet_mu")
        self._fleet_cache: dict[str, dict] = {}
        self._rng = random.Random()  # probe jitter (timing only)
        # THE ROUTING GATE: live resharding flips the shard map behind
        # an epoch fence — new routed requests wait at the gate while
        # the flip drains the in-flight ones, so no read can observe a
        # moved slice range on both its old and new owner.  The gate's
        # lock is only ever held to flip flags and count — never across
        # a socket.
        self._gate_cv = lockcheck.named_condition("replica.router._route_gate")
        self._active_routed = 0
        self._gated = False
        self._httpd = None
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # Build the shard runtimes: each shard gets its own GroupStates,
        # its own WAL, and its own sequencer (see ShardRuntime).  An
        # explicitly passed ``wal`` belongs to shard 0 — the single-
        # shard (default) layout, where it is THE router WAL.
        self.shard_map = shard_map
        self.map_epoch = 0
        self.shards: list = []
        self.groups: list = []
        self._group_shard: dict = {}
        gi = 0
        for si, sh in enumerate(shard_map):
            gs = []
            for spec_s in sh.group_specs:
                gs.append(_parse_group_spec(gi, spec_s))
                gi += 1
            swal = wal if si == 0 and wal is not None else self._shard_wal(sh.name)
            rt = ShardRuntime(self, sh, gs, swal)
            self.shards.append(rt)
            self.groups.extend(gs)
            for g in gs:
                self._group_shard[g] = rt
        if len({g.name for g in self.groups}) != len(self.groups):
            raise ValueError("duplicate replica group names")
        # Single-shard compat aliases: tests, operators, and the CLI all
        # reach the sequencing state through the router object — shard 0
        # IS that state under the default map (same WAL object, same
        # lock instance, same floor dict), so the pre-shard surface
        # stays byte-for-byte.
        s0 = self.shards[0]
        self.wal = s0.wal
        self.catchup = s0.catchup
        self.resync = s0.resync
        self._seq_mu = s0._seq_mu
        self._resync_floor = s0._resync_floor
        for g in self.groups:
            self.stats.gauge(f"replica.healthy.{g.name}", 1)
            self.stats.gauge(f"replica.inflight.{g.name}", 0)
            self.stats.gauge(f"replica.lag.{g.name}", 0)
        self.stats.gauge("replica.shard.count", len(self.shards))
        self.stats.gauge("replica.shard.map_epoch", self.map_epoch)

    def _shard_wal(self, shard_name: str) -> WriteAheadLog:
        """A shard's write log: durable under ``wal_dir`` (one file per
        shard — sequence spaces never mix), in-memory otherwise (same
        sequencing/abort/replay semantics, no crash durability)."""
        path = None
        if self._wal_dir:
            path = os.path.join(
                os.path.expanduser(self._wal_dir), f"router-{shard_name}.wal"
            )
        kw = {}
        if self._wal_max_bytes is not None:
            kw["max_bytes"] = self._wal_max_bytes
        return WriteAheadLog(path, stats=self.stats, faults=self.faults, **kw)

    # -- group table ------------------------------------------------------

    @property
    def quorum(self) -> int:
        """Shard 0's majority — THE quorum under the default single-
        shard map (multi-shard maps report per-shard quorums in
        /replica/status's shards array)."""
        return self.shards[0].quorum

    @property
    def write_seq(self) -> int:
        """Shard 0's write high-water mark (the router-wide mark under
        the default single-shard map)."""
        return self.shards[0].write_seq

    def _shard_for_slice(self, slice_i: int):
        """The ShardRuntime owning ``slice_i`` (positional: runtimes
        mirror the validated map's order)."""
        sh = self.shard_map.shard_of(slice_i)
        for rt in self.shards:
            if rt.name == sh.name:
                return rt
        raise ShardMapError(f"no runtime for shard {sh.name}")  # unreachable

    def _ready_groups(self) -> list:
        """Groups in the write rotation, across every shard."""
        out = []
        for sh in self.shards:
            out.extend(sh._ready_groups())
        return out

    def _pick(self, exclude=None) -> Optional[GroupState]:
        """Shard 0's read pick (single-shard compat; multi-shard reads
        pick per target shard in _route_read)."""
        return self.shards[0]._pick(exclude=exclude)

    def _release(self, g: GroupState) -> None:
        with self._mu:
            g.inflight -= 1
            self.stats.gauge(f"replica.inflight.{g.name}", g.inflight)

    def _mark_unhealthy(self, g: GroupState, why: str) -> None:
        with self._mu:
            first = g.healthy
            g.healthy = False
            # Arm the probe backoff: first retry after the base
            # interval, doubling (with jitter) on every failed probe.
            if first:
                g.probe_delay = self.probe_interval_s
                g.probe_at = time.monotonic() + g.probe_delay * self._rng.uniform(0.5, 1.0)
        if not first:
            return
        self.stats.gauge(f"replica.healthy.{g.name}", 0)
        self.stats.count(f"replica.unhealthy.{g.name}")
        self.stats.set("replica.last_failure", f"{g.name}: {why}")

    def _mark_healthy(self, g: GroupState) -> None:
        with self._mu:
            if g.healthy:
                return
            g.healthy = True
            g.probe_delay = self.probe_interval_s
        self.stats.gauge(f"replica.healthy.{g.name}", 1)
        self.stats.count("replica.recovered")

    def _mark_lagging(self, g: GroupState) -> None:
        """The group missed a sequenced write: out of the read rotation
        until catch-up replays it to its shard's WAL head."""
        sh = self._group_shard.get(g)
        (sh if sh is not None else self.shards[0])._mark_lagging(g)

    def _backoff(self, g: GroupState) -> None:
        """One failed probe: double the group's retry delay (jittered,
        capped) so a dead group is not hammered in lockstep."""
        with self._mu:
            g.probe_delay = min(
                self.probe_max_interval_s,
                max(self.probe_interval_s, g.probe_delay * 2.0),
            )
            g.probe_at = time.monotonic() + g.probe_delay * self._rng.uniform(0.5, 1.5)

    def _note_epoch(self, g: GroupState, hdr: Optional[str]) -> None:
        """Track the group identity header; a changed epoch means the
        group restarted (in-memory generation vectors rebuilt) — counted
        so dashboards can correlate it with that group's cold caches.
        Called from every forward path (handler threads, probe thread),
        so the epoch write takes the table lock like any other
        GroupState mutation."""
        if not hdr:
            return
        with self._mu:
            bumped = g.epoch is not None and g.epoch != hdr
            g.epoch = hdr
        if bumped:
            self.stats.count("replica.epoch_bump")

    def _note_applied(self, g: GroupState, hdr: Optional[str]) -> None:
        """Passive lag tracking: every group response reports its
        applied sequence high-water mark.  The monotonic-max update is
        a read-modify-write, so it must hold the table lock — two
        concurrent responses would otherwise drop the higher mark."""
        if not hdr:
            return
        try:
            seq = int(hdr)
        except ValueError:
            return
        sh = self._group_shard.get(g)
        wal = sh.wal if sh is not None else self.wal
        with self._mu:
            g.applied_seq = max(g.applied_seq, seq)
            applied = g.applied_seq
            spec.emit("mark", src=id(wal), group=g.name,
                      epoch=g.epoch, value=applied)
        self.stats.gauge(
            f"replica.lag.{g.name}", max(0, wal.last_seq - applied)
        )

    def healthy_count(self) -> int:
        with self._mu:
            return sum(1 for g in self.groups if g.healthy)

    def quorate(self) -> bool:
        """True when writes can commit EVERYWHERE: every shard has at
        least a MAJORITY of its group set in rotation (healthy + caught
        up + not stale).  Minority outages degrade durability of the
        margin, not availability — each shard's WAL replays the missed
        suffix to its laggards."""
        return all(sh.quorate() for sh in self.shards)

    # -- the hop ----------------------------------------------------------

    def _forward(self, g: GroupState, method: str, path_qs: str, body: bytes,
                 headers: dict, deadline=None, trace_id: str = "",
                 extra_headers: Optional[dict] = None,
                 timeout_s: Optional[float] = None):
        """One HTTP exchange with a group.  Returns (status, ctype,
        payload, response headers); raises OSError on a connect/transport
        failure (the caller's failover trigger).  ``extra_headers``
        carries router-owned headers (write sequence, replay marker);
        ``timeout_s`` tightens the socket below ``self.timeout`` (the
        locked catch-up drain's per-record bound)."""
        try:
            self.faults.hit("forward", key=g.name)
        except InjectedStatus as e:
            rh = {"Retry-After": "0.250"} if e.status in (429, 503) else {}
            return (
                e.status, "application/json",
                json.dumps({"error": str(e)}).encode(), rh,
            )
        fwd = {k: v for k, v in headers.items() if k.lower() not in _HOP_HEADERS}
        timeout = self.timeout
        if timeout_s is not None:
            timeout = min(timeout, max(timeout_s, 0.001))
        if deadline is not None:
            # Hop rule (qos/deadline.py): forward the REMAINING budget,
            # tighten the socket to match (+1s for the 504 to travel).
            fwd[DEADLINE_HEADER] = deadline.header_value()
            timeout = min(timeout, deadline.remaining_ms() / 1000.0 + 1.0)
        if trace_id:
            fwd[TRACE_HEADER] = trace_id
        if extra_headers:
            fwd.update(extra_headers)
        req = urllib.request.Request(
            g.base + path_qs, data=body if body else None, method=method
        )
        for k, v in fwd.items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                status, payload, rheaders = resp.status, resp.read(), resp.headers
        except urllib.error.HTTPError as e:
            status, payload, rheaders = e.code, e.read(), e.headers
        except urllib.error.URLError as e:
            # Normalize to OSError for the failover path (URLError wraps
            # the socket-level reason).
            raise OSError(str(e.reason))
        self._note_epoch(g, rheaders.get(GROUP_HEADER))
        self._note_applied(g, rheaders.get(APPLIED_SEQ_HEADER))
        return status, rheaders.get("Content-Type", "application/json"), payload, rheaders

    # -- read path --------------------------------------------------------

    @staticmethod
    def _slices_param(query: str) -> Optional[list]:
        """The ``slices=`` query parameter as an int list (None when
        absent or malformed — malformed means "all slices", the safe
        over-approximation, never a 400 on the read path)."""
        vals = parse_qs(query).get("slices")
        if not vals:
            return None
        try:
            return [int(s) for s in vals[0].split(",") if s.strip()]
        except ValueError:
            return None

    def _read_targets(self, path: str, query: str, headers: dict):
        """The shards a read must touch.  Single-shard maps (the
        default) short-circuit to shard 0; multi-shard maps compute the
        slice cover: a ``slices=`` query param fans only to the owners
        of those slices (exact and minimal — K shards cost exactly K
        forwards), an unscoped query spans the whole slice space, and
        slice-addressed fragment reads go to the one owner."""
        if len(self.shards) == 1:
            return [self.shards[0]]
        if path == "/fragment/data":
            vals = parse_qs(query).get("slice")
            if vals:
                try:
                    return [self._shard_for_slice(int(vals[0]))]
                except ValueError:
                    pass
            return [self.shards[0]]
        if _QUERY_PATH_RE.match(path):
            slices = self._slices_param(query)
            if slices is None:
                return list(self.shards)
            cover = self.shard_map.cover(slices)
            return [sh for sh in self.shards if sh.name in cover]
        if path == "/slices/max":
            return list(self.shards)
        # Schema/status/admin reads: identical on every shard (mutating
        # admin fans to all of them) — any one shard answers.
        return [self.shards[0]]

    def _route_read(self, method: str, path_qs: str, body: bytes, headers: dict,
                    deadline=None, trace=None):
        parsed = urlparse(path_qs)
        targets = self._read_targets(parsed.path, parsed.query, headers)
        if not targets:
            # An empty cover (slices= named no slice any shard owns is
            # impossible — the map is total — but an empty list is):
            # nothing to scan, an empty result.
            return 200, "application/json", b'{"results": []}', {}
        if len(targets) == 1:
            return self._route_read_one(targets[0], method, path_qs, body,
                                        headers, deadline=deadline, trace=trace)
        if "application/x-protobuf" in (headers.get("accept") or ""):
            return (
                501, "application/json",
                json.dumps({"error": "protobuf responses cannot be merged "
                            "across shards; use JSON or scope the query "
                            "with slices="}).encode(), {},
            )
        outs = []
        for sh in targets:
            out = self._route_read_one(sh, method, path_qs, body, headers,
                                       deadline=deadline, trace=trace)
            if out[0] >= 300:
                return out  # one shard's failure is the read's failure
            outs.append(out)
        self.stats.count("replica.shard.read_fanout")
        if parsed.path == "/slices/max":
            merged: dict = {}
            for _st, _ct, payload, _h in outs:
                try:
                    for idx, mx in (json.loads(payload).get("maxSlices") or {}).items():
                        merged[idx] = max(merged.get(idx, 0), int(mx))
                except (ValueError, TypeError):
                    pass
            body_out = json.dumps({"maxSlices": merged}).encode()
        else:
            body_out = _merge_query_payloads([o[2] for o in outs])
        return 200, "application/json", body_out, {GROUP_HEADER: "all"}

    def _route_read_one(self, sh, method: str, path_qs: str, body: bytes,
                        headers: dict, deadline=None, trace=None):
        g = sh._pick()
        if g is None:
            return self._shed(
                503, f"no healthy replica group in shard {sh.name}",
                retry_after=1.0,
            )
        attempt, first, last = 0, g, g
        while True:
            last = g
            sp = trace.root.child("forward") if trace is not None else None
            try:
                out = self._forward(
                    g, method, path_qs, body, headers, deadline=deadline,
                    trace_id=(trace.id if trace is not None else ""),
                )
            except OSError as e:
                self._release(g)
                if sp is not None:
                    sp.finish().annotate(group=g.name, error=str(e))
                self._mark_unhealthy(g, str(e))
                out = None
            else:
                self._release(g)
                if sp is not None:
                    sp.finish().annotate(group=g.name, status=out[0])
                    raw = out[3].get(TRACE_SPANS_HEADER)
                    if raw:
                        try:
                            sp.graft(json.loads(raw))
                        except ValueError:
                            pass
                if out[0] < 500 or out[0] == 504:
                    # <500 is an answer; 504 is deadline-exceeded for
                    # THIS request's own budget — request-scoped, not a
                    # group-health signal, so it must never demote the
                    # group (a burst of tight-deadline reads would
                    # otherwise mark every group unhealthy and refuse
                    # all writes via the quorum rule).
                    if trace is not None:
                        trace.root.tags["group"] = g.name
                    extra = {GROUP_HEADER: out[3].get(GROUP_HEADER) or g.name}
                    ra = out[3].get("Retry-After")
                    if ra:
                        extra["Retry-After"] = ra
                    return out[0], out[1], out[2], extra
                # Other 5xx: this group cannot serve; a degraded
                # lockstep group answers 503 until its job restarts, so
                # stop routing reads there and let the probe restore it.
                self._mark_unhealthy(g, f"HTTP {out[0]} on read")
            # One-shot failover: reads are side-effect-free, so the
            # retry on a sibling (of the SAME shard — only it holds the
            # slices) is always safe.
            if not self.failover or attempt >= 1:
                break
            attempt += 1
            g = sh._pick(exclude=first)
            if g is None:
                break
            self.stats.count("replica.failover")
        if out is not None:
            return out[0], out[1], out[2], {GROUP_HEADER: last.name}
        return self._shed(503, "replica group unreachable", retry_after=1.0)

    # -- write path -------------------------------------------------------

    def _route_write(self, method: str, path_qs: str, body: bytes, headers: dict,
                     deadline=None, trace=None, fan_admin: bool = False):
        """Route one write.  A single-shard map (the default) sequences
        straight into shard 0 — the pre-shard fast path, byte-for-byte
        the old router.  A multi-shard map routes by slice ownership:

        - mutating ADMIN (schema, deletions) fans to EVERY shard —
          replicated schema must stay identical across the whole mesh;
        - ``/fragment/data`` posts route by their ``slice=`` param;
        - PQL write bodies route by ``columnID // SLICE_WIDTH``: one
          owning shard sequences the whole body, a body spanning shards
          is SPLIT into per-shard sub-batches (each sequenced in its
          owner's space, results reassembled in call order), and
          column-free calls (SetRowAttrs — row metadata lives
          everywhere) broadcast to all shards;
        - streaming ingest (``/import``, restore) and bodies mixing
          reads with multi-shard writes answer 501 — they cannot be
          slice-routed; scope them per shard or run a single-shard map
          (documented in DEVELOPMENT.md).

        Two shards' sequencers are DIFFERENT lock instances, so their
        fan-outs run concurrently — write throughput scales with the
        shard axis."""
        if len(self.shards) == 1:
            return self.shards[0].sequence_write(
                method, path_qs, body, headers, deadline=deadline, trace=trace
            )
        parsed = urlparse(path_qs)
        if fan_admin:
            return self._sequence_all(method, path_qs, body, headers,
                                      deadline=deadline, trace=trace)
        if parsed.path == "/fragment/data":
            vals = parse_qs(parsed.query).get("slice")
            if vals:
                try:
                    sh = self._shard_for_slice(int(vals[0]))
                except (ValueError, ShardMapError):
                    sh = None
                if sh is not None:
                    return sh.sequence_write(method, path_qs, body, headers,
                                             deadline=deadline, trace=trace)
        if _QUERY_PATH_RE.match(parsed.path):
            return self._route_query_write(method, path_qs, body, headers,
                                           deadline=deadline, trace=trace)
        self.stats.count("replica.shard.unroutable")
        return (
            501, "application/json",
            json.dumps({"error": f"{method} {parsed.path} cannot be routed "
                        "across a partitioned shard map; address one shard's "
                        "slice range or run a single-shard layout"}).encode(),
            {},
        )

    def _route_query_write(self, method: str, path_qs: str, body: bytes,
                           headers: dict, deadline=None, trace=None):
        """Slice-route a PQL write body under a multi-shard map (see
        _route_write's routing table)."""
        try:
            q = pql.parse_cached(body.decode("utf-8"))
        except (pql.ParseError, UnicodeDecodeError):
            # Unparsable bodies 400 deterministically wherever they
            # land: shard 0 sequences it and the deterministic-4xx rule
            # tombstones the record.
            return self.shards[0].sequence_write(
                method, path_qs, body, headers, deadline=deadline, trace=trace
            )
        by_shard: dict = {}  # shard name -> original call indexes
        broadcast = False
        for i, call in enumerate(q.calls):
            if call.name not in WRITE_CALL_NAMES:
                # A read mixed into a multi-shard write body would need
                # its result merged ACROSS shards mid-sequence — refuse
                # rather than answer it from one shard's slice subset.
                self.stats.count("replica.shard.unroutable")
                return (
                    501, "application/json",
                    json.dumps({"error": f"call {call.name} mixes reads into "
                                "a write body; multi-shard maps require "
                                "write-only bodies on the write path"}).encode(),
                    {},
                )
            if call.name == "SetRowAttrs":
                broadcast = True  # row metadata lives on every shard
                continue
            try:
                col, ok = call.uint_arg("columnID")
            except TypeError:
                ok = False
            if not ok:
                self.stats.count("replica.shard.unroutable")
                return (
                    501, "application/json",
                    json.dumps({"error": f"call {call.name} carries no integer "
                                "columnID; custom column labels are not "
                                "slice-routable — use a single-shard map"}).encode(),
                    {},
                )
            sh = self._shard_for_slice(col // SLICE_WIDTH)
            by_shard.setdefault(sh.name, []).append(i)
        if broadcast and by_shard:
            self.stats.count("replica.shard.unroutable")
            return (
                501, "application/json",
                json.dumps({"error": "body mixes broadcast calls "
                            "(SetRowAttrs) with column-routed writes; send "
                            "them as separate requests"}).encode(),
                {},
            )
        if broadcast:
            return self._sequence_all(method, path_qs, body, headers,
                                      deadline=deadline, trace=trace)
        if len(by_shard) == 1:
            sh = self._shard_by_name(next(iter(by_shard)))
            return sh.sequence_write(method, path_qs, body, headers,
                                     deadline=deadline, trace=trace)
        # SPLIT: per-shard sub-batches in deterministic shard order,
        # each sequenced in its owner's space; results reassembled in
        # the original call order.  A failed sub-batch surfaces its
        # error — already-committed shards keep theirs, and the client's
        # idempotent retry realigns the rest.
        self.stats.count("replica.shard.split_writes")
        results: list = [None] * len(q.calls)
        last = None
        for name in sorted(by_shard):
            sh = self._shard_by_name(name)
            idxs = by_shard[name]
            sub = " ".join(str(q.calls[i]) for i in idxs).encode()
            out = sh.sequence_write(method, path_qs, sub, headers,
                                    deadline=deadline, trace=trace)
            if out[0] >= 300:
                return out
            try:
                rs = json.loads(out[2]).get("results") or []
            except (ValueError, AttributeError):
                rs = []
            for k, i in enumerate(idxs):
                results[i] = rs[k] if k < len(rs) else None
            last = out
        return (
            200, last[1] if last else "application/json",
            json.dumps({"results": results}).encode(),
            {GROUP_HEADER: "all"},
        )

    def _shard_by_name(self, name: str):
        for sh in self.shards:
            if sh.name == name:
                return sh
        raise ShardMapError(f"no runtime for shard {name}")

    def _sequence_all(self, method: str, path_qs: str, body: bytes,
                      headers: dict, deadline=None, trace=None):
        """Sequence one write into EVERY shard (mutating admin,
        broadcast PQL): each shard's own sequencer orders it against
        that shard's writes.  The first failing shard's answer surfaces
        — shards that already committed keep the write (idempotent
        re-apply is the contract), and the retry realigns the rest."""
        out = None
        for sh in self.shards:
            out = sh.sequence_write(method, path_qs, body, headers,
                                    deadline=deadline, trace=trace)
            if out[0] >= 300:
                return out
        self.stats.count("replica.shard.fanout_writes")
        return out

    def _partial_write(self, failed_names: str):
        """A write reached fewer than a majority of groups: 502 tells
        the client it may be partially applied — the WAL record stays,
        the lagging groups replay it during catch-up, and the
        idempotent client retry is harmless either way."""
        return (
            502,
            "application/json",
            json.dumps({
                "error": f"write failed on group(s) {failed_names}; "
                "may be partially applied — retry when the group set is quorate"
            }).encode(),
            {"Retry-After": "1.000"},
        )

    def _shed(self, status: int, message: str, retry_after: float = 1.0):
        """A router-door refusal (non-quorate write, no healthy group,
        WAL failure).  The Retry-After hint carries DECORRELATED JITTER
        (mirroring the client-side retry budget's jitter): a
        fixed hint makes a synchronized client herd retry in lockstep
        against a recovering cluster — the exact moment it can least
        absorb a coordinated burst.  Jitter here spreads even clients
        that obey the hint literally."""
        jittered = max(0.05, self._rng.uniform(retry_after * 0.5,
                                               retry_after * 1.5))
        return (
            status,
            "application/json",
            json.dumps({"error": message}).encode(),
            {"Retry-After": f"{jittered:.3f}"},
        )

    # -- WAL compaction / backlog bound -----------------------------------

    def _maybe_compact(self) -> None:
        """Per-shard compaction (see ShardRuntime._maybe_compact —
        each shard's log advances past ITS min-applied watermark)."""
        for sh in self.shards:
            sh._maybe_compact()

    # -- dispatch ---------------------------------------------------------

    def handle(self, method: str, path_qs: str, body: bytes, headers: dict):
        """Serve one request.  Returns (status, ctype, payload, extra
        headers).  ``headers`` keys must be lowercase."""
        parsed = urlparse(path_qs)
        path = parsed.path
        if method == "GET" and path == "/debug/vars":
            snap = self.stats.snapshot() if hasattr(self.stats, "snapshot") else {}
            return 200, "application/json", (json.dumps(snap) + "\n").encode(), {}
        if method == "GET" and path == "/metrics":
            return (
                200, metrics_mod.CONTENT_TYPE,
                metrics_mod.render(self.stats).encode(), {},
            )
        if method == "GET" and path == "/debug/traces":
            return self._debug_traces(parse_qs(parsed.query))
        if method == "GET" and path == "/debug/fleet":
            return self._debug_fleet(parse_qs(parsed.query))
        if method == "GET" and path == "/replica/status":
            return self._replica_status()
        if method == "POST" and path == "/replica/reshard":
            # Router-owned admin: operates the routing gate itself, so
            # it must never pass THROUGH the gate.
            return self._handle_reshard(body)

        deadline = qos.deadline_from_headers(headers, self.default_deadline_ms)
        if deadline is not None and deadline.expired():
            return (
                504, "application/json",
                json.dumps({"error": "deadline exceeded (router)"}).encode(), {},
            )
        cls = qos.classify_request(method, path, body)
        # [tenancy]: the router-door fair-share gate.  The tenant is
        # resolved through the SAME seam the handler and the lockstep
        # front end use (header > map > index name > default), and the
        # door is the same AdmissionController the servers run — an
        # over-share tenant sheds 429+Retry-After HERE, before its
        # request costs a single group-side socket.
        tenant = None
        if self.admission is not None:
            if self.tenancy is not None:
                tenant = self.tenancy.resolve(path, headers)
            try:
                self.admission.acquire(cls, deadline, tenant=tenant)
            except qos.ShedError as e:
                self.stats.count("replica.router.shed")
                return self._shed(e.status, str(e), retry_after=e.retry_after)
        try:
            return self._handle_routed(
                method, path_qs, path, body, headers, deadline, cls
            )
        finally:
            if self.admission is not None:
                self.admission.release(cls, tenant=tenant)

    def _handle_routed(self, method, path_qs, path, body, headers,
                       deadline, cls):
        """The routed section of ``handle`` — everything past the
        tenancy door (the door must release on EVERY exit path)."""
        # Mutating admin (schema, deletions) must apply to EVERY group or
        # the replicas' schemas diverge; admin GETs route like reads.
        fan_all = cls == qos.CLASS_WRITE or (
            cls == qos.CLASS_ADMIN and method in ("POST", "DELETE", "PATCH")
        )
        trace = (
            self.tracer.begin(headers, name=f"{method} {path}")
            if self.tracer is not None
            else None
        )
        t0 = time.perf_counter()
        # Every routed request crosses the gate: an in-flight reshard
        # flip holds newcomers here (bounded — the fence is a drain plus
        # a delta stream, not a full copy) so no request can observe two
        # owners for one slice.  Ungated state (the steady state) costs
        # two uncontended lock hops.
        self._gate_enter()
        try:
            if fan_all:
                out = self._route_write(
                    method, path_qs, body, headers, deadline=deadline,
                    trace=trace, fan_admin=(cls == qos.CLASS_ADMIN),
                )
            else:
                out = self._route_read(method, path_qs, body, headers,
                                       deadline=deadline, trace=trace)
        finally:
            self._gate_exit()
            if trace is not None:
                self.tracer.release(trace)
        if self.tracer is not None:
            extra = self.tracer.finish_request(
                trace, name=f"{method} {path}",
                dt_ms=(time.perf_counter() - t0) * 1e3,
                body=body, status=out[0],
            )
            if extra:
                merged = dict(out[3])
                merged.update(extra)
                out = (out[0], out[1], out[2], merged)
        return out

    def _gate_enter(self) -> None:
        with self._gate_cv:
            while self._gated:
                self._gate_cv.wait(timeout=30.0)
            self._active_routed += 1

    def _gate_exit(self) -> None:
        with self._gate_cv:
            self._active_routed -= 1
            self._gate_cv.notify_all()

    def _replica_status(self):
        with self._mu:
            table = [g.to_json() for g in self.groups]
            heads = {sh.name: sh.wal.last_seq for sh in self.shards}
        shard_of = {g.name: self._group_shard[g].name for g in self.groups}
        for t in table:
            # Lag is measured against the group's OWN shard's head —
            # cross-shard sequence numbers are unrelated.
            t["shard"] = shard_of.get(t["name"])
            t["lag"] = max(0, heads.get(t["shard"], 0) - t["appliedSeq"])
        payload = json.dumps({
            "groups": table,
            "quorate": self.quorate(),
            "quorum": self.quorum,
            "write_seq": self.write_seq,
            "wal": self.shards[0].wal_json(),
            "mapEpoch": self.map_epoch,
            "shards": [sh.to_json() for sh in self.shards],
        }).encode()
        return 200, "application/json", payload, {}

    def _debug_traces(self, params: dict):
        if self.tracer is None:
            return 200, "application/json", b'{"traces": []}\n', {}
        # Malformed/out-of-range filters clamp to defaults — a debug
        # endpoint must answer, not 400 (same contract as the handler).
        min_ms = metrics_mod.clamp_float((params.get("min-ms") or [None])[0], 0.0)
        limit = metrics_mod.clamp_int((params.get("limit") or [None])[0], 64)
        payload = json.dumps(
            {"traces": self.tracer.traces_json(min_ms=min_ms, limit=limit)}
        ).encode()
        return 200, "application/json", payload, {}

    # -- /debug/fleet: the cluster-wide observability view ----------------

    def _scrape_group(self, base: str, timeout_s: float):
        """One group scrape: /replica/health (authoritative liveness +
        applied sequence) and /debug/vars (the group's own stats
        snapshot).  Returns (scrape dict, None) on success or
        (None, error string) when the health probe fails; a vars
        failure degrades to health-only rather than failing the
        scrape."""
        out: dict = {}
        try:
            req = urllib.request.Request(base + "/replica/health", method="GET")
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                out["health"] = json.loads(resp.read() or b"{}")
        except (urllib.error.URLError, OSError, ValueError) as e:
            return None, f"health: {e}"
        try:
            req = urllib.request.Request(base + "/debug/vars", method="GET")
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                vars_snap = json.loads(resp.read() or b"{}")
        except (urllib.error.URLError, OSError, ValueError) as e:
            vars_snap = {}
            out["varsError"] = str(e)
        out["appliedSeq"] = out["health"].get("appliedSeq")
        # Latency percentiles ride the group's qos.latency_ms.<class>
        # histograms; the rest of the snapshot is served verbatim.
        out["latencyMs"] = {
            key.split("qos.latency_ms.", 1)[1]: val
            for key, val in vars_snap.items()
            if key.startswith("qos.latency_ms.") and isinstance(val, dict)
        }
        # Per-tenant rows off the group's own counters: every
        # tenancy.<series>.<tenant> key pivots into tenant -> series so
        # the fleet view answers "which tenant is this group shedding"
        # without a per-group scrape by the operator.
        tenants: dict = {}
        for key, val in vars_snap.items():
            if not key.startswith("tenancy."):
                continue
            rest = key.split("tenancy.", 1)[1]
            series, _, tenant = rest.partition(".")
            if tenant:
                tenants.setdefault(tenant, {})[series] = val
        out["tenants"] = tenants
        out["vars"] = vars_snap
        return out, None

    def _debug_fleet(self, params: dict):
        """Aggregate every group's stats/health/applied-seq plus the
        router's own WAL + resync/anti-entropy progress into one
        cluster-wide JSON view.  A down group yields a PARTIAL entry:
        the router-side table row, the error, and the last successful
        scrape (if any) stamped with its age."""
        timeout_s = metrics_mod.clamp_float(
            (params.get("timeout-ms") or [None])[0], 750.0, lo=50.0, hi=10_000.0
        ) / 1e3
        now = time.time()
        with self._mu:
            table = {g.name: g.to_json() for g in self.groups}
            heads = {sh.name: sh.wal.last_seq for sh in self.shards}
            # Shard-qualified floors (single-shard keeps bare group
            # names — the pre-shard payload shape).
            if len(self.shards) == 1:
                floors = dict(self._resync_floor)
            else:
                floors = {
                    f"{sh.name}/{gname}": seq
                    for sh in self.shards
                    for gname, seq in sh._resync_floor.items()
                }
        shard_of = {g.name: self._group_shard[g].name for g in self.groups}
        groups_out = []
        scraped_ok = 0
        for name, row in table.items():
            entry = dict(row)
            entry["shard"] = shard_of.get(name)
            # Per-(shard, group) WAL depth: committed records of ITS
            # shard this group has not applied yet (what catch-up will
            # replay to it).
            entry["walDepth"] = max(
                0, heads.get(entry["shard"], 0) - entry["appliedSeq"]
            )
            scrape, err = self._scrape_group(entry["base"], timeout_s)
            if scrape is not None:
                scrape["scrapedAt"] = round(now, 3)
                with self._fleet_mu:
                    self._fleet_cache[name] = scrape
                scraped_ok += 1
            else:
                entry["error"] = err
                with self._fleet_mu:
                    scrape = self._fleet_cache.get(name)
            if scrape is not None:
                entry["scrape"] = scrape
                entry["scrapedAt"] = scrape["scrapedAt"]
                entry["ageMs"] = round(max(0.0, (now - scrape["scrapedAt"]) * 1e3), 1)
            else:
                entry["scrape"] = None
                entry["scrapedAt"] = None
                entry["ageMs"] = None
            entry["staleScrape"] = "error" in entry
            groups_out.append(entry)
        router_stats = (
            self.stats.snapshot() if hasattr(self.stats, "snapshot") else {}
        )
        payload = {
            "ts": round(now, 3),
            "quorum": self.quorum,
            "quorate": self.quorate(),
            "writeSeq": self.write_seq,
            "wal": self.shards[0].wal_json(),
            "mapEpoch": self.map_epoch,
            "shards": [sh.to_json() for sh in self.shards],
            "resyncFloors": floors,
            # Router-side progress counters (resync/catch-up/anti-entropy
            # rounds, divergence, fan-out outcomes) all live under the
            # replica.* prefix.
            "routerStats": {
                k: v for k, v in router_stats.items()
                if k.startswith("replica.")
            },
            "partial": scraped_ok < len(table),
            # Router-door fair-share state (weights, inflight, debt,
            # shed counts per tenant) — {} when tenancy is off.
            "tenants": (
                self.admission.tenants_snapshot()
                if self.admission is not None
                else {}
            ),
            "groups": groups_out,
        }
        return 200, "application/json", (json.dumps(payload) + "\n").encode(), {}

    # -- health probe + catch-up ------------------------------------------

    def _probe_once(self) -> None:
        for sh in self.shards:
            self._probe_shard(sh)

    def _probe_shard(self, sh) -> None:
        now = time.monotonic()
        with self._mu:
            # STALE groups stay in the rotation (at probe-max-interval
            # cadence, armed when they went stale): the automated
            # resync needs a live door back in, and so does an
            # operator-resynced group.
            due = [
                g for g in sh.groups
                if (not g.healthy or not g.caught_up or g.stale)
                and g.probe_at <= now
            ]
        for g in due:
            try:
                req = urllib.request.Request(g.base + "/replica/health", method="GET")
                with urllib.request.urlopen(req, timeout=2.0) as resp:
                    ok = resp.status == 200
                    hdr = resp.headers.get(GROUP_HEADER)
                    try:
                        health = json.loads(resp.read())
                    except ValueError:
                        health = {}
            except (urllib.error.URLError, OSError):
                # Unreachable OR alive-but-degraded (an HTTPError is a
                # URLError): back the probe off and try again later.
                self._backoff(g)
                continue
            if not ok:
                self._backoff(g)
                continue
            self._note_epoch(g, hdr)
            reported = health.get("appliedSeq")
            if reported is not None:
                # The probe is AUTHORITATIVE for a restarted group: a
                # fresh incarnation reports where its persisted state
                # actually stands, which may be BEHIND what the router
                # remembered of its predecessor.
                with self._mu:
                    g.applied_seq = int(reported)
                    spec.emit("probe_mark", src=id(sh.wal), group=g.name,
                              epoch=g.epoch, value=int(reported))
                self.stats.gauge(
                    f"replica.lag.{g.name}",
                    max(0, sh.wal.last_seq - int(reported)),
                )
            if g.suspect:
                # The group 4xx'd a write a sibling applied: content
                # presumed diverged until a digest check against a
                # donor clears it (resyncing on mismatch).
                if not sh.resync.verify(g):
                    self._backoff(g)
                    continue
            if sh.resync.needed(g):
                # Stale (the shard's WAL compacted past its lag), blank
                # (applied_seq=0 over a non-empty sequence space), or
                # an uncovered gap: replay alone cannot (or should not,
                # write by write) converge it — drive a fragment-level
                # RESYNC round instead of parking it for an operator.
                if not sh.resync.resync(g):
                    self._backoff(g)
                    continue
            elif reported is not None and sh.catchup.needed(g):
                if not sh.catchup.catch_up(g):
                    self._backoff(g)
                    continue
            else:
                # Legacy group (no applied-seq reporting) or already at
                # the head: nothing to replay.
                with self._mu:
                    g.caught_up = True
            self.stats.gauge(f"replica.lag.{g.name}", 0)
            self._mark_healthy(g)

    def _probe_loop(self) -> None:
        tick = min(max(self.probe_interval_s / 4.0, 0.02), 0.5)
        while not self._stop.wait(tick):
            try:
                self._probe_once()
            except Exception:  # noqa: BLE001 — the probe must never die
                self.stats.count("replica.probe_errors")

    # -- anti-entropy sweep -----------------------------------------------

    def _anti_entropy_once(self) -> None:
        """One cross-group divergence sweep: fetch every in-rotation
        group's content digest under the sequencer lock (a CONSISTENT
        CUT — no write can be sequenced between the fetches, so a
        mid-sweep write cannot masquerade as divergence), compare, and
        repair any mismatched fragment from the majority copy via the
        resync fragment stream.  Divergence is counted per group
        (``replica.divergence.<g>``) and logged as one structured
        ``pilosa_tpu_torch.divergence`` line naming the first differing
        (index, frame, view, slice) path — a correctness event, never
        silent.  The repair work under the lock is budget-bounded
        (``anti_entropy_budget_s``); an over-budget sweep stops and the
        next sweep finishes."""
        for sh in self.shards:
            self._anti_entropy_shard(sh)

    def _anti_entropy_shard(self, sh) -> None:
        """One shard's divergence sweep: digests are only comparable
        WITHIN a shard's group set (siblings hold the same slice
        range), so the sweep runs per shard under that shard's
        sequencer."""
        ready = sh._ready_groups()
        if len(ready) < 2:
            return
        self.stats.count("replica.antientropy_rounds")
        by_name = {g.name: g for g in ready}
        with sh._seq_mu:
            digests: dict[str, dict] = {}
            for g in ready:
                try:
                    digests[g.name] = sh.resync._digest(g)
                except (OSError, ResyncAbort):
                    # A group that cannot answer is the probe's problem,
                    # not this sweep's — compare whoever answered.
                    self.stats.count("replica.antientropy_abort")
                    return
            if len({d.get("digest") for d in digests.values()}) == 1:
                return  # the common case: one string compare, no walk
            plan = majority_plan(digests)
            if not plan.divergent:
                # Digests differ only in schema (an empty index one
                # group lacks): no fragment carries different bits, so
                # nothing to repair — still worth a counter.
                self.stats.count("replica.antientropy_schema_only")
                return
            for name in sorted(plan.divergent):
                self.stats.count(f"replica.divergence.{name}")
            _divergence_logger.warning(
                "divergence %s",
                json.dumps({
                    "groups": sorted(plan.divergent),
                    "first_path": plan.first_path,
                    "paths": sum(len(p) for p in plan.divergent.values()),
                    "write_seq": sh.write_seq,
                    "shard": sh.name,
                }, separators=(",", ":")),
            )
            deadline = time.monotonic() + self.anti_entropy_budget_s
            for name in sorted(plan.divergent):
                g = by_name[name]
                for path in plan.divergent[name]:
                    if time.monotonic() > deadline:
                        self.stats.count("replica.antientropy_stall")
                        return
                    donor = by_name[plan.donor[path]]
                    try:
                        sh.resync._stream_fragment(donor, g, path, g.epoch)
                    except (OSError, ResyncAbort):
                        self.stats.count("replica.antientropy_abort")
                        return
                    self.stats.count("replica.divergence_repaired")

    def _anti_entropy_loop(self) -> None:
        base = self.anti_entropy_interval_s
        while not self._stop.wait(base * self._rng.uniform(0.75, 1.25)):
            try:
                self._anti_entropy_once()
            except Exception:  # noqa: BLE001 — the sweep must never die
                self.stats.count("replica.antientropy_errors")

    # -- live resharding ---------------------------------------------------

    def _handle_reshard(self, body: bytes):
        """``POST /replica/reshard``: split one shard live.  Body::

            {"shard": "s0", "at": 4, "name": "s1",
             "groups": ["g2=host:port", "g3=host:port"]}

        moves slices ``[at, hi)`` of ``shard`` onto the brand-new
        ``groups`` (every spec explicitly named) with zero downtime and
        zero failed writes: bulk fragments PRE-STREAM while the old
        shard keeps serving, then the routing gate drains in-flight
        requests, the (small) delta streams, the map flips behind a
        bumped ownership epoch, the moved range is cleared off the old
        owners, and the old WAL compacts to head."""
        try:
            req = json.loads(body or b"{}")
            shard_name = str(req.get("shard") or "")
            at = int(req.get("at"))
            new_name = str(req.get("name") or f"s{len(self.shards)}")
            group_specs = [str(s) for s in (req.get("groups") or [])]
        except (ValueError, TypeError):
            self.stats.count("replica.reshard.refused")
            return (
                400, "application/json",
                json.dumps({"error": "reshard body must be JSON with "
                            "shard, at (int), groups[]"}).encode(), {},
            )
        try:
            return self._reshard(shard_name, at, new_name, group_specs)
        except ShardMapError as e:
            self.stats.count("replica.reshard.refused")
            return (
                400, "application/json",
                json.dumps({"error": str(e)}).encode(), {},
            )
        except (OSError, ResyncAbort) as e:
            # Data motion failed BEFORE the flip: nothing changed
            # ownership, partial fragments on the new groups are inert
            # (and the next attempt's stream resumes them).
            self.stats.count("replica.reshard.errors")
            return (
                502, "application/json",
                json.dumps({"error": f"reshard aborted: {e}"}).encode(), {},
            )

    def _reshard_refused(self, why: str):
        self.stats.count("replica.reshard.refused")
        return (
            409, "application/json",
            json.dumps({"error": f"reshard refused: {why}"}).encode(), {},
        )

    def _reshard(self, shard_name: str, at: int, new_name: str,
                 group_specs: list):
        t0 = time.perf_counter()
        old = self._shard_by_name(shard_name)  # ShardMapError on miss
        if at <= old.lo or (old.hi is not None and at >= old.hi):
            raise ShardMapError(
                f"split point {at} outside shard {shard_name}'s range "
                f"[{old.lo}, {old.hi if old.hi is not None else ''})"
            )
        if not group_specs:
            raise ShardMapError("reshard needs at least one new group")
        for gs_ in group_specs:
            head = gs_.split("=", 1)[0]
            if "=" not in gs_ or "://" in head:
                raise ShardMapError(
                    f"reshard group spec {gs_!r} must be name=host:port "
                    "(explicit names — positional g<i> names would collide)"
                )
        # Validate the candidate map BEFORE any data motion: the split
        # shard keeps [lo, at), the new shard takes [at, hi).
        cand = []
        for s in self.shard_map:
            if s.name == shard_name:
                cand.append(Shard(s.name, s.lo, at, s.group_specs))
                cand.append(Shard(new_name, at, s.hi, group_specs))
            else:
                cand.append(Shard(s.name, s.lo, s.hi, s.group_specs))
        new_map = ShardMap(cand)
        new_groups = [_parse_group_spec(0, gs_) for gs_ in group_specs]
        if {g.name for g in new_groups} & {g.name for g in self.groups}:
            raise ShardMapError("new group names collide with existing groups")
        # Cheap preconditions before moving a byte.
        if not old.quorate():
            return self._reshard_refused(f"shard {shard_name} is not quorate")
        for g in new_groups:
            try:
                st, _ct, _p, _h = self._forward(
                    g, "GET", "/replica/health", b"", {}, timeout_s=5.0
                )
            except OSError as e:
                return self._reshard_refused(f"new group {g.name}: {e}")
            if st != 200:
                return self._reshard_refused(
                    f"new group {g.name}: HTTP {st} on health probe"
                )
        donor = old.resync._pick_donor(None)
        if donor is None:
            return self._reshard_refused(
                f"shard {shard_name} has no donor group"
            )

        def _moved(path_key: str) -> bool:
            sl = parse_fragment_path(path_key)[3]
            return sl >= at and (old.hi is None or sl < old.hi)

        new_rt = ShardRuntime(
            self, Shard(new_name, at, old.hi, group_specs), new_groups,
            self._shard_wal(new_name),
        )
        moved_fragments = 0
        moved_bytes = 0
        # PHASE 1 — pre-stream (unfenced): schema plus the bulk of the
        # moved range copies while the old shard keeps serving; writes
        # landing during the copy are in the fence delta.
        donor_digest = old.resync._digest(donor)
        pre = {
            p: c for p, c in (donor_digest.get("fragments") or {}).items()
            if _moved(p)
        }
        for g in new_groups:
            target_digest = old.resync._digest(g)
            old.resync._push_schema(donor_digest, target_digest, g, None)
            have = target_digest.get("fragments") or {}
            for p, chk in sorted(pre.items()):
                if have.get(p) == chk:
                    continue  # a resumed attempt already moved it
                # A fragment the target lacks entirely may negotiate
                # the columnar (Arrow -> /bulk) path when enabled.
                moved_bytes += old.resync._stream_fragment(
                    donor, g, p, None, laggard_empty=p not in have
                )
                moved_fragments += 1
        # PHASE 2 — the epoch fence: hold new routed requests at the
        # gate, drain the in-flight ones, stream the (small) delta,
        # flip.  No lock is held across any socket — the gate is a
        # flag; blocked requests wait on the condition, not on us.
        with self._gate_cv:
            self._gated = True
            fence_deadline = time.monotonic() + 30.0
            while self._active_routed > 0:
                if time.monotonic() > fence_deadline:
                    self._gated = False
                    self._gate_cv.notify_all()
                    return self._reshard_refused(
                        "fence drain timed out with requests in flight"
                    )
                self._gate_cv.wait(timeout=1.0)
        t_fence = time.perf_counter()
        try:
            # Delta: whatever the moved range gained (or lost) since the
            # pre-stream.  The gate guarantees no new write can land, so
            # this digest is the final pre-flip truth.
            delta_digest = old.resync._digest(donor)
            post = {
                p: c
                for p, c in (delta_digest.get("fragments") or {}).items()
                if _moved(p)
            }
            changed = [p for p, c in sorted(post.items()) if pre.get(p) != c]
            vanished = [p for p in sorted(pre) if p not in post]
            for g in new_groups:
                for p in changed + vanished:
                    moved_bytes += old.resync._stream_fragment(donor, g, p, None)
                    moved_fragments += 1
            # THE FLIP: reference-swap the map, the runtime list, and
            # the group->shard table (readers on other threads see the
            # old or the new object, never a half-built one), then bump
            # the ownership epoch.
            old.hi = at
            self.shard_map = new_map
            self.shards = sorted(self.shards + [new_rt], key=lambda r: r.lo)
            self.groups = self.groups + new_groups
            gmap = dict(self._group_shard)
            for g in new_groups:
                gmap[g] = new_rt
            self._group_shard = gmap
            self.map_epoch += 1
            spec.emit("reshard", src=id(self), epoch=self.map_epoch,
                      shard=shard_name, new=new_name, at=at)
            self.stats.gauge("replica.shard.count", len(self.shards))
            self.stats.gauge("replica.shard.map_epoch", self.map_epoch)
            for g in new_groups:
                self.stats.gauge(f"replica.healthy.{g.name}", 1)
                self.stats.gauge(f"replica.inflight.{g.name}", 0)
                self.stats.gauge(f"replica.lag.{g.name}", 0)
            # Old-WAL records for the moved range must never replay onto
            # the old groups post-clear: compact to head.  Laggard old
            # groups lose replay coverage and take the RESYNC path
            # instead — whose donor diff also streams them the clears.
            spec.emit("compact_plan", src=id(old.wal),
                      floor=old.wal.last_seq, tracked={}, floors=[])
            old.wal.compact(old.wal.last_seq)
            # Clear the moved range off the old owners (an in-rotation
            # old group still holding moved fragments would double-count
            # them under unscoped fan-out reads).  A failed clear marks
            # the group suspect — the probe's digest check repairs it —
            # and a same-server old/new pairing (dev rigs) skips the
            # clear: the "two groups" share one holder.
            clear_errors = []
            new_bases = {g.base for g in new_groups}
            for g in old.groups:
                if g.base in new_bases:
                    self.stats.count("replica.reshard.clear_skipped")
                    continue
                for p in sorted(post):
                    qs = fragment_query(p)
                    try:
                        old.resync._push(
                            g, "POST",
                            f"/fragment/import-roaring?{qs}&total=0&crc=0&off=0",
                            b"", None, ctype="application/octet-stream",
                        )
                    except (OSError, ResyncAbort) as e:
                        self.stats.count("replica.reshard.clear_errors")
                        clear_errors.append(f"{g.name}: {p}: {e}")
                        with self._mu:
                            g.suspect = True
                            g.caught_up = False
                        break
        finally:
            with self._gate_cv:
                self._gated = False
                self._gate_cv.notify_all()
        fence_ms = (time.perf_counter() - t_fence) * 1e3
        self.stats.count("replica.reshard.rounds")
        self.stats.count("replica.reshard.moved_fragments", moved_fragments)
        self.stats.count("replica.reshard.moved_bytes", moved_bytes)
        self.stats.timing("replica.reshard.fence_ms", fence_ms)
        payload = {
            "mapEpoch": self.map_epoch,
            "shards": self.shard_map.to_json(),
            "moved": {"fragments": moved_fragments, "bytes": moved_bytes},
            "fenceMs": round(fence_ms, 3),
            "totalMs": round((time.perf_counter() - t0) * 1e3, 3),
            "clearErrors": clear_errors,
        }
        return 200, "application/json", json.dumps(payload).encode(), {}

    # -- lifecycle --------------------------------------------------------

    class _Handler(BaseHTTPRequestHandler):
        router: "ReplicaRouter"
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _run(self, method: str) -> None:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            headers = {k.lower(): v for k, v in self.headers.items()}
            status, ctype, payload, extra = self.router.handle(
                method, self.path, body, headers
            )
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            self._run("GET")

        def do_POST(self):
            self._run("POST")

        def do_DELETE(self):
            self._run("DELETE")

        def do_PATCH(self):
            self._run("PATCH")

    def serve(self) -> "ReplicaRouter":
        """Bind and serve in a background thread; returns self (the
        resolved port lands in ``self.port``)."""
        cls = type("BoundRouter", (self._Handler,), {"router": self})
        self._httpd = ThreadingHTTPServer((self.host, self.port), cls)
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        self._probe_thread = threading.Thread(target=self._probe_loop, daemon=True)
        self._probe_thread.start()
        if self.anti_entropy_interval_s > 0:
            threading.Thread(
                target=self._anti_entropy_loop, daemon=True
            ).start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for sh in self.shards:
            sh.wal.close()


def router_from_config(cfg, stats=None, tracer=None) -> ReplicaRouter:
    """Build a router from Config ([replica] TOML + PILOSA_TPU_REPLICA_*
    env, resolved by Config itself) — the CLI entry point's constructor.

    Shard map resolution (the config satellite's contract): an explicit
    ``shard-map`` string wins; else ``shards = N`` (N > 1) auto-splits
    the flat group list with ``uniform_shard_map``; else the degenerate
    single-shard map — which keeps the historical single-WAL layout
    (``<wal-dir>/router.wal``) byte-identical to the pre-shard router.
    Multi-shard routers get per-shard WALs (``router-<shard>.wal``)
    built lazily by the router itself from ``wal_dir``."""
    import os

    host, _, port = (cfg.host or "127.0.0.1").replace("http://", "").partition(":")
    faults = FaultInjector.from_env() or NOP_FAULTS

    shard_map = None
    if (cfg.replica_shard_map or "").strip():
        shard_map = parse_shard_map(cfg.replica_shard_map)
    elif int(cfg.replica_shards or 1) > 1:
        shard_map = uniform_shard_map(
            cfg.replica_groups, int(cfg.replica_shards),
            span=int(cfg.replica_shard_span or 1),
        )

    # [tenancy]: the router runs the SAME fair-share door the servers
    # do, from the same config — one [tenancy] section isolates tenants
    # at every entry point.  Disabled (the default) passes None for
    # both, which keeps handle() on the doorless fast path.
    from pilosa_tpu_torch import tenancy as tenancy_mod

    tenancy = tenancy_mod.from_config(cfg, stats=stats)
    admission = None
    if tenancy is not None:
        admission = qos.AdmissionController(
            depths={
                qos.CLASS_READ: cfg.qos_read_depth,
                qos.CLASS_WRITE: cfg.qos_write_depth,
                qos.CLASS_ADMIN: cfg.qos_admin_depth,
            },
            queue_wait_ms=cfg.qos_queue_wait_ms,
            retry_after_ms=cfg.qos_retry_after_ms,
            stats=stats,
            tenancy=tenancy,
        )

    common = dict(
        host=host or "127.0.0.1",
        port=cfg.replica_router_port,
        failover=cfg.replica_failover,
        default_deadline_ms=cfg.default_deadline_ms,
        probe_interval_s=cfg.replica_probe_interval,
        probe_max_interval_s=cfg.replica_probe_max_interval,
        faults=faults,
        stats=stats,
        tracer=tracer,
        anti_entropy_interval_s=cfg.replica_anti_entropy_interval,
        resync_chunk_bytes=cfg.replica_resync_chunk_bytes,
        resync_columnar=cfg.replica_resync_columnar,
        admission=admission,
        tenancy=tenancy,
    )
    if shard_map is not None and len(shard_map) > 1:
        return ReplicaRouter(
            shard_map=shard_map,
            wal_dir=cfg.replica_wal_dir,
            wal_max_bytes=cfg.replica_wal_max_bytes,
            **common,
        )
    wal = WriteAheadLog(
        os.path.join(os.path.expanduser(cfg.replica_wal_dir), "router.wal")
        if cfg.replica_wal_dir
        else None,
        max_bytes=cfg.replica_wal_max_bytes,
        stats=stats if stats is not None else NOP_STATS,
        faults=faults,
    )
    if shard_map is not None:
        # A one-shard explicit map: honor its group specs but keep the
        # historical single-WAL filename.
        return ReplicaRouter(shard_map=shard_map, wal=wal, **common)
    return ReplicaRouter(cfg.replica_groups, wal=wal, **common)
