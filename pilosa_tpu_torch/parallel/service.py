"""Lockstep multi-GPU query service: one HTTP front end, SPMD execution.

The reference serves distributed queries coordinator-style: the handler
node parses, fans slice batches out to peers over HTTP+protobuf, and
reduces (executor.go:1009-1244).  On a homogeneous GPU job the
alternative is SPMD LOCKSTEP: every process (one per GPU) holds the same
holder data, joins one ``torch.distributed`` process group, and executes
the SAME query program; device work is sharded over the slice axis
(engine.MeshEngine: each rank runs the port's kernels on its block) and
collectives (all_reduce / all_gather over NCCL or gloo) do the reduce
that protobuf responses did in the reference.

This module is the SERVICE shell around that execution model:

- rank 0 runs the HTTP front end (``POST /index/<name>/query``, the
  reference's wire shape, handler.go:179-243) and a control-plane TCP
  listener;
- every other rank connects to the control plane and replays, in
  arrival order, exactly the requests rank 0 serves;
- rank 0 forwards each request to all ranks BEFORE executing it
  locally, so every process enters the same device computations in the
  same order — the lockstep invariant the collectives require.

Requests flow through ONE total order — a sequence number assigned on
rank 0 — but execution is PIPELINED: N requests can be in flight on the
control plane (sends, receipt acks) while device execution proceeds
strictly in sequence order on every rank, so concurrent HTTP clients
overlap their network/parse time with each other's device time without
ever breaking the lockstep invariant.  Writes (SetBit etc.) replay
identically on every rank, keeping the replicated holders convergent.
Errors raised before device work (parse errors, unknown frames) raise
identically everywhere — rank 0 reports them to the client, workers log
and continue.

COALESCING: concurrent requests drain into ONE control-plane batch
entry (``{"op": "batch", "seq": n, "reqs": [{"index", "query"}, ...]}``)
through the same rotating-leader group commit the ingest queue uses —
one sequence number, one fan-out send, and one ack round per batch
instead of per request, amortizing the fixed replay overhead across the
batch.  Every rank executes the batch's requests in list order inside
the batch's slot in the total order, so the lockstep invariant is
untouched; per-request errors are ISOLATED (a deterministic PilosaError
is returned to its own client and skipped identically on every rank —
it never poisons sibling requests or desynchronizes ranks).
``PILOSA_TPU_LOCKSTEP_COALESCE`` caps the batch size (default 32;
1 disables coalescing).  An idle service adds no latency: the first
request leads immediately and ships a batch of one.

QoS: each request may carry a deadline (``X-Pilosa-Deadline-Ms``
header, or the service's ``default_deadline_ms``).  Expiry is decided
ONCE — on rank 0, at ship time — and rides the batch entry as a
per-request ``expired`` flag (plus ``deadline_ms`` remaining, for
observability): every rank drops the same expired requests before
execution from the flag alone, so no clock sync is assumed and the
lockstep invariant holds (the client gets a 504).  The arrival queue
is bounded (``queue_depth``, default 256): a request landing on a full
queue gets 429 + Retry-After at the door, and a degraded control plane
answers 503 + Retry-After instead of 400.

TRACING: the head-sampling decision for the request tracer
(``PILOSA_TPU_TRACE_SAMPLE_RATE`` / ``_SLOW_MS``, or ctor args from the
CLI's [trace] config) is decided ONCE — on rank 0 at ship time, forced
by an inbound ``X-Pilosa-Trace`` header — and rides the batch entry as
a per-request ``trace`` flag, exactly like expiry: every rank reads
the flag (never its own RNG), so the decision is identical everywhere.
Tracing never changes execution, so workers only COUNT the flags
(``stat_traced``, the determinism probe); rank 0 additionally records
each traced request's queue/ship/execute phases (the ship span covers
the worker fan-out + receipt-ack barrier) into its tracer ring, served
at ``/debug/traces`` by the full server or read off ``svc.tracer``.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import threading

from pilosa_tpu_torch.analysis import lockcheck
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

_now = time.perf_counter

from pilosa_tpu_torch.engine import MeshEngine
from pilosa_tpu_torch.executor import ExecOptions, Executor
from pilosa_tpu_torch.pilosa import ErrFrameNotFound, ErrIndexNotFound, PilosaError
from pilosa_tpu_torch.qos import DeadlineExceeded, ShedError, deadline_from_headers
from pilosa_tpu_torch.server.handler import result_to_json

_LEN = struct.Struct("<I")

# Reserved internal entry for the streaming-ingest completion hook: the
# front end ships it through the normal total order and EVERY rank
# executes the rank-cache recalculation identically (import parity).
# The NUL bytes keep it outside any parseable PQL; a client posting the
# sentinel directly just triggers a harmless recalc.
INGEST_RECALC_PREFIX = "\x00ingest-recalc\x00"

# Reserved internal entries for the device-build bulk door: rank 0
# decodes each chunk once and replays the decoded pairs through the
# total order as base64(packed-uint64) bodies — every rank runs the
# SAME build kernel over the SAME pairs, so the committed plane
# overlays are replicated without rank-0 shipping any derived state.
# The recalc sentinel runs the completion hook (rank-cache recalc +
# budgeted materialization) identically on every rank.
BULK_APPLY_PREFIX = "\x00bulk-apply\x00"
BULK_RECALC_PREFIX = "\x00bulk-recalc\x00"

# Reserved internal entry for the collective self-check (``POST
# /debug/mesh-check``): every rank runs the slice-sharded compositions
# (parallel/sharded.py) over rows of a frame, each on its own block, and
# rank 0 answers their merged results — the job's kernels and collectives
# checked end to end on the replicated data.
MESH_CHECK_PREFIX = "\x00mesh-check\x00"
# Rows a self-check may name (its block is [S/n, rows, W] on every rank).
MESH_CHECK_ROWS_MAX = 64


class DegradedError(PilosaError):
    """The lockstep control plane lost a rank — the replicas can no
    longer be guaranteed identical, so the whole service refuses work
    (HTTP 503 + Retry-After: clients should come back to a RESTARTED
    job, not hammer a dead one)."""

    retry_after = 5.0


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_msg(sock: socket.socket) -> Optional[dict]:
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = _LEN.unpack(head)
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            return None
        data += chunk
    return json.loads(data.decode("utf-8"))


class LockstepService:
    """SPMD query service over a joined ``torch.distributed`` job.

    Construct AFTER ``init_multihost`` on every process, with identical
    holder contents, then call :meth:`serve_forever`.  Rank 0 needs
    ``http_addr`` and ``control_addr``; workers need the same
    ``control_addr`` to connect.  Without an initialized process group
    the service is a job of one rank.  ``device`` is the rank's device
    (default: the current CUDA device, which ``init_multihost`` set;
    there is no fallback to the CPU, which is asked for with
    ``device="cpu"``).
    """

    def __init__(
        self,
        holder,
        control_addr: tuple[str, int],
        http_addr: Optional[tuple[str, int]] = None,
        device=None,
        ack_timeout: Optional[float] = None,
        connect_timeout: Optional[float] = None,
        queue_depth: Optional[int] = None,
        default_deadline_ms: Optional[float] = None,
        qcache_enabled: Optional[bool] = None,
        qcache_max_bytes: Optional[int] = None,
        trace_sample_rate: Optional[float] = None,
        trace_slow_ms: Optional[float] = None,
        group: Optional[str] = None,
        group_epoch: Optional[int] = None,
        bulk_batch_slices: Optional[int] = None,
        bulk_materialize_budget_ms: Optional[float] = None,
        tenancy_map: Optional[str] = None,
    ):
        import torch.distributed as dist

        from pilosa_tpu_torch import qcache as qcache_mod
        from pilosa_tpu_torch import trace as trace_mod
        from pilosa_tpu_torch.replica import parse_group

        self.holder = holder
        joined = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if joined else 0
        self.n_ranks = dist.get_world_size() if joined else 1
        # GROUP IDENTITY (replica serving groups): this job is one
        # serving group behind the replica router.  The name@epoch pair
        # rides every HTTP response (X-Pilosa-Group — the router's
        # epoch-bump detection) and every control-plane batch entry
        # (``gepoch``): every rank of a group is constructed with the
        # SAME epoch, so a worker receiving an entry from a DIFFERENT
        # epoch is talking to a stale rank 0 from a previous incarnation
        # and fail-stops rather than replaying writes the restarted
        # group never acknowledged.  Ctor args (the CLI passes [replica]
        # config) > PILOSA_TPU_REPLICA_GROUP env ("name[@epoch]") > off.
        if group is None and group_epoch is None:
            group, env_epoch = parse_group(
                os.environ.get("PILOSA_TPU_REPLICA_GROUP", "")  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
            )
            group_epoch = env_epoch
        self.group = group or ""
        self.group_epoch = int(group_epoch or 0)
        # Replica durability: rank 0 tracks (and persists beside the
        # holder data) the highest router write sequence this group has
        # applied — reported on every response (X-Pilosa-Applied-Seq)
        # and at /replica/health, so a restarted lockstep job tells the
        # router exactly which WAL suffix to replay.  Workers never see
        # HTTP headers; the front end is the single writer.
        from pilosa_tpu_torch.replica.catchup import AppliedSeq

        holder_path = getattr(holder, "path", None)
        self.applied_seq = AppliedSeq(
            os.path.join(holder_path, "applied_seq")
            if (self.group and holder_path and self.rank == 0)
            else None
        )
        # The rank's engine: its block of every slice stack on its own
        # device.  PILOSA_TPU_MESH_TIMING=1 times the local kernel step
        # and the collectives between device synchronizations (per-batch
        # telemetry in ``batch_log``; off by default: the extra syncs
        # cost a little on every request).
        from pilosa_tpu_torch.parallel.sharded import SliceMesh

        timing = os.environ.get("PILOSA_TPU_MESH_TIMING", "").lower() in (
            "1", "true", "yes",
        )
        self.engine = MeshEngine(SliceMesh(device=device, timing=timing))
        self.batch_log: list = []
        # Observability plane: a real expvar registry (rank 0 serves it
        # at /debug/vars and /metrics) plus the dispatch meter + cost
        # ledger the full server carries, gated by PILOSA_TPU_COSTS like
        # there.  Stats are rank-local TELEMETRY — never read back into
        # control flow — so recording them on every rank cannot skew the
        # SPMD total order.
        from pilosa_tpu_torch import costs as costs_mod
        from pilosa_tpu_torch.stats import ExpvarStatsClient

        self.stats = ExpvarStatsClient()
        self.costs = (
            costs_mod.CostLedger(stats=self.stats)
            if costs_mod.enabled_from_env()
            else None
        )
        # Query result cache, DETERMINISTIC variant: hit/miss must be a
        # pure function of replicated state (request strings + the
        # lockstep total order of writes), so every rank hits or misses
        # identically and no rank skips a collective another rank runs —
        # the same rule as error isolation and expired-request drops.
        # Wall-clock cost admission is rank-local, so min_cost_ms is
        # FORCED to 0 here (admit every eligible read); byte-accounted
        # eviction stays deterministic because result sizes and the
        # serialized execution order are identical on every rank.
        if qcache_enabled is None:
            qcache_enabled = os.environ.get("PILOSA_TPU_QCACHE", "").lower() in (  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
                "1", "true", "yes",
            )
        if qcache_max_bytes is None:
            qcache_max_bytes = int(
                os.environ.get(  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
                    "PILOSA_TPU_QCACHE_MAX_BYTES", str(qcache_mod.DEFAULT_MAX_BYTES)
                )
            )
        qc = (
            qcache_mod.QueryCache(max_bytes=qcache_max_bytes, min_cost_ms=0.0)
            if qcache_enabled
            else None
        )
        self.executor = Executor(
            holder, engine=self.engine, qcache=qc,
            stats=self.stats if self.costs is not None else None,
        )
        # Cost-based planner, RANK 0 ONLY: plans are computed once at
        # ship time and ride the batch wire entry exactly like the
        # expiry and trace flags, so every rank applies rank 0's lane
        # and no rank ever consults rank-local state.  Workers carry
        # planner=None (they read plans off the wire); the EXECUTOR
        # planner is also rank-0-only so the ledger fold-back (wall
        # timestamps, win/loss tallies) stays telemetry, never control
        # flow on a worker.  PILOSA_TPU_PLANNER=0 disables.
        self.planner = None
        if (
            self.rank == 0
            and self.costs is not None
            and os.environ.get("PILOSA_TPU_PLANNER", "").lower()  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
            not in ("0", "false", "no")
        ):
            from pilosa_tpu_torch import planner as planner_mod

            self.planner = planner_mod.Planner(self.costs, stats=self.stats)
            self.executor.planner = self.planner
        self.control_addr = control_addr
        self.http_addr = http_addr
        self._workers: list[socket.socket] = []
        # Bound on how long rank 0 waits for a worker's receipt ack (and
        # for the send buffer to drain).  Acks come from the workers'
        # reader threads (receipt, not completion), so this only needs to
        # cover control-plane latency plus scheduling hiccups.  Config
        # precedence (PR-2 style): ctor arg (the CLI passes
        # Config.lockstep_ack_timeout) > env > default.
        if ack_timeout is None:
            ack_timeout = float(os.environ.get("PILOSA_TPU_LOCKSTEP_ACK_TIMEOUT", "120"))  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
        self.ack_timeout = ack_timeout
        # Worker startup: how long a worker retries connecting to rank
        # 0's control listener (the gossip seed-join startup race).
        if connect_timeout is None:
            connect_timeout = float(
                os.environ.get("PILOSA_TPU_LOCKSTEP_CONNECT_TIMEOUT", "60")  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
            )
        self.connect_timeout = connect_timeout
        # Admission bound on rank 0's arrival queue: requests beyond
        # this shed with 429 + Retry-After instead of growing the
        # coalescing queue without limit (coalesced batches stay sized,
        # and waiting clients aren't promised work the job can't do).
        # 0 = unbounded.
        if queue_depth is None:
            queue_depth = int(os.environ.get("PILOSA_TPU_LOCKSTEP_QUEUE_DEPTH", "256"))  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
        self.queue_depth = queue_depth
        # Default per-request budget when no X-Pilosa-Deadline-Ms header
        # arrives; 0 = unbounded.
        if default_deadline_ms is None:
            default_deadline_ms = float(os.environ.get("PILOSA_TPU_DEADLINE_MS", "0"))  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
        self.default_deadline_ms = default_deadline_ms
        # Request tracer: the sampling decision is made on rank 0 at
        # ship time and rides the batch entry as a per-request flag —
        # every rank reads the flag, never its own RNG, so the decision
        # is replicated (same rule as expiry).  Only rank 0 records
        # spans; workers count the flags (stat_traced).  Ctor args (the
        # CLI passes [trace] config) > env > off.
        if trace_sample_rate is None and trace_slow_ms is None:
            self.tracer = trace_mod.from_env(stats=self.stats, costs=self.costs)
        else:
            rate = trace_sample_rate if trace_sample_rate is not None else 0.0
            slow = trace_slow_ms if trace_slow_ms is not None else 0.0
            self.tracer = (
                trace_mod.Tracer(sample_rate=rate, slow_ms=slow,
                                 stats=self.stats, costs=self.costs)
                if (rate > 0 or slow > 0)
                else None
            )
        # PIPELINED total order: _order_mu only covers sequence assignment
        # + the worker sends (cheap), so N requests can be in flight on
        # the control plane at once; local execution is serialized in
        # sequence order by the _exec_cv gate, matching the workers'
        # socket-order replay.  _ack_mu[i]/_acked[i] track each worker's
        # ordered receipt-ack stream.
        self._order_mu = lockcheck.named_lock("lockstep._order_mu")
        self._next_seq = 1
        self._exec_cv = lockcheck.named_condition("lockstep._exec_cv")
        self._exec_next = 1
        self._ack_mu: list[threading.Lock] = []
        self._acked: list[int] = []
        self._degraded = False
        self._httpd = None
        self._stop = threading.Event()
        # Request coalescing: concurrent _execute callers drain into one
        # control-plane batch entry via a rotating shipper (the ingest
        # WriteQueue's leaderless group commit, SPLIT so shipping and
        # execution pipeline: the shipper releases its role right after
        # the ack round, letting the next batch's forward/ack network
        # time overlap this batch's device execution).  No dedicated
        # thread, no idle timer — a lone request ships immediately as a
        # batch of one.
        self.coalesce_max = max(
            1, int(os.environ.get("PILOSA_TPU_LOCKSTEP_COALESCE", "32"))
        )
        self._q_cv = lockcheck.named_condition("lockstep._q_cv")
        self._q: list = []  # [((index, query), slot)]
        self._shipping = False
        # Ship-ahead pipeline depth: while batch n executes, at most ONE
        # further batch may ship (its forward/ack overlaps n's device
        # time).  Deeper shipping would drain arrivals into batches of
        # one — requests must ACCUMULATE during execution for the
        # coalescing to form real batches.
        self._inflight = 0
        # Telemetry (bench + tests): batches shipped / requests carried,
        # plus QoS outcomes (shed at the arrival queue, dropped expired).
        self.stat_batches = 0
        self.stat_requests = 0
        self.stat_shed = 0
        self.stat_expired = 0
        # Trace flags observed in executed batch entries: every rank
        # counts the SAME number (the flag rides the wire, decided once
        # on rank 0) — the lockstep determinism probe for sampling.
        self.stat_traced = 0
        # Per-tenant request accounting off the wire entries: the tenant
        # is resolved ONCE on rank 0 at ship time (header > [tenancy]
        # map > index name > "default" — the tenancy.resolve seam) and
        # rides the batch entry like the expired/trace/plan flags, so
        # every rank tallies identical per-tenant counts from the flag
        # alone.  tenant -> {"requests": n, "expired": m}.
        from pilosa_tpu_torch import tenancy as tenancy_mod

        if tenancy_map is None:
            tenancy_map = os.environ.get("PILOSA_TPU_TENANCY_MAP", "")  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
        self.tenancy_index_map = tenancy_mod.parse_map(tenancy_map)
        self.stat_tenants: dict = {}
        # Streaming columnar ingest on the lockstep front end: chunks
        # decode on rank 0 and replay as canonical batched SetBit
        # bodies through the normal total order (every rank applies
        # them — via the native write lane when armed); the completion
        # hook ships the INGEST_RECALC_PREFIX sentinel so every rank
        # recalculates rank caches identically.  Staging state
        # (offsets, running CRC) is rank-0-local: a restarted job
        # re-streams, which is idempotent.
        from pilosa_tpu_torch import ingest as ingest_mod

        self._ingestor = ingest_mod.StreamIngestor(
            self._ingest_apply, complete=self._ingest_complete,
        )
        # Device-build bulk door: chunks decode on rank 0 and the
        # decoded PAIRS replay through the total order (base64 packed
        # bodies) — every rank runs the build kernel itself, so the
        # plane overlays are a pure function of the replicated pairs.
        # The materialize budget only shapes WHEN each rank folds its
        # overlay into roaring storage (physical representation, not
        # logical content), so wall-clock divergence across ranks is
        # benign.  [bulk] config > PILOSA_TPU_BULK_* env > defaults.
        if bulk_batch_slices is None:
            bulk_batch_slices = int(
                os.environ.get("PILOSA_TPU_BULK_BATCH_SLICES", "8")  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
            )
        if bulk_materialize_budget_ms is None:
            bulk_materialize_budget_ms = float(
                os.environ.get("PILOSA_TPU_BULK_MATERIALIZE_BUDGET_MS", "0")  # analysis-ok: env-knob-outside-config: rank-process fallback; ctor args win, ranks inherit the launcher's env
            )
        self.bulk_batch_slices = bulk_batch_slices
        self.bulk_materialize_budget_ms = bulk_materialize_budget_ms
        self._bulk_ingestor = ingest_mod.StreamIngestor(
            self._bulk_apply, complete=self._bulk_complete,
        )

    # -- rank 0 ----------------------------------------------------------

    def _accept_workers(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(self.control_addr)
        srv.listen(self.n_ranks)
        self.control_addr = srv.getsockname()
        self._control_srv = srv
        for _ in range(self.n_ranks - 1):
            conn, _ = srv.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._workers.append(conn)
            self._ack_mu.append(lockcheck.named_lock("lockstep._ack_mu"))
            self._acked.append(0)

    def _degrade(self, e) -> "DegradedError":
        self._degraded = True
        with self._exec_cv:
            self._exec_cv.notify_all()
        return DegradedError(
            f"lockstep control plane lost a rank ({e}); "
            "service degraded — restart the job"
        )

    def _await_acks(self, seq: int) -> None:
        """Wait until every worker has acked receipt of request ``seq``.

        Each worker's control socket delivers one ack byte per request in
        order, so "acked seq n" == "n ack bytes consumed"; any thread may
        consume acks for earlier sequences on the way (the per-worker
        lock keeps consumption single-threaded).  A timeout counts as a
        lost rank — detected here instead of by hanging in the collective
        the dead worker will never enter.
        """
        for i, w in enumerate(self._workers):
            with self._ack_mu[i]:
                while self._acked[i] < seq:
                    b = w.recv(1)
                    if b != b"k":
                        raise OSError("worker closed control connection")
                    self._acked[i] += 1

    def _execute(self, index: str, query: str, deadline=None, trace_force=False,
                 tenant_hdr=None):
        """Serve one request through the coalescing queue.

        ADMISSION: the arrival queue is bounded (``queue_depth``) — a
        request landing on a full queue sheds with :class:`ShedError`
        (HTTP 429 + Retry-After) instead of queuing into collapse, so
        coalesced batches stay sized and every admitted request is one
        the job can actually serve.

        Whoever finds the queue shipper-less drains every waiting
        request (up to ``coalesce_max``) into ONE control-plane batch
        entry, ships it (sequence number + worker fan-out + ack round),
        hands the shipper role to the next thread, and only then
        executes the batch in its slot of the total order — so batch
        n+1's forward/ack network time overlaps batch n's device
        execution exactly like the old per-request pipeline, with the
        fixed replay overhead now amortized over the whole batch.
        Per-request results — including a request's own deterministic
        PilosaError — come back through per-item slots, so one bad
        request never poisons its batch siblings.
        """
        slot = [False, None]  # done, result (exception instance = raise)
        with self._q_cv:
            if self.queue_depth > 0 and len(self._q) >= self.queue_depth:
                self.stat_shed += 1
                raise ShedError(
                    f"lockstep arrival queue full ({self.queue_depth}); retry",
                    retry_after=0.25,
                )
            self._q.append(
                ((index, query, deadline, trace_force, tenant_hdr, _now()), slot)
            )
            while not slot[0]:
                if not self._shipping and self._q and self._inflight < 2:
                    self._shipping = True
                    self._inflight += 1
                    batch = self._q[: self.coalesce_max]
                    del self._q[: len(batch)]
                    self.stat_batches += 1
                    self.stat_requests += len(batch)
                    self._q_cv.release()
                    shipped = None
                    try:
                        shipped = self._ship_batch([it for it, _ in batch])
                    except BaseException as e:  # noqa: BLE001 — degrade
                        for _, s in batch:
                            s[1] = e
                            s[0] = True
                    finally:
                        self._q_cv.acquire()
                        self._shipping = False
                        self._q_cv.notify_all()
                    if shipped is not None:
                        self._q_cv.release()
                        try:
                            self._run_batch(
                                shipped[0], batch, shipped[1], shipped[2],
                                shipped[3], shipped[4],
                            )
                        finally:
                            self._q_cv.acquire()
                    self._inflight -= 1
                    self._q_cv.notify_all()
                    continue
                self._q_cv.wait()
        if isinstance(slot[1], BaseException):
            raise slot[1]
        return slot[1]

    # -- streaming ingest (front-end half) --------------------------------

    # Pairs per replicated SetBit body: bounds the control-plane entry
    # size and keeps each replayed body inside the native write lane's
    # sweet spot.
    _INGEST_SUBBATCH = 4096

    def _ingest_apply(self, key, rows, cols, deadline) -> int:
        """One decoded chunk -> canonical batched SetBit bodies through
        the replicated total order.  The translation keeps the wire
        JSON-clean and deterministic; each rank's executor applies the
        body through its own native batch lane."""
        index, fname = key
        idx = self.holder.index(index)
        if idx is None:
            raise ErrIndexNotFound(index)
        fr = idx.frame(fname)
        if fr is None:
            raise ErrFrameNotFound(fname)
        rl, cl = fr.row_label, idx.column_label
        rlist, clist = rows.tolist(), cols.tolist()
        for i in range(0, len(rlist), self._INGEST_SUBBATCH):
            body = "".join(
                f'SetBit({rl}={r}, frame="{fname}", {cl}={c})'
                for r, c in zip(
                    rlist[i : i + self._INGEST_SUBBATCH],
                    clist[i : i + self._INGEST_SUBBATCH],
                )
            )
            self._execute(index, body, deadline=deadline)
        return len(rlist)

    def _ingest_complete(self, key) -> None:
        index, fname = key
        self._execute(index, INGEST_RECALC_PREFIX + fname)

    def _do_ingest_recalc(self, index: str, fname: str) -> bool:
        """Executed identically on every rank (sorted iteration inside
        recalc_frame_caches): import-parity rank-cache freshness after
        a streamed ingest."""
        from pilosa_tpu_torch import ingest as ingest_mod

        fr = self.holder.frame(index, fname)
        if fr is not None:
            ingest_mod.recalc_frame_caches(fr)
        return True

    # -- bulk build (front-end half) ---------------------------------------

    # Pairs per replicated bulk body: each entry carries base64(packed
    # uint64 pairs), so at 16 bytes/pair + 4/3 base64 overhead this is
    # ~350 KiB per control-plane entry — large enough to amortize the
    # ship/ack round, small enough to stay well under socket comfort.
    _BULK_SUBBATCH = _INGEST_SUBBATCH * 4

    def _bulk_apply(self, key, rows, cols, deadline) -> int:
        """One decoded bulk chunk -> packed-pair bodies through the
        replicated total order.  Unlike the streamed door's SetBit
        translation, the pairs ship VERBATIM (base64 of the same PI64
        packing the wire uses) and every rank runs the bulk build
        kernel over them itself — the committed overlays are a pure
        function of replicated input."""
        import base64

        from pilosa_tpu_torch import ingest as ingest_mod

        index, fname = key
        idx = self.holder.index(index)
        if idx is None:
            raise ErrIndexNotFound(index)
        if idx.frame(fname) is None:
            raise ErrFrameNotFound(fname)
        rlist, clist = rows, cols
        for i in range(0, len(rlist), self._BULK_SUBBATCH):
            payload = base64.b64encode(
                ingest_mod.encode_packed(
                    rlist[i : i + self._BULK_SUBBATCH],
                    clist[i : i + self._BULK_SUBBATCH],
                )
            ).decode("ascii")
            self._execute(
                index,
                BULK_APPLY_PREFIX + fname + "\x00" + payload,
                deadline=deadline,
            )
        return len(rlist)

    def _bulk_complete(self, key) -> None:
        index, fname = key
        self._execute(index, BULK_RECALC_PREFIX + fname)

    def _do_bulk_apply(self, index: str, body: str) -> int:
        """Executed identically on every rank: decode the replicated
        packed pairs and run the device build + overlay commit through
        this rank's own engine (device and numpy builds are bit-identical,
        so replicas stay digest-equal regardless of backend)."""
        import base64

        from pilosa_tpu_torch import ingest as ingest_mod
        from pilosa_tpu_torch.bulk import ingress

        fname, _, payload = body.partition("\x00")
        fr = self.holder.frame(index, fname)
        if fr is None:
            raise ErrFrameNotFound(fname)
        rows, cols = ingest_mod.decode_packed(base64.b64decode(payload))
        return ingress.apply_bulk(
            fr, rows, cols,
            engine=self.engine,
            executor=self.executor,
            index=index,
            batch_slices=self.bulk_batch_slices,
            stats=self.stats,
        )

    def _do_bulk_recalc(self, index: str, fname: str) -> bool:
        """Executed identically on every rank: rank-cache recalc plus
        the budgeted lazy-materialization drain.  The drain's wall-clock
        budget is rank-local, so ranks may fold different AMOUNTS of
        overlay into roaring storage here — that divergence is physical
        representation only (logical content, digests and query results
        are already identical), and any residue materializes on first
        touch."""
        from pilosa_tpu_torch.bulk import ingress

        fr = self.holder.frame(index, fname)
        if fr is not None:
            ingress.complete_bulk(fr, self.bulk_materialize_budget_ms)
        return True

    def _do_mesh_check(self, index: str, body: str) -> dict:
        """Executed identically on every rank: densify this rank's block
        of ``rows`` and ``src`` (its own slices only) and run every
        sharded composition over it.  Returns the merged results, the
        same on every rank: TopN counts summed over slices
        (``topn_counts``), per-(slice, row) src counts (``gather_src_counts``),
        each row's pair count with the next (``dispatch.gather_count``),
        the fold of all rows (``dispatch.gather_count_multi``, or) and the
        first row against src under every pair op (``count_rows``)."""
        import numpy as np

        from pilosa_tpu_torch.ops import bitwise
        from pilosa_tpu_torch.parallel import sharded

        spec = json.loads(body)
        fname, rows, src = spec["frame"], [int(r) for r in spec["rows"]], int(spec["src"])
        idx = self.holder.index(index)
        if idx is None:
            raise ErrIndexNotFound(index)
        if self.holder.frame(index, fname) is None:
            raise ErrFrameNotFound(fname)
        if not 1 <= len(rows) <= MESH_CHECK_ROWS_MAX:
            raise PilosaError(f"mesh check: 1 to {MESH_CHECK_ROWS_MAX} rows, got {len(rows)}")
        mesh = self.engine.mesh
        n_slices = idx.max_slice() + 1
        if n_slices % mesh.n_devices:
            raise PilosaError(
                f"mesh check: {n_slices} slices do not divide over {mesh.n_devices} ranks"
            )
        own = mesh.owned_range(n_slices)
        block = np.zeros((len(own), len(rows), bitwise.WORDS_PER_SLICE), dtype=np.uint32)
        srcb = np.zeros((len(own), bitwise.WORDS_PER_SLICE), dtype=np.uint32)
        for j, s in enumerate(own):
            frag = self.holder.fragment(index, fname, "standard", s)
            if frag is not None:
                for k, r in enumerate(rows):
                    block[j, k] = frag.row_dense(r)
                srcb[j] = frag.row_dense(src)
        dev = self.engine.device
        rm, sv = bitwise.to_words(block, dev), bitwise.to_words(srcb, dev)
        k = len(rows)
        pairs = np.array([[i, (i + 1) % k] for i in range(k)], dtype=np.int32)
        ints = lambda t: t.cpu().numpy().astype(np.int64).tolist()  # noqa: E731
        return {
            "slices": n_slices, "ranks": mesh.n_devices, "rows": rows, "src": src,
            "topn": ints(sharded.sharded_topn_counts(mesh, rm, sv)),
            "scorer": ints(sharded.sharded_scorer_counts(mesh, rm, np.arange(k), sv)),
            "pairs": ints(sharded.sharded_gather_count(mesh, "and", rm, pairs)),
            "fold_or": ints(sharded.sharded_gather_count_multi(
                mesh, "or", rm, np.arange(k, dtype=np.int32)[None, :])),
            "count": {op: int(sharded.sharded_count_call(mesh, op, rm[:, 0], sv))
                      for op in ("and", "or", "xor", "andnot")},
        }

    def _ship_batch(self, items) -> tuple[int, list[bool], list, list, list]:
        """Assign the batch's slot in the total order and replicate it:
        one control-plane send per worker plus one ack round for the
        WHOLE batch (the per-request fixed cost this coalescing
        amortizes).  Returns (seq, expired flags, per-request traces).

        TRACING rides the same wire rule as deadlines: the sampling
        decision is made HERE, once, on rank 0 (forced by the client's
        X-Pilosa-Trace header or the tracer's coin flip) and ships as a
        per-request ``trace`` flag — every rank reads the flag, never
        its own RNG, so the decision is replicated.  Rank 0 builds the
        Trace objects (queue span = arrival -> ship; ship span = worker
        fan-out + receipt-ack barrier) and _run_batch closes them with
        the execute phase.

        DEADLINES ride the wire entry: expiry is decided ONCE, here on
        rank 0 at ship time, and the per-request ``expired`` flag (plus
        the remaining budget, for observability) is part of the batch
        entry — every rank drops the same expired requests before
        execution from the flag alone, never from its own clock, so the
        lockstep invariant holds without any clock sync (the same
        determinism rule as PR 2's error isolation).

        FAIL-STOP on a broken control plane: once any forward or ack
        fails, the ranks can no longer be guaranteed identical (a partial
        fan-out may have replayed a write on some ranks only), so the
        whole service degrades: new queries are refused, and in-flight
        batches behind the failed sequence error out WITHOUT executing
        locally even though live workers may replay them — after a
        degrade the replicas are presumed diverged and nothing more is
        served from any of them, so rank 0 skipping those requests is
        safe; clients retry against a restarted job (SetBit is
        idempotent).  A dead rank forces a restart exactly like the
        collective hang it would otherwise cause.
        """
        from pilosa_tpu_torch.trace import Trace

        reqs = []
        expired: list[bool] = []
        traces: list = []
        plans: list = []
        tenants: list = []
        t_ship = _now()
        for index, query, d, tforce, thdr, t_enq in items:
            exp = bool(d is not None and d.expired())
            expired.append(exp)
            traced = self.tracer is not None and self.tracer.decide(force=tforce)
            # Tenant resolved ONCE here on rank 0 (the tenancy.resolve
            # precedence: X-Pilosa-Tenant header > [tenancy] map > index
            # name) and shipped like the expiry/trace flags — every rank
            # attributes from the wire, never from local state.
            tenant = (thdr or "").strip() or self.tenancy_index_map.get(
                index, index
            )
            tenants.append(tenant)
            entry = {"index": index, "query": query, "expired": exp,
                     "trace": traced, "tenant": tenant}
            if d is not None:
                entry["deadline_ms"] = max(0, int(d.remaining_ms()))
            # Planner decision, made ONCE here on rank 0 and shipped on
            # the wire like the expiry/trace flags: every rank applies
            # the same lane, no rank consults rank-local ledger state.
            plan = (
                self.planner.plan_for(index, query.encode())
                if self.planner is not None and not exp
                else None
            )
            plans.append(plan)
            if plan is not None:
                entry["plan"] = plan
            reqs.append(entry)
            tr = None
            if traced:
                tr = Trace(f"lockstep {index}", forced=tforce)
                # Both dimensions on the root: the cost ledger keys
                # (tenant, index, ...) without conflating them.
                tr.root.tags["tenant"] = tenant
                tr.root.tags["index"] = index
                # The queue phase already happened (arrival -> ship):
                # record it with its measured duration.
                qsp = tr.root.child("lockstep.queue")
                qsp.ms = (t_ship - t_enq) * 1e3
            traces.append(tr)
        ship_spans = [
            tr.root.child("lockstep.ship") if tr is not None else None
            for tr in traces
        ]
        with self._order_mu:
            if self._degraded:
                raise DegradedError(
                    "lockstep service degraded: control plane lost a rank; restart the job"
                )
            seq = self._next_seq
            self._next_seq += 1
            entry = {"op": "batch", "seq": seq, "reqs": reqs}
            if self.group:
                # Group identity on the wire: workers fail-stop on an
                # epoch mismatch (a stale rank 0 from a previous group
                # incarnation must never drive a restarted worker).
                entry["group"] = self.group
                entry["gepoch"] = self.group_epoch
            try:
                for w in self._workers:
                    w.settimeout(self.ack_timeout)
                    _send_msg(w, entry)
            except (OSError, socket.timeout) as e:
                raise self._degrade(e)
        try:
            self._await_acks(seq)
        except (OSError, socket.timeout) as e:
            raise self._degrade(e)
        for sp in ship_spans:
            if sp is not None:
                # Covers the worker fan-out sends plus the receipt-ack
                # barrier — the control-plane cost the batch amortizes.
                sp.finish().annotate(ranks=self.n_ranks, batch=len(items))
        return seq, expired, traces, plans, tenants

    def _exec_batch_entries(self, entries, deliver) -> None:
        """Drop expired entries (the flag decided at ship time — every
        rank sees the same flags, so every rank drops the same entries
        before execution), then run the remaining requests through the
        fused batch units.  The expired requests resolve to
        DeadlineExceeded — deterministic, so it is safe as a
        per-request result on every rank (batch siblings unaffected).
        """
        live: list = []  # (original position, (index, query), plan)
        for pos, e in enumerate(entries):
            if e.get("trace"):
                # Ship-time sampling flag off the wire: every rank sees
                # (and counts) the same flags — the determinism probe
                # the 2-rank trace test asserts on.
                self.stat_traced += 1
            ten = e.get("tenant")
            if ten:
                # Rank 0's ship-time tenant off the wire: every rank
                # tallies identical per-tenant counts (the 2-rank
                # tenancy determinism probe).
                row = self.stat_tenants.setdefault(  # analysis-ok: check-then-act: batch replay is single-threaded per rank (the control loop); stat_tenants is read only by the post-shutdown probe
                    ten, {"requests": 0, "expired": 0}
                )
                row["requests"] += 1
                if e.get("expired"):
                    row["expired"] += 1
                self.stats.count(f"tenancy.admit.{ten}")
            if e.get("expired"):
                self.stat_expired += 1
                deliver(pos, DeadlineExceeded("dropped at lockstep replay"))
            else:
                # Planner plan off the wire (rank 0's ship-time decision;
                # absent = static ladder) — applied, never re-derived.
                live.append((pos, (e["index"], e["query"]), e.get("plan")))
        if not live:
            return
        from pilosa_tpu_torch.ops import kernels

        eng = self.engine
        t0, l0, k0 = _now(), eng.stat_local_s, dict(kernels.LAUNCHES)
        c0, n0 = eng.mesh.stat_collective_s, eng.mesh.stat_collectives
        self._exec_batch_units(
            [it for _, it, _ in live],
            lambda i, result: deliver(live[i][0], result),
            plans=[p for _, _, p in live],
        )
        if eng.timing:
            # Per-batch telemetry (PILOSA_TPU_MESH_TIMING): wall, the
            # local kernel step and the collectives, each between device
            # synchronizations, and the kernels launched; the first
            # request's head names the batch.
            self.batch_log.append({
                "requests": len(live), "q": live[0][1][1][:60],
                "ms": (_now() - t0) * 1e3,
                "local_ms": (eng.stat_local_s - l0) * 1e3,
                "collective_ms": (eng.mesh.stat_collective_s - c0) * 1e3,
                "collectives": eng.mesh.stat_collectives - n0,
                "launches": {k: n - k0[k] for k, n in kernels.LAUNCHES.items() if n > k0[k]},
            })

    def _batch_units(self, items):
        """Split one replay batch into execution units.

        Maximal runs of ADJACENT same-index READ-ONLY requests fuse into
        one joined PQL execution — one parse, one fused dispatch, and
        one collective round instead of N (the per-request device
        barrier is the coalescing bench's dominant cost; the control
        plane was already amortized by the batch entry).  Writes, mixed
        requests, and unparseable requests execute alone, preserving
        their exact semantics.  The split is a pure function of the
        request strings, so every rank derives identical units — the
        lockstep invariant holds through the fusion."""
        from pilosa_tpu_torch import pql

        units: list = []  # ("run", index, [(pos, query, n_calls)]) | ("solo", pos, index, query)
        cur: list = []
        cur_idx = None

        def flush():
            nonlocal cur, cur_idx
            if cur:
                units.append(("run", cur_idx, cur))
                cur, cur_idx = [], None

        for pos, (index, query) in enumerate(items):
            n_calls = 0
            read_only = False
            try:
                q = pql.parse_cached(query)
                n_calls = len(q.calls)
                read_only = n_calls > 0 and q.write_call_n() == 0
            # analysis-ok: exception-hygiene: unit-splitting probe; the solo execution raises the real parse error to its owner
            except Exception:  # noqa: BLE001 — parse error: solo raises it
                pass
            if read_only:
                if cur and cur_idx != index:
                    flush()
                cur_idx = index
                cur.append((pos, query, n_calls))
            else:
                flush()
                units.append(("solo", pos, index, query))
        flush()
        return units

    def _exec_batch_units(self, items, deliver, plans=None) -> None:
        """Execute one batch's units in order, reporting each request's
        result (or isolated PilosaError) through ``deliver(pos, r)``.

        ERROR ISOLATION: a PilosaError is deterministic (replicated
        holders, same total order), so every rank resolves it
        identically — it becomes that request's result only.  A fused
        read run that errors falls back to per-request execution: reads
        are side-effect-free, so the partial re-execution is safe and
        every rank repeats the same fallback.  Any OTHER exception
        propagates to the caller (rank-local failure — fail-stop).

        ``plans`` (aligned with items) carries rank 0's ship-time
        planner decisions: solo and single-read units apply theirs via
        ExecOptions.plan; MULTI-REQUEST fused runs execute without one
        (the join is its own shape — no per-request fingerprint fits),
        which is replicated because _batch_units is a pure function of
        the request strings and the plans came off the wire.
        """

        def _opt(pos):
            p = plans[pos] if plans is not None else None
            return ExecOptions(plan=p) if p is not None else None

        for unit in self._batch_units(items):
            if unit[0] == "solo":
                _, pos, index, query = unit
                if query.startswith(INGEST_RECALC_PREFIX):
                    # Reserved ingest-completion entry: recalc is a
                    # deterministic function of replicated state.
                    deliver(pos, self._do_ingest_recalc(
                        index, query[len(INGEST_RECALC_PREFIX):]
                    ))
                    continue
                if query.startswith(BULK_APPLY_PREFIX):
                    # Reserved bulk-build entry: every rank builds the
                    # same planes from the same replicated pairs.
                    try:
                        deliver(pos, self._do_bulk_apply(
                            index, query[len(BULK_APPLY_PREFIX):]
                        ))
                    except PilosaError as e:
                        deliver(pos, e)  # deterministic: isolated
                    continue
                if query.startswith(BULK_RECALC_PREFIX):
                    deliver(pos, self._do_bulk_recalc(
                        index, query[len(BULK_RECALC_PREFIX):]
                    ))
                    continue
                if query.startswith(MESH_CHECK_PREFIX):
                    try:
                        deliver(pos, self._do_mesh_check(
                            index, query[len(MESH_CHECK_PREFIX):]
                        ))
                    except PilosaError as e:
                        deliver(pos, e)  # deterministic: isolated
                    continue
                try:
                    deliver(pos, self.executor.execute(index, query, opt=_opt(pos)))
                except PilosaError as e:
                    deliver(pos, e)  # isolated: every rank resolved it too
                continue
            _, index, run = unit
            if len(run) > 1:
                joined = " ".join(q for _, q, _ in run)
                try:
                    res = self.executor.execute(index, joined)
                except PilosaError:
                    pass  # per-request fallback pins the error to its owner
                else:
                    off = 0
                    for pos, _q, n in run:
                        deliver(pos, res[off : off + n])
                        off += n
                    continue
            for pos, query, _n in run:
                try:
                    deliver(pos, self.executor.execute(index, query, opt=_opt(pos)))
                except PilosaError as e:
                    deliver(pos, e)

    def _run_batch(self, seq: int, batch, expired=None, traces=None,
                   plans=None, tenants=None) -> None:
        """Execute one shipped batch in its slot of the total order and
        fill every submitter's result slot; never raises (siblings would
        hang on an unfilled slot otherwise).  ``expired`` carries the
        ship-time per-request expiry flags — the SAME flags the workers
        read off the wire, so the drop is identical on every rank.
        ``traces`` carries the per-request rank-0 Trace objects for
        ship-time-sampled requests: the execute phase (this batch's
        slot wait + device execution) closes each one here and lands it
        in the tracer ring.

        Requests execute through the batch units (_exec_batch_units):
        adjacent read-only requests fuse into one executor pass,
        per-request errors stay isolated.  Any non-PilosaError failure
        means this rank may have diverged from the workers that replayed
        the batch — fail-stop: the service degrades and the batch's
        unresolved requests error out.
        """
        err = None
        with self._exec_cv:
            while self._exec_next != seq:
                if self._degraded:
                    # An earlier in-flight batch hit a lost rank: its
                    # seq will never execute here, so waiting would
                    # deadlock — every later batch reports degraded.
                    err = PilosaError(
                        "lockstep service degraded mid-flight; restart the job"
                    )
                    break
                self._exec_cv.wait(timeout=1.0)
        owned = err is None  # the wait loop exited at our slot
        try:
            if err is None and self._degraded:
                err = PilosaError(
                    "lockstep service degraded mid-batch; restart the job"
                )
            if err is None:
                def deliver(pos, result):
                    slot = batch[pos][1]
                    slot[1] = result
                    slot[0] = True

                flags = expired or [False] * len(batch)
                trs = traces or [None] * len(batch)
                pls = plans or [None] * len(batch)
                tens = tenants or [None] * len(batch)
                entries = [
                    {"index": it[0], "query": it[1], "expired": flags[i],
                     "trace": trs[i] is not None, "plan": pls[i],
                     "tenant": tens[i]}
                    for i, (it, _) in enumerate(batch)
                ]
                exec_spans = [
                    tr.root.child("lockstep.execute") if tr is not None else None
                    for tr in trs
                ]
                try:
                    self._exec_batch_entries(entries, deliver)
                except Exception as e:  # noqa: BLE001 — rank-local failure
                    self._degraded = True
                    err = e
                finally:
                    for tr, sp, (it, _) in zip(trs, exec_spans, batch):
                        if tr is None:
                            continue
                        sp.finish()
                        tr.root.finish()
                        # finish_request: ring entry + the slow-query
                        # log line when the request cleared slow-ms.
                        self.tracer.finish_request(
                            tr, name=tr.root.name, dt_ms=tr.root.ms,
                            body=it[1].encode("utf-8", errors="replace"),
                        )
            if err is not None:
                for _, slot in batch:
                    if not slot[0]:
                        slot[1] = err
                        slot[0] = True
        finally:
            if owned:
                with self._exec_cv:
                    self._exec_next = seq + 1
                    self._exec_cv.notify_all()

    class _Handler(BaseHTTPRequestHandler):
        service: "LockstepService"

        def log_message(self, *a):  # quiet
            pass

        def _group_header(self) -> None:
            from pilosa_tpu_torch.replica import (
                APPLIED_SEQ_HEADER,
                GROUP_HEADER,
                format_group,
            )

            if self.service.group:
                self.send_header(
                    GROUP_HEADER,
                    format_group(self.service.group, self.service.group_epoch),
                )
                self.send_header(
                    APPLIED_SEQ_HEADER, str(self.service.applied_seq.value)
                )

        def do_GET(self):
            # The replica router forwards admin GETs to a group like
            # reads, so a lockstep group must answer the common
            # read-only admin surface itself (the full server's handler
            # table is not mounted here) — plus the router health probe:
            # 200 while the group can serve, 503 once degraded (a
            # restarted job answers with a bumped epoch in
            # X-Pilosa-Group).
            svc = self.service
            parsed = urlparse(self.path)
            path = parsed.path.rstrip("/") or "/"
            status = 200
            if path == "/replica/health":
                status = 503 if svc._degraded else 200
                body = json.dumps({
                    "group": svc.group,
                    "epoch": svc.group_epoch,
                    "ranks": svc.n_ranks,
                    "appliedSeq": svc.applied_seq.value,
                    "state": "DEGRADED" if svc._degraded else "UP",
                }).encode()
            elif path == "/replica/digest":
                # Content digest for the router's resync diff and
                # anti-entropy sweep.  Rank 0 computes it over its own
                # holder — the lockstep total order keeps every rank's
                # holder identical, so the digest speaks for the whole
                # group by construction (no cross-rank collective
                # needed, and no rank-local nondeterminism: the walk is
                # sorted and the checksums are pure functions of bits).
                from pilosa_tpu_torch.replica.digest import holder_digest

                d = holder_digest(svc.holder)
                d["appliedSeq"] = svc.applied_seq.value
                body = json.dumps(d).encode()
            elif path == "/schema":
                body = json.dumps({"indexes": svc.holder.schema()}).encode()
            elif path == "/status":
                body = json.dumps({"status": {
                    "state": "DEGRADED" if svc._degraded else "UP",
                    "group": svc.group,
                    "epoch": svc.group_epoch,
                    "ranks": svc.n_ranks,
                    "appliedSeq": svc.applied_seq.value,
                    "indexes": svc.holder.schema(),
                }}).encode()
            elif path == "/slices/max":
                body = json.dumps({"maxSlices": svc.holder.max_slices()}).encode()
            elif path == "/version":
                from pilosa_tpu_torch import __version__

                body = json.dumps({"version": __version__}).encode()
            elif path == "/debug/vars":
                body = json.dumps(svc.stats.snapshot()).encode()
            elif path == "/debug/tenants":
                # Per-tenant wire accounting (rank 0's view; every rank
                # holds the same tallies by the lockstep invariant) plus
                # the ledger billing aggregate.
                body = json.dumps({
                    "enabled": bool(svc.tenancy_index_map),
                    "tenants": {
                        t: dict(row) for t, row in svc.stat_tenants.items()
                    },
                    "ledger": (
                        svc.costs.by_tenant() if svc.costs is not None else {}
                    ),
                }).encode()
            elif path == "/metrics":
                from pilosa_tpu_torch import metrics as metrics_mod

                body = metrics_mod.render(svc.stats).encode()
                self.send_response(status)
                self.send_header("Content-Type", metrics_mod.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self._group_header()
                self.end_headers()
                self.wfile.write(body)
                return
            elif path == "/debug/costs":
                from pilosa_tpu_torch import metrics as metrics_mod

                params = parse_qs(parsed.query)
                limit = metrics_mod.clamp_int(
                    (params.get("limit") or [None])[0], 0
                )
                body = json.dumps(
                    svc.costs.snapshot(limit=limit)
                    if svc.costs is not None
                    else {"cap": 0, "alpha": 0.0, "entries": []}
                ).encode()
            elif path == "/debug/traces":
                from pilosa_tpu_torch import metrics as metrics_mod

                params = parse_qs(parsed.query)
                # Clamp instead of 400 — same contract as the full
                # server's handler and the replica router.
                min_ms = metrics_mod.clamp_float(
                    (params.get("min-ms") or [None])[0], 0.0
                )
                limit = metrics_mod.clamp_int(
                    (params.get("limit") or [None])[0], 64
                )
                traces = (
                    svc.tracer.traces_json(min_ms=min_ms, limit=limit)
                    if svc.tracer is not None
                    else []
                )
                body = json.dumps({"traces": traces}).encode()
            else:
                self.send_error(404)
                return
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self._group_header()
            self.end_headers()
            self.wfile.write(body)

        def _do_ingest(self, index: str, frame: str, params: dict,
                       ingestor=None) -> None:
            """Streaming columnar ingest through the lockstep front
            end: same wire contract as the full server's route (off/
            total/crc/ccrc/probe params, packed-uint64 or Arrow chunk
            bodies); chunks replay on every rank as batched SetBit
            bodies and the completion recalc ships through the same
            total order.  ``ingestor`` selects the door sharing this
            wire contract (default the streamed-SetBit one; the /bulk
            route passes the device-build ingestor)."""
            from pilosa_tpu_torch.ingest import IngestError
            from pilosa_tpu_torch.replica.catchup import note_applied_from_headers

            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b""
            headers = {k.lower(): v for k, v in self.headers.items()}
            deadline = deadline_from_headers(
                headers, self.service.default_deadline_ms
            )

            def p(name, default=None):
                v = params.get(name)
                return v[0] if v else default

            status = 200
            retry_after = None
            key = (index, frame)
            if ingestor is None:
                ingestor = self.service._ingestor
            try:
                off = int(p("off", 0))
                total = int(p("total", 0))
                crc = int(p("crc", 0))
                ccrc_s = p("ccrc")
                ccrc = int(ccrc_s) if ccrc_s is not None else None
                if p("probe") == "1":
                    out = ingestor.probe(key, total, crc)
                else:
                    arrow = "arrow" in (self.headers.get("Content-Type") or "")
                    out = ingestor.chunk(
                        key, off, total, crc, body, chunk_crc=ccrc,
                        arrow=arrow, deadline=deadline,
                    )
                body_out = json.dumps(out).encode()
            except (ValueError, TypeError):
                status = 400
                body_out = json.dumps({"error": "bad off/total/crc/ccrc"}).encode()
            except IngestError as e:
                status = e.status
                body_out = json.dumps(
                    {"error": str(e), "staged": e.staged}
                ).encode()
            except DeadlineExceeded as e:
                status = 504
                body_out = json.dumps({"error": str(e)}).encode()
            except ShedError as e:
                status = e.status
                retry_after = e.retry_after
                body_out = json.dumps({"error": str(e)}).encode()
            except DegradedError as e:
                status = 503
                retry_after = e.retry_after
                body_out = json.dumps({"error": str(e)}).encode()
            except PilosaError as e:
                status = 400
                body_out = json.dumps({"error": str(e)}).encode()
            except Exception as e:  # noqa: BLE001 — surface as 5xx
                body_out = json.dumps({"error": f"internal: {e}"}).encode()
                status = 500
            note_applied_from_headers(
                self.service.applied_seq, headers, status,
                retry_after=retry_after,
            )
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body_out)))
            if retry_after is not None:
                self.send_header("Retry-After", f"{retry_after:.3f}")
            self._group_header()
            self.end_headers()
            self.wfile.write(body_out)

        def _do_mesh_check(self, params: dict) -> None:
            """``POST /debug/mesh-check?index=&frame=&rows=a,b,..&src=``:
            the collective self-check through the total order (every rank
            runs it); 200 with its JSON, 400 on a deterministic error."""
            def p(name, default=""):
                v = params.get(name)
                return v[0] if v else default

            status, retry_after = 200, None
            try:
                spec = {"frame": p("frame"), "src": int(p("src", "0")),
                        "rows": [int(r) for r in p("rows").split(",") if r.strip()]}
                out = self.service._execute(p("index"), MESH_CHECK_PREFIX + json.dumps(spec))
                body = json.dumps(out).encode()
            except ValueError:
                status, body = 400, json.dumps({"error": "bad rows/src"}).encode()
            except DegradedError as e:
                status, retry_after = 503, e.retry_after
                body = json.dumps({"error": str(e)}).encode()
            except PilosaError as e:
                status, body = 400, json.dumps({"error": str(e)}).encode()
            except Exception as e:  # noqa: BLE001 — surface as 5xx
                status, body = 500, json.dumps({"error": f"internal: {e}"}).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", f"{retry_after:.3f}")
            self._group_header()
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            parsed_url = urlparse(self.path)
            parts = parsed_url.path.strip("/").split("/")
            if (
                len(parts) == 5
                and parts[0] == "index"
                and parts[2] == "frame"
                and parts[4] in ("ingest", "bulk")
            ):
                self._do_ingest(
                    parts[1], parts[3], parse_qs(parsed_url.query),
                    ingestor=(
                        self.service._bulk_ingestor
                        if parts[4] == "bulk" else None
                    ),
                )
                return
            if parts == ["debug", "mesh-check"]:
                self._do_mesh_check(parse_qs(parsed_url.query))
                return
            if len(parts) != 3 or parts[0] != "index" or parts[2] != "query":
                self.send_error(404)
                return
            index = parts[1]
            n = int(self.headers.get("Content-Length", 0))
            query = self.rfile.read(n).decode("utf-8")
            headers = {k.lower(): v for k, v in self.headers.items()}
            deadline = deadline_from_headers(
                headers, self.service.default_deadline_ms
            )
            # X-Pilosa-Trace force override: the decision itself is made
            # on rank 0 at SHIP time (one place, replicated as a wire
            # flag), this only carries the client's request for it.
            trace_force = bool((headers.get("x-pilosa-trace") or "").strip())
            # X-Pilosa-Tenant override: carried to rank 0, which
            # RESOLVES the tenant once at ship time (the wire flag every
            # rank reads) — this only transports the client's claim.
            tenant_hdr = headers.get("x-pilosa-tenant")
            retry_after = None
            status = 500
            try:
                results = self.service._execute(
                    index, query, deadline=deadline, trace_force=trace_force,
                    tenant_hdr=tenant_hdr,
                )
                body = json.dumps(
                    {"results": [result_to_json(r) for r in results]}
                ).encode()
                status = 200
            except DeadlineExceeded as e:
                body = json.dumps({"error": str(e)}).encode()
                status = 504
            except ShedError as e:  # arrival queue full: back off and retry
                body = json.dumps({"error": str(e)}).encode()
                status = e.status
                retry_after = e.retry_after
            except DegradedError as e:  # control plane down: 503, not 400
                body = json.dumps({"error": str(e)}).encode()
                status = 503
                retry_after = e.retry_after
            except PilosaError as e:
                body = json.dumps({"error": str(e)}).encode()
                status = 400
            except Exception as e:  # noqa: BLE001 — a dead worker (broken
                # control pipe) or engine failure must surface as a 5xx,
                # not a silently dropped connection.
                body = json.dumps({"error": f"internal: {e}"}).encode()
                status = 500
            # Replica durability: a router-sequenced write that answered
            # deterministically (applied, or a deterministic 400) is
            # recorded as this group's applied high-water mark; sheds
            # (any answer carrying Retry-After — the shared not-applied
            # predicate), degraded 503s, and internal errors stay
            # replayable.
            from pilosa_tpu_torch.replica.catchup import note_applied_from_headers

            note_applied_from_headers(self.service.applied_seq, headers, status,
                                      retry_after=retry_after)
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", f"{retry_after:.3f}")
            self._group_header()
            self.end_headers()
            self.wfile.write(body)

    # -- workers ---------------------------------------------------------

    def _epoch_ok(self, msg: dict) -> bool:
        """A control-plane entry replays only when its group identity
        matches this rank's.  Entries without the fields (legacy wire,
        or a group-less job) always pass — the guard only bites when
        BOTH sides carry an identity and they disagree."""
        if "gepoch" not in msg and "group" not in msg:
            return True
        return (
            msg.get("group", self.group) == self.group
            and int(msg.get("gepoch", self.group_epoch)) == self.group_epoch
        )

    def _worker_loop(self) -> None:
        import time

        # Rank 0 may still be binding its control listener; retry briefly
        # (the same startup race the gossip seed-join retries handle).
        deadline = time.monotonic() + self.connect_timeout
        while True:
            try:
                sock = socket.create_connection(self.control_addr, timeout=5)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)

        # Receipt acks come from a dedicated reader thread so they track
        # RECEIPT, not completion — with one loop doing recv+ack+execute,
        # rank 0's ack wait for request n+1 would block behind this
        # rank's execution of n and the pipeline depth would collapse to
        # one.  Execution itself stays strictly in arrival order.
        import queue as _queue

        jobs: "_queue.Queue[Optional[dict]]" = _queue.Queue()

        def reader():
            while True:
                msg = _recv_msg(sock)
                if msg is None or msg.get("op") == "shutdown":
                    jobs.put(None)
                    return
                try:
                    sock.sendall(b"k")  # receipt ack (rank 0 waits on these)
                except OSError:
                    jobs.put(None)
                    return
                jobs.put(msg)

        rt = threading.Thread(target=reader, daemon=True)
        rt.start()
        dead = False
        while not self._stop.is_set() and not dead:
            msg = jobs.get()
            if msg is None:
                break
            # A batch entry replays N requests in list order; a legacy
            # "query" entry is a batch of one.  Replay goes through the
            # SAME batch units as rank 0 (_exec_batch_units): adjacent
            # read-only requests fuse into one executor pass, and
            # per-request PilosaErrors are deterministic (rank 0
            # returned the same error to that request's client) and
            # resolve identically on every rank — the batch, and the
            # lockstep, continue with the next request.
            if not self._epoch_ok(msg):
                # A batch entry from a DIFFERENT group epoch: this
                # worker belongs to a restarted incarnation of the
                # group and the sender is stale (or vice versa).
                # Replaying would advance this rank's generation
                # vectors past what the group ever acknowledged —
                # fail-stop, exactly like a rank-local failure.
                print(
                    f"lockstep group epoch mismatch: entry "
                    f"{msg.get('group')}@{msg.get('gepoch')} != local "
                    f"{self.group}@{self.group_epoch}; fail-stop",
                    file=sys.stderr,
                )
                dead = True
                continue
            if msg.get("op") == "batch":
                reqs = msg["reqs"]
            else:
                reqs = [{"index": msg["index"], "query": msg["query"]}]
            try:
                # Entries marked expired at ship time are dropped HERE
                # exactly as on rank 0 — by the wire flag, never this
                # rank's clock — before any device work.
                self._exec_batch_entries(reqs, lambda pos, result: None)
            except Exception:  # noqa: BLE001
                # Rank-LOCAL failure (disk full, engine fault): this
                # replica may have diverged from its peers, so
                # fail-stop — closing the socket trips rank 0's ack
                # check on the next request and degrades the whole
                # service, rather than silently serving collectives
                # over diverged data.
                import traceback

                traceback.print_exc()
                dead = True
        sock.close()

    # -- lifecycle -------------------------------------------------------

    def serve_forever(self) -> None:
        """Run the service until :meth:`shutdown` (rank 0) or a shutdown
        message (workers).  Blocks."""
        if self.rank == 0:
            self._accept_workers()
            handler = type("Bound", (self._Handler,), {"service": self})
            self._httpd = ThreadingHTTPServer(self.http_addr or ("127.0.0.1", 0), handler)
            self.http_addr = self._httpd.server_address
            self._httpd.serve_forever(poll_interval=0.1)
        else:
            self._worker_loop()

    def shutdown(self) -> None:
        """Rank 0: stop the HTTP front end and release the workers."""
        self._stop.set()
        with self._order_mu:
            for w in self._workers:
                try:
                    _send_msg(w, {"op": "shutdown"})
                    w.close()
                except OSError:
                    pass
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if getattr(self, "_control_srv", None) is not None:
            self._control_srv.close()
