"""Admission control: per-class bounded doors with shed-on-full.

Requests are classified into three classes — ``read`` (data-plane
queries, exports, fragment reads), ``write`` (imports, mutating PQL,
fragment restores), ``admin`` (schema, status, debug) — and each class
has a bounded door: at most ``depth`` requests executing, at most
``depth`` more waiting briefly (``queue-wait-ms``) for a slot.  Beyond
that the request is REJECTED AT THE DOOR with :class:`ShedError`
(HTTP 429 + ``Retry-After``) instead of queuing into collapse — under
overload the server keeps serving ``depth`` requests at pre-saturation
latency and sheds the excess, rather than serving everyone a timeout.

``depth <= 0`` disables the bound for that class (the pre-QoS
behavior, and the bench's QoS-off baseline).
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch.analysis import lockcheck
from contextlib import contextmanager
from typing import Optional

from pilosa_tpu_torch.pilosa import PilosaError
from pilosa_tpu_torch.pql.ast import WRITE_CALL_NAMES
from pilosa_tpu_torch.stats import NOP_STATS

CLASS_READ = "read"
CLASS_WRITE = "write"
CLASS_ADMIN = "admin"
CLASSES = (CLASS_READ, CLASS_WRITE, CLASS_ADMIN)

# Mutating-call markers, matched as raw bytes so one scan classifies
# both JSON bodies (the PQL string itself) and protobuf QueryRequests
# (the PQL string is embedded verbatim as a length-delimited field).
_WRITE_MARKERS = tuple(f"{name}(".encode() for name in WRITE_CALL_NAMES)


class ShedError(PilosaError):
    """Request rejected at the door (HTTP 429, or 503 when the serving
    plane itself is down); ``retry_after`` is the client hint in
    seconds for the ``Retry-After`` header."""

    def __init__(self, message: str, retry_after: float = 0.25, status: int = 429):
        super().__init__(message)
        self.retry_after = retry_after
        self.status = status


def classify_request(method: str, path: str, body: bytes = b"") -> str:
    """Map (method, path, body) to an admission class.

    The query route is split by content: a request whose body carries a
    mutating call (SetBit & co.) is a write, everything else a read —
    a cheap substring scan, not a parse, so classification never fails
    a request and costs O(len(body)) at the door.
    """
    if path.startswith("/index/") and path.endswith("/query"):
        if any(m in body for m in _WRITE_MARKERS):
            return CLASS_WRITE
        return CLASS_READ
    if path == "/import" or (
        method == "POST"
        and (
            path in ("/fragment/data", "/fragment/block/diff")
            or path.endswith("/restore")
            or path.endswith("/ingest")
            or path.endswith("/bulk")
        )
    ):
        # /ingest and /bulk: the streamed and device-build columnar
        # ingest doors — writes, so the admission bound backpressures
        # each chunk and the replica router sequences + WAL-logs it
        # like any other write.
        return CLASS_WRITE
    if path == "/export" or path.startswith("/fragment/") or path.endswith("/attr/diff"):
        return CLASS_READ
    return CLASS_ADMIN


class AdmissionController:
    """Per-class bounded admission with a short in-door wait.

    A request ACQUIRES a slot for its class before executing and
    releases it after.  When all ``depth`` slots are busy the request
    waits at most ``queue_wait_ms`` (never past its deadline) for a
    release; when the wait lane itself is full (``depth`` waiters) it
    sheds immediately — the two bounds together cap the work the
    server ever holds to 2x depth per class.

    With a :class:`~pilosa_tpu_torch.tenancy.TenancyState` attached AND a
    resolved tenant on the acquire, the same doors enforce weighted
    fair shares: a tenant past its weighted slice of ``depth`` waits or
    sheds while under-share tenants keep clearing, and the wait lane is
    bounded PER TENANT so a flooding tenant cannot fill it and shed a
    polite one at the door.  ``tenancy is None`` or ``tenant is None``
    takes the pre-tenancy path byte-identically.
    """

    def __init__(
        self,
        depths: Optional[dict[str, int]] = None,
        queue_wait_ms: float = 100.0,
        retry_after_ms: float = 250.0,
        stats=None,
        tenancy=None,
    ):
        self.depths = dict(depths or {})
        self.queue_wait_ms = queue_wait_ms
        self.retry_after = max(0.001, retry_after_ms / 1000.0)
        self.stats = stats if stats is not None else NOP_STATS
        self.tenancy = tenancy
        self._cv = lockcheck.named_condition("qos.admission._cv")
        self._active = {c: 0 for c in CLASSES}
        self._waiting = {c: 0 for c in CLASSES}
        # Totals (also mirrored into stats counters for /debug/vars).
        self.stat_admitted = 0
        self.stat_shed = 0

    def _shed(self, cls: str, tenant=None, fair=None) -> ShedError:
        self.stat_shed += 1
        self.stats.count(f"qos.shed.{cls}")
        if fair is not None and tenant is not None:
            fair.note_shed(cls, tenant)
            self.stats.count(f"tenancy.shed.{tenant}")
        return ShedError(
            f"{cls} admission queue full; retry after {self.retry_after:.3f}s",
            retry_after=self.retry_after,
        )

    def acquire(self, cls: str, deadline=None, tenant=None) -> None:
        depth = self.depths.get(cls, 0)
        fair = None
        if tenant is not None and self.tenancy is not None:
            fair = self.tenancy.fair
        with self._cv:
            if fair is not None:
                self._acquire_fair(fair, cls, depth, deadline, tenant)
                return
            if depth <= 0 or self._active[cls] < depth:
                self._active[cls] += 1
                self.stat_admitted += 1
                self.stats.gauge(f"qos.inflight.{cls}", self._active[cls])
                return
            if self._waiting[cls] >= depth:
                raise self._shed(cls)
            self._waiting[cls] += 1
            self.stats.gauge(f"qos.queue_depth.{cls}", self._waiting[cls])
            try:
                budget = self.queue_wait_ms / 1000.0
                if deadline is not None:
                    budget = min(budget, max(0.0, deadline.remaining_ms() / 1000.0))
                import time as _time

                end = _time.monotonic() + budget
                while self._active[cls] >= depth:
                    left = end - _time.monotonic()
                    if left <= 0:
                        raise self._shed(cls)
                    self._cv.wait(left)
            finally:
                self._waiting[cls] -= 1
                self.stats.gauge(f"qos.queue_depth.{cls}", self._waiting[cls])
            self._active[cls] += 1
            self.stat_admitted += 1
            self.stats.gauge(f"qos.inflight.{cls}", self._active[cls])

    def _acquire_fair(self, fair, cls: str, depth: int, deadline, tenant: str) -> None:
        """Fair-share acquire (``self._cv`` held).  Admission requires a
        free door slot AND the tenant under its weighted inflight cap;
        the wait lane is bounded per tenant (each tenant queues at most
        its own share of waiters) with a 2x-depth overall backstop."""
        if depth <= 0:
            # Unbounded door: nothing to share, account only.
            self._active[cls] += 1
            fair.note_admit(cls, tenant)
            self.stat_admitted += 1
            self.stats.count(f"tenancy.admit.{tenant}")
            self.stats.gauge(f"qos.inflight.{cls}", self._active[cls])
            return
        if self._active[cls] < depth and not fair.over_cap(cls, tenant, depth):
            self._active[cls] += 1
            fair.note_admit(cls, tenant)
            self.stat_admitted += 1
            self.stats.count(f"tenancy.admit.{tenant}")
            self.stats.gauge(f"qos.inflight.{cls}", self._active[cls])
            return
        if fair.wait_full(cls, tenant, depth) or self._waiting[cls] >= 2 * depth:
            raise self._shed(cls, tenant=tenant, fair=fair)
        self._waiting[cls] += 1
        fair.note_wait(cls, tenant, 1)
        self.stats.gauge(f"qos.queue_depth.{cls}", self._waiting[cls])
        try:
            budget = self.queue_wait_ms / 1000.0
            if deadline is not None:
                budget = min(budget, max(0.0, deadline.remaining_ms() / 1000.0))
            import time as _time

            end = _time.monotonic() + budget
            while self._active[cls] >= depth or fair.over_cap(cls, tenant, depth):
                left = end - _time.monotonic()
                if left <= 0:
                    raise self._shed(cls, tenant=tenant, fair=fair)
                self._cv.wait(left)
        finally:
            self._waiting[cls] -= 1
            fair.note_wait(cls, tenant, -1)
            self.stats.gauge(f"qos.queue_depth.{cls}", self._waiting[cls])
        self._active[cls] += 1
        fair.note_admit(cls, tenant)
        self.stat_admitted += 1
        self.stats.count(f"tenancy.admit.{tenant}")
        self.stats.gauge(f"qos.inflight.{cls}", self._active[cls])

    def release(self, cls: str, tenant=None) -> None:
        with self._cv:
            self._active[cls] -= 1
            if tenant is not None and self.tenancy is not None:
                self.tenancy.fair.note_release(cls, tenant)
                self.stats.gauge(f"qos.inflight.{cls}", self._active[cls])
                # Waiters have heterogeneous predicates (door slot AND
                # per-tenant cap), so a single notify could wake only an
                # over-cap tenant and strand an eligible one.
                self._cv.notify_all()
                return
            self.stats.gauge(f"qos.inflight.{cls}", self._active[cls])
            self._cv.notify()

    def tenants_snapshot(self) -> dict:
        """Per-tenant fair-share accounting rows (/debug/tenants)."""
        if self.tenancy is None:
            return {}
        with self._cv:
            return self.tenancy.fair.snapshot(self.depths)

    @contextmanager
    def admit(self, cls: str, deadline=None, tenant=None):
        self.acquire(cls, deadline, tenant=tenant)
        try:
            yield
        finally:
            self.release(cls, tenant=tenant)
