"""Multi-tenant isolation and fairness (ROADMAP item 5).

The reference serves many indexes from one cluster over HTTP; at
"millions of users" scale that is a shared service with hostile
neighbors.  The tracer gave every trace span, slow-query log line, and
cost-ledger entry a ``tenant`` tag but enforced nothing — one tenant's
flood degraded every tenant's p99, evicted everyone's qcache entries,
and saturated the ingest doors.  This subsystem turns the attribution
into isolation, on the seams the earlier PRs left open:

- :func:`resolve` — the SINGLE tenant-resolution seam, shared by the
  HTTP handler, the lockstep front end (resolved once on rank 0, riding
  the batch wire entry like the expired/trace/plan flags so every rank
  agrees), and the replica router.  Precedence: ``X-Pilosa-Tenant``
  header > explicit ``[tenancy] map`` index→tenant table > index name >
  ``"default"``.
- :class:`FairShare` — weighted fair-share admission accounting INSIDE
  the existing QoS class doors (qos/admission.py).  Each tenant's
  inflight share of a door's depth is ``depth * w_t / W_active`` where
  ``W_active`` sums the weights of tenants at the door — inflight,
  waiting, or active within a short presence window so a tenant's
  between-requests instant never hands its share to a flooder
  (work-conserving at the window's horizon: a tenant alone gets the
  whole depth, a departed tenant's share is reclaimed).  A tenant
  over its share sheds 429 + Retry-After while under-share tenants keep
  clearing the same door; per-admit deficit (``1/w_t``) accumulates as
  the billing-adjacent debt series /debug/tenants exposes.
- :class:`BandwidthPacer` — per-tenant token buckets on the streaming
  ingest and device-bulk chunk doors so a backfill cannot starve
  interactive writes (``[tenancy] ingest-bytes-per-s``).
- :class:`TenancyState` — the per-server aggregate built from the
  ``[tenancy]`` config section: resolution map + weights + qcache byte
  shares + pacer, handed to the handler, the admission controller, the
  query cache, and the replica router.

Isolation OFF (the default — ``[tenancy] enabled = false``) is the
contract the rest of the tree relies on: no TenancyState is built and
every touched seam takes its pre-tenancy path byte-identically.
"""

from __future__ import annotations

import re
import time
from typing import Optional

from pilosa_tpu_torch.analysis import lockcheck

# Client tenant override header (case-insensitive on the wire; handler
# dicts are lowercased).
TENANT_HEADER = "X-Pilosa-Tenant"
DEFAULT_TENANT = "default"

_INDEX_RX = re.compile(r"^/index/([^/]+)")


def index_of(path: str) -> str:
    """The index an ``/index/<name>/...`` request addresses, or ""."""
    m = _INDEX_RX.match(path or "")
    return m.group(1) if m else ""


def resolve(path: str, headers=None, index_map=None,
            default: str = DEFAULT_TENANT) -> str:
    """The single tenant-resolution seam (see module docstring).

    Precedence: ``X-Pilosa-Tenant`` header > ``index_map`` entry for the
    addressed index > the index name itself > ``default`` (admin routes
    with no index).  Every door that attributes OR enforces goes through
    this function so trace tags, slow-query lines, the cost ledger, and
    the admission doors can never disagree on a request's tenant.
    """
    if headers:
        hdr = (headers.get(TENANT_HEADER.lower()) or "").strip()
        if hdr:
            return hdr
    index = index_of(path)
    if index:
        if index_map:
            mapped = index_map.get(index)
            if mapped:
                return mapped
        return index
    return default


# -- config parsing ---------------------------------------------------------


def parse_weights(s) -> dict[str, float]:
    """``"gold=4,free=1"`` -> {"gold": 4.0, "free": 1.0}."""
    out: dict[str, float] = {}
    for part in str(s or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            out[name.strip()] = max(1e-3, float(val))
        except ValueError:
            continue
    return out


def parse_map(s) -> dict[str, str]:
    """``"idx_a=gold,idx_b=free"`` -> {"idx_a": "gold", ...}."""
    out: dict[str, str] = {}
    for part in str(s or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        index, _, tenant = part.partition("=")
        if index.strip() and tenant.strip():
            out[index.strip()] = tenant.strip()
    return out


def parse_shares(s) -> tuple[float, dict[str, float]]:
    """qcache-share config: a bare fraction ("0.5" — every tenant may
    hold at most half the cache) or per-tenant overrides
    ("gold=0.75,free=0.1").  Returns (default_share, per-tenant map);
    0.0 means unquoted (no per-tenant byte cap)."""
    s = str(s or "").strip()
    if not s:
        return 0.0, {}
    if "=" not in s:
        try:
            return min(1.0, max(0.0, float(s))), {}
        except ValueError:
            return 0.0, {}
    out: dict[str, float] = {}
    for part in s.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            out[name.strip()] = min(1.0, max(0.0, float(val)))
        except ValueError:
            continue
    return 0.0, out


# -- weighted fair-share admission accounting -------------------------------


@lockcheck.guarded_class
class FairShare:
    """Per-tenant deficit-weighted accounting inside the QoS doors.

    PASSIVE by design: every method is called by AdmissionController
    with the door's ``_cv`` already held, so the accounting joins the
    door's existing critical section instead of adding a second lock to
    the admission fast path — the declarations below make that contract
    checkable (lockcheck's lockset race detector sees every rebind, the
    static guarded-fields rule covers the in-place dict mutations via
    the locked caller chain in qos/admission.py).
    """

    # Presence hysteresis: a tenant stays "present" at the door for this
    # long after its last admit/wait/release, so the instant between a
    # closed-loop client's release and its next request does NOT hand
    # its whole share to a flooder (which would then hold depth slots
    # for a full drain — exactly the burst-seizure real weighted-fair
    # schedulers smooth away).  Work conservation still holds at the
    # window's horizon: half a second after a tenant truly leaves, the
    # remaining tenants split its share.
    PRESENCE_S = 0.5

    _guarded_by_ = {
        "_inflight": "qos.admission._cv",
        "_waiting": "qos.admission._cv",
        "_seen": "qos.admission._cv",
        "_debt": "qos.admission._cv",
        "_admitted": "qos.admission._cv",
        "_shed": "qos.admission._cv",
    }

    def __init__(self, weights=None, default_weight: float = 1.0, clock=time.monotonic):
        self.weights = {k: max(1e-3, float(v)) for k, v in (weights or {}).items()}
        self.default_weight = max(1e-3, float(default_weight))
        self._clock = clock
        # cls -> tenant -> count (entries removed at zero so "present at
        # the door" is exactly the key set).
        self._inflight: dict[str, dict[str, int]] = {}
        self._waiting: dict[str, dict[str, int]] = {}
        # cls -> tenant -> last door activity (monotonic): the recency
        # half of "present" (see PRESENCE_S).
        self._seen: dict[str, dict[str, float]] = {}
        # Lifetime totals (per tenant, across classes).
        self._debt: dict[str, float] = {}
        self._admitted: dict[str, int] = {}
        self._shed: dict[str, int] = {}

    def _touch(self, cls: str, tenant: str) -> None:
        self._seen.setdefault(cls, {})[tenant] = self._clock()

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    def cap(self, cls: str, tenant: str, depth: int) -> int:
        """The tenant's inflight share of one door: a weighted split of
        ``depth`` over the tenants PRESENT at the door (inflight,
        waiting, or active within PRESENCE_S, plus the asker) —
        work-conserving at the hysteresis horizon: a tenant alone gets
        the whole depth, shares rebalance the moment a neighbor shows
        up, and a departed tenant's share is reclaimed PRESENCE_S after
        its last activity.  Never below 1: presence always buys
        eventual progress."""
        seen = self._seen.get(cls)
        recent: set = set()
        if seen:
            horizon = self._clock() - self.PRESENCE_S
            stale = [t for t, ts in seen.items() if ts < horizon]
            for t in stale:
                del seen[t]
            recent = set(seen)
        present = (
            set(self._inflight.get(cls, ()))
            | set(self._waiting.get(cls, ()))
            | recent
            | {tenant}
        )
        w_all = sum(self.weight(t) for t in present)
        if w_all <= 0.0:
            return depth
        return max(1, int(depth * self.weight(tenant) / w_all))

    def over_cap(self, cls: str, tenant: str, depth: int) -> bool:
        return self._inflight.get(cls, {}).get(tenant, 0) >= self.cap(
            cls, tenant, depth
        )

    def wait_full(self, cls: str, tenant: str, depth: int) -> bool:
        """Per-tenant wait-lane bound: a flooding tenant may queue at
        most its own share of waiters, so it can never fill the lane
        and shed a polite tenant at the door."""
        return self._waiting.get(cls, {}).get(tenant, 0) >= self.cap(
            cls, tenant, depth
        )

    def note_wait(self, cls: str, tenant: str, delta: int) -> None:
        self._touch(cls, tenant)
        by = self._waiting.setdefault(cls, {})
        n = by.get(tenant, 0) + delta
        if n <= 0:
            by.pop(tenant, None)
        else:
            by[tenant] = n

    def note_admit(self, cls: str, tenant: str) -> None:
        self._touch(cls, tenant)
        by = self._inflight.setdefault(cls, {})
        by[tenant] = by.get(tenant, 0) + 1
        # Deficit-weighted debt: each admit costs 1/w_t, so equal debt
        # growth means weight-proportional admission (the /debug/tenants
        # fairness probe and the billing-adjacent usage series).
        self._debt[tenant] = self._debt.get(tenant, 0.0) + 1.0 / self.weight(tenant)
        self._admitted[tenant] = self._admitted.get(tenant, 0) + 1

    def note_release(self, cls: str, tenant: str) -> None:
        self._touch(cls, tenant)
        by = self._inflight.get(cls)
        if by is None:
            return
        n = by.get(tenant, 0) - 1
        if n <= 0:
            by.pop(tenant, None)
        else:
            by[tenant] = n

    def note_shed(self, cls: str, tenant: str) -> None:
        self._shed[tenant] = self._shed.get(tenant, 0) + 1

    def snapshot(self, depths=None) -> dict:
        """Per-tenant accounting rows (caller holds the door's _cv)."""
        tenants: set[str] = set(self._debt) | set(self._shed)
        for by in self._inflight.values():
            tenants |= set(by)
        for by in self._waiting.values():
            tenants |= set(by)
        out = {}
        for t in sorted(tenants):
            inflight = {
                cls: by[t] for cls, by in self._inflight.items() if t in by
            }
            row = {
                "weight": self.weight(t),
                "inflight": inflight,
                "waiting": {
                    cls: by[t] for cls, by in self._waiting.items() if t in by
                },
                "debt": round(self._debt.get(t, 0.0), 3),
                "admitted": self._admitted.get(t, 0),
                "shed": self._shed.get(t, 0),
            }
            if depths:
                row["share"] = {
                    cls: self.cap(cls, t, depth)
                    for cls, depth in depths.items()
                    if depth > 0
                }
            out[t] = row
        return out


# -- per-tenant ingest/bulk bandwidth pacing --------------------------------


@lockcheck.guarded_class
class BandwidthPacer:
    """Per-tenant token-bucket pacer for the streaming-ingest and bulk
    chunk doors (``[tenancy] ingest-bytes-per-s``).

    Each tenant's refill rate is its weighted share of the aggregate
    budget over the tenants ACTIVE in the last idle window — like the
    admission caps, work-conserving: a lone backfill gets the whole
    budget, and the share rebalances the moment an interactive writer
    shows up.  :meth:`admit` answers 0.0 (chunk admitted, tokens spent)
    or the advised Retry-After seconds; the door maps that to
    429 + Retry-After through the existing ShedError plumbing.
    """

    _guarded_by_ = {"_buckets": "tenancy.pacer._mu"}

    # A bucket idle past this window returns its share to the others.
    IDLE_S = 10.0

    def __init__(self, bytes_per_s: int, weights=None,
                 default_weight: float = 1.0, burst_s: float = 2.0,
                 clock=time.monotonic):
        self.bytes_per_s = max(1, int(bytes_per_s))
        self.weights = {k: max(1e-3, float(v)) for k, v in (weights or {}).items()}
        self.default_weight = max(1e-3, float(default_weight))
        self.burst_s = max(0.1, float(burst_s))
        self._clock = clock
        self._mu = lockcheck.named_lock("tenancy.pacer._mu")
        # tenant -> [tokens, last_refill_ts, last_seen_ts]
        self._buckets: dict[str, list] = {}

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    def admit(self, tenant: str, nbytes: int) -> float:
        """Spend ``nbytes`` from the tenant's bucket.  Returns 0.0 when
        the chunk is admitted, else the advised retry-after in seconds
        (never admits partially: the chunk wire retries whole chunks)."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return 0.0
        now = self._clock()
        with self._mu:
            stale = [
                t for t, b in self._buckets.items()
                if t != tenant and now - b[2] > self.IDLE_S
            ]
            for t in stale:
                del self._buckets[t]
            w_all = sum(
                self.weight(t) for t in set(self._buckets) | {tenant}
            )
            rate = self.bytes_per_s * self.weight(tenant) / max(1e-3, w_all)
            # The burst ceiling never drops below one chunk: any single
            # chunk eventually clears, however small the share.
            cap = max(float(nbytes), rate * self.burst_s)
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = [cap, now, now]
            tokens = min(cap, b[0] + (now - b[1]) * rate)
            b[1] = now
            b[2] = now
            if tokens >= nbytes:
                b[0] = tokens - nbytes
                return 0.0
            b[0] = tokens
            return max(0.05, (nbytes - tokens) / rate)

    def snapshot(self) -> dict:
        now = self._clock()
        with self._mu:
            return {
                t: {
                    "tokens": int(b[0]),
                    "idleS": round(now - b[2], 3),
                }
                for t, b in self._buckets.items()
            }


# -- the per-server aggregate -----------------------------------------------


class TenancyState:
    """Everything one server's tenancy enforcement shares: resolution
    map, fair-share door accounting, qcache byte shares, ingest pacer.
    Built once from the ``[tenancy]`` config section and handed to the
    handler, the admission controller, the query cache, and the replica
    router; None everywhere = isolation off, byte-identical behavior."""

    def __init__(self, weights=None, default_weight: float = 1.0,
                 index_map=None, qcache_share="", ingest_bytes_per_s: int = 0,
                 stats=None):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.weights = (
            parse_weights(weights) if isinstance(weights, str)
            else {k: max(1e-3, float(v)) for k, v in (weights or {}).items()}
        )
        self.default_weight = max(1e-3, float(default_weight))
        self.index_map = (
            parse_map(index_map) if isinstance(index_map, str)
            else dict(index_map or {})
        )
        self.default_share, self.shares = parse_shares(qcache_share)
        self.stats = stats if stats is not None else NOP_STATS
        self.fair = FairShare(self.weights, self.default_weight)
        self.pacer = (
            BandwidthPacer(
                ingest_bytes_per_s,
                weights=self.weights,
                default_weight=self.default_weight,
            )
            if int(ingest_bytes_per_s or 0) > 0
            else None
        )

    def resolve(self, path: str, headers=None) -> str:
        return resolve(path, headers, self.index_map)

    def resolve_for_index(self, index: str, headers=None) -> str:
        """Resolution for doors that already hold the index name (the
        ingest/bulk chunk wire) — same precedence, no path re-parse."""
        if headers:
            hdr = (headers.get(TENANT_HEADER.lower()) or "").strip()
            if hdr:
                return hdr
        return self.tenant_of_index(index)

    def tenant_of_index(self, index: str) -> str:
        if not index:
            return DEFAULT_TENANT
        return self.index_map.get(index, index)

    def qcache_quota(self, tenant: str, max_bytes: int) -> int:
        """The tenant's qcache byte quota; 0 = unquoted."""
        share = self.shares.get(tenant, self.default_share)
        if share <= 0.0:
            return 0
        return int(max_bytes * share)


def from_config(cfg, stats=None) -> Optional[TenancyState]:
    """Build the tenancy state from a Config, or None when the
    ``[tenancy]`` section is disabled (the default)."""
    if not getattr(cfg, "tenancy_enabled", False):
        return None
    return TenancyState(
        weights=cfg.tenancy_weights,
        default_weight=cfg.tenancy_default_weight,
        index_map=cfg.tenancy_map,
        qcache_share=cfg.tenancy_qcache_share,
        ingest_bytes_per_s=cfg.tenancy_ingest_bytes_per_s,
        stats=stats,
    )
