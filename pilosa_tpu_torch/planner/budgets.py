"""Adaptive budgets: constants re-derived from measured cost/bandwidth.

Three knobs that were hand-set constants become functions of the cost
ledger, each with the same safety shape: WHILE THE LEDGER IS EMPTY (or
the relevant lanes have no samples) the static configured value is
returned unchanged, and every adaptive value is clamped to a band
around that static default — a poisoned or skewed ledger can shift a
budget, never break it.

- qcache admission floor (``qcache.min-cost-ms``): only results whose
  execution cost clears the floor are cached.  Adaptive form: the 25th
  percentile of observed per-fingerprint EWMA costs — the floor tracks
  the workload's cheap-query population instead of assuming 1 ms means
  "cheap" on every engine.  NOT used by the lockstep service (its
  floor is forced to 0 for determinism).
- replica catch-up drain batch (``CatchupManager.drain_batch``): the
  locked drain phase replays at most this many records under the
  sequencer lock.  Adaptive form: as many records as measured replay
  cost fits in half the locked-drain deadline.
- resync chunk size (``ResyncManager.chunk_bytes``): adaptive form is
  measured push bandwidth times a target per-chunk wall time, so fast
  links stream fewer, larger CRC-framed chunks and slow links keep
  chunks small enough to resume cheaply.

The replica consumers feed their own observations back through
:meth:`AdaptiveBudgets.observe_transfer` (lanes "catchup"/"resync"),
so the router side closes its loop on the data it moves itself.
"""

from __future__ import annotations

from typing import Optional

# Clamp bands and targets (fractions of / multipliers on the static
# defaults; see class docstring for the rationale per budget).
_QCACHE_FLOOR_BAND = (0.1, 10.0)
_QCACHE_MIN_ENTRIES = 8
_RESYNC_TARGET_MS = 50.0
_RESYNC_CHUNK_MIN = 64 << 10
_RESYNC_CHUNK_MAX = 4 << 20
_CATCHUP_BATCH_MIN = 16
_CATCHUP_BATCH_MAX = 1024


class AdaptiveBudgets:
    """Measured-cost replacements for three static budgets (see module
    docstring).  Thread-safe: all state lives in the ledger, which
    locks internally; the derivations are pure reads."""

    def __init__(
        self,
        ledger,
        *,
        qcache_min_cost_ms: float = 1.0,
        catchup_drain_batch: int = 64,
        catchup_locked_drain_s: float = 5.0,
        resync_chunk_bytes: int = 256 << 10,
        stats=None,
    ):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.ledger = ledger
        self.static_qcache_min_cost_ms = float(qcache_min_cost_ms)
        self.static_catchup_drain_batch = int(catchup_drain_batch)
        self.catchup_locked_drain_s = float(catchup_locked_drain_s)
        self.static_resync_chunk_bytes = int(resync_chunk_bytes)
        self.stats = stats if stats is not None else NOP_STATS

    # -- feedback (replica consumers) -------------------------------------

    def observe_transfer(self, lane: str, ms: float, bytes_moved: int = 0) -> None:
        """Fold one transfer observation (catch-up record replay, resync
        chunk push) into the ledger under its budget lane."""
        if self.ledger is not None and ms > 0:
            self.ledger.observe(
                index="", frame="", fp="", lane=lane, ms=ms,
                bytes_moved=bytes_moved,
            )

    # -- derived budgets ---------------------------------------------------

    def _lane(self, lane: str) -> Optional[dict]:
        if self.ledger is None:
            return None
        return self.ledger.peek(index="", frame="", fp="", lane=lane)

    def qcache_min_cost_ms(self) -> float:
        """Admission floor from the observed cost distribution: the 25th
        percentile of per-entry EWMA costs, clamped to [0.1x, 10x] the
        static floor; static until the ledger holds enough entries for
        a percentile to mean anything."""
        static = self.static_qcache_min_cost_ms
        if self.ledger is None or static <= 0:
            return static
        costs = sorted(e["ewma_ms"] for e in self.ledger.entries())
        if len(costs) < _QCACHE_MIN_ENTRIES:
            return static
        p25 = costs[len(costs) // 4]
        lo, hi = _QCACHE_FLOOR_BAND
        floor = min(max(p25, static * lo), static * hi)
        self.stats.gauge("planner.qcache_floor_ms", round(floor, 3))
        return floor

    def catchup_drain_batch(self) -> int:
        """Locked-drain record budget from measured replay cost: fill at
        most HALF the locked-drain deadline at the observed per-record
        EWMA (the other half absorbs variance), clamped; static while
        no replay has ever been measured."""
        static = self.static_catchup_drain_batch
        e = self._lane("catchup")
        if e is None or e["ewma_ms"] <= 0:
            return static
        fit = int((self.catchup_locked_drain_s * 1e3 / 2.0) / e["ewma_ms"])
        batch = min(max(fit, _CATCHUP_BATCH_MIN), _CATCHUP_BATCH_MAX)
        self.stats.gauge("planner.catchup_drain_batch", batch)
        return batch

    def resync_chunk_bytes(self) -> int:
        """Chunk size from measured push bandwidth x the target per-chunk
        wall time, clamped to [64 KiB, 4 MiB]; static until a chunk has
        actually moved bytes."""
        static = self.static_resync_chunk_bytes
        e = self._lane("resync")
        if e is None or e["ewma_mbps"] <= 0:
            return static
        raw = int(e["ewma_mbps"] * 1e6 * (_RESYNC_TARGET_MS / 1e3))
        chunk = min(max(raw, _RESYNC_CHUNK_MIN), _RESYNC_CHUNK_MAX)
        self.stats.gauge("planner.resync_chunk_bytes", chunk)
        return chunk
