"""Materialization ledger: the lazy half of the bulk build.

A bulk commit leaves each touched fragment with a pending dense
overlay (packed word planes) instead of roaring containers — serving
reads merge the overlay for free, but snapshot, sync, digest, and
roaring-shaped reads need real containers.  The ledger tracks which
fragments owe that conversion, so:

- any storage-shaped touch on a fragment pays its own debt right there
  (the fragment calls back into roaring conversion itself — the ledger
  just stops tracking it), and
- transfer completion can opportunistically drain debt oldest-first
  under a time budget (``[bulk] materialize-budget-ms``): small loads
  finish fully materialized, huge backfills stay lazy and pay on
  touch.

Fragments are held weakly: a deleted frame's debt disappears with its
fragments, never pinning storage.
"""

from __future__ import annotations

import time
import weakref

from pilosa_tpu_torch.analysis import lockcheck


class MaterializationLedger:
    """Registry of fragments carrying unmaterialized bulk overlays."""

    def __init__(self, stats=None):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.stats = stats if stats is not None else NOP_STATS
        self._mu = lockcheck.named_lock("bulk.lazy._mu")
        # Insertion-ordered weak map: oldest debt first, so the budget
        # drain retires the fragments most likely to be touched next
        # (they have been lazy the longest).
        self._pending: "weakref.WeakValueDictionary[int, object]" = (
            weakref.WeakValueDictionary()
        )

    def note_pending(self, frag) -> None:
        """A bulk commit left ``frag`` with overlay debt."""
        with self._mu:
            self._pending[id(frag)] = frag
        self.stats.gauge("bulk.lazy_pending", len(self._pending))

    def note_materialized(self, frag) -> None:
        """``frag`` paid its debt (on touch or via the drain)."""
        with self._mu:
            self._pending.pop(id(frag), None)
        self.stats.count("bulk.materialized")
        self.stats.gauge("bulk.lazy_pending", len(self._pending))

    def pending_count(self) -> int:
        with self._mu:
            return len(self._pending)

    def materialize_some(self, budget_ms: float) -> int:
        """Drain overlay debt oldest-first until ``budget_ms`` is spent
        (<= 0 means fully lazy: drain nothing).  Returns the number of
        fragments materialized.  The budget is checked BETWEEN
        fragments — one fragment's conversion always completes once
        started (partial conversions would leave torn digests)."""
        if budget_ms <= 0:
            return 0
        t0 = time.perf_counter()
        done = 0
        while (time.perf_counter() - t0) * 1000.0 < budget_ms:
            with self._mu:
                frag = None
                for key in self._pending:
                    frag = self._pending.get(key)
                    if frag is not None:
                        break
            if frag is None:
                break
            # materialize_bulk unregisters via note_materialized; a
            # concurrent touch that beat us here makes this a no-op.
            frag.materialize_bulk()
            done += 1
        if done:
            self.stats.timing(
                "bulk.materialize_drain", time.perf_counter() - t0
            )
        return done


# Process-wide default ledger: fragments report overlay debt here, the
# bulk doors drain it under the configured budget.
LEDGER = MaterializationLedger()
