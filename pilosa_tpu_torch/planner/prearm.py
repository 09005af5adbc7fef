"""Predictive pre-arming: re-warm hot serve states after writes.

The executor's steady-state serving loop is the armed native lane —
cached row matrix, warm Gram, captured serve state.  An invalidating
write (over the repair budget, or structural) pops that state, and
without this module the NEXT READ pays the rebuild: matrix fetch, Gram
build, state capture, all on a request's critical path.

The PreArmer moves that rebuild off the read path.  The executor's flat
lane registers a REPLAY THUNK per (index, frame) as it serves (the exact
pair arrays of the last flat batch — re-running them re-arms matrix,
Gram, and serve state through the ordinary code path, no special arming
API to keep consistent).  Write paths signal invalidation; a background
worker drains the invalidated keys hottest-first — heat is the measured
serve count since registration, the live analog of the ledger's
hit-rate ranking — re-running each key's thunk TWICE (the Gram warms on
the second touch against an unchanged matrix) under a per-cycle wall
budget, the same throttle shape as the bulk door's materialize drain:
pre-arming must never starve foreground serving.

Single-host only: the lockstep service never constructs one (a
rank-local background replay would run collectives outside the total
order).  Off by default; [planner] prearm-budget-ms enables it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from pilosa_tpu_torch.analysis import lockcheck

# Bound on registered replay thunks (one per (index, frame) dashboard).
DEFAULT_SHAPES_CAP = 16


@lockcheck.guarded_class
class PreArmer:
    """Budgeted background re-arming of invalidated serve states."""

    _guarded_by_ = {
        "_shapes": "planner.prearm._cv",
        "_pending": "planner.prearm._cv",
    }

    def __init__(self, budget_ms: float = 25.0, shapes_cap: int = DEFAULT_SHAPES_CAP,
                 stats=None):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.budget_ms = max(1.0, float(budget_ms))
        self.shapes_cap = max(1, int(shapes_cap))
        self.stats = stats if stats is not None else NOP_STATS
        self._cv = lockcheck.named_condition("planner.prearm._cv")
        # (index, frame) -> {"thunk": callable, "hits": int} — LRU.
        self._shapes: "OrderedDict[tuple[str, str], dict]" = OrderedDict()
        self._pending: set[tuple[str, str]] = set()
        self._closing = False
        self._thread: threading.Thread | None = None
        # Totals for /debug/vars readers (mirrored as stats counters).
        self.stat_armed = 0
        self.stat_deferred = 0

    # -- executor hooks (serving + write paths) ---------------------------

    def note_shape(self, index: str, frame: str, thunk) -> None:
        """Register/refresh the replay thunk for one (index, frame) and
        count the serve (the heat rank).  Called by the flat lane after
        a successful evaluation — the thunk captures that exact batch."""
        key = (index, frame)
        with self._cv:
            ent = self._shapes.get(key)
            if ent is None:
                ent = self._shapes[key] = {"thunk": thunk, "hits": 0}
                while len(self._shapes) > self.shapes_cap:
                    old, _ = self._shapes.popitem(last=False)
                    self._pending.discard(old)
            else:
                ent["thunk"] = thunk
            ent["hits"] += 1
            self._shapes.move_to_end(key)

    def note_invalidate(self, index: str, frame: str) -> None:
        """A write touched (index, frame): queue a re-arm if the shape
        is known.  Cheap no-op otherwise — every write path calls this."""
        key = (index, frame)
        with self._cv:
            if key in self._shapes and key not in self._pending:
                self._pending.add(key)
                self._cv.notify()

    def forget(self, index: str, frame: str) -> None:
        """Frame dropped: its thunk replays against a dead object graph
        for nothing — discard it."""
        with self._cv:
            self._shapes.pop((index, frame), None)
            self._pending.discard((index, frame))

    def forget_index(self, index: str) -> None:
        with self._cv:
            for k in [k for k in self._shapes if k[0] == index]:
                del self._shapes[k]
            self._pending = {k for k in self._pending if k[0] != index}

    # -- worker -----------------------------------------------------------

    def start(self) -> "PreArmer":
        self._thread = threading.Thread(
            target=self._loop, name="planner-prearm", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _drain_order(self) -> list[tuple[str, str]]:
        """Pending keys hottest-first (must be called with _cv held)."""
        return sorted(
            self._pending,
            key=lambda k: -self._shapes.get(k, {"hits": 0})["hits"],
        )

    def _loop(self) -> None:
        """Drain pending re-arms under the per-cycle budget; past it,
        yield the rest of the interval to foreground serving (deferred
        keys keep their place and drain next cycle)."""
        while True:
            with self._cv:
                while not self._pending and not self._closing:
                    self._cv.wait(timeout=1.0)
                if self._closing:
                    return
                order = self._drain_order()
            t0 = time.perf_counter()
            for key in order:
                with self._cv:
                    ent = self._shapes.get(key)
                    if ent is None or key not in self._pending:
                        continue
                    self._pending.discard(key)
                    thunk = ent["thunk"]
                try:
                    # Twice: the Gram warms on the second touch against
                    # the matrix the first touch re-cached.
                    thunk()
                    thunk()
                except Exception:  # noqa: BLE001 — arming is best-effort
                    # A failed replay (frame dropped mid-flight, engine
                    # hiccup) just means the next read pays cold-start,
                    # the pre-planner behavior; never crash the worker.
                    self.stats.count("planner.prearm_error")
                    continue
                self.stat_armed += 1
                self.stats.count("planner.prearm")
                if (time.perf_counter() - t0) * 1e3 >= self.budget_ms:
                    with self._cv:
                        deferred = len(self._pending)
                    if deferred:
                        self.stat_deferred += deferred
                        self.stats.count("planner.prearm_deferred", deferred)
                    break
            spent_ms = (time.perf_counter() - t0) * 1e3
            self.stats.timing("planner.prearm_ms", spent_ms)
            # Budget pacing: a cycle that spent its budget sleeps the
            # complement, so pre-arming holds a bounded duty cycle.
            if spent_ms >= self.budget_ms:
                time.sleep(self.budget_ms / 1e3)
