"""Lane selection: the ledger-driven half of the executor's strategy ladder.

The executor's fused count paths choose between two strategy families
per working set: the slice-major lane ("gram" — cached row matrix, the
all-pairs Gram and the native serve states it feeds) and the row-major
gather lane ("rmgather" — one contiguous DMA descriptor per operand
row).  The static ladder picks by shape thresholds (gram-rows-max,
``engine.prefer_rowmajor``); this module replaces the pick with a
measured one wherever the ledger has evidence, and reproduces the
static pick bit-for-bit where it doesn't.

Decision contract (the lockstep-safe part):

- ``plan_for(index, body)`` runs at the FRONT DOOR only — the server
  handler per request, the lockstep service on rank 0 at ship time.
  The returned plan dict is JSON-clean and rides ``ExecOptions.plan``
  (single host) or the batch wire entry (lockstep, next to the
  ``expired``/``trace`` flags), so every rank applies the same lane.
- ``plan["lane"] is None`` means "use the static ladder" — the
  executor's decision sites treat it exactly like no plan at all, which
  is what makes an empty ledger reproduce static decisions exactly.
- The executor reports every outcome through :meth:`Planner.record`
  under the lane that ACTUALLY ran (a planner pick vetoed by an
  eligibility gate records as the fallback lane), so mispredictions
  self-correct through the same EWMA fold everything else uses.

Convergence machinery, all deterministic (no RNG — exploration is a
consult-counter modulus, so a replayed request stream re-derives the
same decision sequence):

- confidence gate: a lane only wins on cost once every candidate lane
  has ``min_samples`` observations; until then the static ladder (plus
  exploration ticks) keeps serving.
- exploration: every ``explore_every``-th consult of a key with an
  under-sampled lane returns that lane, so the ledger gains coverage of
  the road not taken without a persistent cost.
- hysteresis: a challenger lane must beat the incumbent's EWMA by
  ``hysteresis`` (fraction) to take over — near-tied lanes don't flap.
- pinning: ``pin`` forces one lane everywhere (the debugging and
  bench-baseline lever; eligibility gates still apply).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Optional

from pilosa_tpu_torch.analysis import lockcheck

# The strategy lanes the planner arbitrates.  Deliberately NOT the
# dispatch-meter lane tags ("gather"/"stream"/"native"): those attribute
# device time to kernels, these name the executor's per-working-set
# strategy families.  Ledger entries for these lanes are written by
# Planner.record only (frame "" — strategy choice is per request shape,
# not per frame), so the two vocabularies coexist in one ledger.
PLAN_LANES = ("gram", "rmgather")

# Bound on distinct (index, fingerprint) keys with live decision state;
# matches the ledger's own LRU philosophy (dashboards repeat a small
# set of shapes).
DEFAULT_KEYS_CAP = 256
DEFAULT_MIN_SAMPLES = 3
DEFAULT_HYSTERESIS = 0.15
DEFAULT_EXPLORE_EVERY = 16


@lockcheck.guarded_class
class Planner:
    """Per-(index, fingerprint) strategy-lane selection over a
    :class:`~pilosa_tpu_torch.costs.CostLedger` (see module docstring)."""

    _guarded_by_ = {"_keys": "planner._mu"}

    def __init__(
        self,
        ledger,
        *,
        min_samples: int = DEFAULT_MIN_SAMPLES,
        hysteresis: float = DEFAULT_HYSTERESIS,
        explore_every: int = DEFAULT_EXPLORE_EVERY,
        pin: str = "",
        keys_cap: int = DEFAULT_KEYS_CAP,
        stats=None,
    ):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.ledger = ledger
        self.min_samples = max(1, int(min_samples))
        self.hysteresis = min(0.9, max(0.0, float(hysteresis)))
        self.explore_every = max(2, int(explore_every))
        self.pin = pin if pin in PLAN_LANES else ""
        self.keys_cap = max(1, int(keys_cap))
        self.stats = stats if stats is not None else NOP_STATS
        self._mu = lockcheck.named_lock("planner._mu")
        # (index, fp) -> {"consults", "incumbent", "decided": {src: n},
        #                 "wins", "losses"} — bounded LRU.
        self._keys: "OrderedDict[tuple[str, str], dict]" = OrderedDict()

    # -- consultation (front door) ----------------------------------------

    def plan_for(self, index: str, body: bytes) -> Optional[dict[str, Any]]:
        """Fingerprint one request body and consult; the JSON-clean plan
        dict for ``ExecOptions.plan`` / the batch wire, or None for
        bodies that don't fingerprint (empty)."""
        if not body:
            return None
        from pilosa_tpu_torch.trace import fingerprint

        return self.choose(index, fingerprint(body)["fp"])

    def choose(self, index: str, fp: str) -> dict[str, Any]:
        """One decision for (index, fp).  Always returns a plan dict —
        ``lane`` None means "static ladder" — so the executor can fold
        the outcome back under the fingerprint either way."""
        if not fp:
            return {"fp": "", "lane": None, "src": "static", "confidence": 0.0}
        with self._mu:
            st = self._keys.get((index, fp))
            if st is None:
                st = self._keys[(index, fp)] = {
                    "consults": 0,
                    "incumbent": None,
                    "decided": {},
                    "wins": 0,
                    "losses": 0,
                }
                while len(self._keys) > self.keys_cap:
                    self._keys.popitem(last=False)
            self._keys.move_to_end((index, fp))
            st["consults"] += 1
            consults = st["consults"]
            incumbent = st["incumbent"]
        lane: Optional[str]
        confidence = 0.0
        if self.pin:
            lane, src = self.pin, "pinned"
            confidence = 1.0
        else:
            costs = {
                ln: self.ledger.peek(index=index, frame="", fp=fp, lane=ln)
                if self.ledger is not None
                else None
                for ln in PLAN_LANES
            }
            counts = {ln: (e["n"] if e else 0) for ln, e in costs.items()}
            confidence = min(
                1.0, min(counts.values()) / float(2 * self.min_samples)
            )
            if all(n >= self.min_samples for n in counts.values()):
                best = min(PLAN_LANES, key=lambda ln: costs[ln]["ewma_ms"])
                if (
                    incumbent in PLAN_LANES
                    and best != incumbent
                    and costs[best]["ewma_ms"]
                    > costs[incumbent]["ewma_ms"] * (1.0 - self.hysteresis)
                ):
                    # Challenger inside the hysteresis band: don't flap.
                    best = incumbent
                lane, src = best, "ledger"
            elif consults % self.explore_every == 0:
                # Deterministic exploration tick: sample the lane the
                # ladder has been starving (ties break in PLAN_LANES
                # order — replicated, no RNG).
                lane = min(PLAN_LANES, key=lambda ln: (counts[ln], PLAN_LANES.index(ln)))
                src = "explore"
            else:
                lane, src = None, "static"
        with self._mu:
            st = self._keys.get((index, fp))
            if st is not None:
                st["decided"][src] = st["decided"].get(src, 0) + 1
                if lane in PLAN_LANES:
                    st["incumbent"] = lane
        self.stats.count(f"planner.choose.{src}")
        return {
            "fp": fp,
            "lane": lane,
            "src": src,
            "confidence": round(confidence, 3),
        }

    # -- fold-back (executor decision sites) ------------------------------

    def record(
        self,
        *,
        index: str,
        fp: str,
        lane: str,
        ms: float,
        plan: Optional[dict] = None,
    ) -> None:
        """Fold one observed dispatch back into the ledger under the
        lane that ACTUALLY ran, and score the decision: a planner-made
        pick (src ledger/explore/pinned) wins when its observed cost
        beats the alternative lane's current EWMA, loses otherwise —
        the /debug/planner win/loss counters and the bench's
        convergence assert both read these."""
        if not fp or lane not in PLAN_LANES:
            return
        other = PLAN_LANES[1 - PLAN_LANES.index(lane)]
        alt = (
            self.ledger.peek(index=index, frame="", fp=fp, lane=other)
            if self.ledger is not None
            else None
        )
        if self.ledger is not None:
            # Rank-0-only state in lockstep (workers carry no planner),
            # like the tracer ring; the wall timestamp is debug payload.
            # analysis-ok: lockstep-determinism: rank-0-only telemetry; lane choices ship on the batch wire
            ts = time.time()
            self.ledger.observe(
                index=index, frame="", fp=fp, lane=lane, ms=ms, wall_ts=ts,
            )
        if plan is None or plan.get("src") not in ("ledger", "explore", "pinned"):
            return
        won = alt is None or ms <= alt["ewma_ms"]
        with self._mu:
            st = self._keys.get((index, fp))
            if st is not None:
                st["wins" if won else "losses"] += 1
        if won:
            self.stats.count(f"planner.win.{lane}")
        else:
            self.stats.count(f"planner.loss.{lane}")

    # -- observability ----------------------------------------------------

    def snapshot(self, limit: int = 0) -> dict:
        """The /debug/planner payload: per-key decision state joined
        with the ledger's per-lane EWMA costs, most-consulted first."""
        with self._mu:
            items = [
                {
                    "index": k[0],
                    "fp": k[1],
                    "incumbent": v["incumbent"],
                    "consults": v["consults"],
                    "decided": dict(v["decided"]),
                    "wins": v["wins"],
                    "losses": v["losses"],
                }
                for k, v in self._keys.items()
            ]
        items.sort(key=lambda e: -e["consults"])
        if limit > 0:
            items = items[:limit]
        for e in items:
            lanes = {}
            for ln in PLAN_LANES:
                ent = (
                    self.ledger.peek(index=e["index"], frame="", fp=e["fp"], lane=ln)
                    if self.ledger is not None
                    else None
                )
                if ent is not None:
                    lanes[ln] = {
                        "n": ent["n"],
                        "ewma_ms": round(ent["ewma_ms"], 3),
                    }
            e["lanes"] = lanes
            counts = [lanes.get(ln, {}).get("n", 0) for ln in PLAN_LANES]
            e["confidence"] = round(
                min(1.0, min(counts) / float(2 * self.min_samples)), 3
            )
        return {
            "lanes": list(PLAN_LANES),
            "min_samples": self.min_samples,
            "hysteresis": self.hysteresis,
            "explore_every": self.explore_every,
            "pin": self.pin,
            "keys": items,
        }
