"""Request deadlines: a monotonic time budget that rides the request.

A ``Deadline`` is created once at the door (from the
``X-Pilosa-Deadline-Ms`` header, the ``default-deadline-ms`` config, or
``PILOSA_TPU_DEADLINE_MS``) and threaded through handler -> executor ->
cluster fan-out.  Hops between machines forward the REMAINING budget in
milliseconds — never an absolute timestamp — so no clock sync is
assumed anywhere: each receiver re-anchors the budget against its own
monotonic clock.

Expiry surfaces as :class:`DeadlineExceeded` (HTTP 504), raised at
cheap CHECKPOINTS between units of work (between PQL calls, between
slice chunks in the fan-out) — an expired request stops occupying the
serve lane at the next checkpoint instead of running to completion.
"""

from __future__ import annotations

import time
from typing import Optional

from pilosa_tpu_torch.pilosa import PilosaError

# Hop-by-hop wire format: remaining budget in integer milliseconds.
DEADLINE_HEADER = "X-Pilosa-Deadline-Ms"


class DeadlineExceeded(PilosaError):
    """The request's time budget ran out (HTTP 504).

    Deterministic given the same expiry decision — the lockstep service
    relies on this: rank 0 decides expiry once at ship time, the
    decision rides the batch entry, and every rank resolves the same
    requests to this same error.
    """

    def __init__(self, where: str = ""):
        suffix = f" ({where})" if where else ""
        super().__init__(f"deadline exceeded{suffix}")
        self.where = where


class Deadline:
    """A monotonic-clock deadline with an injectable clock (tests)."""

    __slots__ = ("_at", "_clock")

    def __init__(self, budget_ms: float, clock=time.monotonic):
        self._clock = clock
        self._at = clock() + max(0.0, float(budget_ms)) / 1000.0

    def remaining_ms(self) -> float:
        """Milliseconds left; <= 0 once expired."""
        return (self._at - self._clock()) * 1000.0

    def expired(self) -> bool:
        return self._clock() >= self._at

    def check(self, where: str = "") -> None:
        """Checkpoint: raise :class:`DeadlineExceeded` if expired."""
        if self.expired():
            raise DeadlineExceeded(where)

    def header_value(self) -> str:
        """Remaining budget for the next hop (floor 0: the receiver's
        door check sheds it immediately)."""
        return str(max(0, int(self.remaining_ms())))


def deadline_from_headers(headers, default_ms: float = 0.0) -> Optional[Deadline]:
    """Build the request's deadline from lowercase-keyed ``headers``.

    Header wins over ``default_ms`` (the server's configured default);
    ``None`` when neither applies — an unbounded request, the
    pre-QoS behavior.  A malformed header falls back to the default
    rather than failing the request at the door.
    """
    raw = (headers or {}).get(DEADLINE_HEADER.lower())
    if raw is not None:
        try:
            return Deadline(float(raw))
        except (TypeError, ValueError):
            pass
    if default_ms and default_ms > 0:
        return Deadline(default_ms)
    return None
