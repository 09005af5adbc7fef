"""Group catch-up: replaying the missed WAL suffix to a recovering group.

The contract that makes degraded-quorum writes safe is REPLAYABILITY:
any write a group missed (down, lagging, or shed under load) can be
re-delivered, in the original total order, until the group's applied
state is identical to its siblings'.  Two halves live here:

GROUP SIDE — :class:`AppliedSeq` tracks the highest router-assigned
write sequence this group has applied (the ``X-Pilosa-Write-Seq``
request header, noted once the route answered deterministically) and
persists it next to the data so a RESTARTED group reports where it
left off instead of zero.  The group reports it on every response
(``X-Pilosa-Applied-Seq``, beside ``X-Pilosa-Group``) and in the
``/replica/health`` JSON — the router's passive lag tracking and the
probe's catch-up trigger.  Persistence is write-behind of the data
itself, so after a crash the number can UNDERcount: replay then
re-applies a short suffix the group already holds — harmless, because
every sequenced write is idempotent at the group (SetBit/import
re-apply cleanly; schema mutations answer deterministic 409/404 which
catch-up counts as applied).

ROUTER SIDE — :class:`CatchupManager` streams ``wal.records(applied+1)``
to a recovering group over the router's own forward path, in order,
each tagged with its sequence (``X-Pilosa-Write-Seq``) and the replay
marker (``X-Pilosa-Replay: 1`` — the group tags sampled trace roots
``replay=true`` so replayed traffic is distinguishable in
``/debug/traces``).  EPOCH GUARD: the round pins the group's epoch at
start; if any replay response reports a different epoch the group
restarted MID-replay — the round aborts immediately (counted
``replica.catchup_abort``) rather than keep feeding a new incarnation
writes sequenced against the old one's applied state; the next probe
reads the fresh incarnation's applied_seq and starts over.  The final
records are replayed under the router's sequencer lock so no write can
slip between "drained the suffix" and "rejoined the rotation" — only a
FULLY caught-up group starts taking reads again, preserving the
cross-group read-your-writes invariant.  That locked hold is
DEADLINE-BOUND (``locked_drain_s``; ``replica.catchup_stall`` counted
on expiry): a group that turns slow or hangs mid-drain aborts the
round instead of stalling every write cluster-wide.

RESYNC HANDOFF: the automated resync (replica/resync.py) uses
this manager as its final leg — after streaming a stale or blank group
the donor's fragments it seeds the group's ``AppliedSeq`` to the
donor's sequence (``POST /replica/seed-seq``, monotonic via
:meth:`AppliedSeq.note`) and calls :meth:`CatchupManager.catch_up` to
replay the short remainder, so "rejoined" always means byte-identical
AND caught up regardless of which path brought the group back.
"""

from __future__ import annotations

import os
import threading

from pilosa_tpu_torch.analysis import lockcheck
import time
from typing import Optional

from pilosa_tpu_torch.stats import NOP_STATS


class AppliedSeq:
    """The group's high-water mark of applied router write sequences.

    ``path=None`` keeps it in memory (embedders, tests); with a path the
    value is persisted via atomic replace on every advance, so a
    restarted group resumes from (at most a hair under) where it
    stopped."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mu = lockcheck.named_lock("replica.appliedseq._mu")
        self.value = 0
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self.value = int(f.read().strip() or 0)
            except (OSError, ValueError):
                self.value = 0

    def note(self, seq: int) -> None:
        """Record that write ``seq`` was applied (monotonic max)."""
        with self._mu:
            if seq <= self.value:
                return
            self.value = seq
            if self.path:
                tmp = self.path + ".tmp"
                try:
                    with open(tmp, "w") as f:
                        f.write(str(seq))
                    os.replace(tmp, self.path)
                except OSError:
                    pass  # persistence is best-effort; replay re-converges


def note_applied_from_headers(applied: Optional[AppliedSeq], headers: dict,
                              status: int, retry_after=None) -> None:
    """Group-side helper: advance the applied mark when a request carried
    the router's write-sequence header and the route answered
    DETERMINISTICALLY — 2xx (applied) or a deterministic 4xx (the write
    answers identically on every group: 409 index-exists on a replayed
    create, 400 parse errors).  The decision is the SHARED
    :func:`pilosa_tpu_torch.replica.write_not_applied` predicate — identical
    to the router's fan-out and replay rules, so a shed expressed as a
    <500 status carrying Retry-After (pass ``retry_after`` from the
    response) never advances a mark the router considers not applied."""
    from pilosa_tpu_torch.replica import write_not_applied

    if applied is None:
        return
    raw = headers.get("x-pilosa-write-seq")
    if not raw:
        return
    if write_not_applied(status, retry_after):
        return
    try:
        applied.note(int(raw))
    except (TypeError, ValueError):
        pass


class CatchupManager:
    """Streams the missed WAL suffix to recovering groups (router side)."""

    def __init__(self, router, wal, stats=None, drain_batch: int = 64,
                 locked_drain_s: float = 5.0, budgets=None):
        self.router = router
        self.wal = wal
        self.stats = stats if stats is not None else NOP_STATS
        # Adaptive drain budget (planner.AdaptiveBudgets): when the
        # router wires one, each round sizes the locked phase from the
        # MEASURED per-record replay cost (observed below) instead of
        # the static drain_batch — fast links drain more under the lock,
        # slow ones less, both inside locked_drain_s.
        self.budgets = budgets
        # Records replayed per loop iteration OUTSIDE the sequencer
        # lock; the final <= drain_batch records replay under it so the
        # rejoin flip races no concurrent write.  That locked phase is
        # DEADLINE-BOUND (locked_drain_s, shared across its records,
        # each socket capped at the remainder): a slow or hanging
        # recovering group must not stall every write cluster-wide —
        # past the bound the round aborts, the group keeps its
        # applied_seq progress, and the next probe retries with a
        # shorter suffix.
        self.drain_batch = drain_batch
        self.locked_drain_s = locked_drain_s

    def needed(self, g) -> bool:
        return g.applied_seq < self.wal.last_seq

    def _replay_one(self, g, rec, start_epoch: str,
                    timeout_s: Optional[float] = None) -> bool:
        """Forward one WAL record to ``g``; returns True when the group
        applied (or deterministically answered) it AND its epoch still
        matches the round's.  ``timeout_s`` caps the socket (the locked
        drain's remaining deadline)."""
        from pilosa_tpu_torch.replica import (
            GROUP_HEADER,
            REPLAY_HEADER,
            WRITE_SEQ_HEADER,
            write_not_applied,
        )

        self.router.faults.hit("catchup", key=g.name)
        headers = {"content-type": rec.ctype} if rec.ctype else {}
        t_fwd = time.perf_counter()
        try:
            # The sequence and the replay marker are router-owned: the
            # forward path strips them from ``headers`` (no client may set
            # them) and sends them only as ``extra_headers``.
            status, _ctype, _payload, rheaders = self.router._forward(
                g, rec.method, rec.path, rec.body, headers,
                timeout_s=timeout_s,
                extra_headers={WRITE_SEQ_HEADER: str(rec.seq),
                               REPLAY_HEADER: "1"},
            )
        except OSError:
            return False
        finally:
            if self.budgets is not None:
                # Feed the measured replay cost back under the "catchup"
                # budget lane — the next round's drain batch reads it.
                self.budgets.observe_transfer(
                    "catchup", (time.perf_counter() - t_fwd) * 1e3,
                    len(rec.body or b""),
                )
        hdr_epoch = rheaders.get(GROUP_HEADER)
        if (start_epoch is not None and hdr_epoch is not None
                and hdr_epoch != start_epoch):
            # The group restarted mid-replay: a fresh incarnation must
            # not absorb a stream paced against the old one's state.
            self.stats.count("replica.catchup_abort")
            return False
        # The SAME "did it land?" predicate as the write fan-out and
        # the group-side bookkeeping — a shed-shaped answer (<500 with
        # Retry-After) must not advance the mark here while the fan-out
        # counts the identical answer as not applied.
        if write_not_applied(status, rheaders.get("Retry-After")):
            return False
        # Monotonic-max under the router's table lock: replay runs on
        # the probe thread while handler threads note applied marks off
        # live responses — an unguarded read-modify-write here can drop
        # the higher mark (lockset-race declared on GroupState).
        from pilosa_tpu_torch.analysis import spec

        with self.router._mu:
            g.applied_seq = max(g.applied_seq, rec.seq)
            spec.emit("apply", src=id(self.wal), group=g.name, seq=rec.seq,
                      ok=status < 300, replay=True)
        self.stats.count("replica.replayed")
        return True

    def catch_up(self, g) -> bool:
        """Run one full catch-up round for ``g`` (probe thread).  On
        success the group is fully converged and flipped back into the
        read/write rotation atomically w.r.t. the sequencer; on any
        failure the group stays out and the next probe retries."""
        start_epoch = g.epoch
        self.stats.count("replica.catchup_rounds")
        t0 = time.perf_counter()
        # Effective locked-phase record budget: measured (clamped) when
        # the adaptive budgets have replay samples, static otherwise.
        batch = (
            self.budgets.catchup_drain_batch()
            if self.budgets is not None
            else self.drain_batch
        )
        # Phase 1: drain the bulk of the suffix without blocking writes.
        while True:
            recs = self.wal.records(g.applied_seq + 1)
            if len(recs) <= batch:
                break
            for rec in recs[: -batch]:
                if not self._replay_one(g, rec, start_epoch):
                    return False
        # Phase 2: the short remainder under the sequencer lock — no new
        # write can be sequenced while the group drains to the head and
        # rejoins, so rejoining == fully caught up, always.  The lock
        # hold is DEADLINE-BOUND: a group that turned slow mid-round
        # (default socket timeout × drain_batch could stall writes for
        # minutes) aborts the round instead — it keeps its applied_seq
        # progress and the next probe retries the shorter remainder.
        with self.router._seq_mu:
            limit = time.monotonic() + self.locked_drain_s
            for rec in self.wal.records(g.applied_seq + 1):
                left = limit - time.monotonic()
                if left <= 0:
                    self.stats.count("replica.catchup_stall")
                    return False
                if not self._replay_one(g, rec, start_epoch, timeout_s=left):
                    if time.monotonic() >= limit:
                        # The socket was capped at the remaining budget:
                        # a replay that failed past it is the same expiry.
                        self.stats.count("replica.catchup_stall")
                    return False
            with self.router._mu:
                g.caught_up = True
        self.stats.timing("replica.catchup_ms", (time.perf_counter() - t0) * 1e3)
        return True
