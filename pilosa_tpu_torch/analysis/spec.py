"""Executable replica write-protocol model + conformance checkers.

The router write protocol's contracts live as prose in docstrings: sequence assignment, majority-quorum commit,
abort tombstones only for provably-unapplied writes, applied-sequence
marks monotonic-max within a group epoch, WAL compaction floored at the
slowest tracked group (and at in-flight resync seeds), catch-up's
locked drain, resync's seed-seq handoff.  This module makes those
contracts EXECUTABLE, three ways:

1. **Small-scope exhaustive model checking** (:func:`model_check`):
   the protocol as an explicit state machine over G groups and up to W
   writes — writes with per-group apply/shed/ambiguous-failure
   outcomes, crash/restart with write-behind applied-mark persistence,
   in-order WAL replay, resync seeding, compaction, reads — explored
   breadth-first over EVERY reachable state, checking the invariants at
   each one:

   - no acked write lost: an acked sequence is applied by every group
     or still replayable from the log;
   - applied marks never regress within an epoch;
   - compaction never drops a record some live (tracked) group lacks;
   - a tombstoned write was never applied anywhere;
   - read-your-writes: a group serving reads holds every acked write.

   Small scope is the point (the classic small-scope hypothesis:
   protocol bugs show up at 2 groups x 2 writes); the whole space is a
   few thousand states and runs in tier-1.  ``break_*`` knobs mutate
   one rule at a time so tests can prove each invariant actually
   trips when its protecting rule is removed.

2. **Trace conformance** (:func:`check_trace`): the real router / WAL /
   catch-up / resync emit event records at their protocol transitions
   (:func:`emit` — one ``is None`` test when no collector is installed,
   zero cost in production) and the checker validates a recorded event
   stream against the same invariants.  Runs under the interleaving
   explorer's scenarios (analysis/sched.py) and, via the conftest
   gate, under the fault-seam replica e2e tests.  Traces are grouped
   by ``src`` (the WAL object identity == one sequence space == one
   router incarnation); events for sequences that predate the
   collector are tolerated (a recovered WAL replays records this trace
   never saw appended).

3. **Linearizability checking** (:func:`check_linearizable` over a
   :class:`LinHistory`): explored histories of Fragment
   set/clear/count and qcache store/invalidate are checked against
   their sequential specs with the Wing & Gong search (small histories
   only — the explorer's scenarios produce a handful of operations).
"""

from __future__ import annotations

from typing import Callable, Optional

# -- event collection --------------------------------------------------------
#
# The collector is a plain list; list.append is atomic under the GIL,
# so emission needs no lock and the event order IS the observation
# order.  (A free-threaded build would need an explicit lock here —
# noted in DEVELOPMENT.md next to the other GIL-era assumptions.)

_collector: Optional[list] = None


def emit(kind: str, **fields) -> None:
    """Record one protocol event when a collector is installed; a
    single None test otherwise (the zero-cost-off contract)."""
    c = _collector
    if c is not None:
        c.append((kind, fields))


def install_collector() -> list:
    """Install and return a fresh event list (tests / explorer)."""
    global _collector
    _collector = []
    return _collector


def uninstall_collector() -> None:
    global _collector
    _collector = None


def collector_installed() -> bool:
    return _collector is not None


# -- trace conformance -------------------------------------------------------


class _TraceState:
    """Per-src (per WAL / per router incarnation) running state."""

    __slots__ = ("last_append", "appended", "aborted", "ok_applies",
                 "acked_max", "marks", "quorum", "plan_floor")

    def __init__(self):
        self.last_append = 0
        self.appended: set[int] = set()
        self.aborted: set[int] = set()
        self.ok_applies: dict[int, set] = {}  # seq -> group names (2xx)
        self.acked_max = 0  # highest 2xx-acked sequence so far
        self.marks: dict[str, tuple] = {}  # group -> (epoch, value)
        self.quorum: Optional[int] = None
        self.plan_floor: Optional[int] = None


def check_trace(events: list) -> list[str]:
    """Validate an emitted event stream against the protocol model.
    Returns human-readable violation strings (empty = conformant)."""
    by_src: dict = {}
    out: list[str] = []

    def st(fields) -> _TraceState:
        return by_src.setdefault(fields.get("src"), _TraceState())

    for kind, f in events:
        s = st(f)
        if kind == "config":
            s.quorum = f.get("quorum")
        elif kind == "append":
            seq = f["seq"]
            if seq <= s.last_append:
                out.append(
                    f"append seq {seq} not strictly increasing "
                    f"(last was {s.last_append})"
                )
            s.last_append = max(s.last_append, seq)
            s.appended.add(seq)
        elif kind == "abort":
            seq = f["seq"]
            if s.ok_applies.get(seq):
                out.append(
                    f"abort tombstoned seq {seq} which group(s) "
                    f"{sorted(s.ok_applies[seq])} already applied — replay "
                    "will never deliver a write a live group holds"
                )
            s.aborted.add(seq)
        elif kind == "apply":
            seq = f["seq"]
            if seq in s.aborted:
                out.append(
                    f"group {f.get('group')} applied seq {seq} AFTER its "
                    "abort tombstone — replay delivered a tombstoned write"
                )
            if f.get("ok"):
                s.ok_applies.setdefault(seq, set()).add(f.get("group"))
        elif kind == "ack":
            seq, status = f["seq"], f["status"]
            if status < 300:
                if seq in s.aborted:
                    out.append(f"acked 2xx for aborted seq {seq}")
                applied = f.get("applied", 0)
                if s.quorum is not None and applied < s.quorum:
                    out.append(
                        f"seq {seq} acked 2xx with {applied} applies "
                        f"< quorum {s.quorum}"
                    )
                s.acked_max = max(s.acked_max, seq)
        elif kind in ("mark", "probe_mark", "seed"):
            g = f.get("group")
            epoch = f.get("epoch")
            value = f.get("value", f.get("seq", 0))
            prev = s.marks.get(g)
            if (
                prev is not None
                and prev[0] is not None
                and epoch is not None
                and prev[0] == epoch
                and value < prev[1]
            ):
                out.append(
                    f"group {g} applied mark regressed {prev[1]} -> {value} "
                    f"within epoch {epoch} ({kind})"
                )
            if prev is not None and prev[0] == epoch:
                value = max(value, prev[1])
            s.marks[g] = (epoch, value)
        elif kind == "compact_plan":
            floor = f["floor"]
            tracked = f.get("tracked", {})
            floors = f.get("floors", [])
            lo = min(list(tracked.values()) + list(floors), default=None)
            if lo is not None and floor > lo:
                lag = [g for g, a in tracked.items() if a < floor]
                out.append(
                    f"compaction floor {floor} exceeds the minimum tracked "
                    f"applied mark {lo} (lagging: {sorted(lag)}, resync "
                    f"floors: {sorted(floors)}) — dropped records a live "
                    "group still needs"
                )
            s.plan_floor = floor
        elif kind == "wal_compact":
            floor = f["floor"]
            if s.plan_floor is not None and floor > s.plan_floor:
                out.append(
                    f"WAL compacted past the planned floor "
                    f"({floor} > {s.plan_floor})"
                )
        elif kind == "read":
            applied = f.get("applied", 0)
            if applied < s.acked_max:
                out.append(
                    f"read routed to group {f.get('group')} at applied mark "
                    f"{applied} < acked head {s.acked_max} — read-your-writes "
                    "broken"
                )
        elif kind == "reshard":
            # Ownership-epoch fence events (src = the router).  The map
            # epoch must strictly increase — a flip that reuses an epoch
            # lets a group accept a stale ownership view as current.
            epoch = f.get("epoch")
            prev = s.marks.get("__map_epoch__")
            if prev is not None and epoch is not None and epoch <= prev[1]:
                out.append(
                    f"reshard map epoch did not advance "
                    f"({prev[1]} -> {epoch})"
                )
            s.marks["__map_epoch__"] = (None, epoch)
    return out


# -- small-scope exhaustive protocol model -----------------------------------
#
# State encoding (hashable tuples only):
#   next_seq       int — the next sequence the router would assign
#   records        tuple of (seq, live: bool) for sequences still in the
#                  log; compaction removes entries entirely
#   acked          tuple of acked (committed 2xx) sequences
#   groups         tuple per group of (data, mark, persisted, epoch, rot)
#   floor          compaction floor already applied (highest dropped seq)
#
# Two watermarks per group, deliberately distinct: ``data`` is the
# highest write whose BITS the group durably holds (fragment state —
# survives restart), ``mark`` is its AppliedSeq counter (write-behind
# persistence: restart falls back to ``persisted`` and replay
# re-delivers the suffix the group already holds — the documented
# harmless undercount).  mark <= data always; fan-out, replay, and
# seeding are in-order, so "group g holds write s" == data_g >= s
# (matching the real protocol; see catchup.py).

OUT_APPLY, OUT_SHED, OUT_FAIL = "apply", "shed", "fail"


class ModelViolation(Exception):
    pass


class ModelResult:
    __slots__ = ("states", "transitions", "violations")

    def __init__(self):
        self.states = 0
        self.transitions = 0
        self.violations: list[str] = []

    @property
    def ok(self) -> bool:
        return not self.violations


def model_check(
    n_groups: int = 2,
    max_writes: int = 2,
    max_restarts: int = 1,
    break_quorum: bool = False,
    break_compaction: bool = False,
    break_abort: bool = False,
    max_states: int = 200_000,
) -> ModelResult:
    """Exhaustively explore the protocol state machine and check the
    invariants at every reachable state.

    ``break_quorum`` commits on ANY single apply AND leaves groups
    that missed the write in the read rotation (the
    shed-was-ACKed hazard: a loaded group sheds a write its sibling
    commits, then keeps serving stale reads); ``break_compaction``
    computes the floor over in-rotation groups only (dropping what a
    demoted laggard still needs — the seeded compaction bug);
    ``break_abort`` tombstones any write that answered fewer than
    quorum (aborting writes a group applied).  Each knob must produce
    violations — tests assert that — while the unbroken model explores
    clean."""
    quorum = 1 if break_quorum else (n_groups // 2 + 1)
    res = ModelResult()
    init = (
        1,  # next_seq
        (),  # records
        (),  # acked
        tuple((0, 0, 0, 0, True) for _ in range(n_groups)),
        0,  # floor
        0,  # restarts used
    )
    seen = {init}
    work = [init]

    def invariants(state) -> None:
        next_seq, records, acked, groups, floor, _r = state
        live = {s for s, alive in records if alive}
        for s in acked:
            for gi, (data, _m, _p, _e, _rot) in enumerate(groups):
                if data < s and s not in live:
                    res.violations.append(
                        f"acked write {s} lost: group {gi} holds data up to "
                        f"{data} and the record is no longer replayable "
                        f"(state {state})"
                    )
                    return

    def out_state(state):
        if state not in seen:
            seen.add(state)
            invariants(state)
            work.append(state)
        res.transitions += 1

    def write_outcomes(n):
        # Every per-group outcome vector for the in-rotation groups.
        if n == 0:
            yield ()
            return
        for rest in write_outcomes(n - 1):
            for o in (OUT_APPLY, OUT_SHED, OUT_FAIL):
                yield (o,) + rest

    while work:
        if res.states >= max_states:
            res.violations.append("state-space cap exceeded")
            break
        state = work.pop()
        res.states += 1
        if res.violations:
            break
        next_seq, records, acked, groups, floor, restarts = state
        in_rot = [i for i, g in enumerate(groups) if g[4]]
        live_seqs = sorted(s for s, alive in records if alive)

        # WRITE: quorum precondition, then every outcome vector.
        if len(in_rot) >= quorum and next_seq <= max_writes:
            for outs in write_outcomes(len(in_rot)):
                seq = next_seq
                applied_ct = sum(1 for o in outs if o == OUT_APPLY)
                shed_any = any(o == OUT_SHED for o in outs)
                ambiguous = any(o == OUT_FAIL for o in outs)
                gl = list(groups)
                for pos, gi in enumerate(in_rot):
                    d, m, p, e, _rot = gl[gi]
                    if outs[pos] == OUT_APPLY:
                        gl[gi] = (max(d, seq), max(m, seq), p, e, True)
                    else:
                        # A group that missed a sequenced write leaves
                        # the rotation until replay re-converges it —
                        # UNLESS the broken-quorum variant models the
                        # shed-was-ACKed hazard (no demotion).
                        gl[gi] = (d, m, p, e, bool(break_quorum))
                recs = records + ((seq, True),)
                new_acked = acked
                tombstoned = False
                if applied_ct >= quorum:
                    new_acked = acked + (seq,)
                elif applied_ct == 0 and shed_any and not ambiguous:
                    # Provably applied nowhere: tombstone.
                    recs = records + ((seq, False),)
                    tombstoned = True
                elif break_abort and applied_ct < quorum:
                    recs = records + ((seq, False),)
                    tombstoned = True
                if tombstoned and applied_ct > 0:
                    res.violations.append(
                        f"write {seq} tombstoned with {applied_ct} group(s) "
                        "having applied it — replay will never re-deliver a "
                        f"write a live group holds (state {state})"
                    )
                out_state((seq + 1, recs, new_acked, tuple(gl), floor,
                           restarts))

        # PERSIST: write-behind applied-mark persistence per group.
        for gi, (d, m, p, e, rot) in enumerate(groups):
            if p != m:
                gl = list(groups)
                gl[gi] = (d, m, m, e, rot)
                out_state((next_seq, records, acked, tuple(gl), floor,
                           restarts))

        # RESTART: epoch bump; the counter falls back to its persisted
        # value (write-behind undercount) but the DATA survives; out of
        # rotation until replay re-converges the counter.
        if restarts < max_restarts:
            for gi, (d, m, p, e, rot) in enumerate(groups):
                gl = list(groups)
                gl[gi] = (d, p, p, e + 1, False)
                out_state((next_seq, records, acked, tuple(gl), floor,
                           restarts + 1))

        # REPLAY: in-order delivery of the next LIVE record past the
        # counter (idempotent for records the data already holds); a
        # group with nothing left to replay rejoins the rotation
        # (tombstones are never delivered — replay skips them).
        for gi, (d, m, p, e, rot) in enumerate(groups):
            if rot:
                continue
            missing = [s for s in live_seqs if s > m]
            if m < floor and not missing:
                # Everything past its counter was compacted away: only
                # a resync seed can bring it back (modeled below).
                continue
            if missing:
                s0 = missing[0]
                gl = list(groups)
                gl[gi] = (max(d, s0), s0, p, e, False)
            else:
                gl = list(groups)
                gl[gi] = (d, m, p, e, True)
            out_state((next_seq, records, acked, tuple(gl), floor,
                       restarts))

        # SEED (resync handoff): the laggard becomes byte-identical to
        # the best in-rotation donor and adopts its counter; the
        # remaining suffix replays normally.
        if in_rot:
            donor = max(in_rot, key=lambda i: groups[i][1])
            dd, dm = groups[donor][0], groups[donor][1]
            for gi, (d, m, p, e, rot) in enumerate(groups):
                if not rot and m < dm:
                    gl = list(groups)
                    gl[gi] = (max(d, dd), dm, dm, e, False)
                    out_state((next_seq, records, acked, tuple(gl), floor,
                               restarts))

        # COMPACT: floor at the minimum applied counter over TRACKED
        # groups (all of them — a demoted laggard still replays), or —
        # broken variant — over the in-rotation groups only.
        tracked = in_rot if break_compaction else range(len(groups))
        marks = [groups[i][1] for i in tracked]
        if marks:
            new_floor = min(marks)
            if new_floor > floor:
                recs = tuple(
                    (s, alive) for s, alive in records if s > new_floor
                )
                out_state((next_seq, recs, acked, groups, new_floor,
                           restarts))

        # READ: route to any in-rotation group; read-your-writes check
        # against the data the group actually serves.
        for gi in in_rot:
            data = groups[gi][0]
            missed = [s for s in acked if s > data]
            if missed:
                res.violations.append(
                    f"read-your-writes: group {gi} serves reads holding data "
                    f"up to {data} but write(s) {missed} are acked "
                    f"(state {state})"
                )
    return res


# -- sharded (2-D slice-shard x replica) protocol model ----------------------
#
# The router runs a (slice-shard x replica) layout: each
# shard owns a contiguous slice range, sequences its writes in its OWN
# sequence space (its own WAL, its own sequencer lock), and runs the
# catch-up/resync/compaction machinery per shard unchanged.  The
# sharded model is the PRODUCT of S per-shard instances of the
# :func:`model_check` machine — same per-shard transitions and
# invariants — plus the two properties that only exist ACROSS shards:
#
# - **exclusive ownership**: a write routed to shard k lands on shard
#   k's groups only.  Unconstrained reads fan to every shard and merge
#   by sum/union, so a write applied on a non-owning shard is counted
#   twice (``break_routing`` plants exactly that bug: the foreign-data
#   invariant must trip);
# - **cross-shard read-your-writes**: a merged read picks one
#   in-rotation group per shard; every shard's acked writes must be
#   visible in the group IT contributed (per-shard read-your-writes
#   composes — the model checks the composition explicitly at every
#   state).
#
# Scope stays small on purpose: 2 shards x 2 replicas x 1 write per
# shard x 1 shared restart explores in well under a second; the
# per-shard machinery is already exercised at 2 writes by
# :func:`model_check`, so the product run only needs enough writes to
# give every shard a sequence space of its own.


def model_check_sharded(
    n_shards: int = 2,
    n_groups: int = 2,
    max_writes_per_shard: int = 1,
    max_restarts: int = 1,
    break_quorum: bool = False,
    break_compaction: bool = False,
    break_abort: bool = False,
    break_routing: bool = False,
    max_states: int = 400_000,
) -> ModelResult:
    """Exhaustively explore the sharded protocol: ``n_shards``
    independent sequence spaces of ``n_groups`` replicas each, a shared
    restart budget, per-shard invariants at every state plus the
    cross-shard exclusive-ownership and merged-read checks.

    ``break_quorum`` / ``break_compaction`` / ``break_abort`` mutate
    the same per-shard rules as :func:`model_check` (applied to shard
    0's instance — one broken shard must be enough to trip).
    ``break_routing`` mis-routes shard 0's writes onto shard 1's groups
    too, modeling a router that fans a bit-write across shards — the
    double-count hazard the slice-cover routing exists to prevent."""
    quorum = 1 if break_quorum else (n_groups // 2 + 1)
    res = ModelResult()
    # Per-shard sub-state mirrors model_check: (next_seq, records,
    # acked, groups, floor).  ``foreign`` is a per-shard tuple of
    # per-group highest FOREIGN sequence applied (data the shard does
    # not own — always 0 unless break_routing plants it).
    shard0 = (
        1,
        (),
        (),
        tuple((0, 0, 0, 0, True) for _ in range(n_groups)),
        0,
    )
    init = (
        tuple(shard0 for _ in range(n_shards)),
        tuple(tuple(0 for _ in range(n_groups)) for _ in range(n_shards)),
        0,  # shared restarts used
    )
    seen = {init}
    work = [init]

    def invariants(state) -> None:
        shards, foreign, _r = state
        for si, (next_seq, records, acked, groups, floor) in enumerate(shards):
            live = {s for s, alive in records if alive}
            for s in acked:
                for gi, (data, _m, _p, _e, _rot) in enumerate(groups):
                    if data < s and s not in live:
                        res.violations.append(
                            f"shard {si}: acked write {s} lost: group {gi} "
                            f"holds data up to {data} and the record is no "
                            f"longer replayable (state {state})"
                        )
                        return
        for si, per_group in enumerate(foreign):
            for gi, fseq in enumerate(per_group):
                if fseq:
                    res.violations.append(
                        f"shard {si} group {gi} holds foreign write {fseq} "
                        "for a slice range it does not own — an "
                        "unconstrained fan-out read double-counts it "
                        f"(state {state})"
                    )
                    return

    def out_state(state):
        if state not in seen:
            seen.add(state)
            invariants(state)
            work.append(state)
        res.transitions += 1

    def write_outcomes(n):
        if n == 0:
            yield ()
            return
        for rest in write_outcomes(n - 1):
            for o in (OUT_APPLY, OUT_SHED, OUT_FAIL):
                yield (o,) + rest

    while work:
        if res.states >= max_states:
            res.violations.append("state-space cap exceeded")
            break
        state = work.pop()
        res.states += 1
        if res.violations:
            break
        shards, foreign, restarts = state

        def sub(si, new_shard, new_foreign=None):
            sl = list(shards)
            sl[si] = new_shard
            fl = list(foreign) if new_foreign is None else new_foreign
            out_state((tuple(sl), tuple(fl), restarts))

        for si, (next_seq, records, acked, groups, floor) in enumerate(shards):
            in_rot = [i for i, g in enumerate(groups) if g[4]]
            live_seqs = sorted(s for s, alive in records if alive)
            # The break_* knobs target shard 0's instance only.
            b_quorum = break_quorum and si == 0
            b_compaction = break_compaction and si == 0
            b_abort = break_abort and si == 0
            s_quorum = 1 if b_quorum else (n_groups // 2 + 1)

            # WRITE in shard si's sequence space.
            if len(in_rot) >= s_quorum and next_seq <= max_writes_per_shard:
                for outs in write_outcomes(len(in_rot)):
                    seq = next_seq
                    applied_ct = sum(1 for o in outs if o == OUT_APPLY)
                    shed_any = any(o == OUT_SHED for o in outs)
                    ambiguous = any(o == OUT_FAIL for o in outs)
                    gl = list(groups)
                    for pos, gi in enumerate(in_rot):
                        d, m, p, e, _rot = gl[gi]
                        if outs[pos] == OUT_APPLY:
                            gl[gi] = (max(d, seq), max(m, seq), p, e, True)
                        else:
                            gl[gi] = (d, m, p, e, bool(b_quorum))
                    recs = records + ((seq, True),)
                    new_acked = acked
                    tombstoned = False
                    if applied_ct >= s_quorum:
                        new_acked = acked + (seq,)
                    elif applied_ct == 0 and shed_any and not ambiguous:
                        recs = records + ((seq, False),)
                        tombstoned = True
                    elif b_abort and applied_ct < s_quorum:
                        recs = records + ((seq, False),)
                        tombstoned = True
                    if tombstoned and applied_ct > 0:
                        res.violations.append(
                            f"shard {si}: write {seq} tombstoned with "
                            f"{applied_ct} group(s) having applied it "
                            f"(state {state})"
                        )
                    fl = list(foreign)
                    if break_routing and si == 0 and applied_ct >= s_quorum:
                        # Mis-route: the acked write also lands on every
                        # other shard's groups as foreign data.
                        for oi in range(n_shards):
                            if oi != si:
                                fl[oi] = tuple(
                                    max(f, seq) for f in fl[oi]
                                )
                    sub(si, (seq + 1, recs, new_acked, tuple(gl), floor), fl)

            # PERSIST / RESTART / REPLAY / SEED / COMPACT per shard.
            for gi, (d, m, p, e, rot) in enumerate(groups):
                if p != m:
                    gl = list(groups)
                    gl[gi] = (d, m, m, e, rot)
                    sub(si, (next_seq, records, acked, tuple(gl), floor))
            if restarts < max_restarts:
                for gi, (d, m, p, e, rot) in enumerate(groups):
                    gl = list(groups)
                    gl[gi] = (d, p, p, e + 1, False)
                    sl = list(shards)
                    sl[si] = (next_seq, records, acked, tuple(gl), floor)
                    out_state((tuple(sl), foreign, restarts + 1))
            for gi, (d, m, p, e, rot) in enumerate(groups):
                if rot:
                    continue
                missing = [s for s in live_seqs if s > m]
                if m < floor and not missing:
                    continue
                if missing:
                    s0 = missing[0]
                    gl = list(groups)
                    gl[gi] = (max(d, s0), s0, p, e, False)
                else:
                    gl = list(groups)
                    gl[gi] = (d, m, p, e, True)
                sub(si, (next_seq, records, acked, tuple(gl), floor))
            if in_rot:
                donor = max(in_rot, key=lambda i: groups[i][1])
                dd, dm = groups[donor][0], groups[donor][1]
                for gi, (d, m, p, e, rot) in enumerate(groups):
                    if not rot and m < dm:
                        gl = list(groups)
                        gl[gi] = (max(d, dd), dm, dm, e, False)
                        sub(si, (next_seq, records, acked, tuple(gl), floor))
            tracked = in_rot if b_compaction else range(len(groups))
            marks = [groups[i][1] for i in tracked]
            if marks:
                new_floor = min(marks)
                if new_floor > floor:
                    recs = tuple(
                        (s, alive) for s, alive in records if s > new_floor
                    )
                    sub(si, (next_seq, recs, acked, groups, new_floor))

        # MERGED READ: one in-rotation group per shard (every
        # combination); shard k's acked writes must be visible in the
        # group shard k contributed — the cross-shard composition of
        # read-your-writes that the fan-out merge relies on.
        picks = [
            [i for i, g in enumerate(sh[3]) if g[4]] for sh in shards
        ]
        if all(picks):
            for si, choices in enumerate(picks):
                _ns, _recs, acked, groups, _fl = shards[si]
                for gi in choices:
                    data = groups[gi][0]
                    missed = [s for s in acked if s > data]
                    if missed:
                        res.violations.append(
                            f"merged read: shard {si} contributed group "
                            f"{gi} holding data up to {data} but write(s) "
                            f"{missed} are acked on that shard "
                            f"(state {state})"
                        )
    return res


# -- live-reshard (split -> stream -> epoch-fenced flip) model ---------------
#
# Resharding splits one shard's slice range and hands the upper half to
# a new replica set with ZERO failed writes: fragments stream to the
# new owners while the OLD shard keeps serving, then an epoch fence
# blocks the moved range just long enough to stream the delta and flip
# ownership.  The model abstracts writes to the moved range as opaque
# ids (the per-shard sequence machinery is checked by
# :func:`model_check_sharded`); what it explores is the ORDER of
# stream / flip / clear against concurrent writes:
#
# - flip only after every new-owner group holds all acked moved-range
#   writes (``break_fence`` flips without the precondition — the
#   read-your-writes invariant must trip);
# - the old owner's moved-range fragments are cleared only AFTER the
#   flip (``break_clear`` clears early — acked data is lost while the
#   old shard still owns the range).


def model_check_reshard(
    max_writes: int = 2,
    break_fence: bool = False,
    break_clear: bool = False,
    max_states: int = 50_000,
) -> ModelResult:
    """Explore the split -> stream -> epoch-fenced flip protocol for
    one moved slice range, two groups per shard."""
    res = ModelResult()
    # State: (owner, next_id, acked, old0, old1, new0, new1, epoch)
    # where acked/old*/new* are frozensets of moved-range write ids.
    empty = frozenset()
    init = (0, 1, empty, empty, empty, empty, empty, 0)
    seen = {init}
    work = [init]

    def invariants(state) -> None:
        owner, _n, acked, old0, old1, new0, new1, _e = state
        serving = (old0, old1) if owner == 0 else (new0, new1)
        for gi, data in enumerate(serving):
            missed = sorted(acked - data)
            if missed:
                res.violations.append(
                    f"moved-range read: owning shard {owner} group {gi} "
                    f"is missing acked write(s) {missed} (state {state})"
                )
                return

    def out_state(state):
        if state not in seen:
            seen.add(state)
            invariants(state)
            work.append(state)
        res.transitions += 1

    while work:
        if res.states >= max_states:
            res.violations.append("state-space cap exceeded")
            break
        state = work.pop()
        res.states += 1
        if res.violations:
            break
        owner, next_id, acked, old0, old1, new0, new1, epoch = state

        # WRITE to the moved range: applies on the CURRENT owner's
        # groups (both — quorum behavior is model_check_sharded's job),
        # never fails (the fence holds writes, it does not fail them).
        if next_id <= max_writes:
            w = frozenset({next_id})
            if owner == 0:
                out_state((0, next_id + 1, acked | w, old0 | w, old1 | w,
                           new0, new1, epoch))
            else:
                out_state((1, next_id + 1, acked | w, old0, old1,
                           new0 | w, new1 | w, epoch))

        if owner == 0:
            # STREAM: one new-owner group copies a donor old-owner
            # group's current moved-range bytes (each group streams
            # independently; repeated rounds pick up the delta).
            for donor in (old0, old1):
                out_state((0, next_id, acked, old0, old1,
                           new0 | donor, new1, epoch))
                out_state((0, next_id, acked, old0, old1,
                           new0, new1 | donor, epoch))
            # FLIP: behind the fence — every new-owner group must hold
            # all acked moved-range writes first (break_fence skips the
            # precondition: the invariant must trip on the next read).
            if break_fence or (acked <= new0 and acked <= new1):
                out_state((1, next_id, acked, old0, old1,
                           new0, new1, epoch + 1))
            if break_clear:
                # Premature clear: the old owner drops the moved range
                # while it still owns it.
                out_state((0, next_id, acked, empty, empty,
                           new0, new1, epoch))
        else:
            # CLEAR: after the flip the old owner reclaims the moved
            # fragments — safe, it no longer serves the range.
            out_state((1, next_id, acked, empty, empty,
                       new0, new1, epoch))
    return res


# -- linearizability ---------------------------------------------------------


class LinHistory:
    """Concurrent operation history recorded by scenario threads.

    ``invoke``/``respond`` use list appends (GIL-atomic) so recording
    adds no locks — under the explorer only one thread runs at a time
    anyway, and the global append order is the real-time order the
    checker respects."""

    def __init__(self):
        self._tick = [0]
        self.ops: list[dict] = []

    def invoke(self, tid: int, op, args=()) -> int:
        opid = len(self.ops)
        self.ops.append({
            "tid": tid, "op": op, "args": args,
            "inv": self._next(), "res": None, "result": None,
        })
        return opid

    def respond(self, opid: int, result) -> None:
        rec = self.ops[opid]
        rec["res"] = self._next()
        rec["result"] = result

    def _next(self) -> int:
        self._tick[0] += 1
        return self._tick[0]


def check_linearizable(history: LinHistory, init_state,
                       apply: Callable) -> tuple[bool, str]:
    """Wing & Gong search: is there a sequential order of the completed
    operations, consistent with real-time order, that the sequential
    spec accepts?  ``apply(state, op, args)`` returns either one
    ``(new_state, result)`` or a LIST of candidates (a nondeterministic
    spec — e.g. a cache that may conservatively decline a store).
    States must be hashable.  Returns (ok, detail)."""
    ops = [o for o in history.ops if o["res"] is not None]
    n = len(ops)
    seen: set = set()

    def dfs(done_mask: int, state) -> bool:
        if done_mask == (1 << n) - 1:
            return True
        key = (done_mask, state)
        if key in seen:
            return False
        seen.add(key)
        # An op may linearize next only if its invocation precedes the
        # earliest response among the other not-yet-linearized ops.
        first_res = min(
            (ops[i]["res"] for i in range(n) if not done_mask & (1 << i)),
        )
        for i in range(n):
            if done_mask & (1 << i):
                continue
            if ops[i]["inv"] > first_res:
                continue
            outs = apply(state, ops[i]["op"], ops[i]["args"])
            if isinstance(outs, tuple):
                outs = [outs]
            for new_state, result in outs:
                if result != ops[i]["result"]:
                    continue
                if dfs(done_mask | (1 << i), new_state):
                    return True
        return False

    if dfs(0, init_state):
        return True, ""
    rendered = "; ".join(
        f"t{o['tid']}:{o['op']}{o['args']}->{o['result']}" for o in ops
    )
    return False, f"no linearization of [{rendered}]"


# -- sequential specs for the explored histories -----------------------------


def bitmap_apply(state, op, args):
    """Sequential spec for Fragment set/clear/count at (row, col)
    granularity: state = frozenset of set (row, col) pairs."""
    if op == "set":
        changed = args not in state
        return (state | {args}) if changed else state, changed
    if op == "clear":
        changed = args in state
        return (state - {args}) if changed else state, changed
    if op == "count":
        return state, len(state)
    raise ValueError(op)


def qcache_apply(state, op, args):
    """Sequential spec for the generation-validated cache: state =
    (stored entry or None, current generation).  ``store`` may succeed
    ONLY while its snapshot generation is still current — but it may
    always DECLINE (the real cache's vector re-check is conservative:
    refusing a store is safe, stamping a stale one is not), so the spec
    is nondeterministic on the False branch.  ``bump`` is a write
    (generation advance); ``get`` returns the stored value only while
    its generation is current."""
    stored, gen = state
    if op == "store":
        value, snap_gen = args
        outs = [(state, False)]  # declining is always legal
        if snap_gen == gen:
            outs.append((((value, gen), gen), True))
        return outs
    if op == "bump":
        return (stored, gen + 1), None
    if op == "get":
        if stored is not None and stored[1] == gen:
            return state, stored[0]
        return state, None
    raise ValueError(op)
