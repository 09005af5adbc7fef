"""Explorer scenario registry: the concurrency-dense code under
systematic schedule control.

Each scenario builds REAL project objects (WAL, router + catch-up,
qcache, ingest stager, fragment) inside an exploration run — so every
named lock, condition, guarded-field write, and patched blocking call
they touch is a controlled yield point — runs a small fixed set of
threads, and checks invariants at the end.  Scenarios flagged
``trace_check`` additionally validate the protocol events the replica
tier emitted (analysis/spec.py) against the executable model.

The ``bug_*`` entries are SEEDED KNOWN-BUG FIXTURES (``known_bug=True``):
deliberately broken twins of real protocol code — an applied-sequence
lost-update (the unlocked read-modify-write the lockset detector
flagged in the live tree, reintroduced here), and a compaction that
ignores a lagging group's backlog (dropping records catch-up still
needs).  The live-tree gate skips them; tests/test_sched.py asserts the
explorer FINDS each one and that the printed schedule string replays
the failure deterministically.  Everything else must explore clean —
any real interleaving bug a new scenario surfaces gets fixed, keeping
the analysis baseline empty (the wal_append_vs_close scenario found
exactly one: a file-backed WAL silently buffering post-close appends to
memory, fixed in replica/wal.py).

Scenario sizing: threads and per-thread work are deliberately tiny
(2-3 threads, 1-3 protocol operations each) — the schedule space grows
exponentially and the point is the INTERLEAVINGS, not the payload.
Bounds are tuned per scenario so the tier-1 suite explores every
scenario exhaustively in seconds.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import zlib

from pilosa_tpu_torch.analysis import lockcheck, spec
from pilosa_tpu_torch.analysis.sched import Scenario

# -- fake serving-group transport for router scenarios -----------------------


class _FakeGroups:
    """In-process stand-in for the HTTP groups behind a router: applies
    whatever write sequence rides the forward, tracks per-group applied
    marks, and reports the usual identity/applied headers.  State
    mutation is append/dict-store only (atomic under the explorer's
    one-thread-at-a-time execution)."""

    def __init__(self, names):
        self.store = {n: [] for n in names}
        self.applied = {n: 0 for n in names}
        self.epoch = {n: f"{n}@1" for n in names}

    def forward(self, router):
        from pilosa_tpu_torch.replica import (
            APPLIED_SEQ_HEADER,
            GROUP_HEADER,
            WRITE_SEQ_HEADER,
        )

        def _forward(g, method, path_qs, body, headers, deadline=None,
                     trace_id="", extra_headers=None, timeout_s=None):
            raw = (extra_headers or {}).get(WRITE_SEQ_HEADER) \
                or headers.get(WRITE_SEQ_HEADER)
            if raw:
                seq = int(raw)
                self.store[g.name].append(seq)
                self.applied[g.name] = max(self.applied[g.name], seq)
            rheaders = {
                GROUP_HEADER: self.epoch[g.name],
                APPLIED_SEQ_HEADER: str(self.applied[g.name]),
            }
            router._note_epoch(g, rheaders[GROUP_HEADER])
            router._note_applied(g, rheaders[APPLIED_SEQ_HEADER])
            return 200, "application/json", b"{}", rheaders

        return _forward


def _mini_router(groups=("g0", "g1", "g2"), wal=None):
    """A router over fake in-process groups: no HTTP server, no probe
    thread — scenario threads drive the protocol methods directly."""
    from pilosa_tpu_torch.replica.router import ReplicaRouter
    from pilosa_tpu_torch.replica.wal import WriteAheadLog

    wal = wal if wal is not None else WriteAheadLog(None, fsync=False)
    r = ReplicaRouter([f"{n}=127.0.0.1:1" for n in groups], wal=wal)
    fakes = _FakeGroups(list(groups))
    r._forward = fakes.forward(r)
    return r, fakes


# -- WAL scenarios -----------------------------------------------------------


class _WalAppendCompactCtx:
    """Two appenders race a compactor over one file-backed log: the
    compaction's three-phase copy/delta/swap (and its _sync_cv
    generation dance) under schedule control.  Recovery must see every
    appended record not legitimately compacted.  fsync is off here to
    keep the schedule space tight; the group-commit leader election has
    its own scenario below."""

    def __init__(self):
        from pilosa_tpu_torch.replica.wal import WriteAheadLog

        self.dir = tempfile.mkdtemp(prefix="sched-wal-")
        self.path = os.path.join(self.dir, "router.wal")
        self.wal = WriteAheadLog(self.path, fsync=False)
        self.threads = [
            lambda: self.wal.append("POST", "/w1", b"a"),
            lambda: self.wal.append("POST", "/w2", b"b"),
            lambda: self.wal.compact(1),
        ]

    def check(self):
        from pilosa_tpu_torch.replica.wal import WriteAheadLog

        self.wal.close()
        back = WriteAheadLog(self.path, fsync=False)
        try:
            live = {r.seq for r in back.records(0)}
            assert back.last_seq == 2, f"lost sequence space: {back.last_seq}"
            assert 2 in live, f"seq 2 missing after recovery: {sorted(live)}"
            assert live <= {1, 2}, f"phantom records: {sorted(live)}"
        finally:
            back.close()

    def close(self):
        self.wal.close()
        shutil.rmtree(self.dir, ignore_errors=True)


class _WalGroupCommitCtx:
    """Two appenders share one fsync'ing log: the group-commit leader
    election (one leader syscall covers both appends) explored across
    every handoff ordering.  Both records must be recoverable and the
    sequence space dense."""

    def __init__(self):
        from pilosa_tpu_torch.replica.wal import WriteAheadLog

        self.dir = tempfile.mkdtemp(prefix="sched-walgc-")
        self.path = os.path.join(self.dir, "router.wal")
        self.wal = WriteAheadLog(self.path, fsync=True)
        self.threads = [
            lambda: self.wal.append("POST", "/w1", b"a"),
            lambda: self.wal.append("POST", "/w2", b"b"),
        ]

    def check(self):
        from pilosa_tpu_torch.replica.wal import WriteAheadLog

        self.wal.close()
        back = WriteAheadLog(self.path, fsync=False)
        try:
            live = {r.seq for r in back.records(0)}
            assert live == {1, 2}, f"group commit lost a record: {sorted(live)}"
        finally:
            back.close()

    def close(self):
        self.wal.close()
        shutil.rmtree(self.dir, ignore_errors=True)


class _WalAppendCloseCtx:
    """An appender races close(): the append must either refuse with
    OSError or yield a durably recoverable record — never a sequence
    number whose record evaporates.  (This scenario found the real
    silent-buffer-after-close bug fixed in replica/wal.py.)"""

    def __init__(self):
        from pilosa_tpu_torch.replica.wal import WriteAheadLog

        self.dir = tempfile.mkdtemp(prefix="sched-walclose-")
        self.path = os.path.join(self.dir, "router.wal")
        self.wal = WriteAheadLog(self.path, fsync=False)
        self.appended = []
        self.refused = []

        def appender():
            try:
                self.appended.append(self.wal.append("POST", "/w", b"x"))
            except OSError as e:
                self.refused.append(str(e))

        self.threads = [appender, self.wal.close]

    def check(self):
        from pilosa_tpu_torch.replica.wal import WriteAheadLog

        self.wal.close()
        back = WriteAheadLog(self.path, fsync=False)
        try:
            live = {r.seq for r in back.records(0)}
            for seq in self.appended:
                assert seq in live, (
                    f"append returned seq {seq} but the record is not "
                    f"recoverable (live: {sorted(live)}) — a write was ACKed "
                    "into nothing"
                )
        finally:
            back.close()

    def close(self):
        self.wal.close()
        shutil.rmtree(self.dir, ignore_errors=True)


# -- router / catch-up scenarios --------------------------------------------


class _WriteVsCatchupCtx:
    """A writer commits sequence 3 through the sequencer while catch-up
    replays a lagging group's missed suffix (1, 2): the locked drain,
    the monotonic-max mark updates, and the rejoin flip race the
    fan-out.  Afterwards the laggard must be fully converged and every
    group must hold every live record."""

    def __init__(self):
        self.router, self.fakes = _mini_router()
        r = self.router
        # Pre-populated backlog: seqs 1..2 applied by g0/g2, missed by
        # g1 (down at the time) — the probe would have demoted it.
        for i in (1, 2):
            r.wal.append("POST", "/index/i/query", b"w%d" % i)
            spec.emit("ack", src=id(r.wal), seq=i, status=200, applied=2)
        r.shards[0].write_seq = 2
        g0, g1, g2 = r.groups
        for g in (g0, g2):
            g.applied_seq = 2
            self.fakes.applied[g.name] = 2
            self.fakes.store[g.name] = [1, 2]
        g1.caught_up = False

        def writer():
            status, _c, _p, _h = r._route_write(
                "POST", "/index/i/query", b"w3",
                {"content-type": "application/json"},
            )
            assert status == 200, f"write refused mid-scenario: {status}"

        self.threads = [writer, lambda: r.catchup.catch_up(r.groups[1])]

    def check(self):
        r = self.router
        g1 = r.groups[1]
        assert r.wal.last_seq == 3
        assert g1.caught_up, "catch-up round failed"
        assert g1.applied_seq == 3, (
            f"laggard rejoined at applied {g1.applied_seq} < head 3"
        )
        assert self.fakes.applied["g1"] == 3
        for n in ("g0", "g1", "g2"):
            assert set(self.fakes.store[n]) >= {1, 2, 3}, (
                f"{n} missing writes: {sorted(self.fakes.store[n])}"
            )

    def close(self):
        self.router.wal.close()


class _AppliedSeqNotesCtx:
    """Three handler threads note applied-sequence headers for one
    group concurrently: the locked monotonic-max must keep the highest
    mark under every interleaving (the live-tree twin of the
    bug_applied_seq_lost_update fixture)."""

    def __init__(self):
        self.router, _ = _mini_router(("g0", "g1"))
        g0 = self.router.groups[0]
        self.threads = [
            lambda: self.router._note_applied(g0, "5"),
            lambda: self.router._note_applied(g0, "9"),
            lambda: self.router._note_applied(g0, "7"),
        ]

    def check(self):
        got = self.router.groups[0].applied_seq
        assert got == 9, f"lost applied-seq update: {got} != 9"

    def close(self):
        self.router.wal.close()


# -- qcache scenario ---------------------------------------------------------


@lockcheck.guarded_class
class _FakeFragment:
    """Minimal fragment for generation_vector: the generation rebind is
    declared guarded so the writer thread's bump is a yield point."""

    _guarded_by_ = {"generation": "scenario.fakefrag._mu"}

    def __init__(self):
        self.generation = 0


class _FakeView:
    def __init__(self, frag):
        self.fragments = {0: frag}


class _FakeFrame:
    def __init__(self, frag):
        self.row_label = "rowID"
        self.inverse_enabled = False
        self.time_quantum = ""
        self.views = {"standard": _FakeView(frag)}


class _FakeIndex:
    column_label = "columnID"
    time_quantum = ""

    def max_slice(self):
        return 0

    def max_inverse_slice(self):
        return 0


class _FakeHolder:
    def __init__(self, frag):
        self._idx = _FakeIndex()
        self._frame = _FakeFrame(frag)

    def index(self, name):
        return self._idx

    def frame(self, index, name):
        return self._frame


_QUERY = 'Count(Bitmap(id=1, frame="f"))'


class _QcacheStoreVsWriteCtx:
    """A cacheable miss executes and commits while a writer bumps the
    referenced fragment's generation: commit must decline whenever the
    write landed mid-execution, and the explored history must
    linearize against the sequential store/bump/get spec — a stale
    stored result under ANY interleaving is a read-your-writes break."""

    def __init__(self):
        from pilosa_tpu_torch import qcache
        # Warm the executor import on the scheduler thread: a first-thread
        # import inside the reader would give execution #1 a different
        # yield structure than #2..N.  The parse memo needs no warm-up
        # anymore — a NamedGlobal bypasses itself under an active
        # exploration run, so every execution takes the identical
        # miss-parse path by construction.
        from pilosa_tpu_torch.executor import DEFAULT_FRAME  # noqa: F401

        self.frag = _FakeFragment()
        self.holder = _FakeHolder(self.frag)
        self.cache = qcache.QueryCache(min_cost_ms=0)
        self.history = spec.LinHistory()

        def reader():
            results, pending = self.cache.lookup(
                self.holder, "i", _QUERY, None
            )
            assert results is None  # cold cache: always a miss
            gen = self.frag.generation  # the "execution" reads state here
            value = f"v{gen}"
            opid = self.history.invoke(0, "store", (value, gen))
            stored = pending is not None and self.cache.commit(
                self.holder, pending, [value]
            )
            self.history.respond(opid, bool(stored))

        def writer():
            opid = self.history.invoke(1, "bump")
            self.frag.generation += 1
            self.history.respond(opid, None)

        self.threads = [reader, writer]

    def check(self):
        results, _pending = self.cache.lookup(self.holder, "i", _QUERY, None)
        opid = self.history.invoke(2, "get")
        self.history.respond(opid, results[0] if results else None)
        if results:
            want = f"v{self.frag.generation}"
            assert results[0] == want, (
                f"stale cache hit: {results[0]} with generation "
                f"{self.frag.generation} current — a write was lost"
            )
        ok, detail = spec.check_linearizable(
            self.history, (None, 0), spec.qcache_apply
        )
        assert ok, f"qcache history not linearizable: {detail}"

    def close(self):
        pass


# -- ingest stager scenario --------------------------------------------------


class _IngestResumeVsApplyCtx:
    """Two senders race the same two-chunk transfer (a retrying client
    re-sends chunk 0 while the original is mid-flight or already
    applied): the busy flag must never leak, offsets must only advance
    chunk-by-chunk, and chunk 1 must apply exactly once."""

    def __init__(self):
        from pilosa_tpu_torch.ingest import StreamIngestor, encode_packed

        self.applies = []
        self.errors = []
        self.ing = StreamIngestor(
            apply=lambda key, rows, cols, deadline: self.applies.append(
                (key, int(rows[0]))
            )
        )
        c0 = encode_packed([0], [5])
        c1 = encode_packed([1], [6])
        self.c0, self.c1 = c0, c1
        total = len(c0) + len(c1)
        crc = zlib.crc32(c1, zlib.crc32(c0))

        def send(chunks):
            def fn():
                from pilosa_tpu_torch.ingest import IngestError

                for off, body in chunks:
                    try:
                        self.ing.chunk(("i", "f"), off, total, crc, body,
                                       chunk_crc=zlib.crc32(body))
                    except IngestError as e:
                        self.errors.append(e.status)
            return fn

        self.threads = [
            send([(0, c0), (len(c0), c1)]),  # the real sender
            send([(0, c0)]),  # a retry racing it
        ]

    def check(self):
        later = [n for _k, n in self.applies if n == 1]
        assert len(later) <= 1, (
            f"chunk 1 applied {len(later)} times: {self.applies}"
        )
        if not self.errors:
            # No sender was turned away: the transfer must have
            # completed exactly once.
            assert len(later) == 1, (
                f"error-free run never applied chunk 1: {self.applies}"
            )
        assert all(s == 409 for s in self.errors), (
            f"unexpected ingest error statuses: {self.errors}"
        )
        # A sender bounced by the busy gate (or an offset gap) resumes
        # in real life; here the transfer may legitimately end parked —
        # but NEVER with the busy flag leaked or at an offset that is
        # not a chunk boundary.
        for st in self.ing._transfers.values():
            assert not st["busy"], "busy flag leaked on a settled transfer"
            assert st["off"] in (0, len(self.c0)), (
                f"residual transfer at non-boundary offset {st['off']}"
            )

    def close(self):
        pass


# -- fragment linearizability scenario ---------------------------------------


class _FragmentLinCtx:
    """Concurrent set/clear/count on one fragment, checked linearizable
    against the sequential bitmap spec (the fragment's RLock makes each
    op atomic; the checker proves the HISTORY is, under every explored
    schedule)."""

    def __init__(self):
        from pilosa_tpu_torch.core.fragment import Fragment

        self.dir = tempfile.mkdtemp(prefix="sched-frag-")
        self.frag = Fragment(
            os.path.join(self.dir, "0"), "i", "f", "standard", 0
        )
        self.frag.open()
        self.history = spec.LinHistory()

        def op(tid, name, *args):
            def fn():
                opid = self.history.invoke(tid, name, args)
                if name == "set":
                    r = self.frag.set_bit(*args)
                elif name == "clear":
                    r = self.frag.clear_bit(*args)
                else:
                    r = self.frag.count()
                self.history.respond(opid, r)
            return fn

        self.threads = [op(0, "set", 0, 1), op(1, "clear", 0, 1),
                        op(2, "count")]

    def check(self):
        ok, detail = spec.check_linearizable(
            self.history, frozenset(), spec.bitmap_apply
        )
        assert ok, f"fragment history not linearizable: {detail}"

    def close(self):
        self.frag.close()
        shutil.rmtree(self.dir, ignore_errors=True)


# -- seeded known-bug fixtures ----------------------------------------------


class _BugAppliedSeqLostUpdateCtx:
    """KNOWN BUG twin of _AppliedSeqNotesCtx: the applied-sequence
    read-modify-write WITHOUT the router table lock — exactly the
    unlocked monotonic-max the lockset detector caught in the live
    router.  The explorer must find the interleaving that loses the
    higher mark and print a schedule that replays it."""

    def __init__(self):
        from pilosa_tpu_torch.replica.router import GroupState

        self.g = GroupState("g0", "127.0.0.1:1")

        def note(n):
            def fn():
                cur = self.g.applied_seq  # read ...
                self.g.applied_seq = max(cur, n)  # ... racy write
            return fn

        self.threads = [note(5), note(9)]

    def check(self):
        got = self.g.applied_seq
        assert got == 9, (
            f"applied-seq lost update: mark regressed to {got} (wanted 9) — "
            "the read-modify-write ran without replica.router._mu"
        )

    def close(self):
        pass


class _BugCompactDropsUnreplayedCtx:
    """KNOWN BUG: a compaction that floors at the WAL head, ignoring a
    demoted laggard's backlog (and any resync floors).  In schedules
    where it beats the catch-up round, the laggard 'rejoins' while
    missing acked writes — caught three ways: the end-state invariant,
    the trace checker's compact_plan floor rule, and the read events
    that follow."""

    def __init__(self):
        self.router, self.fakes = _mini_router()
        r = self.router
        for i in (1, 2, 3):
            r.wal.append("POST", "/index/i/query", b"w%d" % i)
            spec.emit("ack", src=id(r.wal), seq=i, status=200, applied=2)
        r.shards[0].write_seq = 3
        g0, g1, g2 = r.groups
        for g in (g0, g2):
            g.applied_seq = 3
            self.fakes.applied[g.name] = 3
            self.fakes.store[g.name] = [1, 2, 3]
        g1.applied_seq = 1
        g1.caught_up = False
        self.fakes.applied["g1"] = 1
        self.fakes.store["g1"] = [1]

        def buggy_compactor():
            with r._mu:
                tracked = {g.name: g.applied_seq for g in r.groups}
            floor = r.wal.last_seq  # BUG: ignores g1's lag + resync floors
            spec.emit("compact_plan", src=id(r.wal), floor=floor,
                      tracked=tracked, floors=[])
            r.wal.compact(floor)

        self.threads = [buggy_compactor,
                        lambda: r.catchup.catch_up(r.groups[1])]

    def check(self):
        g1 = self.router.groups[1]
        assert not (g1.caught_up and g1.applied_seq < 3), (
            f"compaction dropped records g1 still needed: rejoined at "
            f"applied {g1.applied_seq} with head 3 — acked writes lost"
        )

    def close(self):
        self.router.wal.close()


# -- registry ----------------------------------------------------------------

SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario("wal_append_vs_compact", _WalAppendCompactCtx,
                 trace_check=True, bound=1, max_schedules=600),
        Scenario("wal_group_commit", _WalGroupCommitCtx,
                 bound=1, max_schedules=200),
        Scenario("wal_append_vs_close", _WalAppendCloseCtx,
                 bound=2, max_schedules=600),
        Scenario("router_write_vs_catchup", _WriteVsCatchupCtx,
                 trace_check=True, bound=1, max_schedules=800),
        Scenario("applied_seq_notes", _AppliedSeqNotesCtx,
                 trace_check=True, bound=2, max_schedules=800),
        Scenario("qcache_store_vs_write", _QcacheStoreVsWriteCtx,
                 bound=2, max_schedules=800),
        Scenario("ingest_resume_vs_apply", _IngestResumeVsApplyCtx,
                 bound=2, max_schedules=800),
        Scenario("fragment_set_clear_count", _FragmentLinCtx,
                 bound=1, max_schedules=600),
        Scenario("bug_applied_seq_lost_update", _BugAppliedSeqLostUpdateCtx,
                 known_bug=True, bound=2, max_schedules=400),
        Scenario("bug_compact_drops_unreplayed", _BugCompactDropsUnreplayedCtx,
                 known_bug=True, trace_check=True, bound=1,
                 max_schedules=600),
    )
}


def get(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(sorted(SCENARIOS))}"
        )


def live_scenarios() -> list[Scenario]:
    """The tier-1 gate set: every scenario that must explore clean."""
    return [s for n, s in sorted(SCENARIOS.items()) if not s.known_bug]


def known_bug_scenarios() -> list[Scenario]:
    return [s for n, s in sorted(SCENARIOS.items()) if s.known_bug]
