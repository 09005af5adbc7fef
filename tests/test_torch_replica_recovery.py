"""The port's durable write log and group catch-up: tests/test_replica_recovery.py
through pilosa_tpu_torch.

Writes survive a dead replica group, and a restarted group re-converges:
every accepted write is sequenced into the router WAL before any group
sees it, writes commit on a majority of three groups, a restarted group
gets its missed suffix replayed (epoch-guarded) and only then rejoins
the read rotation, and partial-failure orderings are reproducible
through the seeded fault seam (PILOSA_TPU_FAULT_SPEC).  The file runs
under the port's lock checker and its replica-protocol trace check.
"""

import json
import os
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.replica import (
    APPLIED_SEQ_HEADER,
    GROUP_HEADER,
    REPLAY_HEADER,
    ReplicaRouter,
    write_not_applied,
)
from pilosa_tpu_torch.replica.catchup import AppliedSeq, note_applied_from_headers
from pilosa_tpu_torch.replica.faults import (
    FaultError,
    FaultInjector,
    InjectedStatus,
)
from pilosa_tpu_torch.replica.wal import WriteAheadLog, _FRAME
from pilosa_tpu_torch.stats import ExpvarStatsClient


# -- the port's runtime lock checker (as tests/conftest.py's gate does for
# the reference's module names, pointed at pilosa_tpu_torch) ---------------


@pytest.fixture(autouse=True)
def _port_lockcheck_gate():
    from pilosa_tpu_torch.analysis import lockcheck

    os.environ[lockcheck.ENV_VAR] = "1"
    lockcheck.enable()
    lockcheck.reset()
    try:
        yield
    finally:
        os.environ.pop(lockcheck.ENV_VAR, None)
        violations = lockcheck.take_violations()
        lockcheck.disable()
        if violations:
            pytest.fail(
                f"lock checker recorded {len(violations)} violation(s):\n\n"
                + "\n\n".join(v.describe() for v in violations),
                pytrace=False,
            )


# -- the port's replica-protocol trace check (tests/conftest.py's gate,
# pointed at pilosa_tpu_torch.analysis.spec) ---------------------------------


@pytest.fixture(autouse=True)
def _port_spec_trace_gate():
    from pilosa_tpu_torch.analysis import spec

    events = spec.install_collector()
    try:
        yield events
    finally:
        spec.uninstall_collector()
        problems = spec.check_trace(events)
        if problems:
            pytest.fail(
                "replica-protocol trace conformance: "
                f"{len(problems)} violation(s) over {len(events)} event(s):\n"
                + "\n".join("  " + p for p in problems),
                pytrace=False,
            )


# -- WAL unit tests -----------------------------------------------------------


def test_wal_append_records_roundtrip(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.wal"))
    s1 = wal.append("POST", "/index/i/query", b"SetBit(...)", "text/plain")
    s2 = wal.append("POST", "/index/i", b"{}")
    assert (s1, s2) == (1, 2)
    assert wal.last_seq == 2 and wal.first_seq == 1
    recs = wal.records(1)
    assert [(r.seq, r.method, r.path, r.body, r.ctype) for r in recs] == [
        (1, "POST", "/index/i/query", b"SetBit(...)", "text/plain"),
        (2, "POST", "/index/i", b"{}", ""),
    ]
    assert wal.records(2)[0].seq == 2 and len(wal.records(3)) == 0
    wal.close()


def test_wal_reopen_recovers_sequence_and_records(tmp_path):
    path = str(tmp_path / "w.wal")
    wal = WriteAheadLog(path)
    for i in range(5):
        wal.append("POST", f"/p{i}", bytes([i]) * i)
    wal.abort(wal.append("POST", "/aborted", b"x"))
    wal.close()
    wal2 = WriteAheadLog(path)
    assert wal2.last_seq == 6
    recs = wal2.records(1)
    assert [r.seq for r in recs] == [1, 2, 3, 4, 5]  # tombstone skipped
    assert wal2.append("POST", "/next", b"") == 7  # sequence space continues
    wal2.close()


def test_wal_torn_tail_truncated(tmp_path):
    """A crash mid-append leaves a torn frame: recovery truncates it,
    keeps every complete record, and appends continue cleanly."""
    path = str(tmp_path / "w.wal")
    stats = ExpvarStatsClient()
    wal = WriteAheadLog(path)
    wal.append("POST", "/a", b"aaaa")
    wal.append("POST", "/b", b"bbbb")
    good_size = wal.size_bytes
    wal.close()
    with open(path, "ab") as f:
        f.write(_FRAME.pack(1 << 20, 0))  # length header with no payload
        f.write(b"torn-garbage")
    wal2 = WriteAheadLog(path, stats=stats)
    assert wal2.last_seq == 2
    assert wal2.size_bytes == good_size  # the tail was truncated away
    assert stats.snapshot().get("wal.torn_tail") == 1
    assert wal2.append("POST", "/c", b"cc") == 3
    wal2.close()
    wal3 = WriteAheadLog(path)  # and the re-append round-trips
    assert [r.seq for r in wal3.records(1)] == [1, 2, 3]
    wal3.close()


def test_wal_corrupt_crc_truncates_from_there(tmp_path):
    path = str(tmp_path / "w.wal")
    wal = WriteAheadLog(path)
    wal.append("POST", "/a", b"aaaa")
    off_b = wal.size_bytes
    wal.append("POST", "/b", b"bbbb")
    wal.close()
    with open(path, "r+b") as f:  # flip a payload byte in record 2
        f.seek(off_b + _FRAME.size + 2)
        f.write(b"\xff")
    wal2 = WriteAheadLog(path)
    assert wal2.last_seq == 1  # the corrupt record and everything after drops
    assert [r.seq for r in wal2.records(1)] == [1]
    wal2.close()


def test_wal_compaction_drops_applied_prefix(tmp_path):
    path = str(tmp_path / "w.wal")
    wal = WriteAheadLog(path)
    for i in range(10):
        wal.append("POST", f"/p{i}", b"x" * 64)
    wal.abort(wal.append("POST", "/ab", b"y"))
    before = wal.size_bytes
    freed = wal.compact(7)
    assert freed > 0 and wal.size_bytes < before
    assert wal.first_seq == 8 and wal.last_seq == 11
    assert [r.seq for r in wal.records(1)] == [8, 9, 10]
    # Still recoverable from disk after the rewrite.
    wal.close()
    wal2 = WriteAheadLog(path)
    assert wal2.last_seq == 11
    assert [r.seq for r in wal2.records(1)] == [8, 9, 10]
    wal2.close()


def test_wal_in_memory_parity():
    """path=None: identical sequence/abort/replay semantics, no disk."""
    wal = WriteAheadLog(None)
    assert wal.append("POST", "/a", b"1") == 1
    assert wal.append("POST", "/b", b"2") == 2
    wal.abort(2)
    assert [r.seq for r in wal.records(1)] == [1]
    wal.compact(1)
    assert wal.records(1) == [] and wal.last_seq == 2
    assert wal.append("POST", "/c", b"3") == 3
    wal.close()


def test_wal_concurrent_appends_group_commit(tmp_path):
    """Concurrent appenders share fsyncs and never collide on sequence
    numbers or frames (the group-commit path)."""
    wal = WriteAheadLog(str(tmp_path / "w.wal"))
    seqs: list[int] = []
    mu = threading.Lock()

    def worker(k):
        for i in range(25):
            s = wal.append("POST", f"/t{k}/{i}", f"{k}:{i}".encode())
            with mu:
                seqs.append(s)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(seqs) == list(range(1, 101))
    recs = wal.records(1)
    assert [r.seq for r in recs] == list(range(1, 101))
    assert {r.body.decode() for r in recs} == {
        f"{k}:{i}" for k in range(4) for i in range(25)
    }
    wal.close()


def test_wal_compact_excludes_inflight_fsync_and_clamps_frontier(
        tmp_path, monkeypatch):
    """compact() swaps the backing file while a group-commit leader may
    be inside os.fsync on the OLD fd: the swap must WAIT for that
    leader (never close a fd under a syscall) and afterwards the
    synced frontier must be the NEW file's end — a stale old-file
    offset (which can exceed the compacted size) would make every
    later append think it is already durable and silently skip its
    fsync."""
    import pilosa_tpu_torch.replica.wal as walmod

    wal = WriteAheadLog(str(tmp_path / "w.wal"))
    for i in range(6):
        wal.append("POST", f"/w{i}", b"x" * 200)
    real_fsync = os.fsync
    main_fd = wal._f.fileno()
    gate = threading.Event()
    entered = threading.Event()

    def parked_fsync(fd):
        if fd == main_fd:
            entered.set()
            gate.wait(10)
        return real_fsync(fd)

    monkeypatch.setattr(walmod.os, "fsync", parked_fsync)
    # A leader enters fsync on the main file and parks there...
    t = threading.Thread(target=lambda: wal.append("POST", "/park", b"p"))
    t.start()
    assert entered.wait(10)
    # ...while compaction tries to drop everything and swap the file.
    done = []
    c = threading.Thread(
        target=lambda: (wal.compact(wal.last_seq), done.append(1))
    )
    c.start()
    time.sleep(0.15)
    assert not done  # the swap waited for the in-flight leader
    gate.set()
    t.join(10)
    c.join(10)
    assert done and not t.is_alive() and not c.is_alive()
    # Frontier clamped to the compacted (empty) file, not stranded at
    # the old file's larger offset.
    assert wal._synced_off == wal._end_off == wal.size_bytes
    calls = []
    monkeypatch.setattr(
        walmod.os, "fsync", lambda fd: (calls.append(fd), real_fsync(fd))[1]
    )
    wal.append("POST", "/tail", b"y")  # still reaches the disk
    assert calls
    assert [r.path for r in wal.records(1)] == ["/tail"]
    wal.close()


def test_wal_concurrent_appends_survive_repeated_compaction(tmp_path):
    """Hammer appends from several threads against back-to-back
    compactions: no appender may ever crash (the old code could fsync
    a closed/stale fd -> ValueError) and the file must stay
    frame-parseable end to end."""
    wal = WriteAheadLog(str(tmp_path / "w.wal"))
    errs = []

    def appender(k):
        try:
            for i in range(40):
                wal.append("POST", f"/t{k}/{i}", b"z" * 128)
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errs.append(e)

    ts = [threading.Thread(target=appender, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    while any(t.is_alive() for t in ts):
        wal.compact(wal.last_seq)
    for t in ts:
        t.join()
    assert errs == []
    assert wal.last_seq == 160
    wal.close()
    stats = ExpvarStatsClient()
    reopened = WriteAheadLog(wal.path, stats=stats)  # clean recovery scan
    assert stats.snapshot().get("wal.torn_tail", 0) == 0
    reopened.close()


def test_wal_hammer_under_lock_checker(tmp_path):
    """4-thread hammer — appenders (group-commit fsync) vs a dedicated
    compaction thread vs aborts — run UNDER the runtime lock checker
    (this file's gate enables PILOSA_TPU_LOCK_CHECK): the
    fsync-generation fix must hold as a checkable discipline, i.e. no
    lock-order cycle among wal._mu / _sync_cv / _compact_mu and no
    fsync under a lock outside the documented allowlist (compaction's
    bulk copy under _compact_mu; the bounded delta fsync is scope-
    allowed in compact()).  Afterwards the log must recover cleanly
    with every non-aborted record intact."""
    from pilosa_tpu_torch.analysis import lockcheck

    assert lockcheck.enabled()  # this file's gate is active
    lockcheck.reset()
    wal = WriteAheadLog(str(tmp_path / "w.wal"))
    errs: list = []
    aborted: set[int] = set()
    mu = threading.Lock()
    stop = threading.Event()

    def appender(k):
        try:
            for i in range(50):
                s = wal.append("POST", f"/t{k}/{i}", b"h" * 96)
                if i % 10 == 9:  # sprinkle tombstones into the stream
                    wal.abort(s)
                    with mu:
                        aborted.add(s)
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errs.append(e)

    def compactor():
        try:
            while not stop.is_set():
                wal.compact(0)  # keep everything live; exercise the swap
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errs.append(e)

    ts = [threading.Thread(target=appender, args=(k,)) for k in range(3)]
    ts.append(threading.Thread(target=compactor))
    for t in ts:
        t.start()
    for t in ts[:3]:
        t.join()
    stop.set()
    ts[3].join()
    assert errs == []
    vs = lockcheck.take_violations()
    assert vs == [], "\n\n".join(v.describe() for v in vs)
    live = [r.seq for r in wal.records(1)]
    assert sorted(live + sorted(aborted)) == list(range(1, 151))
    wal.close()
    reopened = WriteAheadLog(wal.path)
    assert [r.seq for r in reopened.records(1)] == live  # clean recovery
    reopened.close()


# -- fault-injection seam -----------------------------------------------------


def test_fault_spec_nth_firing_deterministic():
    fi = FaultInjector.from_spec("forward/g1:drop@3")
    # Hits 1 and 2 pass, 3 fires, 4+ pass; other keys never match.
    fi.hit("forward", key="g0")
    fi.hit("forward", key="g1")
    fi.hit("forward", key="g1")
    with pytest.raises(FaultError):
        fi.hit("forward", key="g1")
    fi.hit("forward", key="g1")


def test_fault_spec_error_and_delay_and_multi():
    fi = FaultInjector.from_spec("forward:error=429@1; wal.append:delay=1@1")
    with pytest.raises(InjectedStatus) as e:
        fi.hit("forward", key="anything")
    assert e.value.status == 429
    t0 = time.perf_counter()
    fi.hit("wal.append")
    assert time.perf_counter() - t0 >= 0.001


def test_fault_spec_seeded_probability_is_deterministic():
    decisions = []
    for _ in range(2):
        fi = FaultInjector.from_spec("seed=7; forward:drop~0.3")
        run = []
        for _ in range(50):
            try:
                fi.hit("forward")
                run.append(False)
            except FaultError:
                run.append(True)
        decisions.append(run)
    assert decisions[0] == decisions[1]  # same seed, same spec, same faults
    assert any(decisions[0]) and not all(decisions[0])


def test_fault_spec_from_env_and_bad_specs():
    assert FaultInjector.from_env({}) is None
    fi = FaultInjector.from_env({"PILOSA_TPU_FAULT_SPEC": "forward:drop@1"})
    with pytest.raises(FaultError):
        fi.hit("forward")
    with pytest.raises(ValueError):
        FaultInjector.from_spec("forward")  # no action
    with pytest.raises(ValueError):
        FaultInjector.from_spec("forward:frobnicate")


# -- applied-sequence tracking ------------------------------------------------


def test_applied_seq_persists_and_is_monotonic(tmp_path):
    path = str(tmp_path / "applied_seq")
    a = AppliedSeq(path)
    assert a.value == 0
    a.note(5)
    a.note(3)  # regressions ignored
    assert a.value == 5
    b = AppliedSeq(path)  # a restarted group resumes from disk
    assert b.value == 5


def test_note_applied_header_rules():
    a = AppliedSeq()
    note_applied_from_headers(a, {"x-pilosa-write-seq": "4"}, 200)
    assert a.value == 4
    note_applied_from_headers(a, {"x-pilosa-write-seq": "5"}, 429)  # shed
    note_applied_from_headers(a, {"x-pilosa-write-seq": "6"}, 503)  # fault
    assert a.value == 4  # load-dependent answers stay replayable
    note_applied_from_headers(a, {"x-pilosa-write-seq": "7"}, 409)
    assert a.value == 7  # deterministic 4xx advances (replay would re-answer it)
    note_applied_from_headers(a, {}, 200)  # no header: untouched
    note_applied_from_headers(a, {"x-pilosa-write-seq": "junk"}, 200)
    assert a.value == 7
    # A shed expressed as a <500 status carrying Retry-After must not
    # advance the mark either — same predicate as the router fan-out.
    note_applied_from_headers(a, {"x-pilosa-write-seq": "8"}, 200,
                              retry_after="0.250")
    assert a.value == 7


def test_write_not_applied_shared_predicate():
    """ONE rule for 'did the write land?' across the fan-out, the
    replay, and the group-side bookkeeping: 429, any 5xx, or any
    answer carrying Retry-After is NOT applied; 2xx and deterministic
    4xx are."""
    assert write_not_applied(429, None)
    assert write_not_applied(500, None)
    assert write_not_applied(503, "1.000")
    assert write_not_applied(200, "0.250")  # shed-shaped 2xx
    assert write_not_applied(409, "0.250")  # shed-shaped 4xx
    assert not write_not_applied(200, None)
    assert not write_not_applied(204, "")
    assert not write_not_applied(400, None)
    assert not write_not_applied(404, None)
    assert not write_not_applied(409, None)


# -- three-group rig (real HTTP, restartable groups) --------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


class _Rig3:
    """Three in-process group Servers on FIXED ports (so a restarted
    group keeps its address) + a router in front."""

    def __init__(self, tmp, wal=None, faults=None, probe_interval_s=0.05,
                 engine="numpy", **router_kw):
        self.tmp = tmp
        self.engine = engine
        self.ports = [_free_port() for _ in range(3)]
        self.servers = [self._spawn(i, 1) for i in range(3)]
        self.stats = ExpvarStatsClient()
        self.router = ReplicaRouter(
            [f"g{i}=127.0.0.1:{p}" for i, p in enumerate(self.ports)],
            probe_interval_s=probe_interval_s, probe_max_interval_s=0.4,
            wal=wal, faults=faults, stats=self.stats, **router_kw,
        ).serve()
        self.base = f"http://127.0.0.1:{self.router.port}"

    def _spawn(self, i: int, epoch: int):
        from pilosa_tpu_torch.server.server import Server

        cfg = Config(
            data_dir=f"{self.tmp}/g{i}", host=f"127.0.0.1:{self.ports[i]}",
            engine=self.engine, stats="expvar", qcache_enabled=False,
            replica_group=f"g{i}@{epoch}",
        )
        srv = Server(cfg)
        srv.open()
        return srv

    def restart(self, i: int, epoch: int):
        """Re-incarnate group i on the same port + data dir (the
        already-closed/killed server is simply replaced)."""
        self.servers[i] = self._spawn(i, epoch)

    def req(self, method, path, body=None, headers=None, timeout=30):
        rq = urllib.request.Request(self.base + path, data=body, method=method)
        for k, v in (headers or {}).items():
            rq.add_header(k, v)
        try:
            with urllib.request.urlopen(rq, timeout=timeout) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    def query(self, q, headers=None):
        return self.req("POST", "/index/i/query", q.encode(), headers)

    def direct_count(self, i, q='Count(Bitmap(rowID=1, frame="f"))'):
        rq = urllib.request.Request(
            f"http://127.0.0.1:{self.ports[i]}/index/i/query",
            data=q.encode(), method="POST",
        )
        with urllib.request.urlopen(rq, timeout=30) as resp:
            return json.loads(resp.read())["results"][0]

    def status(self) -> dict:
        return json.loads(self.req("GET", "/replica/status")[1])

    def group_status(self, name: str) -> dict:
        return next(g for g in self.status()["groups"] if g["name"] == name)

    def seed(self):
        assert self.req("POST", "/index/i", b"{}")[0] == 200
        assert self.req("POST", "/index/i/frame/f", b"{}")[0] == 200

    def wait_ready(self, name: str, timeout=15.0) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            g = self.group_status(name)
            if g["healthy"] and g["caughtUp"]:
                return g
            time.sleep(0.05)
        raise AssertionError(f"group {name} never rejoined: {self.group_status(name)}")

    def close(self):
        self.router.close()
        for s in self.servers:
            try:
                s.close()
            except Exception:  # noqa: BLE001 — already dead
                pass


def _is_replay(forward_kw) -> bool:
    """A catch-up replay carries the router-owned replay marker in the
    forward's ``extra_headers``."""
    return bool((forward_kw.get("extra_headers") or {}).get(REPLAY_HEADER))


@pytest.fixture
def rig3(request):
    with tempfile.TemporaryDirectory() as tmp:
        r = _Rig3(tmp, engine=getattr(request, "param", "numpy"))
        try:
            yield r
        finally:
            r.close()


@pytest.mark.parametrize("rig3", ["numpy", "torch:cpu"], indirect=True)
def test_degraded_quorum_write_survives_dead_group_and_catchup(rig3):
    """THE acceptance scenario, end to end over real HTTP: 3 groups,
    one killed -> writes keep committing (no 503 storm); after restart
    the lagging group replays the WAL suffix, converges to identical
    results, and rejoins reads only once fully caught up."""
    rig3.seed()
    for c in range(5):
        st, _, hdrs = rig3.query(f'SetBit(rowID=1, frame="f", columnID={c})')
        assert st == 200 and hdrs.get(GROUP_HEADER) == "all"

    rig3.servers[2].close()  # the whole group dies
    # Writes KEEP COMMITTING on the degraded quorum (2/3): the very
    # first write discovers the death mid-fan-out and still commits.
    for c in range(5, 15):
        st, body, _ = rig3.query(f'SetBit(rowID=1, frame="f", columnID={c})')
        assert st == 200, (c, body)
    assert rig3.direct_count(0) == rig3.direct_count(1) == 15
    g2 = rig3.group_status("g2")
    assert not g2["healthy"] and g2["lag"] >= 10
    assert rig3.status()["quorate"] is True  # majority rule: still writable
    # Reads keep serving (and never route to the dead group).
    for _ in range(6):
        st, body, hdrs = rig3.query('Count(Bitmap(rowID=1, frame="f"))')
        assert st == 200 and json.loads(body)["results"] == [15]
        assert hdrs.get(GROUP_HEADER, "").startswith(("g0", "g1"))

    routed_g2_before = rig3.stats.snapshot().get("replica.routed.g2", 0)
    rig3.restart(2, epoch=2)
    g2 = rig3.wait_ready("g2")
    # CONVERGENCE: the replayed suffix advanced g2 to the WAL head and
    # its query results are identical to its siblings'.
    assert g2["appliedSeq"] == rig3.status()["wal"]["lastSeq"]
    assert rig3.direct_count(2) == rig3.direct_count(0) == 15
    # Content-level convergence: the fragment block CHECKSUMS agree on
    # every group (generation counters are process-local tokens — the
    # checksums are the cross-process form of "identical state", and
    # identical applied sequences above prove the identical write
    # order that keeps per-group generation vectors in lockstep).
    blocks = []
    for i in range(3):
        rq = urllib.request.Request(
            f"http://127.0.0.1:{rig3.ports[i]}/fragment/blocks"
            "?index=i&frame=f&view=standard&slice=0"
        )
        with urllib.request.urlopen(rq, timeout=10) as resp:
            blocks.append(json.loads(resp.read())["blocks"])
    assert blocks[0] == blocks[1] == blocks[2] and blocks[0]
    snap = rig3.stats.snapshot()
    assert snap.get("replica.replayed", 0) >= 10
    assert snap.get("replica.epoch_bump", 0) >= 1  # g2@1 -> g2@2 observed
    # No read routed to g2 while it was down/lagging; it serves again
    # only now — and correctly.
    assert snap.get("replica.routed.g2", 0) == routed_g2_before
    served = set()
    for _ in range(9):
        st, body, hdrs = rig3.query('Count(Bitmap(rowID=1, frame="f"))')
        assert st == 200 and json.loads(body)["results"] == [15]
        served.add(hdrs.get(GROUP_HEADER, "").split("@")[0])
    assert "g2" in served


def test_crash_mid_fanout_seeded_fault_ordering():
    """The seeded fault spec reproduces a crash-mid-fan-out ordering
    exactly: the Nth forward to g1 drops, the write still commits on
    the majority, and catch-up re-converges g1 — same spec, same
    interleaving, every run."""
    with tempfile.TemporaryDirectory() as tmp:
        # seed()+2 SetBits = 4 forwards per group; the 5th forward to g1
        # is the 3rd SetBit — it fails there and only there.
        faults = FaultInjector.from_spec("forward/g1:drop@5")
        rig = _Rig3(tmp, faults=faults)
        # The probe (every 0.05 s) may replay the missed write before g1
        # is read: catch-up waits until it has been.
        read = threading.Event()
        catch_up = rig.router.catchup.catch_up
        rig.router.catchup.catch_up = lambda g: read.wait(30) and catch_up(g)
        try:
            rig.seed()
            assert rig.query('SetBit(rowID=1, frame="f", columnID=0)')[0] == 200
            assert rig.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200
            # The injected crash: g1's forward drops mid-fan-out.  The
            # write COMMITS anyway (g0 + g2 = majority).
            st, body, hdrs = rig.query('SetBit(rowID=1, frame="f", columnID=2)')
            assert st == 200, body
            assert rig.direct_count(0) == rig.direct_count(2) == 3
            assert rig.direct_count(1) == 2  # g1 missed exactly that write
            assert rig.stats.snapshot().get("replica.write_error", 0) == 1
            read.set()
            # Catch-up replays the missed record (the fault was one-shot)
            # and g1 converges.
            rig.wait_ready("g1")
            assert rig.direct_count(1) == 3
            assert rig.stats.snapshot().get("replica.replayed", 0) >= 1
        finally:
            read.set()
            rig.close()


def test_shed_after_commit_commits_on_majority(rig3, monkeypatch):
    """3-group upgrade of the two-group shed rule: a group shedding AFTER a
    sibling committed no longer fails the write — the majority commits,
    the shedding group becomes a laggard and is replayed back in."""
    rig3.seed()
    real = rig3.router._forward
    g1 = rig3.router.groups[1]
    shed = (
        429, "application/json",
        json.dumps({"error": "shed"}).encode(), {"Retry-After": "0.250"},
    )

    def shed_g1_writes(g, method, path_qs, body, headers, **kw):
        if g is g1 and b"SetBit" in body:
            return shed
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig3.router, "_forward", shed_g1_writes)
    st, body, hdrs = rig3.query('SetBit(rowID=1, frame="f", columnID=2)')
    assert st == 200 and hdrs.get(GROUP_HEADER) == "all"  # committed: 2/3
    assert rig3.direct_count(0) == rig3.direct_count(2) == 1
    assert rig3.direct_count(1) == 0
    assert not g1.healthy and not g1.caught_up  # demoted to laggard
    monkeypatch.setattr(rig3.router, "_forward", real)
    rig3.wait_ready("g1")
    assert rig3.direct_count(1) == 1  # the shed write arrived by replay


def test_shed_before_any_commit_aborts_the_record(rig3, monkeypatch):
    """A shed at the FIRST group still passes the 429 through verbatim
    — and the WAL record is tombstoned, so no later replay can deliver
    a write no live group holds."""
    rig3.seed()
    real = rig3.router._forward
    g0 = rig3.router.groups[0]
    shed = (
        429, "application/json",
        json.dumps({"error": "shed"}).encode(), {"Retry-After": "0.250"},
    )

    def shed_g0(g, method, path_qs, body, headers, **kw):
        if g is g0 and b"SetBit" in body:
            return shed
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig3.router, "_forward", shed_g0)
    st, _, hdrs = rig3.query('SetBit(rowID=1, frame="f", columnID=2)')
    assert st == 429 and hdrs.get("Retry-After") == "0.250"
    aborted_seq = rig3.router.wal.last_seq
    assert all(r.seq != aborted_seq for r in rig3.router.wal.records(1))
    assert all(g.healthy for g in rig3.router.groups)  # loaded, not broken
    assert rig3.stats.snapshot().get("replica.write_shed", 0) == 1
    monkeypatch.setattr(rig3.router, "_forward", real)
    # A group that now goes down and comes back replays the suffix —
    # which must NOT contain the aborted write.
    rig3.servers[2].close()
    assert rig3.query('SetBit(rowID=1, frame="f", columnID=3)')[0] == 200
    rig3.restart(2, epoch=2)
    rig3.wait_ready("g2")
    assert rig3.direct_count(2) == rig3.direct_count(0) == 1  # columnID=3 only


def test_transport_failure_keeps_record_replayable(rig3, monkeypatch):
    """A transport OSError proves NOTHING about application — the
    socket can die AFTER the group applied the write.  When every
    group fails ambiguously the record must stay LIVE (502, no
    tombstone) so catch-up re-delivers it; a tombstone here could hide
    a write one group actually holds, leaving permanent cross-group
    divergence."""
    rig3.seed()
    real = rig3.router._forward

    def die_on_live_setbit(g, method, path_qs, body, headers, **kw):
        if b"SetBit" in body and not _is_replay(kw):
            raise OSError("connection reset mid-exchange")
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig3.router, "_forward", die_on_live_setbit)
    st, body, _ = rig3.query('SetBit(rowID=1, frame="f", columnID=1)')
    assert st == 502 and "partially applied" in json.loads(body)["error"]
    seq = rig3.router.wal.last_seq
    assert [r.seq for r in rig3.router.wal.records(seq)] == [seq]  # LIVE
    # Every group was demoted; with the record live, catch-up delivers
    # the write to ALL of them — at-least-once, never lost.
    monkeypatch.setattr(rig3.router, "_forward", real)
    for i in range(3):
        rig3.wait_ready(f"g{i}")
    assert (rig3.direct_count(0) == rig3.direct_count(1)
            == rig3.direct_count(2) == 1)


def test_shed_after_transport_failure_does_not_abort(rig3, monkeypatch):
    """THE divergence ordering: g0 APPLIES the write but its socket
    dies before the answer; g1/g2 then shed.  Tombstoning on the shed
    (applied==0 from the router's view) would hide the write g0 holds
    — replay could never deliver it to g1/g2.  The record must stay
    live and converge everyone."""
    rig3.seed()
    real = rig3.router._forward
    g0 = rig3.router.groups[0]
    shed = (
        429, "application/json",
        json.dumps({"error": "shed"}).encode(), {"Retry-After": "0.250"},
    )

    def apply_then_die_then_shed(g, method, path_qs, body, headers, **kw):
        if b"SetBit" in body and not _is_replay(kw):
            if g is g0:
                real(g, method, path_qs, body, headers, **kw)  # g0 APPLIED
                raise OSError("reset after apply")
            return shed
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig3.router, "_forward", apply_then_die_then_shed)
    st, body, _ = rig3.query('SetBit(rowID=1, frame="f", columnID=1)')
    assert st == 502  # ambiguous — NOT the shed passthrough, NOT an abort
    seq = rig3.router.wal.last_seq
    assert [r.seq for r in rig3.router.wal.records(seq)] == [seq]  # LIVE
    assert rig3.direct_count(0) == 1  # g0 really does hold the write
    monkeypatch.setattr(rig3.router, "_forward", real)
    for i in range(3):
        rig3.wait_ready(f"g{i}")
    # Replay delivered g0's write to the siblings: no divergence.
    assert (rig3.direct_count(0) == rig3.direct_count(1)
            == rig3.direct_count(2) == 1)


def test_wal_error_injection_refuses_write(rig3, monkeypatch):
    """An injected WAL append failure refuses the write 503 BEFORE any
    group is touched (durability-first ordering)."""
    rig3.seed()

    def boom(*a, **kw):
        raise OSError("injected wal failure")

    monkeypatch.setattr(rig3.router.wal, "append", boom)
    before = [rig3.direct_count(i, 'Count(Bitmap(rowID=9, frame="f"))') for i in range(3)]
    st, body, hdrs = rig3.query('SetBit(rowID=9, frame="f", columnID=1)')
    assert st == 503 and "write log" in json.loads(body)["error"]
    assert "Retry-After" in hdrs
    after = [rig3.direct_count(i, 'Count(Bitmap(rowID=9, frame="f"))') for i in range(3)]
    assert before == after  # no group saw the refused write
    assert rig3.stats.snapshot().get("replica.wal_error", 0) == 1


def test_router_restart_recovers_durable_wal(tmp_path):
    """A router restarted over its durable WAL resumes the sequence
    space (no seq reuse = no misattributed applied marks) and keeps
    serving writes to the same groups."""
    wal_path = str(tmp_path / "router.wal")
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig3(tmp, wal=WriteAheadLog(wal_path))
        try:
            rig.seed()
            for c in range(3):
                assert rig.query(f'SetBit(rowID=1, frame="f", columnID={c})')[0] == 200
            seq_before = rig.router.wal.last_seq
            assert seq_before == 5  # 2 schema + 3 data writes
            rig.router.close()
            # New router, same log, same groups (a crashed router's
            # replacement): the sequence space continues.
            rig.router = ReplicaRouter(
                [f"g{i}=127.0.0.1:{p}" for i, p in enumerate(rig.ports)],
                probe_interval_s=0.05, wal=WriteAheadLog(wal_path),
                stats=rig.stats,
            ).serve()
            rig.base = f"http://127.0.0.1:{rig.router.port}"
            assert rig.router.wal.last_seq == seq_before
            # A restarted router TRUSTS NOTHING it cannot verify: every
            # group starts OUT of the rotation until the first probe
            # reads its persisted appliedSeq and replays any missed
            # suffix — only then does it serve again.
            assert all(not g.caught_up for g in rig.router.groups)
            for i in range(3):
                rig.wait_ready(f"g{i}")
            st, _, _ = rig.query('SetBit(rowID=1, frame="f", columnID=7)')
            assert st == 200
            assert rig.router.wal.last_seq == seq_before + 1
            assert rig.direct_count(0) == rig.direct_count(2) == 4
        finally:
            rig.close()


def test_router_restart_replays_missed_suffix_to_laggard(tmp_path):
    """A group that was LAGGING when the router died must not be
    readmitted at face value by the replacement router: the first
    probe reads its persisted appliedSeq authoritatively, replays the
    suffix the dead router never delivered, and only then lets it
    serve reads — otherwise the group silently serves reads that miss
    committed writes forever."""
    wal_path = str(tmp_path / "router.wal")
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig3(tmp, wal=WriteAheadLog(wal_path))
        try:
            rig.seed()
            assert rig.query('SetBit(rowID=1, frame="f", columnID=0)')[0] == 200
            rig.servers[2].close()  # g2 dies...
            for c in range(1, 4):  # ...and misses these three commits
                assert rig.query(
                    f'SetBit(rowID=1, frame="f", columnID={c})'
                )[0] == 200
            assert rig.direct_count(0) == 4
            rig.router.close()  # ...and then the ROUTER dies too
            rig.restart(2, epoch=2)  # g2 returns, still 3 writes behind
            assert rig.direct_count(2) == 1
            rig.router = ReplicaRouter(
                [f"g{i}=127.0.0.1:{p}" for i, p in enumerate(rig.ports)],
                probe_interval_s=0.05, wal=WriteAheadLog(wal_path),
                stats=rig.stats,
            ).serve()
            rig.base = f"http://127.0.0.1:{rig.router.port}"
            g2 = rig.wait_ready("g2")
            # The new router REPLAYED the suffix its predecessor never
            # delivered — it did not just take the group's currency on
            # faith.
            assert g2["appliedSeq"] == rig.router.wal.last_seq
            assert rig.direct_count(2) == 4
            assert rig.stats.snapshot().get("replica.replayed", 0) >= 3
            # Every routed read now sees all four committed writes —
            # read-your-writes holds across the router crash.
            for _ in range(6):
                st, body, _ = rig.query('Count(Bitmap(rowID=1, frame="f"))')
                assert st == 200 and json.loads(body)["results"] == [4]
        finally:
            rig.close()


def test_laggard_past_wal_bound_goes_stale(tmp_path):
    """A dead group whose backlog would pin the WAL past wal-max-bytes
    is declared STALE: the log compacts past it (bounded backlog), so
    replay alone can never rescue it — once it comes back alive, the
    AUTOMATED RESYNC streams it the donor's fragments and it
    rejoins converged."""
    with tempfile.TemporaryDirectory() as tmp:
        wal = WriteAheadLog(None, max_bytes=4096)
        rig = _Rig3(tmp, wal=wal)
        try:
            rig.seed()
            rig.servers[2].close()
            # Big committed writes grow the dead group's backlog past
            # the bound (the compaction floor is 64 KiB).
            big = " ".join(
                f'SetBit(rowID=1, frame="f", columnID={c})' for c in range(420)
            )
            for _ in range(40):
                assert rig.query(big)[0] == 200
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if rig.group_status("g2")["stale"]:
                    break
                assert rig.query(big)[0] == 200
            g2 = rig.group_status("g2")
            assert g2["stale"] is True
            assert rig.stats.snapshot().get("replica.stale.g2", 0) == 1
            # The log actually compacted past the laggard (0 = fully
            # drained: every retained record was applied by the
            # remaining groups).
            first = rig.router.wal.first_seq
            assert first == 0 or first > g2["appliedSeq"]
            assert rig.router.wal.last_seq > g2["appliedSeq"]
            assert rig.router.wal.size_bytes <= 4096
            # A stale group cannot rejoin by replay (the records are
            # gone from the log) — the automated resync brings it back:
            # digest diff against a donor, fragment stream, seed,
            # catch-up.  Zero operator action.
            rig.restart(2, epoch=2)
            g2 = rig.wait_ready("g2")
            assert g2["stale"] is False
            snap = rig.stats.snapshot()
            assert snap.get("replica.resync.g2", 0) >= 1
            assert rig.direct_count(2) == rig.direct_count(0)
            # And the majority keeps serving writes throughout.
            assert rig.query('SetBit(rowID=2, frame="f", columnID=1)')[0] == 200
        finally:
            rig.close()


def test_replica_status_reports_lag_and_wal(rig3):
    rig3.seed()
    assert rig3.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200
    st = rig3.status()
    assert st["quorum"] == 2 and st["quorate"] is True
    assert st["wal"]["lastSeq"] == 3 and st["wal"]["durable"] is False
    for g in st["groups"]:
        assert g["appliedSeq"] == 3 and g["lag"] == 0 and g["caughtUp"] is True
    snap = rig3.stats.snapshot()
    assert snap.get("replica.wal_bytes", 0) > 0
    assert all(snap.get(f"replica.lag.g{i}") == 0 for i in range(3))


def test_replayed_write_trace_root_tagged(rig3):
    """A catch-up replay carries X-Pilosa-Replay; a (forced) trace on
    the group tags its root replay=true so /debug/traces separates
    replay load from live load."""
    rig3.seed()
    port = rig3.ports[0]

    def direct(headers):
        rq = urllib.request.Request(
            f"http://127.0.0.1:{port}/index/i/query",
            data=b'SetBit(rowID=3, frame="f", columnID=1)', method="POST",
        )
        for k, v in headers.items():
            rq.add_header(k, v)
        with urllib.request.urlopen(rq, timeout=10) as resp:
            return resp.status

    assert direct({"X-Pilosa-Trace": "1", "X-Pilosa-Replay": "1",
                   "X-Pilosa-Write-Seq": "99"}) == 200
    rq = urllib.request.Request(f"http://127.0.0.1:{port}/debug/traces")
    with urllib.request.urlopen(rq, timeout=10) as resp:
        traces = json.loads(resp.read())["traces"]
    root = traces[0]["spans"]
    assert root["tags"].get("replay") is True
    # And the header advanced the group's applied mark (reported back).
    assert rig3.servers[0].applied_seq.value == 99


def test_group_reports_applied_seq_and_persists(rig3):
    """Every group response carries X-Pilosa-Applied-Seq; the mark is
    persisted so a restarted group resumes from it."""
    rig3.seed()
    assert rig3.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200
    rq = urllib.request.Request(f"http://127.0.0.1:{rig3.ports[1]}/version")
    with urllib.request.urlopen(rq, timeout=10) as resp:
        assert resp.headers.get(APPLIED_SEQ_HEADER) == "3"
    rq = urllib.request.Request(f"http://127.0.0.1:{rig3.ports[1]}/replica/health")
    with urllib.request.urlopen(rq, timeout=10) as resp:
        assert json.loads(resp.read())["appliedSeq"] == 3
    rig3.servers[1].close()
    rig3.restart(1, epoch=2)
    assert rig3.servers[1].applied_seq.value == 3  # reloaded from disk


def test_catchup_epoch_guard_aborts_on_restart_mid_replay(rig3, monkeypatch):
    """A replay response reporting a DIFFERENT group epoch aborts the
    catch-up round: a restarted incarnation must never absorb a stream
    paced against its predecessor's applied state — the next probe
    reads the fresh incarnation's mark and starts over."""
    rig3.seed()
    g2 = rig3.router.groups[2]
    rec = rig3.router.wal.records(1)[0]

    def bumped_epoch(g, method, path, body, headers, **kw):
        return 200, "application/json", b"{}", {GROUP_HEADER: "g2@99"}

    monkeypatch.setattr(rig3.router, "_forward", bumped_epoch)
    before = g2.applied_seq
    assert rig3.router.catchup._replay_one(g2, rec, start_epoch="g2@1") is False
    assert g2.applied_seq == before  # the stale-stream record never counted
    assert rig3.stats.snapshot().get("replica.catchup_abort", 0) == 1

    def same_epoch(g, method, path, body, headers, **kw):
        return 200, "application/json", b"{}", {GROUP_HEADER: "g2@1"}

    monkeypatch.setattr(rig3.router, "_forward", same_epoch)
    assert rig3.router.catchup._replay_one(g2, rec, start_epoch="g2@1") is True
    assert g2.applied_seq >= rec.seq


def test_catchup_locked_drain_is_deadline_bounded(rig3, monkeypatch):
    """The final drain holds the router's SEQUENCER lock: a group that
    turns slow mid-drain must abort the round quickly (it keeps its
    applied_seq progress; the next probe retries) instead of pinning
    the lock for up to drain_batch x socket-timeout and stalling every
    write cluster-wide."""
    rig3.seed()
    rig3.router.catchup.locked_drain_s = 0.15
    rig3.servers[2].close()
    for c in range(3):
        assert rig3.query(f'SetBit(rowID=1, frame="f", columnID={c})')[0] == 200
    real = rig3.router._forward

    def crawling_replay(g, method, path_qs, body, headers, **kw):
        if _is_replay(kw):
            time.sleep(0.5)  # far slower than the whole locked budget
        return real(g, method, path_qs, body, headers, **kw)

    # Slow the replays BEFORE the group returns: the probe may start a
    # round the moment the group answers, and a round that ran on the
    # real forward could finish (no stall) or replay several records.
    monkeypatch.setattr(rig3.router, "_forward", crawling_replay)
    rig3.restart(2, epoch=2)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if rig3.stats.snapshot().get("replica.catchup_stall", 0) >= 1:
            break
        time.sleep(0.02)
    assert rig3.stats.snapshot().get("replica.catchup_stall", 0) >= 1
    assert not rig3.router.groups[2].caught_up  # round aborted, stays out
    # Writes were never starved: the sequencer stays responsive while
    # the laggard crawls.
    t0 = time.monotonic()
    assert rig3.query('SetBit(rowID=1, frame="f", columnID=9)')[0] == 200
    assert time.monotonic() - t0 < 5.0
    # Un-throttle: the next probe round finishes the shorter remainder
    # (progress was kept) and the group rejoins for real.
    monkeypatch.setattr(rig3.router, "_forward", real)
    rig3.wait_ready("g2")
    assert rig3.direct_count(2) == rig3.direct_count(0) == 4


def test_catchup_replay_advances_the_groups_applied_mark(rig3):
    """A replay carries its sequence to the group (in the forward's
    router-owned headers), so a caught-up group reports the WAL head as
    its own applied mark, not the mark it restarted with."""
    rig3.seed()
    rig3.servers[2].close()
    for c in range(3):
        assert rig3.query(f'SetBit(rowID=1, frame="f", columnID={c})')[0] == 200
    rig3.restart(2, epoch=2)
    rig3.wait_ready("g2")
    assert rig3.stats.snapshot().get("replica.replayed", 0) >= 3
    health = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{rig3.ports[2]}/replica/health", timeout=30).read())
    assert health["appliedSeq"] == rig3.router.wal.last_seq == 5


def test_catchup_socket_timeout_past_the_locked_budget_is_a_stall(rig3, monkeypatch):
    """A replay whose socket, capped at the locked drain's remainder,
    fails past the budget ends the round as a stall, like the check
    before the next record."""
    rig3.seed()
    rig3.router.catchup.locked_drain_s = 0.15
    rig3.servers[2].close()
    assert rig3.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200
    real = rig3.router._forward

    def timed_out_replay(g, method, path_qs, body, headers, **kw):
        if _is_replay(kw):
            time.sleep(kw["timeout_s"])
            raise OSError("timed out")
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig3.router, "_forward", timed_out_replay)
    rig3.restart(2, epoch=2)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if rig3.stats.snapshot().get("replica.catchup_stall", 0) >= 1:
            break
        time.sleep(0.02)
    assert rig3.stats.snapshot().get("replica.catchup_stall", 0) >= 1
    assert not rig3.router.groups[2].caught_up
    monkeypatch.setattr(rig3.router, "_forward", real)
    rig3.wait_ready("g2")
    assert rig3.direct_count(2) == rig3.direct_count(0) == 1


# -- probe backoff (satellite) ------------------------------------------------


def test_probe_backoff_doubles_jittered_and_caps():
    r = ReplicaRouter(["g0=127.0.0.1:1"], probe_interval_s=0.05,
                      probe_max_interval_s=0.4)
    g = r.groups[0]
    r._mark_unhealthy(g, "down")
    assert g.probe_delay == 0.05
    t0 = time.monotonic()
    delays = []
    for _ in range(6):
        r._backoff(g)
        delays.append(g.probe_delay)
        assert g.probe_at >= t0  # pushed into the future
    assert delays == [0.1, 0.2, 0.4, 0.4, 0.4, 0.4]  # doubled, then capped
    # Jitter: next-probe time is within [0.5x, 1.5x] of the delay.
    assert 0.4 * 0.5 - 1e-6 <= g.probe_at - time.monotonic() <= 0.4 * 1.5 + 0.1
    # Recovery resets the backoff to the base interval.
    r._mark_healthy(g)
    assert g.probe_delay == 0.05


def test_probe_once_backs_off_unreachable_group():
    r = ReplicaRouter(["g0=127.0.0.1:1"], probe_interval_s=0.05,
                      probe_max_interval_s=0.4)
    g = r.groups[0]
    r._mark_unhealthy(g, "down")
    g.probe_at = 0.0  # due immediately
    r._probe_once()
    assert not g.healthy and g.probe_delay == 0.1  # failed probe doubled it
    # Not due again until the backoff expires: _probe_once is a no-op.
    before = g.probe_delay
    r._probe_once()
    assert g.probe_delay == before


# -- client retry budget (satellite) ------------------------------------------


class _ShedThen200:
    """Tiny HTTP stub: sheds the first N requests with 429, then 200s."""

    def __init__(self, sheds: int, retry_after: str = "0.01"):
        self.requests = []
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                outer.requests.append(time.monotonic())
                if len(outer.requests) <= sheds:
                    body = b'{"error": "shed"}'
                    self.send_response(429)
                    self.send_header("Retry-After", retry_after)
                else:
                    from pilosa_tpu_torch import wire

                    body = wire.encode_query_response(results=[1])
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-protobuf")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.host = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_client_retry_budget_spends_until_success():
    from pilosa_tpu_torch.server.client import Client

    stats = ExpvarStatsClient()
    stub = _ShedThen200(sheds=2)
    try:
        c = Client(stub.host, retry_budget=3, stats=stats)
        resp = c.execute_query("i", "Count(Bitmap(rowID=1))")
        assert resp["results"] == [{"n": 1}]
        assert len(stub.requests) == 3  # 2 sheds + the success
        assert stats.snapshot()["client.retries"] == 2
    finally:
        stub.close()


def test_client_retry_budget_exhausts_and_surfaces_shed():
    from pilosa_tpu_torch.server.client import Client, ClientError

    stub = _ShedThen200(sheds=10)
    try:
        c = Client(stub.host, retry_budget=2)
        with pytest.raises(ClientError) as e:
            c.execute_query("i", "Count(Bitmap(rowID=1))")
        assert e.value.status == 429
        assert len(stub.requests) == 3  # 1 + budget of 2, never unbounded
    finally:
        stub.close()


def test_client_retry_budget_zero_disables():
    from pilosa_tpu_torch.server.client import Client, ClientError

    stub = _ShedThen200(sheds=1)
    try:
        c = Client(stub.host, retry_budget=0)
        with pytest.raises(ClientError):
            c.execute_query("i", "Count(Bitmap(rowID=1))")
        assert len(stub.requests) == 1
    finally:
        stub.close()


def test_client_retry_deadline_aware():
    """A retry whose backoff cannot finish inside the remaining budget
    surfaces the shed instead of sleeping through the deadline."""
    from pilosa_tpu_torch.qos import Deadline
    from pilosa_tpu_torch.server.client import Client, ClientError

    stub = _ShedThen200(sheds=10, retry_after="1.5")
    try:
        c = Client(stub.host, retry_budget=5)
        t0 = time.monotonic()
        with pytest.raises(ClientError) as e:
            c.execute_query("i", "Count(Bitmap(rowID=1))", deadline=Deadline(200))
        assert e.value.status == 429
        assert time.monotonic() - t0 < 1.0  # never slept the 1.5s hint
        assert len(stub.requests) == 1
    finally:
        stub.close()


def test_client_retry_decorrelated_jitter_bounds():
    """Backoff waits honor the Retry-After floor and the cap."""
    from pilosa_tpu_torch.server.client import Client

    stub = _ShedThen200(sheds=2, retry_after="0.05")
    try:
        c = Client(stub.host, retry_budget=2)
        c.execute_query("i", "Count(Bitmap(rowID=1))")
        gaps = [b - a for a, b in zip(stub.requests, stub.requests[1:])]
        assert all(g >= 0.04 for g in gaps)  # the peer's floor held
        assert all(g <= 2.5 for g in gaps)  # RETRY_AFTER_CAP_S bound
    finally:
        stub.close()


# -- config / CLI promotion ---------------------------------------------------


def test_config_recovery_promotion(tmp_path):
    toml = tmp_path / "c.toml"
    toml.write_text(
        "[replica]\n"
        'probe-interval = "2s"\n'
        'probe-max-interval = "45s"\n'
        f'wal-dir = "{tmp_path}/wal"\n'
        "wal-max-bytes = 1024\n"
        "\n"
        "[client]\n"
        "retry-budget = 7\n"
    )
    cfg = Config.from_toml(str(toml))
    assert cfg.replica_probe_interval == 2.0
    assert cfg.replica_probe_max_interval == 45.0
    assert cfg.replica_wal_dir == f"{tmp_path}/wal"
    assert cfg.replica_wal_max_bytes == 1024
    assert cfg.client_retry_budget == 7
    cfg.apply_env({
        "PILOSA_TPU_REPLICA_PROBE_INTERVAL": "0.5",
        "PILOSA_TPU_REPLICA_PROBE_MAX_INTERVAL": "9",
        "PILOSA_TPU_REPLICA_WAL_DIR": "/elsewhere",
        "PILOSA_TPU_REPLICA_WAL_MAX_BYTES": "2048",
        "PILOSA_TPU_CLIENT_RETRY_BUDGET": "1",
    })
    assert cfg.replica_probe_interval == 0.5
    assert cfg.replica_probe_max_interval == 9.0
    assert cfg.replica_wal_dir == "/elsewhere"
    assert cfg.replica_wal_max_bytes == 2048
    assert cfg.client_retry_budget == 1


def test_router_from_config_builds_durable_wal(tmp_path):
    from pilosa_tpu_torch.replica import router_from_config

    cfg = Config(host="127.0.0.1:10101")
    cfg.replica_groups = ["127.0.0.1:1"]
    cfg.replica_router_port = 0
    cfg.replica_wal_dir = str(tmp_path / "wal")
    cfg.replica_wal_max_bytes = 12345
    cfg.replica_probe_interval = 0.25
    r = router_from_config(cfg)
    try:
        assert r.wal.path == os.path.join(str(tmp_path / "wal"), "router.wal")
        assert r.wal.max_bytes == 12345
        assert r.probe_interval_s == 0.25
        assert r.wal.append("POST", "/x", b"") == 1
        r.wal.close()
        r2 = router_from_config(cfg)
        assert r2.wal.last_seq == 1  # durable across router builds
        r2.wal.close()
    finally:
        pass


# -- held against the JAX package (exact) -------------------------------------


def _wal_script(wal_cls, path: str) -> bytes:
    """Seeded appends, tombstones and a compaction through one package's
    WriteAheadLog; returns the file's bytes."""
    import numpy as np

    rng = np.random.default_rng(2026)
    wal = wal_cls(path)
    for i in range(48):
        body = rng.integers(0, 256, size=int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
        s = wal.append("POST", f"/index/i/query?k={i}", body,
                       "text/plain" if i % 3 else "")
        if i % 7 == 6:
            wal.abort(s)
    wal.compact(12)
    for i in range(5):
        wal.append("POST", f"/index/i/frame/f{i}", b'{"options":{}}',
                   "application/json")
    wal.close()
    with open(path, "rb") as fh:
        return fh.read()


def test_wal_files_byte_identical_to_reference(tmp_path):
    from pilosa_tpu.replica.wal import WriteAheadLog as RefWal

    ours = _wal_script(WriteAheadLog, str(tmp_path / "port.wal"))
    ref = _wal_script(RefWal, str(tmp_path / "ref.wal"))
    assert len(ours) > 4096 and ours == ref


def test_wal_each_package_reads_the_others_log(tmp_path):
    from pilosa_tpu.replica.wal import WriteAheadLog as RefWal

    _wal_script(WriteAheadLog, str(tmp_path / "port.wal"))
    _wal_script(RefWal, str(tmp_path / "ref.wal"))
    seen = {}
    for reader, name in ((WriteAheadLog, "port"), (RefWal, "ref")):
        for written in ("port", "ref"):
            wal = reader(str(tmp_path / f"{written}.wal"))
            seen[(name, written)] = (
                wal.first_seq, wal.last_seq, wal.size_bytes,
                [tuple(r) for r in wal.records(0)],
            )
            wal.close()
    first = seen[("port", "port")]
    # 13..48 past the compaction, less 5 tombstones, and 5 appends after
    assert len(first[3]) == 36 and first[:2] == (13, 53)
    assert all(v == first for v in seen.values())


@pytest.mark.parametrize("tail", ["header-only", "partial-header", "bad-crc"])
def test_wal_torn_tail_truncated_like_reference(tmp_path, tail):
    """The same damaged file recovers to the same bytes, sequence and
    records, with the same torn-tail count, in either package."""
    import shutil

    from pilosa_tpu.replica.wal import WriteAheadLog as RefWal
    from pilosa_tpu.stats import ExpvarStatsClient as RefStats

    good = _wal_script(WriteAheadLog, str(tmp_path / "src.wal"))
    damaged = str(tmp_path / "damaged.wal")
    with open(damaged, "wb") as fh:
        if tail == "header-only":
            fh.write(good + _FRAME.pack(1 << 20, 0) + b"torn-garbage")
        elif tail == "partial-header":
            fh.write(good + b"\x05\x00\x00")
        else:  # flip a payload byte of the last record
            fh.write(good[:-3] + bytes([good[-3] ^ 0xFF]) + good[-2:])
    got = {}
    for name, wal_cls, stats_cls in (("port", WriteAheadLog, ExpvarStatsClient),
                                     ("ref", RefWal, RefStats)):
        path = str(tmp_path / f"{name}.wal")
        shutil.copy(damaged, path)
        stats = stats_cls()
        wal = wal_cls(path, stats=stats)
        got[name] = (wal.last_seq, wal.size_bytes,
                     [tuple(r) for r in wal.records(0)],
                     stats.snapshot().get("wal.torn_tail", 0))
        wal.close()
        with open(path, "rb") as fh:
            got[name] += (fh.read(),)
    assert got["port"] == got["ref"]
    assert got["port"][1] < len(good) + 32  # the damage was cut away


_FAULT_SPECS = [
    "forward/g2:drop@3",
    "seed=42; forward:drop~0.3; wal.append:error=503~0.2",
    "catchup:error=500@2; forward/g0:drop",
    "resync.chunk/g2:drop@4; resync.seed:error=429@1; resync.fetch/g0:drop~0.5",
    "seed=7; forward/g1:error=502~0.5; forward:drop@5; resync.digest:drop@2",
]


def _firings(fi) -> list:
    """What each of a seeded sequence of crossings did."""
    import numpy as np

    rng = np.random.default_rng(5)
    sites = ["forward", "wal.append", "catchup", "resync.digest",
             "resync.fetch", "resync.chunk", "resync.seed"]
    out = []
    for _ in range(300):
        site = sites[int(rng.integers(0, len(sites)))]
        key = f"g{int(rng.integers(0, 3))}"
        try:
            fi.hit(site, key=key)
            out.append(None)
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out.append((type(e).__name__, getattr(e, "status", None), str(e)))
    return out


@pytest.mark.parametrize("spec_str", _FAULT_SPECS)
def test_fault_injector_fires_like_reference(spec_str):
    from pilosa_tpu.replica.faults import FaultInjector as RefInjector

    ours = _firings(FaultInjector.from_spec(spec_str))
    ref = _firings(RefInjector.from_spec(spec_str))
    assert any(o is not None for o in ours)
    assert ours == ref


@pytest.mark.parametrize("bad", ["forward", "forward:frobnicate", "forward:drop@x",
                                 "seed=q", "forward:delay=abc"])
def test_fault_spec_errors_like_reference(bad):
    from pilosa_tpu.replica.faults import FaultInjector as RefInjector

    errs = []
    for cls in (FaultInjector, RefInjector):
        with pytest.raises(ValueError) as e:
            cls.from_spec(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _trace_variants(events: list):
    """The recorded trace, each one-event deletion, duplication and
    adjacent swap, and each integer field of each event moved by one:
    the checker's verdict on every variant is compared."""
    yield events
    for i in range(len(events)):
        yield events[:i] + events[i + 1:]
        yield events[:i + 1] + events[i:]
    for i in range(len(events) - 1):
        yield events[:i] + [events[i + 1], events[i]] + events[i + 2:]
    for i, (kind, fields) in enumerate(events):
        for key, v in fields.items():
            if isinstance(v, int) and not isinstance(v, bool) and key != "src":
                for d in (-1, 1):
                    yield events[:i] + [(kind, {**fields, key: v + d})] + events[i + 1:]


def test_spec_check_trace_matches_reference(_port_spec_trace_gate, rig3):
    """A degraded-quorum write, a dead group's backlog and its catch-up
    recorded by the port's collector; the port's and the JAX package's
    check_trace give the same verdict on that trace and on every
    one-event deletion and adjacent swap of it."""
    from pilosa_tpu.analysis import spec as ref_spec
    from pilosa_tpu_torch.analysis import spec as port_spec

    events = _port_spec_trace_gate
    rig3.seed()
    assert rig3.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200
    rig3.servers[2].close()
    for c in range(2, 6):
        assert rig3.query(f'SetBit(rowID=1, frame="f", columnID={c})')[0] == 200
    rig3.restart(2, 2)
    rig3.wait_ready("g2")
    trace = [(k, dict(f)) for k, f in events]
    kinds = {k for k, _ in trace}
    assert len(trace) > 20 and len(kinds) >= 4, kinds
    broken = 0
    for variant in _trace_variants(trace):
        ours = port_spec.check_trace(variant)
        assert ours == ref_spec.check_trace(variant)
        broken += bool(ours)
    assert broken > 0  # the variants do reach the checker's rules


@pytest.mark.parametrize("n_groups", [2, 3])
@pytest.mark.parametrize("knob", [None, "break_quorum", "break_compaction",
                                  "break_abort"])
def test_spec_model_check_matches_reference(knob, n_groups):
    from pilosa_tpu.analysis import spec as ref_spec
    from pilosa_tpu_torch.analysis import spec as port_spec

    kw = {knob: True} if knob else {}
    a, b = (m.model_check(n_groups=n_groups, max_writes=2, **kw)
            for m in (port_spec, ref_spec))
    assert (a.states, a.transitions, a.violations) == \
        (b.states, b.transitions, b.violations)
    if knob is None:
        assert a.ok and a.states > 100
    elif n_groups == 3:  # every broken rule trips at three groups
        assert not a.ok


def test_spec_sharded_and_reshard_models_match_reference():
    from pilosa_tpu.analysis import spec as ref_spec
    from pilosa_tpu_torch.analysis import spec as port_spec

    for name, kw in (("model_check_sharded", {}),
                     ("model_check_sharded", {"break_routing": True}),
                     ("model_check_reshard", {}),
                     ("model_check_reshard", {"break_fence": True})):
        a = getattr(port_spec, name)(**kw)
        b = getattr(ref_spec, name)(**kw)
        assert (a.states, a.transitions, a.violations) == \
            (b.states, b.transitions, b.violations), (name, kw)

