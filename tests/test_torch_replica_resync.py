"""The port's automated group resync and cross-group anti-entropy:
tests/test_replica_resync.py through pilosa_tpu_torch.

Stale and blank groups self-heal by streaming a donor's fragments
(roaring, crc-checked, resumable), the WAL suffix past the seed sequence
is replayed, and the anti-entropy sweep finds and repairs divergence.
The file runs under the port's lock checker.
"""

import io
import json
import logging
import os
import shutil
import socket
import tempfile
import time
import urllib.error
import urllib.request
import zlib

import pytest

from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.replica import GROUP_HEADER, ReplicaRouter
from pilosa_tpu_torch.replica.digest import (
    diff_digests,
    fragment_path,
    holder_digest,
    majority_plan,
)
from pilosa_tpu_torch.replica.faults import FaultInjector
from pilosa_tpu_torch.replica.wal import WriteAheadLog
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


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _package(pkg: str):
    """(Config, ReplicaRouter, Server, ExpvarStatsClient) of the port or,
    for ``pkg="pilosa_tpu"``, of the JAX package: the same rig drives
    either package's router over its own groups."""
    import importlib

    config = importlib.import_module(f"{pkg}.config")
    replica = importlib.import_module(f"{pkg}.replica")
    server = importlib.import_module(f"{pkg}.server.server")
    stats = importlib.import_module(f"{pkg}.stats")
    return config.Config, replica.ReplicaRouter, server.Server, stats.ExpvarStatsClient


class _Rig:
    """Three in-process group Servers on FIXED ports + a router whose
    resync knobs the test controls (``pkg`` picks the package)."""

    def __init__(self, tmp, wal=None, faults=None, probe_interval_s=0.05,
                 probe_max_interval_s=0.3, n=3, engine="numpy",
                 pkg="pilosa_tpu_torch", **router_kw):
        self.tmp = tmp
        self.engine = engine
        self.Config, router_cls, self.Server, stats_cls = _package(pkg)
        self.ports = [_free_port() for _ in range(n)]
        self.servers = [self._spawn(i, 1) for i in range(n)]
        self.stats = stats_cls()
        self.router = router_cls(
            [f"g{i}=127.0.0.1:{p}" for i, p in enumerate(self.ports)],
            probe_interval_s=probe_interval_s,
            probe_max_interval_s=probe_max_interval_s,
            wal=wal, faults=faults, stats=self.stats, **router_kw,
        ).serve()
        self.base = f"http://127.0.0.1:{self.router.port}"

    def _spawn(self, i: int, epoch: int):
        cfg = self.Config(
            data_dir=f"{self.tmp}/g{i}", host=f"127.0.0.1:{self.ports[i]}",
            engine=self.engine, stats="expvar", qcache_enabled=False,
            replica_group=f"g{i}@{epoch}",
        )
        srv = self.Server(cfg)
        srv.open()
        return srv

    def restart(self, i: int, epoch: int, blank: bool = False):
        if blank:
            shutil.rmtree(f"{self.tmp}/g{i}", ignore_errors=True)
        self.servers[i] = self._spawn(i, epoch)

    def req(self, method, path, body=None, headers=None, timeout=30, port=None):
        base = self.base if port is None else f"http://127.0.0.1:{port}"
        rq = urllib.request.Request(base + path, data=body, method=method)
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
        st, body, _ = self.req("POST", "/index/i/query", q.encode(),
                               port=self.ports[i])
        assert st == 200, body
        return json.loads(body)["results"][0]

    def direct_digest(self, i) -> dict:
        st, body, _ = self.req("GET", "/replica/digest", port=self.ports[i])
        assert st == 200, body
        return json.loads(body)

    def status(self) -> dict:
        return json.loads(self.req("GET", "/replica/status")[1])

    def group_status(self, name: str) -> dict:
        return next(g for g in self.status()["groups"] if g["name"] == name)

    def seed(self):
        assert self.req("POST", "/index/i", b"{}")[0] == 200
        assert self.req("POST", "/index/i/frame/f", b"{}")[0] == 200

    def wait_ready(self, name: str, timeout=20.0) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            g = self.group_status(name)
            if g["healthy"] and g["caughtUp"] and not g["stale"]:
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


@pytest.fixture
def rig(request):
    with tempfile.TemporaryDirectory() as tmp:
        r = _Rig(tmp, engine=getattr(request, "param", "numpy"))
        try:
            yield r
        finally:
            r.close()


# -- digest protocol ----------------------------------------------------------


def test_holder_digest_deterministic_across_write_paths(tmp_path):
    """The same logical bits through set_bit order A, set_bit order B,
    and a bulk import digest identically — the deterministic twin of
    the hypothesis property (anti-entropy correctness rests on it)."""
    import numpy as np

    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder

    bits = [(1, 3), (1, 77), (2, 9), (5, 200000), (1, 65536)]
    digests = []
    for k, order in enumerate((bits, bits[::-1], None)):
        h = Holder(str(tmp_path / f"h{k}"))
        h.open()
        idx = h.create_index("i")
        idx.create_frame("f", FrameOptions())
        if order is None:
            frag = (
                idx.frame("f").create_view_if_not_exists("standard")
                .create_fragment_if_not_exists(0)
            )
            frag.import_bits(
                np.asarray([b[0] for b in bits], dtype=np.uint64),
                np.asarray([b[1] for b in bits], dtype=np.uint64),
            )
        else:
            for r, c in order:
                idx.frame("f").set_bit("standard", r, c)
        digests.append(holder_digest(h))
        h.close()
    assert digests[0]["digest"] == digests[1]["digest"] == digests[2]["digest"]
    assert digests[0]["fragments"] == digests[1]["fragments"]
    assert list(digests[0]["fragments"]) == [fragment_path("i", "f", "standard", 0)]


def test_holder_digest_omits_empty_fragments(tmp_path):
    """'Never created' and 'cleared to zero bits' digest identically —
    clearing a divergent extra fragment must converge the digests."""
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder

    h1 = Holder(str(tmp_path / "a"))
    h1.open()
    h1.create_index("i").create_frame("f", FrameOptions())
    h2 = Holder(str(tmp_path / "b"))
    h2.open()
    h2.create_index("i").create_frame("f", FrameOptions())
    h2.index("i").frame("f").set_bit("standard", 1, 3)
    assert holder_digest(h1)["digest"] != holder_digest(h2)["digest"]
    h2.index("i").frame("f").clear_bit("standard", 1, 3)
    assert holder_digest(h1)["digest"] == holder_digest(h2)["digest"]
    assert holder_digest(h2)["fragments"] == {}
    h1.close()
    h2.close()


def test_diff_digests_plan():
    donor = {
        "schema": [{"name": "i", "frames": [{"name": "f"}, {"name": "g"}]}],
        "fragments": {"i/f/standard/0": "aa", "i/g/standard/1": "bb"},
    }
    laggard = {
        "schema": [
            {"name": "i", "frames": [{"name": "f"}, {"name": "dead"}]},
            {"name": "old", "frames": [{"name": "x"}]},
        ],
        "fragments": {
            "i/f/standard/0": "MISMATCH",
            "i/f/standard/7": "extra-in-live-frame",
            "i/dead/standard/0": "cc",
            "old/x/standard/0": "dd",
        },
    }
    plan = diff_digests(donor, laggard)
    # Differing + donor-missing fragments stream; extras inside frames
    # the donor keeps stream too (as clears); extras under dropped
    # indexes/frames are handled by the deletes instead.
    assert plan.stream == ["i/f/standard/0", "i/g/standard/1", "i/f/standard/7"]
    assert plan.drop_indexes == ["old"]
    assert plan.drop_frames == [("i", "dead")]


def test_majority_plan_winner_and_ties():
    digs = {
        "g0": {"fragments": {"i/f/standard/0": "aa", "i/f/standard/1": "xx"}},
        "g1": {"fragments": {"i/f/standard/0": "aa"}},
        "g2": {"fragments": {"i/f/standard/0": "zz", "i/f/standard/1": "xx"}},
    }
    plan = majority_plan(digs)
    # Path 0: majority 'aa' -> repair g2 from g0 (smallest holder).
    # Path 1: 'xx' on g0+g2 vs missing on g1 -> repair g1 from g0.
    assert plan.divergent == {"g2": ["i/f/standard/0"], "g1": ["i/f/standard/1"]}
    assert plan.donor == {"i/f/standard/0": "g0", "i/f/standard/1": "g0"}
    assert plan.first_path == "i/f/standard/0"
    # All-equal digests -> empty plan.
    same = {n: {"fragments": {"p": "aa"}} for n in ("g0", "g1")}
    assert majority_plan(same).divergent == {}
    # Majority LACKING the fragment wins: the holder gets a clear.
    lack = {
        "g0": {"fragments": {}},
        "g1": {"fragments": {"p": "aa"}},
        "g2": {"fragments": {}},
    }
    plan = majority_plan(lack)
    assert plan.divergent == {"g1": ["p"]} and plan.donor == {"p": "g0"}


def test_digest_endpoint_reports_applied_seq(rig):
    rig.seed()
    rig.query('SetBit(rowID=1, frame="f", columnID=3)')
    dig = rig.direct_digest(0)
    assert dig["appliedSeq"] >= 1
    assert "i/f/standard/0" in dig["fragments"]
    assert [x["name"] for x in dig["schema"]] == ["i"]
    # All three groups applied the same writes: identical digests.
    assert dig["digest"] == rig.direct_digest(1)["digest"] == rig.direct_digest(2)["digest"]


# -- import-roaring endpoint --------------------------------------------------


def test_import_roaring_crc_mismatch_and_overrun(rig):
    rig.seed()
    data = b"not-a-roaring-payload-but-crc-checked-first"
    total = len(data)
    bad_crc = zlib.crc32(data) ^ 1
    base = (f"/fragment/import-roaring?index=i&frame=f&view=standard&slice=0"
            f"&total={total}&crc={bad_crc}")
    st, body, _ = rig.req("POST", base + "&off=0", data, port=rig.ports[0])
    assert st == 409 and b"crc mismatch" in body
    # The failed transfer left no staging behind.
    st, body, _ = rig.req("POST", base + "&probe=1", b"", port=rig.ports[0])
    assert st == 200 and json.loads(body)["staged"] == 0
    # A chunk overrunning the declared total is refused.
    good = zlib.crc32(data)
    base = (f"/fragment/import-roaring?index=i&frame=f&view=standard&slice=0"
            f"&total=4&crc={good}")
    st, body, _ = rig.req("POST", base + "&off=0", data, port=rig.ports[0])
    assert st == 409 and b"overruns" in body


def test_import_roaring_clear_and_idempotent_apply(rig):
    rig.seed()
    assert rig.query('SetBit(rowID=1, frame="f", columnID=3)')[0] == 200
    assert rig.direct_count(0) == 1
    # total=0 clears the fragment.
    base = ("/fragment/import-roaring?index=i&frame=f&view=standard&slice=0"
            "&total=0&crc=0")
    st, body, _ = rig.req("POST", base + "&off=0", b"", port=rig.ports[0])
    assert st == 200 and json.loads(body)["applied"] is True
    assert rig.direct_count(0) == 0
    # Applying the same payload twice converges to the same bytes.
    st, data, _ = rig.req(
        "GET", "/fragment/data?index=i&frame=f&view=standard&slice=0",
        port=rig.ports[1])
    assert st == 200
    total, crc = len(data), zlib.crc32(data)
    base = (f"/fragment/import-roaring?index=i&frame=f&view=standard&slice=0"
            f"&total={total}&crc={crc}")
    for _ in range(2):
        st, body, _ = rig.req(
            "POST", base + "&off=0", data, port=rig.ports[0],
            headers={"Content-Type": "application/octet-stream"})
        assert st == 200 and json.loads(body)["applied"] is True
    assert rig.direct_count(0) == 1
    assert rig.direct_digest(0)["digest"] == rig.direct_digest(1)["digest"]


def test_import_roaring_creates_missing_path(rig):
    """The blank-group path: index/frame/view/fragment are created on
    demand by the import lane."""
    buf = io.BytesIO()
    from pilosa_tpu_torch import roaring

    bm = roaring.Bitmap([5])
    bm.write_to(buf)
    data = buf.getvalue()
    base = (f"/fragment/import-roaring?index=fresh&frame=nf&view=standard"
            f"&slice=0&total={len(data)}&crc={zlib.crc32(data)}")
    st, body, _ = rig.req("POST", base + "&off=0", data, port=rig.ports[0],
                          headers={"Content-Type": "application/octet-stream"})
    assert st == 200 and json.loads(body)["applied"] is True
    st, body, _ = rig.req("POST", "/index/fresh/query",
                          b'Count(Bitmap(rowID=0, frame="nf"))',
                          port=rig.ports[0])
    assert st == 200 and json.loads(body)["results"] == [1]


# -- the acceptance scenarios -------------------------------------------------


def _spread_writes(rig, n, start=0, per_write=1):
    for k in range(start, start + n):
        q = " ".join(
            f'SetBit(rowID={1 + (k % 3)}, frame="f", columnID={k * per_write + j})'
            for j in range(per_write)
        )
        st, body, _ = rig.query(q)
        assert st == 200, (k, body)


@pytest.mark.parametrize("rig", ["numpy", "torch:cpu"], indirect=True)
def test_blank_group_self_heals(rig):
    """THE blank half of the acceptance scenario: a group restarted on
    a WIPED data dir (applied_seq=0 over a non-empty sequence space)
    is resynced by fragment stream + seed + catch-up, with zero
    operator action, and serves reads reflecting every acked write."""
    rig.seed()
    _spread_writes(rig, 12)
    rig.servers[2].close()
    _spread_writes(rig, 6, start=12)  # writes the blank group must NOT lose
    rig.restart(2, epoch=2, blank=True)
    g2 = rig.wait_ready("g2")
    assert g2["appliedSeq"] == rig.status()["wal"]["lastSeq"]
    # Every acked write is readable from the rejoined group directly.
    want = [rig.direct_count(0, f'Count(Bitmap(rowID={r}, frame="f"))')
            for r in (1, 2, 3)]
    got = [rig.direct_count(2, f'Count(Bitmap(rowID={r}, frame="f"))')
          for r in (1, 2, 3)]
    assert got == want and sum(want) == 18
    # Byte-identical: digests agree everywhere.
    assert (rig.direct_digest(0)["digest"] == rig.direct_digest(1)["digest"]
            == rig.direct_digest(2)["digest"])
    snap = rig.stats.snapshot()
    assert snap.get("replica.resync.g2", 0) >= 1
    assert snap.get("replica.resync_fragments", 0) >= 1
    assert snap.get("replica.resync_bytes", 0) > 0
    # And reads route to it again.
    served = set()
    for _ in range(9):
        st, _b, hdrs = rig.query('Count(Bitmap(rowID=1, frame="f"))')
        assert st == 200
        served.add(hdrs.get(GROUP_HEADER, "").split("@")[0])
    assert "g2" in served


def test_stale_group_self_heals(tmp_path):
    """THE stale half: a group whose lag pinned the WAL past
    wal-max-bytes goes stale (the log compacts past it), stays in the
    probe rotation at probe-max-interval, and is resynced back to
    healthy ∧ caught_up ∧ ¬stale with zero operator action."""
    wal = WriteAheadLog(str(tmp_path / "r.wal"), max_bytes=70_000)
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp, wal=wal)
        try:
            rig.seed()
            _spread_writes(rig, 3)
            rig.servers[2].close()
            # Big write bodies blow the WAL past its bound while g2 is
            # down: compaction can't advance past g2's lag -> stale.
            _spread_writes(rig, 40, start=3, per_write=50)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if rig.group_status("g2")["stale"]:
                    break
                time.sleep(0.05)
            assert rig.group_status("g2")["stale"], rig.status()
            assert rig.stats.snapshot().get("replica.stale.g2", 0) >= 1
            # The stale group's missed records are (at least partly)
            # compacted away: replay alone cannot rescue it.
            rig.restart(2, epoch=2)
            g2 = rig.wait_ready("g2")
            assert not g2["stale"] and g2["appliedSeq"] == rig.status()["wal"]["lastSeq"]
            want = rig.direct_count(0, 'Count(Bitmap(rowID=1, frame="f"))')
            assert rig.direct_count(2, 'Count(Bitmap(rowID=1, frame="f"))') == want
            assert (rig.direct_digest(2)["digest"]
                    == rig.direct_digest(0)["digest"])
            snap = rig.stats.snapshot()
            assert snap.get("replica.resync.g2", 0) >= 1
        finally:
            rig.close()


def _torn_transfer(pkg: str):
    """The reference's torn-transfer script through ``pkg``'s router and
    groups: a seeded fault armed to kill the 4th chunk of g2's blank
    resync, the rig's chunk at 64 bytes.  Returns the router's stats
    snapshot, the fragment's size on the donor and both digests."""
    import importlib

    faults_mod = importlib.import_module(f"{pkg}.replica.faults")
    faults = faults_mod.FaultInjector.from_spec("resync.chunk/g2:drop@4")
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp, faults=faults, resync_chunk_bytes=64, pkg=pkg)
        try:
            rig.seed()
            _spread_writes(rig, 10, per_write=8)  # a multi-chunk fragment
            rig.servers[2].close()
            rig.query('SetBit(rowID=1, frame="f", columnID=999)')
            st, data, _ = rig.req(
                "GET", "/fragment/data?index=i&frame=f&view=standard&slice=0",
                port=rig.ports[0])
            assert st == 200 and len(data) > 4 * 64  # > 4 chunks
            rig.restart(2, epoch=2, blank=True)
            rig.wait_ready("g2")
            return (rig.stats.snapshot(), len(data),
                    rig.direct_digest(2)["digest"], rig.direct_digest(0)["digest"])
        finally:
            rig.close()


def test_torn_transfer_resumes_mid_fragment(monkeypatch):
    """With cost accounting off (PILOSA_TPU_COSTS=0) the rig's 64-byte
    chunk holds: the seeded fault kills the chunk stream mid-fragment,
    the round aborts, the next round RESUMES from the staged offset
    (proven by replica.resync_bytes < the fragment's full size), and
    the group still converges."""
    monkeypatch.setenv("PILOSA_TPU_COSTS", "0")
    snap, size, d2, d0 = _torn_transfer("pilosa_tpu_torch")
    assert snap.get("replica.resync_abort", 0) >= 1  # round 1 died
    # The successful round pushed only the remainder: resumed, not
    # restarted.
    assert 0 < snap.get("replica.resync_bytes", 0) < size
    assert d2 == d0


def test_torn_transfer_adaptive_chunk_floor_matches_reference(monkeypatch):
    """With cost accounting on (the default), the router's AdaptiveBudgets
    re-size the chunk once one chunk has moved bytes, clamped to at
    least 64 KiB: the fragment then goes in two chunks and the fault
    armed for the 4th never fires.  The port does what the JAX package
    does on the same script: the same gauge, no abort, converged."""
    monkeypatch.delenv("PILOSA_TPU_COSTS", raising=False)
    got = {}
    for pkg in ("pilosa_tpu_torch", "pilosa_tpu"):
        snap, size, d2, d0 = _torn_transfer(pkg)
        assert d2 == d0, pkg
        got[pkg] = (snap.get("planner.resync_chunk_bytes"),
                    snap.get("replica.resync_abort", 0),
                    snap.get("replica.resync_bytes", 0) == size)
    assert got["pilosa_tpu_torch"] == got["pilosa_tpu"] == (65536, 0, True), got


def test_donor_death_mid_stream_retries(tmp_path):
    """The donor's fragment fetch dies on the first round; the retry
    picks up and converges (drop@1 fires exactly once)."""
    faults = FaultInjector.from_spec("resync.fetch/g0:drop@1")
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp, faults=faults)
        try:
            rig.seed()
            _spread_writes(rig, 8)
            rig.servers[2].close()
            rig.query('SetBit(rowID=1, frame="f", columnID=500)')
            rig.restart(2, epoch=2, blank=True)
            rig.wait_ready("g2")
            snap = rig.stats.snapshot()
            assert snap.get("replica.resync_abort", 0) >= 1
            assert (rig.direct_digest(2)["digest"]
                    == rig.direct_digest(0)["digest"])
        finally:
            rig.close()


def test_fault_before_seed_retries_and_converges(tmp_path):
    """Crash-before-seed ordering: the stream completes but the round
    dies before the applied-seq handoff.  Nothing is lost — the next
    round finds the fragments already equal (digest diff empty),
    seeds, and the group rejoins fully caught up."""
    faults = FaultInjector.from_spec("resync.seed/g2:drop@1")
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp, faults=faults)
        try:
            rig.seed()
            _spread_writes(rig, 8)
            rig.servers[2].close()
            rig.query('SetBit(rowID=1, frame="f", columnID=501)')
            rig.restart(2, epoch=2, blank=True)
            g2 = rig.wait_ready("g2")
            snap = rig.stats.snapshot()
            assert snap.get("replica.resync_abort", 0) >= 1
            assert snap.get("replica.resync_rounds", 0) >= 2
            assert g2["appliedSeq"] == rig.status()["wal"]["lastSeq"]
            assert (rig.direct_digest(2)["digest"]
                    == rig.direct_digest(0)["digest"])
        finally:
            rig.close()


def test_no_failed_writes_during_resync(tmp_path):
    """Writes keep committing while a blank group resyncs — the stream
    runs outside the sequencer lock except for the bounded seed."""
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp)
        try:
            rig.seed()
            _spread_writes(rig, 10, per_write=4)
            rig.servers[2].close()
            rig.restart(2, epoch=2, blank=True)
            # Write continuously until the group rejoins.
            failed, k = 0, 0
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                st, _b, _h = rig.query(
                    f'SetBit(rowID=9, frame="f", columnID={k})')
                k += 1
                if st != 200:
                    failed += 1
                g2 = rig.group_status("g2")
                if g2["healthy"] and g2["caughtUp"] and not g2["stale"]:
                    break
            else:
                raise AssertionError("g2 never rejoined while writing")
            assert failed == 0 and k > 0
            # The rejoined group holds every write acked during resync.
            assert rig.direct_count(
                2, 'Count(Bitmap(rowID=9, frame="f"))') == k
        finally:
            rig.close()


def test_mixed_4xx_write_marks_suspect_and_resyncs(tmp_path):
    """A group answering 4xx to a write a sibling APPLIED is content-
    divergent (a blank restart 404s the index every sibling holds) —
    A plain router would count that 'deterministic' and advance its
    applied mark.  It is now marked SUSPECT, pulled from rotation, and
    digest-verified by the probe: mismatch drives a resync round."""
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp)
        try:
            rig.seed()
            _spread_writes(rig, 5)
            # Blank-restart g2 QUIETLY: the router still believes it is
            # healthy and caught up, so the next write fans to it and
            # gets 400 index-not-found while g0/g1 answer 200.
            rig.servers[2].close()
            rig.restart(2, epoch=2, blank=True)
            st, _b, _h = rig.query('SetBit(rowID=1, frame="f", columnID=50)')
            assert st == 200  # majority applied: the write commits
            snap = rig.stats.snapshot()
            assert snap.get("replica.suspect.g2", 0) >= 1
            rig.wait_ready("g2")
            snap = rig.stats.snapshot()
            assert snap.get("replica.divergence.g2", 0) >= 1
            assert snap.get("replica.resync.g2", 0) >= 1
            assert not rig.group_status("g2")["suspect"]
            want = rig.direct_count(0, 'Count(Bitmap(rowID=1, frame="f"))')
            assert rig.direct_count(2, 'Count(Bitmap(rowID=1, frame="f"))') == want
            assert (rig.direct_digest(2)["digest"]
                    == rig.direct_digest(0)["digest"])
        finally:
            rig.close()


def test_retried_create_clears_suspect_without_resync(rig):
    """The benign mixed-4xx case: an idempotent client retry of a
    create answers 409 on groups that already applied it and 200 on
    one that missed it.  The 409 groups go suspect, the digest check
    finds them EQUAL to the donor, and the flag clears with no resync
    round (no fragment ever moved)."""
    rig.seed()
    # g0 already holds f2 (e.g. the surviving half of a partially
    # applied create the client is about to retry).
    assert rig.req("POST", "/index/i/frame/f2", b"{}", port=rig.ports[0])[0] == 200
    # The routed (re)create: g0 answers 409, g1/g2 answer 200 — mixed,
    # so g0 goes suspect even though it is the one that was RIGHT.
    st, _b, _h = rig.req("POST", "/index/i/frame/f2", b"{}")
    assert st == 200
    snap = rig.stats.snapshot()
    assert snap.get("replica.suspect.g0", 0) >= 1
    rig.wait_ready("g0")
    snap = rig.stats.snapshot()
    assert snap.get("replica.suspect_cleared", 0) >= 1
    assert snap.get("replica.resync_fragments", 0) == 0  # nothing streamed
    for name in ("g0", "g1", "g2"):
        assert not rig.group_status(name)["suspect"]


# -- anti-entropy -------------------------------------------------------------


def test_anti_entropy_detects_and_repairs_divergence(rig, caplog):
    """A deliberately-diverged fragment (a write slipped into one group
    behind the router's back) is detected by the sweep
    (replica.divergence.<g> increments, one structured divergence log
    line) and repaired to digest equality from the majority copy."""
    rig.seed()
    _spread_writes(rig, 6)
    # Sneak a divergent bit straight into g1 (bypassing the router).
    st, _b, _h = rig.req("POST", "/index/i/query",
                         b'SetBit(rowID=1, frame="f", columnID=77777)',
                         port=rig.ports[1])
    assert st == 200
    want = rig.direct_count(0, 'Count(Bitmap(rowID=1, frame="f"))')
    assert rig.direct_count(1, 'Count(Bitmap(rowID=1, frame="f"))') == want + 1
    with caplog.at_level(logging.WARNING, logger="pilosa_tpu_torch.divergence"):
        rig.router._anti_entropy_once()
    snap = rig.stats.snapshot()
    assert snap.get("replica.divergence.g1", 0) == 1
    assert snap.get("replica.divergence_repaired", 0) >= 1
    assert snap.get("replica.antientropy_rounds", 0) == 1
    # Structured log line names the first differing fragment path.
    rec = next(r for r in caplog.records if r.name == "pilosa_tpu_torch.divergence")
    payload = json.loads(rec.getMessage().split(" ", 1)[1])
    assert payload["groups"] == ["g1"]
    assert payload["first_path"] == "i/f/standard/0"
    # Repaired to the majority copy: the sneaked bit is gone and all
    # digests agree again.
    assert rig.direct_count(1, 'Count(Bitmap(rowID=1, frame="f"))') == want
    assert (rig.direct_digest(0)["digest"] == rig.direct_digest(1)["digest"]
            == rig.direct_digest(2)["digest"])
    # A second sweep is clean: no new divergence counted.
    rig.router._anti_entropy_once()
    snap = rig.stats.snapshot()
    assert snap.get("replica.divergence.g1", 0) == 1
    assert snap.get("replica.antientropy_rounds", 0) == 2


def test_anti_entropy_interval_starts_background_loop(tmp_path):
    """With [replica] anti-entropy-interval set the router runs the
    sweep in the background (jittered) — divergence self-heals with no
    operator call either."""
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp, anti_entropy_interval_s=0.2)
        try:
            rig.seed()
            _spread_writes(rig, 3)
            st, _b, _h = rig.req("POST", "/index/i/query",
                                 b'SetBit(rowID=2, frame="f", columnID=88888)',
                                 port=rig.ports[2])
            assert st == 200
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if rig.stats.snapshot().get("replica.divergence.g2", 0) >= 1:
                    break
                time.sleep(0.05)
            snap = rig.stats.snapshot()
            assert snap.get("replica.divergence.g2", 0) >= 1
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if (rig.direct_digest(2)["digest"]
                        == rig.direct_digest(0)["digest"]):
                    break
                time.sleep(0.05)
            assert (rig.direct_digest(2)["digest"]
                    == rig.direct_digest(0)["digest"])
        finally:
            rig.close()


# -- satellites ---------------------------------------------------------------


def test_stale_group_stays_in_probe_rotation():
    """Stale groups are not dropped from the probe loop; they
    keep being probed at probe-max-interval, so resync (and a
    hand-resynced group) has a live door back in."""
    router = ReplicaRouter(
        ["g0=127.0.0.1:1"], probe_interval_s=0.05, probe_max_interval_s=0.2,
        stats=ExpvarStatsClient(),
    )
    g = router.groups[0]
    g.healthy = False
    g.stale = True
    g.probe_at = 0.0
    g.probe_delay = 0.0
    router._probe_once()  # unreachable -> backoff; but it WAS probed
    assert g.probe_delay > 0  # stale groups enter `due`
    assert g.probe_delay <= router.probe_max_interval_s
    router.close()


def test_going_stale_arms_probe_at_max_interval(tmp_path):
    """Marking a group stale schedules its next probe at the max
    interval (not the tight unhealthy cadence, and not never)."""
    wal = WriteAheadLog(str(tmp_path / "w.wal"), max_bytes=1024, fsync=False)
    router = ReplicaRouter(
        ["g0=127.0.0.1:1", "g1=127.0.0.1:2"],
        probe_max_interval_s=7.5, wal=wal, stats=ExpvarStatsClient(),
    )
    g0, g1 = router.groups
    for k in range(40):
        # Past the 64 KiB compaction floor AND the 1 KiB bound.
        seq = wal.append("POST", "/index/i/query", b"x" * 2048)
        g0.applied_seq = seq  # g0 keeps up; g1 stuck at 0
    router._maybe_compact()
    assert g1.stale and not g0.stale
    assert g1.probe_delay == router.probe_max_interval_s
    assert g1.probe_at > time.monotonic()
    router.close()


def test_nonquorate_write_retry_after_is_jittered():
    """The 503 a non-quorate write gets carries a JITTERED Retry-After
    (decorrelated, mirroring the client retry budget) so a client herd
    doesn't retry in lockstep against a recovering cluster."""
    router = ReplicaRouter(["g0=127.0.0.1:1"], stats=ExpvarStatsClient())
    router.groups[0].healthy = False  # not quorate
    seen = set()
    for _ in range(12):
        status, _ct, _body, extra = router.handle(
            "POST", "/index/i/query",
            b'SetBit(rowID=1, frame="f", columnID=1)', {})
        assert status == 503
        ra = float(extra["Retry-After"])
        assert 0.45 <= ra <= 1.55  # uniform(0.5x, 1.5x) of the 1.0 hint
        seen.add(ra)
    assert len(seen) > 1  # not a fixed value
    router.close()


def test_resync_needed_and_covered_rules(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.wal"), fsync=False)
    router = ReplicaRouter(
        ["g0=127.0.0.1:1", "g1=127.0.0.1:2"], wal=wal,
        stats=ExpvarStatsClient(),
    )
    rs = router.resync
    g = router.groups[1]
    assert not rs.needed(g)  # empty log: nothing to converge
    for _ in range(10):
        wal.append("POST", "/p", b"x")
    g.applied_seq = 0
    assert rs.needed(g)  # blank over a non-empty sequence space
    g.applied_seq = 4
    assert rs.covered(g) and not rs.needed(g)  # replay suffices
    wal.compact(6)  # records 1..6 gone
    assert not rs.covered(g) and rs.needed(g)  # gap no longer covered
    g.applied_seq = 6
    assert rs.covered(g)
    g.stale = True
    assert rs.needed(g)  # stale always resyncs
    router.close()


def test_config_promotion_resync(tmp_path):
    toml = tmp_path / "c.toml"
    toml.write_text(
        "[replica]\n"
        'anti-entropy-interval = "90s"\n'
        "resync-chunk-bytes = 1024\n"
    )
    cfg = Config.from_toml(str(toml))
    assert cfg.replica_anti_entropy_interval == 90.0
    assert cfg.replica_resync_chunk_bytes == 1024
    cfg.apply_env({
        "PILOSA_TPU_REPLICA_ANTI_ENTROPY_INTERVAL": "5.5",
        "PILOSA_TPU_REPLICA_RESYNC_CHUNK_BYTES": "2048",
    })
    assert cfg.replica_anti_entropy_interval == 5.5
    assert cfg.replica_resync_chunk_bytes == 2048
    # Defaults: sweep off, chunk 256 KiB.
    d = Config()
    assert d.replica_anti_entropy_interval == 0.0
    assert d.replica_resync_chunk_bytes == 256 << 10


def test_router_from_config_wires_resync(tmp_path):
    from pilosa_tpu_torch.replica.router import router_from_config

    cfg = Config(replica_groups=["g0=127.0.0.1:1"])
    cfg.replica_anti_entropy_interval = 3.0
    cfg.replica_resync_chunk_bytes = 4096
    router = router_from_config(cfg, stats=ExpvarStatsClient())
    assert router.anti_entropy_interval_s == 3.0
    assert router.resync.chunk_bytes == 4096
    router.close()


def test_resync_floor_pins_compaction(tmp_path):
    """An in-flight resync round floors the compaction watermark at its
    seed sequence — the handoff suffix must stay replayable even though
    the stale laggard is excluded from the usual min-applied rule."""
    wal = WriteAheadLog(str(tmp_path / "w.wal"), max_bytes=1 << 14, fsync=False)
    router = ReplicaRouter(
        ["g0=127.0.0.1:1", "g1=127.0.0.1:2"], wal=wal,
        stats=ExpvarStatsClient(),
    )
    g0, g1 = router.groups
    g1.stale = True  # excluded from `tracked`
    for _ in range(300):
        seq = wal.append("POST", "/p", b"y" * 512)
        g0.applied_seq = seq
    with router._mu:
        router._resync_floor["g1"] = 100
    router._maybe_compact()
    assert wal.first_seq == 101  # floored at the seed, not g0's head
    with router._mu:
        del router._resync_floor["g1"]
    router._maybe_compact()
    assert wal.first_seq == 0 or wal.first_seq > 300 - 1  # head-only now
    router.close()
