"""The port's SWIM gossip node set: tests/test_gossip.py through
pilosa_tpu_torch (UDP probe/piggyback, TCP push/pull, failure detection,
refutation, and schema propagation between port servers).  The file
runs under the port's lock checker.
"""

from __future__ import annotations

import os
import time

import pytest

from pilosa_tpu_torch.gossip import (
    STATE_ALIVE,
    STATE_DEAD,
    GossipNodeSet,
    Member,
    _pack_piggyback,
    _unpack_piggyback,
)


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


def _wait_for(cond, timeout=8.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _mknode(name, seed="", status_handler=None, **kw):
    n = GossipNodeSet(
        name,
        bind="127.0.0.1:0",
        seed=seed,
        status_handler=status_handler,
        probe_interval=0.1,
        probe_timeout=0.3,
        suspect_timeout=0.6,
        push_pull_interval=0.5,
        **kw,
    )
    n.start(lambda msg: None)
    n.open()
    return n


class _Recorder:
    def __init__(self):
        self.messages = []

    def __call__(self, msg: bytes):
        self.messages.append(msg)


class _Status:
    def __init__(self, blob: bytes):
        self.blob = blob
        self.remote = []

    def local_status(self) -> bytes:
        return self.blob

    def handle_remote_status(self, buf: bytes) -> None:
        self.remote.append(buf)


def test_piggyback_roundtrip():
    items = [(0, b"alpha"), (1, b""), (1, b"\x00\xff" * 10)]
    assert _unpack_piggyback(_pack_piggyback(items)) == items


def test_open_requires_start():
    n = GossipNodeSet("n0", bind="127.0.0.1:0")
    with pytest.raises(RuntimeError):
        n.open()  # gossip.go:64-66 ordering requirement


def test_join_and_membership_convergence():
    a = _mknode("node-a:10101")
    b = _mknode("node-b:10101", seed=a.addr)
    try:
        assert _wait_for(lambda: a.nodes() == ["node-a:10101", "node-b:10101"])
        assert _wait_for(lambda: b.nodes() == ["node-a:10101", "node-b:10101"])
    finally:
        a.close()
        b.close()


def test_transitive_membership():
    """C joins via B; A must learn C through gossip (not direct contact)."""
    a = _mknode("a:1")
    b = _mknode("b:1", seed=a.addr)
    c = _mknode("c:1", seed=b.addr)
    try:
        assert _wait_for(lambda: a.nodes() == ["a:1", "b:1", "c:1"], timeout=10)
        assert _wait_for(lambda: c.nodes() == ["a:1", "b:1", "c:1"], timeout=10)
    finally:
        for n in (a, b, c):
            n.close()


def test_send_sync_delivers_to_all_members():
    rec_b, rec_c = _Recorder(), _Recorder()
    a = _mknode("a:1")
    b = _mknode("b:1", seed=a.addr)
    c = _mknode("c:1", seed=a.addr)
    b.handler = rec_b
    c.handler = rec_c
    try:
        assert _wait_for(lambda: len(a.nodes()) == 3)
        a.send_sync(b"schema-mutation")
        assert _wait_for(lambda: rec_b.messages == [b"schema-mutation"])
        assert _wait_for(lambda: rec_c.messages == [b"schema-mutation"])
    finally:
        for n in (a, b, c):
            n.close()


def test_send_async_piggybacks_on_probes():
    rec = _Recorder()
    a = _mknode("a:1")
    b = _mknode("b:1", seed=a.addr)
    b.handler = rec
    try:
        assert _wait_for(lambda: len(a.nodes()) == 2)
        a.send_async(b"async-news")
        assert _wait_for(lambda: b"async-news" in rec.messages, timeout=5)
    finally:
        a.close()
        b.close()


def test_status_push_pull_on_join():
    sa, sb = _Status(b"status-of-a"), _Status(b"status-of-b")
    a = _mknode("a:1", status_handler=sa)
    b = _mknode("b:1", seed=a.addr, status_handler=sb)
    try:
        # Join push/pull exchanges both directions (gossip.go:193-222).
        assert _wait_for(lambda: b"status-of-a" in sb.remote)
        assert _wait_for(lambda: b"status-of-b" in sa.remote)
    finally:
        a.close()
        b.close()


def test_failure_detection_marks_dead():
    a = _mknode("a:1")
    b = _mknode("b:1", seed=a.addr)
    try:
        assert _wait_for(lambda: len(a.nodes()) == 2)
        b.close()  # silent death — no goodbye message
        assert _wait_for(lambda: a.nodes() == ["a:1"], timeout=10)
        assert a.member_states()["b:1"] == STATE_DEAD
    finally:
        a.close()


def test_refutation_keeps_live_node_alive():
    """A live node that hears its own suspicion re-announces with a higher
    incarnation (SWIM refutation)."""
    a = _mknode("a:1")
    b = _mknode("b:1", seed=a.addr)
    try:
        assert _wait_for(lambda: len(b.nodes()) == 2)
        # Inject a false suspicion of B into B itself.
        b._merge_member(Member(name="b:1", addr=b.addr, incarnation=0, state="suspect"))
        assert b._incarnation >= 1
        assert b.member_states()["b:1"] == STATE_ALIVE
        assert _wait_for(lambda: len(a.nodes()) == 2)
    finally:
        a.close()
        b.close()


def test_dead_member_revives_on_higher_incarnation():
    a = _mknode("a:1")
    try:
        a._merge_member(Member(name="x:1", addr="127.0.0.1:9", incarnation=0))
        a._mark("x:1", STATE_DEAD)
        assert "x:1" not in a.nodes()
        a._merge_member(Member(name="x:1", addr="127.0.0.1:9", incarnation=1, state=STATE_ALIVE))
        assert "x:1" in a.nodes()
    finally:
        a.close()


def test_server_schema_propagates_over_gossip(tmp_path):
    """Two full servers with gossip transport: schema created on A appears
    on B via the status push/pull (server_test.go TestMain_SendReceiveMessage
    analog, over SWIM instead of httpbroadcast)."""
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.server.server import Server

    def mkserver(name, port, data_dir, seed=""):
        cfg = Config()
        cfg.data_dir = str(data_dir)
        cfg.host = f"127.0.0.1:{port}"
        cfg.engine = "torch:cpu"
        cfg.cluster.type = "gossip"
        cfg.cluster.hosts = ["127.0.0.1:0"]  # membership comes from gossip
        cfg.cluster.gossip_seed = seed
        srv = Server(cfg)
        # speed up the gossip clocks for the test
        g = srv.receiver
        g.probe_interval, g.probe_timeout = 0.1, 0.3
        g.push_pull_interval = 0.4
        srv.open()
        return srv

    a = mkserver("a", 0, tmp_path / "a")
    b = None
    try:
        seed_addr = a.receiver.addr
        b = mkserver("b", 0, tmp_path / "b", seed=seed_addr)
        # Create schema on A only.
        from pilosa_tpu_torch.core.frame import FrameOptions
        from pilosa_tpu_torch.core.index import IndexOptions

        idx = a.holder.create_index("gossidx", IndexOptions(column_label="col"))
        idx.create_frame("gframe", FrameOptions(row_label="row"))
        assert _wait_for(
            lambda: b.holder.index("gossidx") is not None
            and b.holder.frame("gossidx", "gframe") is not None,
            timeout=10,
        )
        fr = b.holder.frame("gossidx", "gframe")
        assert fr.row_label == "row"
    finally:
        a.close()
        if b is not None:
            b.close()


def test_four_node_convergence_and_death():
    """Membership converges through a single seed at 4 nodes; a killed
    node is marked dead everywhere and survivors keep broadcasting."""
    a = _mknode("n0:1")
    b = _mknode("n1:1", seed=a.addr)
    c = _mknode("n2:1", seed=a.addr)
    d = _mknode("n3:1", seed=a.addr)
    nodes = [a, b, c, d]
    rec = _Recorder()
    d.handler = rec
    try:
        want = ["n0:1", "n1:1", "n2:1", "n3:1"]
        for n in nodes:
            assert _wait_for(lambda n=n: sorted(n.nodes()) == want, timeout=12), (
                n.name, n.nodes())
        # Kill one non-seed node; everyone else marks it dead.
        c.close()
        alive = ["n0:1", "n1:1", "n3:1"]
        for n in (a, b, d):
            assert _wait_for(lambda n=n: sorted(n.nodes()) == alive, timeout=12), (
                n.name, n.nodes())
        # Survivors still deliver broadcasts end to end.
        a.send_async(b"after-death")
        assert _wait_for(lambda: b"after-death" in rec.messages, timeout=8)
    finally:
        for n in nodes:
            try:
                n.close()
            except Exception:
                pass
