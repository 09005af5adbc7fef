"""The replica router over port groups: tests/test_replica.py's router
cases (its lockstep cases are in tests/test_torch_lockstep.py),
tests/test_metrics.py's fleet view, and the fleet held against the JAX
package.

Each group is a complete in-process port Server (numpy engine; one rig
runs ``torch:cpu`` so the torch lane answers through the router) with
its own holder, behind a port ``ReplicaRouter``.  The invariants are the
reference's: writes ship total-ordered to every group through one
sequencer and the WAL, reads fan across healthy groups and fail over
once, a dead group degrades writes to 503 below a majority while reads
keep serving, and the router's counters, gauges and trace tags are the
same names.  The file runs under the port's lock checker.
"""

import json
import os
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.replica import (
    GROUP_HEADER,
    ReplicaRouter,
    format_group,
    parse_group,
)
from pilosa_tpu_torch.stats import ExpvarStatsClient
from pilosa_tpu_torch.trace import Tracer


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


class _Rig:
    """Two in-process group servers + a router in front."""

    def __init__(self, tmp, n_groups=2, failover=True, tracer=None,
                 probe_interval_s=0.1, engine="numpy", **router_kw):
        from pilosa_tpu_torch.server.server import Server

        self.servers = []
        for i in range(n_groups):
            cfg = Config(
                data_dir=f"{tmp}/g{i}", host="127.0.0.1:0", engine=engine,
                stats="expvar", qcache_enabled=False, replica_group=f"g{i}",
            )
            srv = Server(cfg)
            srv.open()
            self.servers.append(srv)
        self.stats = ExpvarStatsClient()
        self.router = ReplicaRouter(
            [f"g{i}={srv.host}" for i, srv in enumerate(self.servers)],
            failover=failover, probe_interval_s=probe_interval_s,
            stats=self.stats, tracer=tracer, **router_kw,
        ).serve()
        self.base = f"http://127.0.0.1:{self.router.port}"

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
            f"http://{self.servers[i].host}/index/i/query",
            data=q.encode(), method="POST",
        )
        with urllib.request.urlopen(rq, timeout=30) as resp:
            return json.loads(resp.read())["results"][0]

    def seed(self):
        assert self.req("POST", "/index/i", b"{}")[0] == 200
        assert self.req("POST", "/index/i/frame/f", b"{}")[0] == 200

    def close(self):
        self.router.close()
        for s in self.servers:
            s.close()


@pytest.fixture
def rig(request):
    with tempfile.TemporaryDirectory() as tmp:
        r = _Rig(tmp, engine=getattr(request, "param", "numpy"))
        try:
            yield r
        finally:
            r.close()


@pytest.mark.parametrize("rig", ["numpy", "torch:cpu"], indirect=True)
def test_write_fanout_and_read_balance(rig):
    """Writes (and schema mutations) apply on EVERY group; sequential
    reads spread across groups via the least-inflight/fewest-routed
    pick; counters account for both."""
    rig.seed()
    for c in range(5):
        st, body, hdrs = rig.query(f'SetBit(rowID=1, frame="f", columnID={c})')
        assert st == 200 and json.loads(body)["results"] == [True]
        assert hdrs.get(GROUP_HEADER) == "all"  # write = whole group set
    # Both groups hold the identical result of the identical write order.
    assert rig.direct_count(0) == rig.direct_count(1) == 5
    served = set()
    for _ in range(4):
        st, body, hdrs = rig.query('Count(Bitmap(rowID=1, frame="f"))')
        assert st == 200 and json.loads(body)["results"] == [5]
        served.add(hdrs.get(GROUP_HEADER))
    assert served == {"g0", "g1"}  # idle router round-robins the ties
    snap = rig.stats.snapshot()
    assert snap["replica.routed.g0"] >= 1 and snap["replica.routed.g1"] >= 1
    # Every data write + schema mutation fanned through the sequencer.
    assert snap["replica.write_fanout"] == 7
    assert snap["replica.inflight.g0"] == 0 and snap["replica.inflight.g1"] == 0
    assert snap["replica.healthy.g0"] == 1 and snap["replica.healthy.g1"] == 1
    # Schema mutations really reached both groups.
    for i in range(2):
        rq = urllib.request.Request(f"http://{rig.servers[i].host}/schema")
        schema = json.loads(urllib.request.urlopen(rq, timeout=10).read())
        assert [x["name"] for x in schema["indexes"]] == ["i"]


@pytest.mark.parametrize("rig", ["numpy", "torch:cpu"], indirect=True)
def test_cross_group_read_your_writes(rig):
    """A write acked by the router is visible on the IMMEDIATE next
    read no matter which group serves it — the total-order fan-out
    advanced both groups' generation vectors before the ack."""
    rig.seed()
    for step in range(1, 6):
        assert rig.query(f'SetBit(rowID=1, frame="f", columnID={100 + step})')[0] == 200
        # Two back-to-back reads hit BOTH groups (round-robin ties).
        groups_seen = set()
        for _ in range(2):
            st, body, hdrs = rig.query('Count(Bitmap(rowID=1, frame="f"))')
            assert st == 200
            assert json.loads(body)["results"] == [step], hdrs.get(GROUP_HEADER)
            groups_seen.add(hdrs.get(GROUP_HEADER))
        assert groups_seen == {"g0", "g1"}
    assert rig.direct_count(0) == rig.direct_count(1) == 5


def test_failover_keeps_reads_serving_and_refuses_writes(rig):
    """Kill one group: reads keep serving from the survivor (one-shot
    failover on the first failed pick), writes answer 503 + Retry-After
    until the group set is quorate again."""
    rig.seed()
    assert rig.query('SetBit(rowID=1, frame="f", columnID=3)')[0] == 200
    rig.servers[1].close()  # the whole group goes away
    for _ in range(6):
        st, body, hdrs = rig.query('Count(Bitmap(rowID=1, frame="f"))')
        assert st == 200 and json.loads(body)["results"] == [1]
        assert hdrs.get(GROUP_HEADER) == "g0"
    snap = rig.stats.snapshot()
    assert snap.get("replica.failover", 0) >= 1
    assert snap["replica.healthy.g1"] == 0
    # Writes refuse without touching ANY group while non-quorate.
    before = rig.direct_count(0)
    st, body, hdrs = rig.query('SetBit(rowID=1, frame="f", columnID=9)')
    assert st == 503 and "quorate" in json.loads(body)["error"]
    assert "Retry-After" in hdrs
    assert rig.direct_count(0) == before
    # The group table tells the same story over HTTP.
    status = json.loads(rig.req("GET", "/replica/status")[1])
    assert status["quorate"] is False
    assert {g["name"]: g["healthy"] for g in status["groups"]} == {
        "g0": True, "g1": False,
    }


def test_health_probe_restores_a_live_group(rig):
    """A group marked unhealthy (e.g. by one failed read) but actually
    serving is restored by the background /replica/health probe — and
    writes work again once the set is quorate."""
    rig.seed()
    g1 = rig.router.groups[1]
    rig.router._mark_unhealthy(g1, "injected")
    deadline = time.monotonic() + 5
    while not g1.healthy and time.monotonic() < deadline:
        time.sleep(0.05)
    assert g1.healthy, "probe never restored a live group"
    snap = rig.stats.snapshot()
    assert snap.get("replica.recovered", 0) >= 1
    assert rig.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200
    assert rig.direct_count(0) == rig.direct_count(1) == 1


def test_partial_write_failure_answers_502_and_degrades(rig, monkeypatch):
    """A write that fails MID-fan-out (first group applied, second
    unreachable) answers 502 (may be partially applied), marks the
    failed group unhealthy, and subsequent writes 503 until recovery."""
    rig.seed()
    real = rig.router._forward
    g1 = rig.router.groups[1]

    def flaky(g, method, path_qs, body, headers, **kw):
        if g is g1 and b"SetBit" in body:
            raise OSError("injected mid-fanout failure")
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig.router, "_forward", flaky)
    st, body, _ = rig.query('SetBit(rowID=1, frame="f", columnID=2)')
    assert st == 502 and "partially applied" in json.loads(body)["error"]
    assert rig.direct_count(0) == 1  # the first group DID commit
    # Non-quorate now: the next write refuses outright (no group touched).
    st, body, _ = rig.query('SetBit(rowID=1, frame="f", columnID=3)')
    assert st == 503
    snap = rig.stats.snapshot()
    assert snap.get("replica.write_error", 0) == 1
    assert snap.get("replica.write_refused", 0) == 1
    # The probe restores g1 (it is actually alive), and the idempotent
    # retry re-aligns the groups.
    monkeypatch.setattr(rig.router, "_forward", real)
    deadline = time.monotonic() + 5
    while not g1.healthy and time.monotonic() < deadline:
        time.sleep(0.05)
    assert g1.healthy
    assert rig.query('SetBit(rowID=1, frame="f", columnID=2)')[0] == 200
    assert rig.direct_count(0) == rig.direct_count(1) == 1


def test_write_shed_never_acked_as_success(rig, monkeypatch):
    """A 429 shed is LOAD-dependent, not deterministic: shed at the
    FIRST group passes the backpressure through (nothing applied, no
    demotion); shed AFTER a sibling committed is a partial write (502 +
    demotion) — the client never gets a success ack while a group
    silently missed the write."""
    rig.seed()
    real = rig.router._forward
    g0, g1 = rig.router.groups
    shed = (
        429, "application/json",
        json.dumps({"error": "shed"}).encode(), {"Retry-After": "0.250"},
    )

    def shed_first(g, method, path_qs, body, headers, **kw):
        if g is g0 and b"SetBit" in body:
            return shed
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig.router, "_forward", shed_first)
    st, body, hdrs = rig.query('SetBit(rowID=1, frame="f", columnID=2)')
    assert st == 429 and hdrs.get("Retry-After") == "0.250"
    # Nothing applied anywhere, and a loaded group is NOT demoted.
    assert rig.direct_count(0) == 0 and rig.direct_count(1) == 0
    assert g0.healthy and g1.healthy
    assert rig.stats.snapshot().get("replica.write_shed", 0) == 1

    # Shed at the SECOND group after the first committed: partial write.
    def shed_second(g, method, path_qs, body, headers, **kw):
        if g is g1 and b"SetBit" in body:
            return shed
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig.router, "_forward", shed_second)
    st, body, _ = rig.query('SetBit(rowID=1, frame="f", columnID=2)')
    assert st == 502 and "partially applied" in json.loads(body)["error"]
    assert rig.direct_count(0) == 1 and rig.direct_count(1) == 0
    assert not g1.healthy  # demoted: further writes refuse until recovery
    assert rig.query('SetBit(rowID=1, frame="f", columnID=3)')[0] == 503
    # The probe restores g1 (it is alive) and the idempotent retry
    # re-aligns the groups.
    monkeypatch.setattr(rig.router, "_forward", real)
    deadline = time.monotonic() + 5
    while not g1.healthy and time.monotonic() < deadline:
        time.sleep(0.05)
    assert g1.healthy
    assert rig.query('SetBit(rowID=1, frame="f", columnID=2)')[0] == 200
    assert rig.direct_count(0) == rig.direct_count(1) == 1


def test_read_504_is_request_scoped_not_group_health(rig, monkeypatch):
    """A 504 spent the REQUEST's own deadline budget, not the group's
    health: it returns to the client without demoting the group, so a
    burst of tight-deadline reads can never mark every group unhealthy
    and refuse writes cluster-wide via the quorum rule."""
    rig.seed()
    real = rig.router._forward

    def deadline_504(g, method, path_qs, body, headers, **kw):
        if b"Count" in body:
            return (
                504, "application/json",
                json.dumps({"error": "deadline exceeded"}).encode(), {},
            )
        return real(g, method, path_qs, body, headers, **kw)

    monkeypatch.setattr(rig.router, "_forward", deadline_504)
    for _ in range(6):  # enough to have drawn BOTH groups
        assert rig.query('Count(Bitmap(rowID=1, frame="f"))')[0] == 504
    assert all(g.healthy for g in rig.router.groups)
    assert rig.router.quorate()
    assert rig.stats.snapshot().get("replica.failover", 0) == 0
    # Writes still flow: the deadline burst demoted nobody.
    monkeypatch.setattr(rig.router, "_forward", real)
    assert rig.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200


def test_router_deadline_and_trace():
    """The router honors deadlines at ITS door (an expired request never
    reaches a group) and forwards the remaining budget on the hop; a
    forced trace tags the root with the serving group and grafts the
    group's own span tree under the forward span."""
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp, tracer=Tracer())
        try:
            rig.seed()
            assert rig.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200
            # Expired at the router door: 504 before any forward.
            st, _, _ = rig.query('Count(Bitmap(rowID=1, frame="f"))',
                                 headers={"X-Pilosa-Deadline-Ms": "0"})
            assert st == 504
            # Forced trace rides the hop and lands in the router ring.
            st, body, _ = rig.query('Count(Bitmap(rowID=1, frame="f"))',
                                    headers={"X-Pilosa-Trace": "1"})
            assert st == 200 and json.loads(body)["results"] == [1]
            traces = json.loads(rig.req("GET", "/debug/traces")[1])["traces"]
            root = traces[0]["spans"]
            assert root["tags"]["group"] in ("g0", "g1")
            fwd = [c for c in root.get("children", []) if c["name"] == "forward"]
            assert fwd and fwd[0]["tags"]["group"] == root["tags"]["group"]
            # The group's own span tree (its "POST /index/i/query" root)
            # was grafted under the forward span — one trace, both sides.
            assert any(
                "query" in c.get("name", "") for c in fwd[0].get("children", [])
            ), fwd[0]
        finally:
            rig.close()


def test_router_debug_vars_http(rig):
    rig.seed()
    assert rig.query('SetBit(rowID=1, frame="f", columnID=1)')[0] == 200
    assert rig.query('Count(Bitmap(rowID=1, frame="f"))')[0] == 200
    st, body, _ = rig.req("GET", "/debug/vars")
    assert st == 200
    snap = json.loads(body)
    assert snap["replica.write_fanout"] >= 1
    assert any(k.startswith("replica.routed.") for k in snap)
    assert snap["replica.healthy.g0"] == 1 and snap["replica.healthy.g1"] == 1


def test_epoch_bump_detection(rig):
    """A changed X-Pilosa-Group epoch on a group's responses (job
    restart) is recorded and counted — the router's signal that the
    group's in-memory generation vectors were rebuilt."""
    g0 = rig.router.groups[0]
    rig.router._note_epoch(g0, "g0@1")
    rig.router._note_epoch(g0, "g0@1")
    assert rig.stats.snapshot().get("replica.epoch_bump", 0) == 0
    rig.router._note_epoch(g0, "g0@2")
    assert rig.stats.snapshot()["replica.epoch_bump"] == 1
    assert g0.epoch == "g0@2"


def test_group_header_on_plain_server(rig):
    """Every group-configured server stamps X-Pilosa-Group on every
    response (the router's attribution source), and /replica/health
    answers 200."""
    for i in range(2):
        rq = urllib.request.Request(f"http://{rig.servers[i].host}/version")
        with urllib.request.urlopen(rq, timeout=10) as resp:
            assert resp.headers.get(GROUP_HEADER) == f"g{i}"
        rq = urllib.request.Request(f"http://{rig.servers[i].host}/replica/health")
        with urllib.request.urlopen(rq, timeout=10) as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["group"] == f"g{i}"


def test_client_surfaces_serving_group(rig):
    """Client.execute_query exposes which replica answered (and "all"
    for a router write), plus the router status helper."""
    from pilosa_tpu_torch.server.client import Client

    rig.seed()
    c = Client(f"127.0.0.1:{rig.router.port}")
    resp = c.execute_query("i", 'SetBit(rowID=1, frame="f", columnID=4)')
    assert resp.get("group") == "all"
    resp = c.execute_query("i", 'Count(Bitmap(rowID=1, frame="f"))')
    assert resp.get("group") in ("g0", "g1")
    status = c.replica_status()
    assert status["quorate"] is True and len(status["groups"]) == 2


def test_no_failover_when_disabled():
    """[replica] failover = false: the first failed pick surfaces to
    the client instead of retrying a sibling."""
    with tempfile.TemporaryDirectory() as tmp:
        rig = _Rig(tmp, failover=False)
        try:
            rig.seed()
            rig.servers[1].close()
            statuses = set()
            for _ in range(4):
                statuses.add(rig.query('Count(Bitmap(rowID=1, frame="f"))')[0])
            # The read that drew the dead group answered 503; once g1 is
            # marked unhealthy the rest route to g0 and succeed.
            assert 503 in statuses and 200 in statuses
            assert rig.stats.snapshot().get("replica.failover", 0) == 0
        finally:
            rig.close()


# -- config / CLI promotion --------------------------------------------------


def test_config_replica_promotion(tmp_path):
    toml = tmp_path / "c.toml"
    toml.write_text(
        "[replica]\n"
        'group = "g1@3"\n'
        'groups = ["g0=h0:1", "g1=h1:2"]\n'
        "router-port = 12345\n"
        "failover = false\n"
    )
    cfg = Config.from_toml(str(toml))
    assert cfg.replica_group == "g1@3"
    assert cfg.replica_groups == ["g0=h0:1", "g1=h1:2"]
    assert cfg.replica_router_port == 12345
    assert cfg.replica_failover is False
    cfg.apply_env({
        "PILOSA_TPU_REPLICA_GROUP": "g2@5",
        "PILOSA_TPU_REPLICA_GROUPS": "a:1, b:2",
        "PILOSA_TPU_REPLICA_ROUTER_PORT": "4321",
        "PILOSA_TPU_REPLICA_FAILOVER": "true",
    })
    assert cfg.replica_group == "g2@5"
    assert cfg.replica_groups == ["a:1", "b:2"]
    assert cfg.replica_router_port == 4321
    assert cfg.replica_failover is True
    assert parse_group(cfg.replica_group) == ("g2", 5)
    assert parse_group("g0") == ("g0", 0)
    assert format_group("g2", 5) == "g2@5"
    assert format_group("") == ""


def test_router_from_config():
    from pilosa_tpu_torch.replica import router_from_config

    cfg = Config(host="127.0.0.1:10101")
    cfg.replica_groups = ["127.0.0.1:1", "gX=127.0.0.1:2"]
    cfg.replica_router_port = 0
    cfg.replica_failover = False
    r = router_from_config(cfg)
    assert [g.name for g in r.groups] == ["g0", "gX"]
    assert r.failover is False and r.host == "127.0.0.1"


def test_cli_replica_router(rig, capsys):
    """The replica-router subcommand wires [replica] config + flags."""
    from pilosa_tpu_torch.cli.main import build_parser

    p = build_parser()
    args = p.parse_args([
        "replica-router",
        "--groups", ",".join(f"g{i}={s.host}" for i, s in enumerate(rig.servers)),
        "--port", "0",
        "--test-exit",
    ])
    assert args.fn(args) == 0
    out = capsys.readouterr().out
    assert "replica-router" in out and "g0=" in out and "g1=" in out


def test_cli_replica_router_no_groups(capsys):
    from pilosa_tpu_torch.cli.main import build_parser

    p = build_parser()
    args = p.parse_args(["replica-router", "--port", "0", "--test-exit"])
    assert args.fn(args) == 1


@pytest.mark.parametrize("rig", ["numpy", "torch:cpu"], indirect=True)
def test_streamed_ingest_converges_on_all_groups(rig):
    """Streamed columnar ingest through the router is a sequenced,
    WAL-logged write per chunk: every group applies every chunk in the
    same total order, both groups' contents (and digests) converge,
    and a replayed chunk acks idempotently."""
    import zlib

    from pilosa_tpu_torch.ingest import encode_packed

    rig.seed()
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 20, size=5000).astype(np.uint64)
    cols = rng.integers(0, 1 << 20, size=5000).astype(np.uint64)
    frames = [
        encode_packed(rows[i : i + 1024], cols[i : i + 1024])
        for i in range(0, 5000, 1024)
    ]
    total = sum(len(f) for f in frames)
    crc = 0
    for f in frames:
        crc = zlib.crc32(f, crc)
    off = 0
    body = b"{}"
    for fb in frames:
        st, body, hdrs = rig.req(
            "POST",
            f"/index/i/frame/f/ingest?off={off}&total={total}&crc={crc}"
            f"&ccrc={zlib.crc32(fb)}",
            fb,
        )
        assert st == 200, body
        assert hdrs.get(GROUP_HEADER) == "all"  # sequenced to every group
        off += len(fb)
    assert json.loads(body)["done"] is True
    # Both groups converge: identical per-row counts and digests.
    for r in (0, 3, 11):
        expect = len(np.unique(cols[rows == r]))
        q = f'Count(Bitmap(rowID={r}, frame="f"))'
        assert rig.direct_count(0, q) == rig.direct_count(1, q) == expect
    digests = []
    for srv in rig.servers:
        rq = urllib.request.Request(f"http://{srv.host}/replica/digest")
        digests.append(json.loads(urllib.request.urlopen(rq, timeout=10).read()))
    assert digests[0]["digest"] == digests[1]["digest"]
    # Idempotent replay of an applied chunk: deterministic 200, no
    # divergence (this is the WAL-replay delivery shape; the completed
    # transfer was dropped, so the replay opens a fresh one and the
    # re-applied bits converge).
    st, body, _ = rig.req(
        "POST",
        f"/index/i/frame/f/ingest?off=0&total={total}&crc={crc}"
        f"&ccrc={zlib.crc32(frames[0])}",
        frames[0],
    )
    assert st == 200 and json.loads(body)["staged"] == len(frames[0])
    q = 'Count(Bitmap(rowID=3, frame="f"))'
    assert rig.direct_count(0, q) == rig.direct_count(1, q)


# -- fleet view (tests/test_metrics.py's router cases) ------------------------


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def _post(url, body, headers=None, timeout=30):
    rq = urllib.request.Request(url, data=body, method="POST")
    for k, v in (headers or {}).items():
        rq.add_header(k, v)
    with urllib.request.urlopen(rq, timeout=timeout) as resp:
        return resp.status, resp.read()


class _FleetRig:
    """Three in-process group servers + a router (the test_replica rig
    shape, sized for the fleet view)."""

    def __init__(self, tmp, n_groups=3):
        from pilosa_tpu_torch.server.server import Server

        self.servers = []
        for i in range(n_groups):
            cfg = Config(
                data_dir=f"{tmp}/g{i}", host="127.0.0.1:0", engine="numpy",
                stats="expvar", qcache_enabled=False, replica_group=f"g{i}",
            )
            srv = Server(cfg)
            srv.open()
            self.servers.append(srv)
        self.stats = ExpvarStatsClient()
        self.router = ReplicaRouter(
            [f"g{i}={srv.host}" for i, srv in enumerate(self.servers)],
            probe_interval_s=0.1, stats=self.stats,
            tracer=Tracer(sample_rate=1.0),
        ).serve()
        self.base = f"http://127.0.0.1:{self.router.port}"
        self.closed = set()

    def close(self):
        self.router.close()
        for i, s in enumerate(self.servers):
            if i not in self.closed:
                s.close()

    def kill(self, i):
        self.servers[i].close()
        self.closed.add(i)


@pytest.fixture
def fleet():
    with tempfile.TemporaryDirectory() as tmp:
        r = _FleetRig(tmp)
        try:
            yield r
        finally:
            r.close()


def test_fleet_aggregates_and_degrades_partially(fleet):
    from pilosa_tpu_torch import metrics

    base = fleet.base
    _post(base + "/index/i", b"{}")
    _post(base + "/index/i/frame/f", b"{}")
    _post(base + "/index/i/query", b'SetBit(rowID=1, frame="f", columnID=1)')
    _post(base + "/index/i/query", b'Count(Bitmap(rowID=1, frame="f"))')
    st, body, _ = _get(base + "/debug/fleet")
    assert st == 200
    fl = json.loads(body)
    assert fl["partial"] is False and len(fl["groups"]) == 3
    assert fl["quorum"] == 2 and fl["quorate"] is True
    # 3 sequenced mutations (2 schema + 1 SetBit); the Count is a read.
    assert fl["wal"]["lastSeq"] == fl["writeSeq"] == 3
    for g in fl["groups"]:
        assert g["staleScrape"] is False and g["ageMs"] is not None
        assert g["scrape"]["health"]["group"] == g["name"]
        assert g["scrape"]["appliedSeq"] == 3 and g["walDepth"] == 0
        # Latency percentiles surfaced from the group's QoS histograms
        # (every group saw the fanned-out writes at minimum).
        assert "write" in g["scrape"]["latencyMs"]
        assert g["scrape"]["latencyMs"]["write"]["p50"] >= 0
    # The one group that served the read carries its read percentiles.
    assert any("read" in g["scrape"]["latencyMs"] for g in fl["groups"])
    # Router-side progress counters ride along.
    assert fl["routerStats"]["replica.write_fanout"] == 3
    # Kill one group: the aggregate degrades to PARTIAL — the dead
    # group stays present, stamped stale with its error and the LAST
    # SUCCESSFUL scrape (aged), while the survivors scrape live.
    fleet.kill(2)
    st, body, _ = _get(base + "/debug/fleet?timeout-ms=200")
    fl = json.loads(body)
    assert st == 200 and fl["partial"] is True
    dead = next(g for g in fl["groups"] if g["name"] == "g2")
    assert dead["staleScrape"] is True and dead["error"]
    assert dead["scrape"] is not None  # cached from the earlier scrape
    assert dead["ageMs"] >= 0
    live = [g for g in fl["groups"] if g["name"] != "g2"]
    assert all(not g["staleScrape"] for g in live)
    # The router's own exposition stays scrapeable throughout.
    st, body, hdrs = _get(base + "/metrics")
    assert st == 200
    fams = metrics.parse_exposition(body.decode())
    assert "pilosa_replica_write_fanout_total" in fams


def test_router_debug_traces_clamp(fleet):
    base = fleet.base
    _post(base + "/index/i", b"{}")
    st, body, _ = _get(base + "/debug/traces?min-ms=bogus&limit=junk")
    assert st == 200
    json.loads(body)


# -- held against the JAX package: a mixed fleet, and both routers ------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _package(pkg: str):
    import importlib

    return (importlib.import_module(f"{pkg}.config").Config,
            importlib.import_module(f"{pkg}.server.server").Server)


class _Fleet:
    """Groups on fixed ports, each a Server of the package and engine its
    member names, behind ``router_pkg``'s ReplicaRouter; a group restarts
    on its port and data directory, or on a blank one."""

    def __init__(self, tmp, members, router_pkg="pilosa_tpu_torch",
                 probe_interval_s=0.05, **router_kw):
        import importlib

        self.tmp, self.members = tmp, list(members)
        self.ports = [_free_port() for _ in self.members]
        self.servers = [self._spawn(i, 1) for i in range(len(self.members))]
        replica = importlib.import_module(f"{router_pkg}.replica")
        stats = importlib.import_module(f"{router_pkg}.stats")
        self.stats = stats.ExpvarStatsClient()
        self.router = replica.ReplicaRouter(
            [f"g{i}=127.0.0.1:{p}" for i, p in enumerate(self.ports)],
            probe_interval_s=probe_interval_s, probe_max_interval_s=0.3,
            stats=self.stats, **router_kw,
        ).serve()
        self.base = f"http://127.0.0.1:{self.router.port}"

    def _spawn(self, i: int, epoch: int):
        pkg, engine = self.members[i]
        config_cls, server_cls = _package(pkg)
        srv = server_cls(config_cls(
            data_dir=f"{self.tmp}/g{i}", host=f"127.0.0.1:{self.ports[i]}",
            engine=engine, stats="expvar", qcache_enabled=False,
            replica_group=f"g{i}@{epoch}",
        ))
        srv.open()
        return srv

    def restart(self, i: int, epoch: int, blank: bool = False):
        import shutil

        if blank:
            shutil.rmtree(f"{self.tmp}/g{i}", ignore_errors=True)
        self.servers[i] = self._spawn(i, epoch)

    def req(self, method, path, body=None, port=None, timeout=30):
        base = self.base if port is None else f"http://127.0.0.1:{port}"
        rq = urllib.request.Request(base + path, data=body, method=method)
        try:
            with urllib.request.urlopen(rq, timeout=timeout) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    def direct(self, i, q):
        st, body, _ = self.req("POST", "/index/i/query", q.encode(), port=self.ports[i])
        assert st == 200, body
        return json.loads(body)["results"]

    def digest(self, i) -> dict:
        st, body, _ = self.req("GET", "/replica/digest", port=self.ports[i])
        assert st == 200, body
        return json.loads(body)

    def group_status(self, name: str) -> dict:
        status = json.loads(self.req("GET", "/replica/status")[1])
        return next(g for g in status["groups"] if g["name"] == name)

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
            except Exception:  # noqa: BLE001 — already closed
                pass


def _write_bodies(seed: int, n: int) -> list:
    """Seeded SetBit/ClearBit requests over four slices and eight rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        calls = []
        for _ in range(8):
            row = int(rng.integers(0, 8))
            col = int(rng.integers(0, 4)) * (1 << 20) + int(rng.integers(0, 5000))
            op = "ClearBit" if rng.random() < 0.15 else "SetBit"
            calls.append(f'{op}(rowID={row}, frame="f", columnID={col})')
        out.append(" ".join(calls).encode())
    return out


_READS = [
    " ".join(f'Count(Bitmap(rowID={r}, frame="f"))' for r in range(8)),
    'TopN(frame="f", n=5)',
    'Count(Union(Bitmap(rowID=1, frame="f"), Bitmap(rowID=2, frame="f")))',
    'Bitmap(rowID=3, frame="f")',
]


def test_mixed_fleet_converges_to_equal_digests():
    """A port router over one JAX-package group (numpy engine) and two
    port groups (numpy, torch:cpu): the same scripted writes, a catch-up
    of the JAX group, and blank resyncs of a port group (from any donor)
    and of the JAX group end with three equal /replica/digest bodies and
    equal answers on every group."""
    members = [("pilosa_tpu", "numpy"), ("pilosa_tpu_torch", "numpy"),
               ("pilosa_tpu_torch", "torch:cpu")]
    writes = _write_bodies(41, 36)
    with tempfile.TemporaryDirectory() as tmp:
        fl = _Fleet(tmp, members)
        try:
            assert fl.req("POST", "/index/i", b"{}")[0] == 200
            assert fl.req("POST", "/index/i/frame/f", b"{}")[0] == 200
            for body in writes[:12]:
                assert fl.req("POST", "/index/i/query", body)[0] == 200
            # Catch-up: the JAX group misses a burst and has it replayed.
            fl.servers[0].close()
            for body in writes[12:24]:
                assert fl.req("POST", "/index/i/query", body)[0] == 200
            fl.restart(0, 2)
            fl.wait_ready("g0")
            assert fl.stats.snapshot().get("replica.replayed", 0) >= 12
            # Blank resync of the torch:cpu group, then of the JAX group.
            fl.servers[2].close()
            for body in writes[24:30]:
                assert fl.req("POST", "/index/i/query", body)[0] == 200
            fl.restart(2, 2, blank=True)
            fl.wait_ready("g2")
            fl.servers[0].close()
            for body in writes[30:]:
                assert fl.req("POST", "/index/i/query", body)[0] == 200
            fl.restart(0, 3, blank=True)
            fl.wait_ready("g0")
            snap = fl.stats.snapshot()
            assert snap.get("replica.resync.g2", 0) >= 1
            assert snap.get("replica.resync.g0", 0) >= 1
            digests = [fl.digest(i) for i in range(3)]
            assert digests[0]["fragments"]  # the fleet holds data
            assert all(d["digest"] == digests[0]["digest"] for d in digests)
            assert all(d["fragments"] == digests[0]["fragments"] for d in digests)
            for q in _READS:
                answers = [fl.direct(i, q) for i in range(3)]
                assert answers[0] == answers[1] == answers[2], q
        finally:
            fl.close()


def _mask(body: bytes) -> bytes:
    import re

    return re.sub(rb"127\.0\.0\.1:\d+", b"HOST", body)


def _normalized(events: list) -> list:
    """Spec events with each ``src`` id replaced by its order of first
    appearance (the ids are object identities)."""
    ids: dict = {}
    out = []
    for kind, fields in events:
        f = dict(fields)
        if "src" in f:
            f["src"] = ids.setdefault(f["src"], len(ids))
        out.append((kind, f))
    return out


def _both_router_script(pkg: str, engines) -> tuple:
    """The same requests through ``pkg``'s router over ``pkg``'s groups.
    Returns every (status, masked body, serving group) and the spec
    events of the sequential part, and the statuses of the part that
    kills and restarts a group."""
    import importlib

    spec = importlib.import_module(f"{pkg}.analysis.spec")
    members = [(pkg, e) for e in engines]
    writes = _write_bodies(7, 10)
    seq = [("POST", "/index/i", b"{}"), ("POST", "/index/i/frame/f", b"{}"),
           ("POST", "/index/i/query", b'SetBit(rowID=1, frame="nope", columnID=1)'),
           ("POST", "/index/i/frame/f", b"{}")]
    seq += [("POST", "/index/i/query", b) for b in writes[:6]]
    seq += [("POST", "/index/i/query", q.encode()) for q in _READS]
    seq += [("POST", "/index/i/query", b"Count(Bitmap(rowID=1, frame=f))"),
            ("GET", "/schema", None), ("GET", "/replica/status", None)]
    seq += [("POST", "/index/i/query", q.encode()) for q in _READS]
    out, events = [], spec.install_collector()
    with tempfile.TemporaryDirectory() as tmp:
        # The probe interval is long enough that no probe runs inside the
        # sequential part: its events are the requests' alone.
        fl = _Fleet(tmp, members, router_pkg=pkg, probe_interval_s=30.0)
        try:
            for method, path, body in seq:
                st, resp, hdrs = fl.req(method, path, body)
                out.append((st, _mask(resp), hdrs.get(GROUP_HEADER)))
            trace = _normalized(list(events))
            spec.uninstall_collector()
            # Degraded quorum and catch-up: a group dies, writes commit
            # on two of three, the group returns and is replayed.
            fl.router.probe_interval_s = 0.05
            fl.servers[2].close()
            for body in writes[6:]:
                out.append((fl.req("POST", "/index/i/query", body)[0], None, None))
            fl.restart(2, 2)
            fl.wait_ready("g2")
            for q in _READS:
                st, resp, _ = fl.req("POST", "/index/i/query", q.encode())
                out.append((st, resp, None))
            digests = {fl.digest(i)["digest"] for i in range(3)}
            assert len(digests) == 1
            status = json.loads(_mask(fl.req("GET", "/replica/status")[1]))
            for g in status["groups"]:
                g.pop("routed")  # which group a read drew after the probes
        finally:
            spec.uninstall_collector()
            fl.close()
    return out, trace, digests.pop(), status


def test_port_router_answers_like_reference_router():
    """The port router over port groups and the JAX package's router over
    its own groups, driven by the same script: equal HTTP statuses and
    bodies (hosts masked), the same serving group for each sequential
    request, equal spec event sequences (src ids normalized) over the
    sequential part, equal digests and equal /replica/status payloads
    once a killed group has been replayed."""
    ours = _both_router_script("pilosa_tpu_torch", ["numpy", "numpy", "torch:cpu"])
    ref = _both_router_script("pilosa_tpu", ["numpy", "numpy", "numpy"])
    assert ours[0] == ref[0]
    assert len(ours[1]) > 30 and ours[1] == ref[1]
    assert ours[2] == ref[2]
    assert ours[3] == ref[3]


def test_cli_replica_router_process_over_torch_groups(tmp_path):
    """``python -m pilosa_tpu_torch.cli replica-router`` as a user starts
    it, in a process of its own with a durable WAL, over two torch:cpu
    groups: a write fans to both, reads route, the WAL holds the write,
    and SIGINT stops the process."""
    import signal
    import subprocess
    import sys

    from pilosa_tpu_torch.server.server import Server

    servers = []
    for i in range(2):
        srv = Server(Config(data_dir=str(tmp_path / f"g{i}"), host="127.0.0.1:0",
                            engine="torch:cpu", qcache_enabled=False, replica_group=f"g{i}@1"))
        srv.open()
        servers.append(srv)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "replica-router", "--port", str(port),
         "--wal-dir", str(tmp_path / "wal"), "--probe-interval", "0.2",
         "--groups", ",".join(f"g{i}={s.host}" for i, s in enumerate(servers))],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(base + "/replica/status", timeout=5) as r:
                    status = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, "router never served"
                time.sleep(0.1)
        assert status["quorate"] and [g["name"] for g in status["groups"]] == ["g0", "g1"]
        for path, body in (("/index/i", b"{}"), ("/index/i/frame/f", b"{}"),
                           ("/index/i/query", b'SetBit(rowID=1, frame="f", columnID=3)')):
            st, _b = _post(base + path, body)
            assert st == 200
        groups = set()
        for _ in range(2):
            rq = urllib.request.Request(base + "/index/i/query", method="POST",
                                        data=b'Count(Bitmap(rowID=1, frame="f"))')
            with urllib.request.urlopen(rq, timeout=30) as r:
                assert json.loads(r.read())["results"] == [1]
                groups.add(r.headers.get(GROUP_HEADER))
        assert groups == {"g0@1", "g1@1"}
        assert json.loads(_get(base + "/replica/status")[1])["wal"]["lastSeq"] == 3
        assert sum(f.stat().st_size for f in (tmp_path / "wal").iterdir()) > 0
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        out = proc.communicate(timeout=60)[0]
        for s in servers:
            s.close()
    assert proc.returncode == 0, out
    assert "replica-router on http://" in out and "shutting down" in out
