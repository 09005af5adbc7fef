"""The port's partitioned replica groups: tests/test_replica_shard.py
through pilosa_tpu_torch.

A shard map cuts the slice space into contiguous ranges, each with its
own replica set, WAL and sequencer; reads fan to the shards their cover
touches and merge like the executor's cluster fan-out, writes route to
their owner only, and a live reshard moves slices with no failed write.
The file runs under the port's lock checker and its replica-protocol
trace check.
"""

import json
import os
import random
import tempfile
import threading
import time
import urllib.error
import urllib.request

import pytest

from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.pilosa import SLICE_WIDTH
from pilosa_tpu_torch.replica import GROUP_HEADER, ReplicaRouter
from pilosa_tpu_torch.replica.shards import (
    DEFAULT_SHARD_SPAN,
    Shard,
    ShardMap,
    ShardMapError,
    parse_shard_map,
    single_shard_map,
    uniform_shard_map,
)
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
        yield
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

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # container without hypothesis: seeded-random loops
    HAVE_HYPOTHESIS = False


# -- shard-map construction & validation -------------------------------------


def test_single_shard_map_is_the_degenerate_default():
    m = single_shard_map(["g0=h:1", "g1=h:2"])
    assert len(m) == 1
    s = m.shards[0]
    assert (s.name, s.lo, s.hi) == ("s0", 0, None)
    assert s.owns(0) and s.owns(10**9)
    assert m.shard_of(0) is s and m.shard_of(5_000_000) is s


def test_uniform_shard_map_shapes():
    m = uniform_shard_map(["a=h:1", "b=h:2", "c=h:3", "d=h:4"], 2, span=100)
    assert [(s.name, s.lo, s.hi) for s in m] == [("s0", 0, 100), ("s1", 100, None)]
    assert m.shards[0].group_specs == ["a=h:1", "b=h:2"]
    assert m.shards[1].group_specs == ["c=h:3", "d=h:4"]
    assert uniform_shard_map(["a=h:1"], 1).shards[0].hi is None
    assert DEFAULT_SHARD_SPAN == 256


def test_uniform_shard_map_rejects_uneven_split():
    with pytest.raises(ShardMapError, match="evenly"):
        uniform_shard_map(["a=h:1", "b=h:2", "c=h:3"], 2)
    with pytest.raises(ShardMapError):
        uniform_shard_map([], 1)
    with pytest.raises(ShardMapError):
        uniform_shard_map(["a=h:1"], 0)
    with pytest.raises(ShardMapError):
        uniform_shard_map(["a=h:1"], 1, span=0)


def test_parse_shard_map_explicit():
    m = parse_shard_map("s0=0-4:g0=h:1,g1=h:2; s1=4-:g2=h:3")
    assert [(s.name, s.lo, s.hi) for s in m] == [("s0", 0, 4), ("s1", 4, None)]
    assert m.shards[0].group_specs == ["g0=h:1", "g1=h:2"]
    assert m.shard_of(3).name == "s0" and m.shard_of(4).name == "s1"
    # Names default positionally when omitted.
    m2 = parse_shard_map("0-2:g0=h:1;2-:g1=h:2")
    assert [s.name for s in m2] == ["s0", "s1"]


@pytest.mark.parametrize("spec,msg", [
    ("s0=1-:g0=h:1", "start at slice 0"),                  # not at 0
    ("s0=0-4:g0=h:1;s1=5-:g1=h:2", "gap"),                 # hole at 4
    ("s0=0-4:g0=h:1;s1=3-:g1=h:2", "overlap"),             # 3 covered twice
    ("s0=0-4:g0=h:1;s1=4-8:g1=h:2", "open-ended"),         # no tail
    ("s0=0-:g0=h:1;s1=4-:g1=h:2", "not last"),             # open-ended mid
    ("s0=0-4:;s1=4-:g1=h:2", "no groups"),                 # empty replica set
    ("s0=0-4:g0=h:1;s0=4-:g1=h:2", "duplicate shard"),     # shard name reuse
    ("s0=0-4:gX=h:1;s1=4-:gX=h:2", "duplicate group"),     # group name reuse
    ("s0=04:g0=h:1", "lo-hi"),                             # no dash
    ("s0=a-b:g0=h:1", "bad range"),                        # non-int bounds
    ("", "at least one shard"),                            # empty map
])
def test_shard_map_validation_errors(spec, msg):
    with pytest.raises(ShardMapError, match=msg):
        parse_shard_map(spec)


def test_shard_of_rejects_negative_slice():
    m = single_shard_map(["g0=h:1"])
    with pytest.raises(ShardMapError):
        m.shard_of(-1)


# -- the cover contract (property tests) -------------------------------------


def _random_map(rng: random.Random) -> ShardMap:
    """A random valid map: 1..6 contiguous ranges, last open-ended."""
    n = rng.randint(1, 6)
    bounds = sorted(rng.sample(range(1, 500), n - 1)) if n > 1 else []
    los = [0] + bounds
    his = bounds + [None]
    return ShardMap([
        Shard(f"s{i}", lo, hi, [f"g{i}=h:{i + 1}"])
        for i, (lo, hi) in enumerate(zip(los, his))
    ])


def _check_cover_contract(m: ShardMap, slices: list):
    cover = m.cover(slices)
    # EXACT: the union over shards is exactly the requested set.
    union = [s for part in cover.values() for s in part]
    assert sorted(union) == sorted(set(slices))
    # MINIMAL: each slice appears exactly once, under its one owner, and
    # every listed shard owns at least one requested slice.
    assert len(union) == len(set(union))
    by_name = {s.name: s for s in m}
    for name, part in cover.items():
        assert part, f"shard {name} listed with no slices"
        for s in part:
            assert by_name[name].owns(s)
            assert m.shard_of(s).name == name  # shard_of agreement
    # K-shard cost: the fan-out breadth is the number of distinct owners.
    assert len(cover) == len({m.shard_of(s).name for s in set(slices)})


if HAVE_HYPOTHESIS:

    @settings(max_examples=200, deadline=None)
    @given(
        seed=st.integers(0, 2**32 - 1),
        slices=st.lists(st.integers(0, 600), max_size=64),
    )
    def test_cover_is_exact_and_minimal(seed, slices):
        _check_cover_contract(_random_map(random.Random(seed)), slices)

else:

    def test_cover_is_exact_and_minimal():
        rng = random.Random(0xC0FFEE)
        for _ in range(300):
            m = _random_map(rng)
            slices = [rng.randrange(600) for _ in range(rng.randint(0, 64))]
            _check_cover_contract(m, slices)
        _check_cover_contract(_random_map(rng), [])


def test_cover_agrees_with_cluster_placement_contract():
    """The router's cover and the executor's ``slices_by_node`` obey the
    SAME partition contract — each requested slice lands on exactly one
    owner and the union is exactly the request — so a query fanned by
    either layer scans every slice once."""
    from pilosa_tpu_torch.cluster import Cluster, Node

    cluster = Cluster(nodes=[Node(f"h{i}:1") for i in range(3)])
    m = parse_shard_map("s0=0-7:g0=h:1;s1=7-40:g1=h:2;s2=40-:g2=h:3")
    rng = random.Random(7)
    for _ in range(50):
        slices = sorted({rng.randrange(120) for _ in range(rng.randint(1, 40))})
        shard_parts = [tuple(v) for v in m.cover(slices).values()]
        node_parts = [
            tuple(v) for v in cluster.slices_by_node("i", slices).values()
        ]
        for parts in (shard_parts, node_parts):
            flat = sorted(s for p in parts for s in p)
            assert flat == slices, parts


# -- config / CLI plumbing ----------------------------------------------------


def test_config_shard_keys(tmp_path):
    toml = tmp_path / "c.toml"
    toml.write_text(
        "[replica]\n"
        "shards = 2\n"
        'shard-map = "s0=0-4:g0=h:1;s1=4-:g1=h:2"\n'
        "shard-span = 64\n"
    )
    cfg = Config.from_toml(str(toml))
    assert cfg.replica_shards == 2
    assert cfg.replica_shard_map.startswith("s0=0-4")
    assert cfg.replica_shard_span == 64
    cfg.apply_env({
        "PILOSA_TPU_REPLICA_SHARDS": "4",
        "PILOSA_TPU_REPLICA_SHARD_MAP": "s0=0-:g0=h:1",
        "PILOSA_TPU_REPLICA_SHARD_SPAN": "128",
    })
    assert cfg.replica_shards == 4
    assert cfg.replica_shard_map == "s0=0-:g0=h:1"
    assert cfg.replica_shard_span == 128
    d = Config()
    assert d.replica_shards == 1
    assert d.replica_shard_map == ""
    assert d.replica_shard_span == DEFAULT_SHARD_SPAN


def test_router_from_config_builds_shard_axis():
    from pilosa_tpu_torch.replica import router_from_config

    # shards = N auto-splits the flat group list.
    cfg = Config(replica_groups=["a=127.0.0.1:1", "b=127.0.0.1:2"])
    cfg.replica_shards = 2
    cfg.replica_shard_span = 8
    r = router_from_config(cfg)
    assert [(sh.name, sh.lo, sh.hi) for sh in r.shards] == [
        ("s0", 0, 8), ("s1", 8, None)
    ]
    assert [g.name for g in r.groups] == ["a", "b"]
    r.close()
    # An explicit shard-map wins over shards=N.
    cfg2 = Config()
    cfg2.replica_shards = 9  # would be invalid — must be ignored
    cfg2.replica_shard_map = "s0=0-4:x=127.0.0.1:1;rest=4-:y=127.0.0.1:2"
    r2 = router_from_config(cfg2)
    assert [sh.name for sh in r2.shards] == ["s0", "rest"]
    r2.close()
    # Default stays the single-sequencer router.
    cfg3 = Config(replica_groups=["127.0.0.1:1"])
    r3 = router_from_config(cfg3)
    assert len(r3.shards) == 1 and r3.shards[0].hi is None
    r3.close()


def test_cli_shard_flags_validate(capsys):
    from pilosa_tpu_torch.cli.main import build_parser

    p = build_parser()
    # A malformed --shard-map refuses before binding anything.
    args = p.parse_args([
        "replica-router", "--port", "0", "--test-exit",
        "--shard-map", "s0=0-4:g0=127.0.0.1:1;s1=9-:g1=127.0.0.1:2",
    ])
    assert args.fn(args) == 1
    assert "bad --shard-map" in capsys.readouterr().err
    # An uneven --shards split refuses too.
    args = p.parse_args([
        "replica-router", "--port", "0", "--test-exit",
        "--groups", "a=127.0.0.1:1,b=127.0.0.1:2,c=127.0.0.1:3",
        "--shards", "2",
    ])
    assert args.fn(args) == 1
    assert "bad --shards split" in capsys.readouterr().err


def test_cli_shard_map_supplies_groups(capsys):
    from pilosa_tpu_torch.cli.main import build_parser

    p = build_parser()
    args = p.parse_args([
        "replica-router", "--port", "0", "--test-exit",
        "--shard-map", "s0=0-4:g0=127.0.0.1:1;s1=4-:g1=127.0.0.1:2",
    ])
    assert args.fn(args) == 0
    out = capsys.readouterr().out
    assert "2 shards" in out and "g0=" in out and "g1=" in out


# -- the 2-shard e2e rig ------------------------------------------------------


class _ShardRig:
    """N in-process group servers behind a sharded router: server i is
    the lone replica of shard i (quorum 1 per shard) unless ``spare``
    holds some back for reshard targets."""

    def __init__(self, tmp, boundaries=(4,), n_servers=2, spare=0,
                 shard_map=None, engine="numpy", **router_kw):
        from pilosa_tpu_torch.server.server import Server

        self.servers = []
        for i in range(n_servers):
            cfg = Config(
                data_dir=f"{tmp}/g{i}", host="127.0.0.1:0", engine=engine,
                stats="expvar", qcache_enabled=False, replica_group=f"g{i}",
            )
            srv = Server(cfg)
            srv.open()
            self.servers.append(srv)
        routed = self.servers[:len(self.servers) - spare]
        if shard_map is None:
            los = [0] + list(boundaries)
            his = list(boundaries) + [None]
            assert len(los) == len(routed)
            shard_map = ShardMap([
                Shard(f"s{i}", lo, hi, [f"g{i}={srv.host}"])
                for i, (lo, hi, srv) in enumerate(zip(los, his, routed))
            ])
        self.stats = ExpvarStatsClient()
        self.router = ReplicaRouter(
            shard_map=shard_map, probe_interval_s=0.1, stats=self.stats,
            **router_kw,
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

    def query(self, q, qs="", headers=None):
        return self.req("POST", f"/index/i/query{qs}", q.encode(), headers)

    def direct_count(self, i, row=1):
        rq = urllib.request.Request(
            f"http://{self.servers[i].host}/index/i/query",
            data=f'Count(Bitmap(rowID={row}, frame="f"))'.encode(),
            method="POST",
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
def rig2(request):
    with tempfile.TemporaryDirectory() as tmp:
        r = _ShardRig(tmp, engine=getattr(request, "param", "numpy"))
        try:
            yield r
        finally:
            r.close()


def _col(slice_i: int, off: int = 0) -> int:
    return slice_i * SLICE_WIDTH + off


@pytest.mark.parametrize("rig2", ["numpy", "torch:cpu"], indirect=True)
def test_two_shard_write_routing_and_merged_reads(rig2):
    """Schema fans everywhere; a data write lands ONLY on its slice's
    owning shard; an unscoped read fans to every shard and sums."""
    rig2.seed()
    for i in range(2):  # schema reached both shards' groups
        rq = urllib.request.Request(f"http://{rig2.servers[i].host}/schema")
        schema = json.loads(urllib.request.urlopen(rq, timeout=10).read())
        assert [x["name"] for x in schema["indexes"]] == ["i"]
    # Three bits in shard s0's range, two in s1's.
    for c in (0, 1, _col(2)):
        st, body, hdrs = rig2.query(f'SetBit(rowID=1, frame="f", columnID={c})')
        assert st == 200 and json.loads(body)["results"] == [True]
        assert hdrs.get(GROUP_HEADER) == "all"
    for c in (_col(4), _col(5)):
        assert rig2.query(f'SetBit(rowID=1, frame="f", columnID={c})')[0] == 200
    assert rig2.direct_count(0) == 3  # g0 holds only s0's slices
    assert rig2.direct_count(1) == 2  # g1 holds only s1's
    st, body, hdrs = rig2.query('Count(Bitmap(rowID=1, frame="f"))')
    assert st == 200 and json.loads(body)["results"] == [5]
    assert hdrs.get(GROUP_HEADER) == "all"
    snap = rig2.stats.snapshot()
    assert snap["replica.shard.writes.s0"] == 3 + 2  # 3 data + 2 schema
    assert snap["replica.shard.writes.s1"] == 2 + 2
    assert snap["replica.shard.read_fanout"] >= 1
    assert snap["replica.shard.count"] == 2


def test_k_shard_read_costs_exactly_k_forwards(rig2):
    """A ``slices=``-scoped query touching K shards forwards to exactly
    K groups — the router analog of the executor's per-node fan-out."""
    rig2.seed()
    assert rig2.query(f'SetBit(rowID=1, frame="f", columnID={_col(0)})')[0] == 200
    assert rig2.query(f'SetBit(rowID=1, frame="f", columnID={_col(4)})')[0] == 200

    def routed():
        snap = rig2.stats.snapshot()
        return (snap.get("replica.routed.g0", 0), snap.get("replica.routed.g1", 0))

    q = 'Count(Bitmap(rowID=1, frame="f"))'
    before = routed()
    st, body, _ = rig2.query(q, qs="?slices=0,1")  # K=1: only s0
    assert st == 200 and json.loads(body)["results"] == [1]
    after = routed()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    before = after
    st, body, _ = rig2.query(q, qs="?slices=4,9")  # K=1: only s1
    assert st == 200 and json.loads(body)["results"] == [1]
    after = routed()
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    before = after
    st, body, _ = rig2.query(q, qs="?slices=0,4")  # K=2: both
    assert st == 200 and json.loads(body)["results"] == [2]
    after = routed()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)


def test_split_write_body_reassembles_results(rig2):
    """One PQL body spanning both shards splits into per-shard
    sub-batches; results come back in the ORIGINAL call order."""
    rig2.seed()
    st, body, hdrs = rig2.query(
        f'SetBit(rowID=1, frame="f", columnID={_col(4)}) '
        f'SetBit(rowID=1, frame="f", columnID=0) '
        f'SetBit(rowID=1, frame="f", columnID={_col(4)})'  # dup: False
    )
    assert st == 200
    assert json.loads(body)["results"] == [True, True, False]
    assert hdrs.get(GROUP_HEADER) == "all"
    assert rig2.direct_count(0) == 1 and rig2.direct_count(1) == 1
    snap = rig2.stats.snapshot()
    assert snap["replica.shard.split_writes"] == 1


def test_multi_shard_unroutable_bodies_answer_501(rig2):
    rig2.seed()
    # A read mixed into a write body.
    st, body, _ = rig2.query(
        f'SetBit(rowID=1, frame="f", columnID=0) Count(Bitmap(rowID=1, frame="f"))'
    )
    assert st == 501 and "mixes reads" in json.loads(body)["error"]
    # Broadcast (SetRowAttrs) mixed with column-routed writes.
    st, body, _ = rig2.query(
        f'SetBit(rowID=1, frame="f", columnID=0) '
        f'SetRowAttrs(rowID=1, frame="f", x="y")'
    )
    assert st == 501 and "broadcast" in json.loads(body)["error"]
    # Streaming ingest cannot be slice-routed across shards.
    st, body, _ = rig2.req(
        "POST", "/index/i/frame/f/ingest?off=0&total=1&crc=0", b"x"
    )
    assert st == 501
    snap = rig2.stats.snapshot()
    assert snap["replica.shard.unroutable"] >= 3


@pytest.mark.parametrize("rig2", ["numpy", "torch:cpu"], indirect=True)
def test_read_your_writes_across_shards(rig2):
    """A write acked by its owning shard is visible on the immediate
    next read, scoped or fanned."""
    rig2.seed()
    total = 0
    for step in range(1, 5):
        for sl in (0, 4):
            c = _col(sl, step)
            assert rig2.query(f'SetBit(rowID=1, frame="f", columnID={c})')[0] == 200
            total += 1
            st, body, _ = rig2.query('Count(Bitmap(rowID=1, frame="f"))')
            assert st == 200 and json.loads(body)["results"] == [total]


def test_status_and_fleet_carry_shard_map(rig2):
    rig2.seed()
    assert rig2.query(f'SetBit(rowID=1, frame="f", columnID={_col(4)})')[0] == 200
    st, body, _ = rig2.req("GET", "/replica/status")
    assert st == 200
    status = json.loads(body)
    assert status["mapEpoch"] == 0
    assert [s["name"] for s in status["shards"]] == ["s0", "s1"]
    assert status["shards"][1]["slices"] == {"lo": 4, "hi": None}
    by_name = {g["name"]: g for g in status["groups"]}
    assert by_name["g0"]["shard"] == "s0" and by_name["g1"]["shard"] == "s1"
    # Lag is measured against the group's OWN shard's head: g0 never saw
    # s1's writes and owes nothing.
    assert by_name["g0"]["lag"] == 0 and by_name["g1"]["lag"] == 0
    st, body, _ = rig2.req("GET", "/debug/fleet")
    assert st == 200
    fleet = json.loads(body)
    router_side = fleet["router"] if "router" in fleet else fleet
    assert router_side["mapEpoch"] == 0
    assert [s["name"] for s in router_side["shards"]] == ["s0", "s1"]


# -- live resharding ----------------------------------------------------------


@pytest.fixture
def reshard_rig():
    """One open-ended shard on g0 plus a SPARE server (g1) standing by
    as the split target."""
    with tempfile.TemporaryDirectory() as tmp:
        r = _ShardRig(tmp, boundaries=(), n_servers=2, spare=1)
        try:
            yield r
        finally:
            r.close()


def test_reshard_validation_refuses_bad_requests(reshard_rig):
    rig = reshard_rig
    rig.seed()
    spare = f"g1={rig.servers[1].host}"

    def reshard(body):
        return rig.req("POST", "/replica/reshard", json.dumps(body).encode())

    st, body, _ = reshard({"shard": "nope", "at": 4, "groups": [spare]})
    assert st == 400 and "no runtime" in json.loads(body)["error"]
    st, body, _ = reshard({"shard": "s0", "at": 0, "groups": [spare]})
    assert st == 400 and "split point" in json.loads(body)["error"]
    st, body, _ = reshard({"shard": "s0", "at": 4, "groups": []})
    assert st == 400
    st, body, _ = reshard({  # bare spec: positional names would collide
        "shard": "s0", "at": 4, "groups": [rig.servers[1].host],
    })
    assert st == 400 and "name=host:port" in json.loads(body)["error"]
    st, body, _ = reshard({  # name collision with the live group
        "shard": "s0", "at": 4, "groups": [f"g0={rig.servers[1].host}"],
    })
    assert st == 400 and "duplicate group" in json.loads(body)["error"]
    st, body, _ = reshard({  # unreachable new group: refused, not erred
        "shard": "s0", "at": 4, "name": "s1", "groups": ["g1=127.0.0.1:1"],
    })
    assert st == 409 and "reshard refused" in json.loads(body)["error"]
    st, body, _ = rig.req("POST", "/replica/reshard", b"not json")
    assert st == 400
    assert rig.stats.snapshot()["replica.reshard.refused"] >= 6
    # Nothing changed ownership.
    assert json.loads(rig.req("GET", "/replica/status")[1])["mapEpoch"] == 0


def test_live_reshard_zero_failed_writes(reshard_rig):
    """Split the open-ended shard at slice 4 while a writer hammers the
    router: every write acks 200 (some briefly held at the fence), the
    map epoch bumps, the moved range serves from the new group only,
    and the old group no longer holds (or double-counts) moved bits."""
    rig = reshard_rig
    rig.seed()
    # Pre-load both halves of the future split.
    for sl in (0, 1, 4, 5, 6):
        assert rig.query(
            f'SetBit(rowID=1, frame="f", columnID={_col(sl)})'
        )[0] == 200
    assert rig.direct_count(0) == 5  # all on g0 pre-split

    failures, acks = [], [0]
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            i += 1
            sl = 4 + (i % 3)  # keep the MOVED range hot during the copy
            st, body, _ = rig.query(
                f'SetBit(rowID=2, frame="f", columnID={_col(sl, i)})',
                headers={}, )
            if st != 200:
                failures.append((st, body[:200]))
            else:
                acks[0] += 1
            time.sleep(0.002)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    time.sleep(0.05)  # writer in flight before the fence
    st, body, _ = rig.req(
        "POST", "/replica/reshard",
        json.dumps({
            "shard": "s0", "at": 4, "name": "s1",
            "groups": [f"g1={rig.servers[1].host}"],
        }).encode(),
        timeout=60,
    )
    assert st == 200, body
    flip = json.loads(body)
    assert flip["mapEpoch"] == 1
    assert [s["name"] for s in flip["shards"]] == ["s0", "s1"]
    assert flip["moved"]["fragments"] >= 1 and flip["clearErrors"] == []
    time.sleep(0.1)  # a few post-flip writes land through the new map
    stop.set()
    t.join(timeout=10)
    assert not failures, f"writes failed during live reshard: {failures[:5]}"
    assert acks[0] > 0

    # ZERO LOST WRITES: every acked row-2 bit is readable post-flip.
    st, body, _ = rig.query('Count(Bitmap(rowID=2, frame="f"))')
    assert st == 200 and json.loads(body)["results"] == [acks[0]]
    # Row 1: 2 bits stayed on s0/g0, 3 moved to s1/g1 — the fan-out sum
    # is exact (no double count: the moved range was cleared off g0).
    st, body, _ = rig.query('Count(Bitmap(rowID=1, frame="f"))')
    assert st == 200 and json.loads(body)["results"] == [5]
    assert rig.direct_count(0) == 2
    assert rig.direct_count(1) == 3
    # DIGEST CONVERGENCE: the two groups now hold disjoint halves whose
    # union is the full slice set; post-flip writes routed to g1 only.
    st, body, _ = rig.query('Count(Bitmap(rowID=2, frame="f"))', qs="?slices=4,5,6")
    assert st == 200 and json.loads(body)["results"] == [acks[0]]
    status = json.loads(rig.req("GET", "/replica/status")[1])
    assert status["mapEpoch"] == 1
    assert {g["name"]: g["shard"] for g in status["groups"]} == {
        "g0": "s0", "g1": "s1"
    }
    snap = rig.stats.snapshot()
    assert snap["replica.reshard.rounds"] == 1
    assert snap["replica.shard.count"] == 2
    assert snap["replica.reshard.moved_fragments"] >= 1
    assert snap["replica.reshard.moved_bytes"] >= 1


def test_reshard_same_server_pairing_skips_clear(reshard_rig):
    """A dev-rig split where the 'new group' is the same server skips
    the moved-range clear (one holder backs both groups) and still
    flips ownership."""
    rig = reshard_rig
    rig.seed()
    for sl in (0, 4):
        assert rig.query(
            f'SetBit(rowID=1, frame="f", columnID={_col(sl)})'
        )[0] == 200
    st, body, _ = rig.req(
        "POST", "/replica/reshard",
        json.dumps({
            "shard": "s0", "at": 4, "name": "s1",
            "groups": [f"gx={rig.servers[0].host}"],  # SAME server
        }).encode(),
        timeout=60,
    )
    assert st == 200, body
    assert rig.stats.snapshot().get("replica.reshard.clear_skipped", 0) >= 1
    # The shared holder keeps every slice, so SCOPED reads stay exact;
    # an unscoped fan-out over a same-server pairing double-counts the
    # shared fragments — the documented dev-rig caveat (DEVELOPMENT.md).
    st, body, _ = rig.query('Count(Bitmap(rowID=1, frame="f"))', qs="?slices=0")
    assert st == 200 and json.loads(body)["results"] == [1]
    st, body, _ = rig.query('Count(Bitmap(rowID=1, frame="f"))', qs="?slices=4")
    assert st == 200 and json.loads(body)["results"] == [1]


# -- held against the JAX package (exact) -------------------------------------


def _map_outcome(build):
    """A shard map's JSON (and shard_of over a band of slices) or its
    error: the value two packages' builders are compared by."""
    try:
        m = build()
    except ValueError as e:
        return ("error", type(e).__name__, str(e))
    return ("map", m.to_json(), [m.shard_of(s).name for s in range(0, 700, 7)])


_SHARD_SPECS = [
    "s0=0-4:g0=h:1,g1=h:2; s1=4-:g2=h:3",
    "0-2:g0=h:1;2-:g1=h:2",
    "a=0-32:g0=h:1;b=32-:g1=h:2",
    "s0=0-7:g0=h:1;s1=7-40:g1=h:2;s2=40-:g2=h:3",
    "s0=0-4:g0=h:1;s1=4-9:g1=h:2,h:5;s2=9-:g2=h:3,g3=h:4",
] + [
    "s0=1-:g0=h:1", "s0=0-4:g0=h:1;s1=5-:g1=h:2", "s0=0-4:g0=h:1;s1=3-:g1=h:2",
    "s0=0-4:g0=h:1;s1=4-8:g1=h:2", "s0=0-:g0=h:1;s1=4-:g1=h:2",
    "s0=0-4:;s1=4-:g1=h:2", "s0=0-4:g0=h:1;s0=4-:g1=h:2",
    "s0=0-4:gX=h:1;s1=4-:gX=h:2", "s0=04:g0=h:1", "s0=a-b:g0=h:1", "",
]


@pytest.mark.parametrize("spec_str", _SHARD_SPECS)
def test_parse_shard_map_matches_reference(spec_str):
    from pilosa_tpu.replica import shards as ref

    ours = _map_outcome(lambda: parse_shard_map(spec_str))
    assert ours == _map_outcome(lambda: ref.parse_shard_map(spec_str))


@pytest.mark.parametrize("groups,n,span", [
    (["a=h:1", "b=h:2", "c=h:3", "d=h:4"], 2, 100),
    (["a=h:1", "b=h:2", "c=h:3", "d=h:4"], 4, 1),
    (["a=h:1"], 1, 256),
    (["h:1", "h:2", "h:3", "h:4", "h:5", "h:6"], 3, 64),
    (["a=h:1", "b=h:2", "c=h:3"], 2, 256),
    ([], 1, 256),
    (["a=h:1"], 0, 256),
    (["a=h:1"], 1, 0),
])
def test_uniform_shard_map_matches_reference(groups, n, span):
    from pilosa_tpu.replica import shards as ref

    ours = _map_outcome(lambda: uniform_shard_map(groups, n, span=span))
    assert ours == _map_outcome(lambda: ref.uniform_shard_map(groups, n, span=span))


def test_covers_match_reference():
    """Seeded random maps and slice lists: the port's cover is the JAX
    package's, shard for shard and slice for slice."""
    from pilosa_tpu.replica import shards as ref

    rng = random.Random(0x5EED)
    for _ in range(200):
        n = rng.randint(1, 6)
        bounds = sorted(rng.sample(range(1, 500), n - 1)) if n > 1 else []
        spec_str = ";".join(
            f"s{i}={lo}-{'' if hi is None else hi}:g{i}=h:{i + 1}"
            for i, (lo, hi) in enumerate(zip([0] + bounds, bounds + [None]))
        )
        slices = [rng.randrange(600) for _ in range(rng.randint(0, 64))]
        ours = parse_shard_map(spec_str).cover(slices)
        theirs = ref.parse_shard_map(spec_str).cover(slices)
        assert list(ours.items()) == list(theirs.items()), spec_str


def _sharded_answers(pkg: str, tmp: str) -> list:
    """A two-shard map (slices 0-3 on g0, 4- on g1) of ``pkg``'s router
    over ``pkg``'s numpy groups: seeded SetBits through the router (each
    lands on its slice's owner), then merged reads, TopN among them.
    Returns each read's status and body."""
    import importlib

    import numpy as np

    config = importlib.import_module(f"{pkg}.config")
    replica = importlib.import_module(f"{pkg}.replica")
    shards = importlib.import_module(f"{pkg}.replica.shards")
    server = importlib.import_module(f"{pkg}.server.server")
    stats = importlib.import_module(f"{pkg}.stats")
    servers = []
    router = None
    try:
        for i in range(2):
            srv = server.Server(config.Config(
                data_dir=f"{tmp}/{pkg}/g{i}", host="127.0.0.1:0", engine="numpy",
                stats="expvar", qcache_enabled=False, replica_group=f"g{i}"))
            srv.open()
            servers.append(srv)
        router = replica.ReplicaRouter(
            shard_map=shards.ShardMap([
                shards.Shard("s0", 0, 4, [f"g0={servers[0].host}"]),
                shards.Shard("s1", 4, None, [f"g1={servers[1].host}"]),
            ]),
            probe_interval_s=0.1, stats=stats.ExpvarStatsClient(),
        ).serve()
        base = f"http://127.0.0.1:{router.port}"

        def post(path, body):
            rq = urllib.request.Request(base + path, data=body, method="POST")
            try:
                with urllib.request.urlopen(rq, timeout=30) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        assert post("/index/i", b"{}")[0] == 200
        assert post("/index/i/frame/f", b"{}")[0] == 200
        rng = np.random.default_rng(11)
        for _ in range(6):
            body = " ".join(
                f'SetBit(rowID={int(r)}, frame="f", columnID={int(c)})'
                for r, c in zip(rng.integers(0, 12, 64), rng.integers(0, 8 * SLICE_WIDTH, 64)))
            assert post("/index/i/query", body.encode())[0] == 200
        reads = [
            'TopN(frame="f", n=5)',
            'TopN(Bitmap(rowID=2, frame="f"), frame="f", n=4)',
            'TopN(frame="f", ids=[1, 3, 5, 7])',
            'Count(Union(Bitmap(rowID=1, frame="f"), Bitmap(rowID=9, frame="f")))',
        ]
        return [post("/index/i/query", q.encode()) for q in reads]
    finally:
        if router is not None:
            router.close()
        for s in servers:
            s.close()


def test_sharded_topn_merges_like_reference(tmp_path):
    """TopN (and a Count) across two shards: the port router's merge of
    its groups' answers equals the JAX package's router's over its own
    groups, status and body."""
    ours = _sharded_answers("pilosa_tpu_torch", str(tmp_path))
    ref = _sharded_answers("pilosa_tpu", str(tmp_path))
    assert all(st == 200 for st, _ in ours)
    assert json.loads(ours[0][1])["results"][0]  # a non-empty TopN
    assert ours == ref
