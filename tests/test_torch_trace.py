"""The port's request spans on the N-ary path, through its HTTP door on
the CPU engine: the stages from the door to each launch, one clock with
``time.perf_counter_ns``, collector pauses charged to the traced
request, nothing built for an untraced one, and the launch spans'
device time preferred by the cost ledger."""

import gc
import json
import time
import types
import urllib.request

import numpy as np
import pytest

from pilosa_tpu_torch import costs, trace
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.pilosa import SLICE_WIDTH
from pilosa_tpu_torch.server.server import Server

N_SLICES, N_ROWS = 2, 40


def _post(host, path, body=b"", headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body or None, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _nary_body(seed) -> bytes:
    """Eight Counts: Intersects of 3-4 rows and Unions of 8-16."""
    rng = np.random.default_rng(seed)
    calls = []
    for k in range(8):
        op, lo, hi = ("Union", 8, 16) if k % 2 else ("Intersect", 3, 4)
        rows = rng.choice(N_ROWS, size=int(rng.integers(lo, hi + 1)), replace=False)
        leaves = ", ".join(f'Bitmap(rowID={int(r)}, frame="f")' for r in rows)
        calls.append(f"Count({op}({leaves}))")
    return "\n".join(calls).encode()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    s = Server(Config(data_dir=str(tmp_path_factory.mktemp("d")), host="127.0.0.1:0",
                      engine="torch:cpu"))
    s.open()
    _post(s.host, "/index/i")
    _post(s.host, "/index/i/frame/f")
    rng = np.random.default_rng(7)
    sets = [f'SetBit(rowID={r}, frame="f", columnID={int(c)})'
            for r in range(N_ROWS) for c in rng.integers(0, N_SLICES * SLICE_WIDTH, size=30)]
    _post(s.host, "/index/i/query", "\n".join(sets).encode())
    yield s
    s.close()


def _traced(server, body):
    """(the request's recorded trace, perf_counter_ns before, after)."""
    n0 = len(server.tracer)
    t0 = time.perf_counter_ns()
    status, _ = _post(server.host, "/index/i/query", body, {trace.TRACE_HEADER: "1"})
    t1 = time.perf_counter_ns()
    assert status == 200 and len(server.tracer) == n0 + 1
    return server.tracer.traces_json(limit=1)[0], t0, t1


def _walk(span):
    yield span
    for c in span.get("children", []):
        yield from _walk(c)


def test_nary_request_spans_from_door_to_launches(server):
    t, before, after = _traced(server, _nary_body(1))
    root = t["spans"]
    assert before <= root["t0_ns"] <= after
    kids = {c["name"]: c for c in root["children"]}
    assert {"qcache.lookup", "flat", "parse", "fused", "qcache.commit"} <= set(kids)
    # The query cache's fingerprint is the real parse (a memo miss).
    (parse,) = [c for c in kids["qcache.lookup"]["children"] if c["name"] == "parse"]
    assert parse["tags"] == {"memo": "miss", "parser": "native"}
    assert kids["parse"]["tags"] == {"memo": "hit"}
    # Every compiled lane declined this shape; the last tried is Range's.
    assert kids["flat"]["tags"] == {"declined": "range"}
    fused = kids["fused"]
    names = [c["name"] for c in fused["children"]]
    assert names[:2] == ["fused.match", "fused.plan"] and set(names[2:]) == {"device"}
    # One launch folds the request's (op, K) groups of both ops: its
    # rows are the request's rows, read once.
    (d,) = [c for c in fused["children"] if c["name"] == "device"]
    tags = d["tags"]
    assert tags["lane"] == "gather" and tags["op"] == "mixed" and tags["groups"] >= 2
    assert tags["slices"] == N_SLICES and tags["k"] >= 8
    assert tags["bytes_read"] == tags["rows"] * N_SLICES * SLICE_WIDTH // 8
    assert "device_ms" not in tags  # no CUDA device: host time only
    assert tags["calls"] == fused["tags"]["calls"] == 8
    assert tags["bytes_read"] == fused["tags"]["need_bytes"] > 0
    # Children start inside their parent, on the root's clock.
    for sp in _walk(root):
        for c in sp.get("children", []):
            assert sp["start_ms"] <= c["start_ms"] <= sp["start_ms"] + sp["ms"] + 1e-3


def test_nary_groups_share_one_launch_beside_pair_and_tree(server):
    """N-ary Counts of both ops beside a pair Count and a nested tree
    Count, each kind over rows of its own, in an index of its own (so no
    Gram answers the pair): one launch folds every N-ary group (``op``
    mixed, ``groups`` its (op, K) groups), the pair and the tree keep a
    launch each, and the launches read the request's rows once."""
    _post(server.host, "/index/m")
    _post(server.host, "/index/m/frame/f")
    rng = np.random.default_rng(11)
    sets = [f'SetBit(rowID={r}, frame="f", columnID={int(c)})'
            for r in range(N_ROWS) for c in rng.integers(0, N_SLICES * SLICE_WIDTH, size=30)]
    _post(server.host, "/index/m/query", "\n".join(sets).encode())
    calls, keys = [], set()
    for k in range(12):
        op, lo, hi = ("Union", 8, 16) if k % 2 else ("Intersect", 3, 4)
        rows = rng.choice(30, size=int(rng.integers(lo, hi + 1)), replace=False)
        keys.add((op, len(rows)))
        calls.append(f"Count({op}({', '.join(f'Bitmap(rowID={int(r)}, frame=\"f\")' for r in rows)}))")
    calls.append('Count(Intersect(Bitmap(rowID=30, frame="f"), Bitmap(rowID=31, frame="f")))')
    calls.append('Count(Union(Intersect(Bitmap(rowID=32, frame="f"), Bitmap(rowID=33, frame="f")), '
                 'Difference(Bitmap(rowID=34, frame="f"), Bitmap(rowID=35, frame="f"))))')
    n0 = len(server.tracer)
    status, _ = _post(server.host, "/index/m/query", "\n".join(calls).encode(),
                      {trace.TRACE_HEADER: "1"})
    assert status == 200 and len(server.tracer) == n0 + 1
    root = server.tracer.traces_json(limit=1)[0]["spans"]
    (fused,) = [c for c in root["children"] if c["name"] == "fused"]
    devices = [c["tags"] for c in fused["children"] if c["name"] == "device"]
    by_op = {d["op"]: d for d in devices}
    assert len(devices) == 3 and set(by_op) == {"mixed", "and", "tree"}
    mixed = by_op["mixed"]
    assert mixed["groups"] == len(keys) and mixed["calls"] == 12
    assert mixed["k"] == max(k for _op, k in keys)
    assert by_op["and"]["groups"] == by_op["tree"]["groups"] == 1
    assert by_op["and"]["k"] == 2 and by_op["and"]["rows"] == 2 and by_op["tree"]["rows"] == 4
    assert sum(d["bytes_read"] for d in devices) == fused["tags"]["need_bytes"] > 0


def test_a_cached_answer_parses_nothing(server):
    body = _nary_body(2)
    _traced(server, body)
    t, _, _ = _traced(server, body)
    root = t["spans"]
    assert root["tags"]["qcache"] == "hit"
    kids = {c["name"]: c for c in root["children"]}
    assert set(kids) == {"qos.admit", "qcache.lookup"}
    assert "children" not in kids["qcache.lookup"]


def test_collector_pause_lands_on_the_traced_request(server, monkeypatch):
    hooks = list(gc.callbacks)
    fused = Executor._fused_local_counts

    def collect_then(self, *a, **k):
        gc.collect()
        return fused(self, *a, **k)

    monkeypatch.setattr(Executor, "_fused_local_counts", collect_then)
    t, _, _ = _traced(server, _nary_body(3))
    tags = t["spans"]["tags"]
    assert tags["gc_n"] >= 1 and tags["gc_full"] >= 1 and tags["gc_ms"] > 0
    assert gc.callbacks == hooks


def test_untraced_request_builds_no_span_and_adds_no_hook(server, monkeypatch):
    made = []
    init = trace.Span.__init__

    def counting(self, *a, **k):
        made.append(a)
        init(self, *a, **k)

    monkeypatch.setattr(trace.Span, "__init__", counting)
    hooks = list(gc.callbacks)
    seen = []

    def watch(phase, info):
        seen.append(list(gc.callbacks))

    gc.callbacks.append(watch)
    try:
        fused = Executor._fused_local_counts

        def collect_then(self, *a, **k):
            gc.collect()
            return fused(self, *a, **k)

        monkeypatch.setattr(Executor, "_fused_local_counts", collect_then)
        status, _ = _post(server.host, "/index/i/query", _nary_body(4))
    finally:
        gc.callbacks.remove(watch)
    assert status == 200
    assert made == []
    assert seen and all(cb == hooks + [watch] for cb in seen)
    assert gc.callbacks == hooks


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.at = None

    def record(self, stream):
        self.at = stream.t

    def query(self):
        return True

    def elapsed_time(self, end):
        return float(end.at - self.at)


class _Stream:
    cuda_stream = 0

    def __init__(self):
        self.t = 0

    def tick(self):
        self.t += 3
        return self.t


@pytest.mark.parametrize("traced", [True, False])
def test_launches_are_timed_between_events_only_when_traced(monkeypatch, traced):
    import torch

    from pilosa_tpu_torch.ops import kernels

    stream = _Stream()
    calls = []

    def entry(*args):
        calls.append(args)
        stream.tick()  # the kernel's own time: 3 a launch
        return 0

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(kernels, "_fn", lambda name: entry)
    monkeypatch.setitem(kernels.LAUNCHES, "gather_count_multi", 0)
    _Event.made = 0
    operand = types.SimpleNamespace(device="cuda:0")
    root = trace.Span("request") if traced else None
    meter = costs.DispatchMeter()
    with meter.measure("gather", root):
        kernels._launch("gather_count_multi", operand, 1, 2)
        kernels._launch("gather_count_multi", operand, 3, 4)
    # The stream is the entry point's last argument; each launch counts.
    assert calls == [(1, 2, 0), (3, 4, 0)]
    assert kernels.LAUNCHES["gather_count_multi"] == 2
    assert getattr(kernels.TIMED, "events", None) is None
    if not traced:
        assert _Event.made == 0
        return
    (dev,) = root.children
    assert _Event.made == 4 and dev.name == "device"
    # Each pair brackets its kernel alone: 3 + 3, not the host's time.
    assert dev.tags == {"lane": "gather", "device_ms": 6.0}
    assert dev.ms is not None


def test_a_dispatch_without_a_kernel_has_no_device_time():
    from pilosa_tpu_torch.ops import kernels

    root = trace.Span("request")
    with costs.DispatchMeter().measure("gather", root):
        pass  # a Gram answer: a host lookup, no launch
    (dev,) = root.children
    assert dev.tags == {"lane": "gather"}
    assert getattr(kernels.TIMED, "events", None) is None


def test_routed_request_that_raises_leaves_no_collector_hook(monkeypatch):
    from pilosa_tpu_torch import qos
    from pilosa_tpu_torch.replica.router import ReplicaRouter

    router = ReplicaRouter(["g0=127.0.0.1:1"], tracer=trace.Tracer(sample_rate=1.0))

    def fail(*a, **k):
        raise RuntimeError("route failed")

    monkeypatch.setattr(router, "_route_read", fail)
    hooks = list(gc.callbacks)
    with pytest.raises(RuntimeError, match="route failed"):
        router._handle_routed("POST", "/index/i/query", "/index/i/query",
                              b"Count(Bitmap(rowID=1))", {"x-pilosa-trace": "1"},
                              deadline=None, cls=qos.CLASS_READ)
    assert gc.callbacks == hooks


def test_a_request_that_raises_in_the_door_leaves_no_collector_hook(server, monkeypatch):
    from pilosa_tpu_torch.server.handler import Handler

    def fail(*a, **k):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(Handler, "_dispatch_qos", fail)
    hooks = list(gc.callbacks)
    handler = server.handler
    with pytest.raises(RuntimeError, match="dispatch failed"):
        handler.dispatch("POST", "/index/i/query", {}, b"", {"x-pilosa-trace": "1"})
    assert gc.callbacks == hooks


def test_cost_ledger_prefers_device_ms():
    ledger = costs.CostLedger()
    tr = trace.Trace("request")
    tr.root.tags.update(index="i", lane="fused")
    timed = tr.root.child("fused").child("device")
    timed.ms, timed.tags["device_ms"] = 5.0, 2.0
    host_only = tr.root.child("device")
    host_only.ms = 1.5
    tr.root.finish()
    ledger.fold(tr, 10.0)
    (entry,) = ledger.entries()
    assert entry["ewma_device_ms"] == pytest.approx(3.5)


def test_trace_json_keeps_offsets_and_adds_the_root_clock():
    tr = trace.Trace("request")
    child = tr.root.child("parse")
    child.finish()
    tr.root.finish()
    out = tr.to_json()
    root = out["spans"]
    assert root["t0_ns"] == tr.root.t0_ns and root["start_ms"] == 0.0
    (c,) = root["children"]
    assert c["start_ms"] == pytest.approx((child.t0_ns - tr.root.t0_ns) / 1e6, abs=1e-3)
    assert "t0_ns" not in c
    assert json.loads(json.dumps(out)) == out
    assert not hasattr(trace.Tracer(), "stat_sampled")
    assert not hasattr(trace.Tracer(), "stat_slow")


@pytest.mark.parametrize("cap", [None, 10])
def test_span_header_is_the_ring_entry_without_its_clock(monkeypatch, cap):
    if cap is not None:
        monkeypatch.setattr(trace, "_SPANS_HEADER_MAX", cap)
    tracer = trace.Tracer()
    tr = tracer.begin({"x-pilosa-trace": "1"}, name="request")
    tr.root.child("parse").finish()
    extra = tracer.finish_request(tr, name="request", dt_ms=1.0)
    (sent,) = json.loads(extra[trace.TRACE_SPANS_HEADER])
    (entry,) = tracer.traces_json(limit=1)
    want = {k: v for k, v in entry["spans"].items() if k != "t0_ns"}
    if cap is not None:  # too long: the root's timing alone
        del want["children"]
        want["truncated"] = True
    assert sent == want
    assert [c["name"] for c in entry["spans"]["children"]] == ["parse"]
