"""The per-layer metrics that read the port's own spans, on the port's
CPU engine at a tiny size: each is reported (or left out where it
cannot be read), and the spans partition every traced request."""

import types

import pytest

from benchport_tiny import make_root, run_cell


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """(the traced run's line, its ``ctx``, the harness's readers)."""
    from benchport import harness

    seen = {}
    reader = harness.Bench.reader

    def capture(self, name):
        fn = reader(self, name)

        def read(ctx):
            seen["ctx"] = ctx
            return fn(ctx)

        seen.setdefault("bench", self)
        return read

    monkeypatch.setattr(harness.Bench, "reader", capture)
    rc, line, _ = run_cell(make_root(tmp_path), "star-team", trace=1)
    assert rc == 0 and line["correct"] is True
    return line, seen["ctx"], lambda name: reader(seen["bench"], name)


def test_span_metrics_are_reported(traced):
    line, _, _ = traced
    got = line["metrics"]
    assert got["executor_ms_per_req"]["value"] > 0
    assert got["read_ratio"]["value"] >= 1
    assert got["gc_ms_per_req"]["value"] >= 0
    # No launch is timed on a device here: the metric is left out.
    assert "launch_gap_ms_per_req" not in got


def _device_ms(span) -> float:
    return sum(c["ms"] if c["name"] == "device" else _device_ms(c)
               for c in span.get("children", []))


def test_spans_partition_each_request(traced):
    _, ctx, reader = traced
    door, executor = reader("door_ms_per_req"), reader("executor_ms_per_req")
    assert ctx.port_spans
    for t in ctx.port_spans:
        one = types.SimpleNamespace(port_spans=[t])
        root = t["spans"]
        assert {"flat", "fused", "qcache.lookup"} <= {c["name"] for c in root["children"]}
        total = door(one) + executor(one) + _device_ms(root)
        assert abs(total - root["ms"]) <= 0.5, (total, root["ms"])
