"""The yardstick: the generators' determinism, the reference against an
independent model, and the check failing the control and each fault the
cells can have."""

import json
import os

import numpy as np
import pytest
import torch

from benchport_tiny import make_root, run_cell

from benchport import datagen, reference, schema
from benchport.harness import Request, judge
from benchport.traffic_gen import Traffic


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def tiny(root, name):
    with open(os.path.join(root, "benchport", "configs", f"{name}.json")) as f:
        return json.load(f)


def mix_of(root, name):
    with open(os.path.join(root, "benchport", "traffic", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 3 * 2**32 + 1, -5])
def test_traffic_is_a_function_of_the_seed(tiny_root, seed):
    cfg, mix = tiny(tiny_root, "startrace-gh"), mix_of(tiny_root, "team-stars")
    a, b = Traffic(mix, cfg, seed), Traffic(mix, cfg, seed)
    for stream in ("window", "warm"):
        assert [a.request(stream, c, i) for c in range(2) for i in range(5)] == \
               [b.request(stream, c, i) for c in range(2) for i in range(5)]
    assert a.request("window", 0, 0) != Traffic(mix, cfg, seed + 1).request("window", 0, 0)
    assert a.request("window", 0, 0) != a.request("window", 1, 0)
    calls = a.request("window", 1, 3)
    assert len(calls) == mix["calls_per_request"]
    for call in calls:
        k = mix["operands"][call[0]]
        rs = [r for _, r in schema.leaves(call)]
        assert {f for f, _ in schema.leaves(call)} == {cfg["frame"]}
        assert len(set(rs)) == len(rs) and k["min"] <= len(rs) <= k["max"]
        assert all(0 <= r < cfg["rows"] for r in rs)
    assert {call[0] for call in calls} == set(mix["ops"])
    named = {leaf for req in a.cover() for call in req for leaf in schema.leaves(call)}
    assert named == {(cfg["frame"], r) for r in range(cfg["rows"])}


@pytest.mark.parametrize("name", ["startrace-gh"])
def test_data_is_a_function_of_the_seed(tiny_root, name):
    cfg = tiny(tiny_root, name)
    seed = 2**31 + 3

    def pairs(s, block):
        got = list(datagen.chunks(cfg, s, "cpu", block))
        assert {f for f, _, _ in got} == {cfg["frame"]}
        return torch.cat([r for _, r, _ in got]), torch.cat([c for _, _, c in got])

    r1, c1 = pairs(seed, 1)
    r2, c2 = pairs(seed, 2)
    k1 = torch.sort((r1 << 40) | c1).values
    k2 = torch.sort((r2 << 40) | c2).values
    assert torch.equal(k1, k2)  # the block size changes the order, not the pairs
    _, c3 = pairs(seed + 1, 2)
    assert not torch.equal(torch.sort(c1).values, torch.sort(c3).values)
    assert int(c1.max()) < cfg["slices"] << 20 and int(r1.max()) < cfg["rows"]


@pytest.mark.parametrize("name", ["startrace-gh"])
def test_reference_matches_sets_of_columns(tiny_root, name):
    """The reference's counts against Python sets built from the pairs."""
    cfg = tiny(tiny_root, name)
    seed = 41
    rows = torch.cat([r for _, r, _ in datagen.chunks(cfg, seed, "cpu", 2)]).numpy()
    cols = torch.cat([c for _, _, c in datagen.chunks(cfg, seed, "cpu", 2)]).numpy()
    sets = [set(cols[rows == r].tolist()) for r in range(cfg["rows"])]
    rng = np.random.default_rng(1)
    calls, want = [], []
    for _ in range(30):
        rs = rng.choice(cfg["rows"], size=int(rng.integers(2, 9)), replace=False).tolist()
        union = set().union(*(sets[r] for r in rs))
        inter = set.intersection(*(sets[r] for r in rs))
        diff = sets[rs[0]].difference(*(sets[r] for r in rs[1:]))
        leaves = tuple(("Bitmap", cfg["frame"], r) for r in rs)
        calls += [("Union",) + leaves, ("Intersect",) + leaves, ("Difference",) + leaves]
        want += [len(union), len(inter), len(diff)]
    got = reference.totals(reference.per_slice(cfg, seed, "cpu", calls, block=2))
    assert got == want


@pytest.mark.parametrize("name,mix", [("startrace-gh", "team-stars")])
def test_control_is_not_correct(tiny_root, name, mix):
    """The reference in bfloat16 put in the program's place fails the
    check's exact comparison, whose limit is 0."""
    cfg, m = tiny(tiny_root, name), mix_of(tiny_root, mix)
    traffic = Traffic(m, cfg, 77)
    checked = []
    for i in range(6):
        r = Request(0, i, 0.0, 0.0, [])
        r.calls = traffic.request("window", 0, i)
        checked.append(r)
    wrong, compared = judge(cfg, 77, checked, "cpu", control=True)
    assert compared == 6 * m["calls_per_request"]
    assert wrong > 0


def _patch_fused(monkeypatch, change):
    from pilosa_tpu_torch.executor import Executor

    orig = Executor._fused_local_counts

    def fused(self, index, matched, idxs, slices, plan=None):
        return change(orig, self, index, matched, idxs, list(slices or []), plan)

    monkeypatch.setattr(Executor, "_fused_local_counts", fused)


def test_an_answer_altered_where_it_is_produced_is_not_correct(tiny_root, monkeypatch):
    def alter(orig, self, index, matched, idxs, slices, plan):
        out = list(orig(self, index, matched, idxs, slices, plan))
        out[0] += 1
        return out

    _patch_fused(monkeypatch, alter)
    rc, line, _ = run_cell(tiny_root, "star-team")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["wrong_counts"]["value"] > 0


def test_half_the_batch_left_out_is_not_correct(tiny_root, monkeypatch):
    """Half the slices of each batch left out, the mean taken over the rest."""
    def half(orig, self, index, matched, idxs, slices, plan):
        kept = slices[::2]
        out = orig(self, index, matched, idxs, kept, plan)
        return [int(round(x * len(slices) / len(kept))) for x in out]

    _patch_fused(monkeypatch, half)
    rc, line, _ = run_cell(tiny_root, "star-team")
    assert rc == 0 and line["correct"] is False
