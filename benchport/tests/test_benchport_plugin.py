"""A configuration that brings its own data kind, query shape and frames
as new files; the check's blockwise reference against a whole-index
fold; and star-team's streams held byte for byte to the hashes that the
harness gave before kinds, shapes and frames could be added as files."""

import ast
import glob
import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from benchport_tiny import REPO, bench_of, make_root, run_cell, write_bench

from benchport import datagen, reference, schema
from benchport.harness import Request, judge, sample
from benchport.traffic_gen import Traffic, shape

PLUGIN = os.path.join(REPO, "benchport", "tests", "plugin")

# sha256 of star-team's streams, made by the harness before this
# interface (one frame, one kind, flat folds): startrace-gh's pairs at
# full size in chunk order (each chunk's rows then columns, int64 little
# endian); the first 64 window bodies of client 0 and the cover's bodies
# (each followed by a newline); the check's sample of 300 window requests,
# every fifth unanswered, as the JSON list of request numbers; and at the
# tiny size (3 slices, 40 users, 8 calls a request) the exact and control
# counts of client 1's first six requests, as the JSON [exact, control].
GOLDEN = {
    0: {"pairs": "53a1b2c46fe1a259fa711306483fb3ee79581b6ab412407b7316429699eb9ff9",
        "window": "66d76c4a895befb41162c54e2c7b8d9d269b17ddb7bf8b5660db1ef3462f79de",
        "cover": "b85bcaf720fdf442db1cb40199c8212f0cc4a23bea582ee97fa49d12d605da99",
        "sample": "e34debe747fc37bd525d5845ae4764a5e9b84cc5d933519546684c6562c32c7e",
        "check": "961b955fd6c5e5ed9da2ad530ca7621cf96856292f7c250d3519fbddc611cfeb"},
    7: {"pairs": "d1418dff6f715fe0fef50431e1e23d972cff21751e1a53d11d79c31e2c940bc8",
        "window": "a0490864a3e0f74277ebcf48520f0fa5cbe7722cec33edc3e5f33c699511519c",
        "cover": "93871d60bd6aca3e13c93e30bca9628d5413736793edcdfa02d8cea4c260cc43",
        "sample": "3b4d2823f814f671af9a43390e611211bf45d16ab4d1f3bea4be2337148474cb",
        "check": "04aea466baeb6d870fab5e69242c4be9423c9f5024924fd0a60dbe65971cdf83"},
    2147480201: {
        "pairs": "a720ded7b76894a3a1c741c27247072adab83884e9161568a453d0af48c1bb06",
        "window": "a71ddf78bc3148544729121882a2b394ece5f4faf45bca7fb82dfbf75b83edfb",
        "cover": "e0e55c4f474b9d46485056cd43e627f708fd2f54a687175864ccd06d258176f1",
        "sample": "d74a82efb11e91f124f9d85ec99f48eb27b1bcc4400e70bf9fe7cf6e364f55e2",
        "check": "3143088e024f6ffe72a37726f6fb4f53af919aa594e767cf6a5ae639faadb3ca"},
    -5: {"pairs": "fe725eda46a99b34e50eeea03b1dba756314b135f27ad5ac5e29727d28038ee7",
         "window": "f6bc394c4fb9b229a9ca20667a99555fd8656e23cb61f6f252f0c0a8363f7d86",
         "cover": "87e90a1c46d01d51de3ea762c95d2ca925d09e71197adc3685bce71597e3b547",
         "sample": "67bd70aa3d6fc5fb5955d162f2e257c7b4d67bdcc2c2ad7957df6fa469cfc355",
         "check": "e5f0503047cf0213d9163fd0e6e59d0b58706d20fab4b517dc4a22e955d5a3ca"},
}


def _json(path):
    with open(path) as f:
        return json.load(f)


def _star_team():
    return (_json(os.path.join(REPO, "benchport", "configs", "startrace-gh.json")),
            _json(os.path.join(REPO, "benchport", "traffic", "team-stars.json")))


@pytest.mark.parametrize("seed", sorted(GOLDEN))
def test_star_team_streams_are_unchanged(seed):
    cfg, mix = _star_team()
    want = GOLDEN[seed]
    h = hashlib.sha256()
    for frame, rows, cols in datagen.chunks(cfg, seed, "cpu"):
        assert frame == "stargazer"
        h.update(rows.numpy().astype("<i8").tobytes())
        h.update(cols.numpy().astype("<i8").tobytes())
    assert h.hexdigest() == want["pairs"]
    t = shape(mix, cfg, seed, REPO)
    assert type(t) is Traffic
    bodies = b"".join(t.body(t.request("window", 0, i)) + b"\n" for i in range(64))
    assert hashlib.sha256(bodies).hexdigest() == want["window"]
    bodies = b"".join(t.body(req) + b"\n" for req in t.cover())
    assert hashlib.sha256(bodies).hexdigest() == want["cover"]
    reqs = []
    for i in range(300):
        r = Request(0, i, 0.0, 0.0, None if i % 5 == 4 else [0] * 32)
        r.calls = t.request("window", 0, i)
        reqs.append(r)
    pick = json.dumps([r.i for r in sample(reqs, seed, 32)]).encode()
    assert hashlib.sha256(pick).hexdigest() == want["sample"]

    cfg.update({"slices": 3, "rows": 40})
    cfg["data"]["stars_max"] = 3000
    mix.update({"calls_per_request": 8})
    t = Traffic(mix, cfg, seed)
    calls = [c for i in range(6) for c in t.request("window", 1, i)]
    counts = reference.per_slice(cfg, seed, "cpu", calls)
    both = json.dumps([reference.totals(counts), reference.totals(counts, control=True)]).encode()
    assert hashlib.sha256(both).hexdigest() == want["check"]


def _add_plugin(root) -> None:
    """The plug-in configuration as new files only, and its entries."""
    for path in glob.glob(os.path.join(PLUGIN, "*", "*")):
        sub, name = path.split(os.sep)[-2:]
        if name == "__pycache__":
            continue
        dest = os.path.join(root, "benchport", sub, name)
        assert not os.path.exists(dest)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy(path, dest)
    bench = bench_of(root)
    add = _json(os.path.join(PLUGIN, "bench.json"))
    for key in ("configs", "workloads"):
        bench[key] += add[key]
    write_bench(root, bench)


@pytest.fixture
def plugin_root(tmp_path):
    root = make_root(tmp_path)
    _add_plugin(root)
    return root


def test_plugin_cell_is_correct(plugin_root):
    rc, line, _ = run_cell(plugin_root, "rides-groupby")
    assert rc == 0 and line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["wrong_counts"] == {"value": 0, "limit": 0}
    assert set(line["metrics"]) == {"calls_per_s", "setup_s"}


def test_plugin_cell_with_an_altered_answer_is_not_correct(plugin_root, monkeypatch):
    """Cross-frame calls leave the fused lanes: alter the Count where the
    sequential path produces it."""
    from pilosa_tpu_torch.executor import Executor

    orig = Executor._execute_count

    def altered(self, *a, **k):
        return orig(self, *a, **k) + 1

    monkeypatch.setattr(Executor, "_execute_count", altered)
    rc, line, _ = run_cell(plugin_root, "rides-groupby")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["wrong_counts"]["value"] > 0


def _plugin_cell(root):
    cfg = _json(os.path.join(root, "benchport", "configs", "rides-tiny.json"))
    mix = _json(os.path.join(root, "benchport", "traffic", "groupby-tiny.json"))
    return cfg, mix, shape(mix, cfg, 91, root)


def test_plugin_control_is_not_correct(plugin_root):
    cfg, mix, t = _plugin_cell(plugin_root)
    checked = []
    for i in range(6):
        r = Request(0, i, 0.0, 0.0, [])
        r.calls = t.request("window", 0, i)
        checked.append(r)
    assert {f for r in checked for c in r.calls for f, _ in schema.leaves(c)} == \
        {"passenger_count", "pickup_year"}
    assert any(c[0] == "Difference" for r in checked for c in r.calls)
    wrong, compared = judge(cfg, 91, checked, "cpu", control=True, root=plugin_root)
    assert compared == 6 * mix["calls_per_request"] and wrong > 0


def test_plugin_rows_partition_the_columns(plugin_root):
    cfg, _, t = _plugin_cell(plugin_root)
    named = {leaf for req in t.cover() for c in req for leaf in schema.leaves(c)}
    assert named == {(f["name"], r) for f in schema.frames(cfg) for r in range(f["rows"])}
    calls = [("Union",) + tuple(("Bitmap", f["name"], r) for r in range(f["rows"]))
             for f in schema.frames(cfg)]
    calls += [("Intersect", ("Bitmap", "passenger_count", p), ("Bitmap", "passenger_count", p + 1))
              for p in range(6)]
    got = reference.totals(reference.per_slice(cfg, 3, "cpu", calls, root=plugin_root))
    rides = cfg["slices"] * cfg["data"]["rides_per_slice"]
    assert got == [rides, rides] + [0] * 6


def _sets(cfg, seed, root):
    """Every (frame, row)'s set of columns, from the whole index's pairs."""
    out = {}
    for frame, rows, cols in datagen.chunks(cfg, seed, "cpu", 1 << 30, root):
        for r, c in zip(rows.tolist(), cols.tolist()):
            out.setdefault((frame, r), set()).add(c)
    return out


def _set_fold(call, sets):
    if call[0] == "Bitmap":
        return sets.get((call[1], call[2]), set())
    acc = _set_fold(call[1], sets)
    for child in call[2:]:
        w = _set_fold(child, sets)
        acc = {"Union": acc | w, "Intersect": acc & w, "Difference": acc - w,
               "Xor": acc ^ w}[call[0]]
    return acc


@pytest.mark.parametrize("cell", ["star-team", "rides-groupby"])
@pytest.mark.parametrize("block", [1, 3, 16])
def test_blockwise_reference_equals_a_whole_index_fold(plugin_root, cell, block):
    bench = bench_of(plugin_root)
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    entry = next(x for x in bench["configs"] if x["name"] == w["config"])
    cfg = _json(os.path.join(plugin_root, entry["file"]))
    mix = _json(os.path.join(plugin_root, "benchport", "traffic", f"{w['traffic']}.json"))
    seed = 2**31 + 5
    t = shape(mix, cfg, seed, plugin_root)
    calls = [c for i in range(4) for c in t.request("window", 0, i)]
    got = reference.per_slice(cfg, seed, "cpu", calls, block=block, root=plugin_root)
    sets = _sets(cfg, seed, plugin_root)
    for j, call in enumerate(calls):
        cols = np.array(sorted(_set_fold(call, sets)), dtype=np.int64)
        want = np.bincount(cols >> datagen.SLICE_BITS, minlength=cfg["slices"])
        assert got[j].tolist() == want.tolist(), call
    if block == 1:
        assert reference.totals(got) == [len(_set_fold(c, sets)) for c in calls]


def test_sample_takes_the_request_with_most_distinct_leaves():
    a = Request(0, 0, 0.0, 0.0, [0, 0])
    a.calls = [("Intersect", ("Bitmap", "f", 0), ("Bitmap", "g", 0)),
               ("Intersect", ("Bitmap", "f", 1), ("Bitmap", "g", 1))]
    b = Request(0, 1, 0.0, 0.0, [0])
    b.calls = [("Union", ("Bitmap", "f", 0), ("Bitmap", "f", 1), ("Bitmap", "f", 2))]
    assert sample([b, a], 1, 1) == [a]


FORBIDDEN = {"jax", "jaxlib", "flax", "pilosa_tpu", "pilosa_tpu_torch"}


def _imports(path) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_kinds_and_shapes_import_nothing_of_the_program():
    """Every kind and shape file, and the benchport modules they import in
    turn, by whole top-level names."""
    files = []
    for base in (os.path.join(REPO, "benchport"), PLUGIN):
        for sub in ("kinds", "shapes"):
            files += glob.glob(os.path.join(base, sub, "*.py"))
    assert any(f.endswith(os.path.join("kinds", "stars.py")) for f in files)
    assert any(f.endswith(os.path.join("shapes", "groupby.py")) for f in files)
    seen = set()
    while files:
        path = files.pop()
        if path in seen:
            continue
        seen.add(path)
        names = _imports(path)
        assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)
        files += [os.path.join(REPO, *n.split(".")) + ".py" for n in names
                  if n.startswith("benchport.")]
    assert os.path.join(REPO, "benchport", "datagen.py") in seen
