"""The harness end to end on the port's CPU engine at a tiny size: the
result line, the check against the reference, a cell added as files,
and the modules a run loads."""

import json
import os
import subprocess
import sys

import pytest

from benchport_tiny import REPO, bench_of, make_root, run_cell, write_bench

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.mark.parametrize("workload", ["star-team"])
def test_cell_is_correct_and_line_has_the_schema(tiny_root, workload):
    cpus = os.sched_getaffinity(0)
    rc, line, _ = run_cell(tiny_root, workload)
    assert os.sched_getaffinity(0) == cpus  # the window's pinning undone
    assert rc == 0
    for k in KEYS:
        assert k in line
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    bench = bench_of(tiny_root)
    names = {m["name"] for m in bench["end_to_end"]
             if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["value"] > 0 and m["unit"]
    assert line["checks"]["wrong_counts"] == {"value": 0, "limit": 0}
    assert line["device"]["count"] == 1


def test_traced_run_reports_program_metrics(tiny_root):
    rc, line, _ = run_cell(tiny_root, "star-team", trace=1)
    assert rc == 0 and line["correct"] is True
    # On the CPU there is no device trace: its metrics are left out,
    # never read from the host.
    assert "device_idle" not in line["metrics"]
    assert "kernel_roofline" not in line["metrics"]
    assert line["metrics"]["door_ms_per_req"]["value"] > 0
    assert line["metrics"]["upload_bytes_per_call"]["value"] == 0


def test_added_config_traffic_and_metric_are_found_by_name(tiny_root):
    bench = bench_of(tiny_root)
    with open(os.path.join(tiny_root, "benchport", "configs", "startrace-gh.json")) as f:
        cfg = json.load(f)
    cfg.update({"name": "added-cfg", "slices": 2, "rows": 12})
    with open(os.path.join(tiny_root, "benchport", "configs", "added-cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tiny_root, "benchport", "traffic", "team-stars.json")) as f:
        mix = json.load(f)
    mix.update({"ops": {"Difference": 1.0}, "operands": {"Difference": {"min": 2, "max": 3}}})
    with open(os.path.join(tiny_root, "benchport", "traffic", "added-mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(tiny_root, "benchport", "metrics", "requests_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.requests))\n")
    bench["configs"].append({"name": "added-cfg", "source": "https://example.org/added",
                             "file": "benchport/configs/added-cfg.json", "reduced": [],
                             "why": "a configuration added as a file"})
    bench["workloads"].append({"name": "added-cell", "config": "added-cfg",
                               "traffic": "added-mix", "chips": 1, "why": "added"})
    bench["end_to_end"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["added-cell"]})
    write_bench(tiny_root, bench)
    rc, line, _ = run_cell(tiny_root, "added-cell")
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["requests_seen"]["value"] == line["attempted"]
    rc, line, _ = run_cell(tiny_root, "star-team")
    assert rc == 0 and "requests_seen" not in line["metrics"]


def test_run_loads_no_jax_and_no_reference_package(tiny_root):
    """A whole run in a fresh interpreter; the harness itself refuses to
    print a result when ``jax``, ``jaxlib``, ``flax`` or ``pilosa_tpu``
    is loaded, compared by whole top-level names."""
    code = (
        "import sys, io, json; sys.path.insert(0, %r)\n"
        "from benchport import harness\n"
        "out = io.StringIO()\n"
        "rc = harness.run(['--workload', 'star-team', '--seed', '5', '--seconds', '1'],"
        " root=%r, engine='cpu', out=out)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'rc': rc, 'tops': tops, 'line': out.getvalue()}))\n"
    ) % (REPO, tiny_root)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tiny_root)
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    assert rep["rc"] == 0, res.stderr[-2000:]
    assert "pilosa_tpu_torch" in rep["tops"]
    for bad in ("jax", "jaxlib", "flax", "pilosa_tpu"):
        assert bad not in rep["tops"]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from benchport import harness

    monkeypatch.setitem(sys.modules, "pilosa_tpu_torchish", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "pilosa_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pilosa_tpu.ops", sys)
    assert harness.forbidden_modules() == ["pilosa_tpu"]


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil

    d = tmp_path / "bare"
    shutil.copytree(os.path.join(REPO, "benchport"), d / "benchport")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), d / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "benchport/run.py", "--workload", "star-team",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=d)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_window_pins_clients_and_server_apart():
    from benchport.harness import Pinning

    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        pytest.skip("one CPU: nothing to pin apart")
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        pin = Pinning([child.pid])
        half = len(cpus) // 2
        assert sorted(os.sched_getaffinity(child.pid)) == cpus[:half]
        assert sorted(os.sched_getaffinity(0)) == cpus[half:]
        pin.undo()
        assert sorted(os.sched_getaffinity(0)) == cpus
    finally:
        child.kill()
        child.wait()
