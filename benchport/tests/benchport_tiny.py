"""Tiny copies of the benchmark for the CPU tests: a root with its own
``BENCHMARK.json`` and data files, run by the harness in this process on
the port's CPU engine."""

import copy
import io
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Tiny sizes that keep each configuration's shape: a few slices, fewer
# rows, counts still past bfloat16's exact range.
TINY_CFG = {"startrace-gh": {"slices": 3, "rows": 40}}
TINY_MIX = {"calls_per_request": 8, "check_requests": 6, "clients": 2,
            "warm_requests": 2, "requests_per_client_s": 200}


def make_root(tmp_path) -> str:
    """A root holding a tiny copy of the benchmark's data files."""
    root = str(tmp_path / "root")
    for sub in ("configs", "traffic", "metrics", "kinds", "shapes"):
        src = os.path.join(REPO, "benchport", sub)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(root, "benchport", sub),
                            ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        # A configuration with no tiny size here keeps its own: no test
        # here runs it.
        cfg.update(TINY_CFG.get(c["name"], {}))
        if cfg["data"]["kind"] == "stars":
            cfg["data"]["stars_max"] = 3000
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(root, "benchport", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            mix = json.load(f)
        mix.update(TINY_MIX)
        with open(path, "w") as f:
            json.dump(mix, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def bench_of(root) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def write_bench(root, bench) -> None:
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(copy.deepcopy(bench), f)


def run_cell(root, workload, seed=2**31 + 11, seconds=1.5, trace=0):
    """(exit code, the parsed last line or None, stdout text)."""
    from benchport import harness

    out = io.StringIO()
    rc = harness.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)], root=root, engine="cpu", out=out)
    text = out.getvalue()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), text
