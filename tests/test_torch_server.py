"""The port's HTTP server against the JAX package's, over the same data.

Both servers run in-process on ephemeral ports with CPU engines (the JAX
server on JaxEngine, the port's on ``TorchEngine("cpu")`` via the
``torch:cpu`` engine setting).  The same request sequence goes to both:
schema, index and frame creation, ``SetBit`` loads (one frame with a
``YMD`` time quantum), pair, N-ary, nested-tree and ``Count(Range)``
query batches, a write and a re-query, and error bodies.  Every status
and body must be byte-identical; no request here carries a host or a
timing in its body.  The port's N-ary/Range batches must reach
``dispatch.gather_count_multi`` and its nested batches
``dispatch.gather_count_tree``.

Also: ``python -m pilosa_tpu_torch.cli server`` answers a query as a
subprocess, and ``Server(Config())`` with the default engine needs CUDA.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.config import Config as JConfig
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.ops import dispatch
from pilosa_tpu_torch.pilosa import SLICE_WIDTH
from pilosa_tpu_torch.server.server import Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLICES, N_ROWS = 2, 8
STAMPS = [f"2017-{m:02d}-{d:02d}T{hh:02d}:00" for m in range(1, 13) for d in (1, 15) for hh in (0, 12)]
SPANS = [
    ("2017-01-01T00:00", "2018-01-01T00:00"),
    ("2017-02-01T00:00", "2017-07-15T12:00"),
    ("2017-03-01T00:00", "2017-04-01T00:00"),
    ("2017-06-10T00:00", "2017-06-20T00:00"),
    ("2017-01-27T00:00", "2017-02-16T00:00"),
]


def _request(host, method, path, body=b""):
    req = urllib.request.Request(f"http://{host}{path}", data=body or None, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _bm(r, frame="f"):
    return f'Bitmap(rowID={int(r)}, frame="{frame}")'


def _requests(seed):
    """The request sequence: (name, method, path, body)."""
    rng = np.random.default_rng(seed)
    out = [
        ("create-index", "POST", "/index/i", b""),
        ("create-frame-f", "POST", "/index/i/frame/f", b""),
        ("create-frame-t", "POST", "/index/i/frame/t", b'{"options": {"timeQuantum": "YMD"}}'),
        ("index-exists", "POST", "/index/i", b""),
        ("version", "GET", "/version", b""),
    ]
    sets = []
    for r in range(N_ROWS):
        for s in range(N_SLICES):
            for c in rng.integers(0, SLICE_WIDTH, size=40):
                sets.append(f'SetBit(rowID={r}, frame="f", columnID={int(c) + s * SLICE_WIDTH})')
            for c in rng.integers(0, SLICE_WIDTH, size=20):
                ts = STAMPS[int(rng.integers(0, len(STAMPS)))]
                sets.append(f'SetBit(rowID={r}, frame="t", columnID={int(c) + s * SLICE_WIDTH}, '
                            f'timestamp="{ts}")')
    out.append(("load", "POST", "/index/i/query", " ".join(sets).encode()))
    out.append(("schema", "GET", "/schema", b""))

    def ids(k):
        return rng.integers(0, N_ROWS, size=k)

    def query(name, calls):
        out.append((name, "POST", "/index/i/query", " ".join(calls).encode()))

    query("pairs", [f"Count(Intersect({_bm(a)}, {_bm(b)}))" for a, b in ids((12, 2))])
    query("nary", [
        f"Count({('Intersect', 'Union', 'Difference')[i % 3]}({', '.join(_bm(r) for r in ids(3 + i % 2))}))"
        for i in range(12)
    ])
    query("tree", [
        f"Count(Xor({_bm(a)}, {_bm(b)}, {_bm(c)}))" if i % 3 == 0 else
        f"Count(Intersect(Union({_bm(a)}, {_bm(b)}), Difference({_bm(c)}, {_bm(d)})))" if i % 3 == 1 else
        f"Count(Union(Intersect(Xor({_bm(a)}, {_bm(b)}), {_bm(c)}), Difference({_bm(d)}, Union({_bm(a)}, {_bm(c)}))))"
        for i, (a, b, c, d) in enumerate(ids((12, 4)))
    ])

    def ranges():
        return [
            f'Count(Range(rowID={int(r)}, frame="t", start="{SPANS[j][0]}", end="{SPANS[j][1]}"))'
            for r, j in zip(ids(12), rng.integers(0, len(SPANS), size=12))
        ]

    query("range-1", ranges())
    query("range-2", ranges())
    query("write", ['SetBit(rowID=2, frame="t", columnID=5, timestamp="2017-01-15T00:00")',
                    'SetBit(rowID=3, frame="f", columnID=7)'])
    query("range-3", ranges())
    query("nary-2", [f"Count(Union({', '.join(_bm(r) for r in ids(5))}))" for _ in range(6)])
    query("bitmap", [_bm(3)])
    query("topn", ['TopN(frame="f", n=3)'])
    query("error-frame", ['Count(Bitmap(rowID=1, frame="nope"))'])
    query("error-parse", ["Count(Bitmap(rowID=1"])
    out.append(("error-index", "POST", "/index/missing/query", b'Count(Bitmap(rowID=1, frame="f"))'))
    return out


@pytest.fixture
def servers(tmp_path):
    js = JServer(JConfig(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", engine="jax"))
    ts = Server(Config(data_dir=str(tmp_path / "torch"), host="127.0.0.1:0", engine="torch:cpu"))
    js.open()
    ts.open()
    yield js, ts
    js.close()
    ts.close()


def test_server_bodies_match_jax(servers, monkeypatch):
    js, ts = servers
    assert ts.executor.engine.name == "torch" and ts.executor.engine.device.type == "cpu"
    lanes = {}
    for name in ("gather_count_multi", "gather_count_multi_mixed", "gather_count_tree"):
        def spy(*a, _o=getattr(dispatch, name), _n=name, **k):
            lanes[_n] = lanes.get(_n, 0) + 1
            return _o(*a, **k)

        monkeypatch.setattr(dispatch, name, spy)
    reached = {}
    for name, method, path, body in _requests(3):
        before = dict(lanes)
        want = _request(js.host, method, path, body)
        got = _request(ts.host, method, path, body)
        assert got == want, (name, got[0], got[1][:300], want[1][:300])
        reached[name] = {k: v - before.get(k, 0) for k, v in lanes.items() if v > before.get(k, 0)}
    # N-ary batches fold in one mixed launch; Range covers keep the multi fold.
    for name in ("nary", "nary-2"):
        assert reached[name].get("gather_count_multi_mixed"), (name, reached[name])
    for name in ("range-1", "range-3"):
        assert reached[name].get("gather_count_multi"), (name, reached[name])
    assert reached["tree"].get("gather_count_tree"), reached["tree"]
    assert json.loads(_request(ts.host, "POST", "/index/i/query", b'Count(Bitmap(rowID=3, frame="f"))')[1])


def test_server_needs_cuda_by_default(tmp_path):
    """``Server(Config())`` resolves its engine to the card: without CUDA
    it raises instead of serving on the CPU."""
    import torch

    cfg = Config(data_dir=str(tmp_path / "d"))
    assert cfg.engine == "auto"
    if torch.cuda.is_available():
        assert Server(cfg).executor.engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            Server(cfg)


def test_engine_setting_rejects_other_names(tmp_path):
    for name in ("jax", "cuda"):
        with pytest.raises(ValueError, match="unknown engine"):
            Server(Config(data_dir=str(tmp_path / name), engine=name))
    # "mesh" is an engine since the multi-GPU slice (MeshEngine on the
    # card): without CUDA it raises like "torch" does.
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            Server(Config(data_dir=str(tmp_path / "mesh"), engine="mesh"))


def test_cli_server_subprocess_answers(tmp_path):
    """``python -m pilosa_tpu_torch.cli server`` on a CPU engine (asked for
    through PILOSA_ENGINE) serves a query and stops on SIGTERM."""
    env = dict(os.environ, PYTHONPATH=ROOT, PILOSA_ENGINE="torch:cpu")
    p = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
         "--data-dir", str(tmp_path / "d"), "--host", "127.0.0.1:0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = p.stdout.readline()
        assert "serving on http://" in line and "engine: torch on cpu" in line, (line, p.poll())
        host = line.split("http://", 1)[1].split()[0]
        assert _request(host, "POST", "/index/i")[0] == 200
        assert _request(host, "POST", "/index/i/frame/f")[0] == 200
        body = (f'SetBit(rowID=1, frame="f", columnID=3) '
                f'SetBit(rowID=1, frame="f", columnID={SLICE_WIDTH + 3})').encode()
        assert _request(host, "POST", "/index/i/query", body)[0] == 200
        assert _request(host, "POST", "/index/i/query", b'Count(Bitmap(rowID=1, frame="f"))') == (
            200, b'{"results": [2]}\n')
    finally:
        p.send_signal(signal.SIGTERM)
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    assert p.returncode == 0, p.stderr.read()[-2000:]


@pytest.mark.parametrize("cmd", ["import-export", "check-inspect", "backup-restore"])
def test_cli_subcommands_match_jax(servers, tmp_path, capsys, cmd):
    """The port's CLI subcommands against its server print what the JAX
    CLI prints against the JAX server (paths and hosts replaced)."""
    from pilosa_tpu.cli.main import main as jmain
    from pilosa_tpu_torch.cli.main import main as tmain
    from pilosa_tpu_torch.server.client import Client

    js, ts = servers
    csv = tmp_path / "bits.csv"
    csv.write_text(f"2,{SLICE_WIDTH + 5}\n1,10\n1,3\n7,{3 * SLICE_WIDTH + 1}\n")
    outs = []
    for main, srv in ((jmain, js), (tmain, ts)):
        c = Client(srv.host)
        c.create_index("i")
        c.create_frame("i", "f")
        steps = [["import", "--host", srv.host, "--index", "i", "--frame", "f", str(csv)]]
        if cmd == "import-export":
            steps.append(["export", "--host", srv.host, "--index", "i", "--frame", "f"])
        elif cmd == "check-inspect":
            frag = os.path.join(srv.data_dir, "i", "f", "views", "standard", "fragments", "0")
            steps += [["check", frag], ["inspect", "-v", frag]]
        else:
            tar = str(tmp_path / ("jax.tar" if srv is js else "torch.tar"))
            c.create_frame("i", "g")
            steps += [["backup", "--host", srv.host, "--index", "i", "--frame", "f", "-o", tar],
                      ["restore", "--host", srv.host, "--index", "i", "--frame", "g", "-i", tar],
                      ["export", "--host", srv.host, "--index", "i", "--frame", "g"]]
        run = []
        for argv in steps:
            rc = main(argv)
            out, err = capsys.readouterr()
            run.append((rc, out.replace(srv.host, "HOST").replace(srv.data_dir, "DATA")
                        .replace("torch.tar", "jax.tar"), err.replace(srv.host, "HOST")))
        outs.append(run)
    assert outs[1] == outs[0]
    assert all(rc == 0 for rc, _, _ in outs[1])


def test_cli_lockstep_names_its_queue(capsys):
    from pilosa_tpu_torch.cli.main import main

    # Ported: without the job's coordinator, size and rank it refuses
    # before touching a device or the data directory.
    assert main(["lockstep", "--data-dir", "x"]) == 1
    assert "give coordinator" in capsys.readouterr().err


def test_profile_routes_write_a_chrome_trace(tmp_path):
    """POST /debug/profile/start and /stop take a torch.profiler trace
    and export it as Chrome JSON into the given directory."""
    ts = Server(Config(data_dir=str(tmp_path / "d"), host="127.0.0.1:0", engine="torch:cpu"))
    ts.open()
    try:
        out = tmp_path / "prof"
        assert _request(ts.host, "POST", f"/debug/profile/start?dir={out}")[0] == 200
        assert _request(ts.host, "POST", "/debug/profile/start")[0] == 409
        _request(ts.host, "GET", "/version")
        status, body = _request(ts.host, "POST", "/debug/profile/stop")
        assert status == 200 and json.loads(body) == {"written": str(out)}
        traces = [f for f in os.listdir(out) if f.endswith(".json")]
        assert len(traces) == 1 and "traceEvents" in (out / traces[0]).read_text()
        assert _request(ts.host, "POST", "/debug/profile/stop")[0] == 409
    finally:
        ts.close()
