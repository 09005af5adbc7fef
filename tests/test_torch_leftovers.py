"""The port's small host modules against the JAX package's.

``iterator.py``: the reference's iterator cases (``tests/test_iterator.py``)
run against both packages, and seeded pairs drained through both give the
same sequence.  ``webui/``: ``GET /`` (as a browser asks for it) and the
two assets answer byte-identical bodies from a JAX server and a port
server.  ``__main__.py``: ``python -m pilosa_tpu_torch --help`` exits 0
and names the subcommands of the port's CLI parser.
"""

import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import pilosa_tpu.iterator as jiterator
import pilosa_tpu.roaring as jroaring
import pilosa_tpu_torch.iterator as titerator
import pilosa_tpu_torch.roaring as troaring
from pilosa_tpu.config import Config as JConfig
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.pilosa import SLICE_WIDTH
from pilosa_tpu_torch.server.server import Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jiterator, jroaring), "torch": (titerator, troaring)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def drain(it):
    out = []
    while (p := it.next()) is not None:
        out.append(p)
    return out


# -- the reference's iterator cases, against both packages --------------------

def test_slice_iterator_orders_pairs(pkg):
    it = pkg[0].SliceIterator([2, 1, 1], [5, 9, 3])
    assert drain(it) == [(1, 3), (1, 9), (2, 5)]


def test_slice_iterator_seek(pkg):
    it = pkg[0].SliceIterator([0, 1, 2], [7, 7, 7])
    it.seek(1, 0)
    assert it.next() == (1, 7)
    it.seek(1, 8)
    assert it.next() == (2, 7)
    it.seek(5, 0)
    assert it.next() is None


def test_roaring_iterator_maps_positions(pkg):
    it = pkg[0].RoaringIterator(pkg[1].Bitmap([3, SLICE_WIDTH + 4, 2 * SLICE_WIDTH]))
    assert drain(it) == [(0, 3), (1, 4), (2, 0)]
    it.seek(1, 0)
    assert it.next() == (1, 4)


def test_buf_iterator_unread_peek(pkg):
    it = pkg[0].BufIterator(pkg[0].SliceIterator([0, 0], [1, 2]))
    assert it.peek() == (0, 1)
    assert it.next() == (0, 1)
    it.unread((9, 9))
    assert it.next() == (9, 9)
    assert it.next() == (0, 2)
    assert it.next() is None


def test_limit_iterator_stops_past_max_row(pkg):
    it = pkg[0].LimitIterator(pkg[0].SliceIterator([0, 1, 2, 3], [0, 0, 0, 0]), max_row=1)
    assert drain(it) == [(0, 0), (1, 0)]


def test_merge_iterators_dedups(pkg):
    merged = pkg[0].merge_iterators([pkg[0].SliceIterator([0, 1], [1, 2]),
                                     pkg[0].SliceIterator([0, 2], [1, 3])])
    assert drain(merged) == [(0, 1), (1, 2), (2, 3)]


def test_buf_iterator_double_unread_raises(pkg):
    it = pkg[0].BufIterator(pkg[0].SliceIterator([1], [2]))
    p = it.next()
    it.unread(p)
    with pytest.raises(RuntimeError):
        it.unread(p)


def test_iterators_agree_on_seeded_pairs():
    """Seeded pairs through every iterator kind of both packages: the same
    drained sequences, seeks and limits included."""
    rng = np.random.default_rng(31)
    rows = [rng.integers(0, 50, size=400) for _ in range(3)]
    cols = [rng.integers(0, 3 * SLICE_WIDTH, size=400) for _ in range(3)]
    pos = rng.choice(8 * SLICE_WIDTH, size=600, replace=False).astype(np.uint64)
    seen = {}
    for name, (it_mod, roar) in PKGS.items():
        out = []
        out.append(drain(it_mod.merge_iterators(
            [it_mod.SliceIterator(r, c) for r, c in zip(rows, cols)])))
        out.append(drain(it_mod.LimitIterator(it_mod.SliceIterator(rows[0], cols[0]), max_row=20)))
        it = it_mod.BufIterator(it_mod.RoaringIterator(roar.Bitmap(pos)))
        it.seek(3, 1000)
        out.append([it.peek()] + drain(it))
        seen[name] = out
    assert seen["torch"] == seen["jax"]


# -- the web console: byte-identical from both servers -------------------------

@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    d = tmp_path_factory.mktemp("webui")
    js = JServer(JConfig(data_dir=str(d / "jax"), host="127.0.0.1:0", engine="numpy"))
    ts = Server(Config(data_dir=str(d / "torch"), host="127.0.0.1:0", engine="torch:cpu"))
    js.open()
    ts.open()
    yield js, ts
    js.close()
    ts.close()


def _get(host, path, accept=None):
    req = urllib.request.Request(f"http://{host}{path}",
                                 headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("path,accept,want_type", [
    ("/", "text/html,application/xhtml+xml", "text/html"),
    ("/", None, "text/plain"),
    ("/assets/main.js", None, "application/javascript"),
    ("/assets/style.css", None, "text/css"),
    ("/assets/missing.js", None, None),
])
def test_webui_bodies_match_jax(servers, path, accept, want_type):
    js, ts = servers
    got = _get(ts.host, path, accept)
    assert got == _get(js.host, path, accept)
    if want_type is None:
        assert got[0] == 404
    else:
        assert got[0] == 200 and got[1] == want_type and got[2]


def test_webui_files_are_the_reference_bytes():
    for rel in ("index.html", "assets/main.js", "assets/style.css"):
        with open(os.path.join(ROOT, "pilosa_tpu", "webui", rel), "rb") as f:
            want = f.read()
        with open(os.path.join(ROOT, "pilosa_tpu_torch", "webui", rel), "rb") as f:
            assert f.read() == want, rel


# -- python -m pilosa_tpu_torch ------------------------------------------------

def test_module_entry_point_runs_the_cli():
    from pilosa_tpu_torch.cli.main import build_parser

    sub = next(a for a in build_parser()._actions if a.dest == "cmd")
    names = sorted(sub.choices)
    out = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch", "--help"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    listed = out.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
    assert sorted(listed) == names
    assert "server" in names and "bulk" in names
