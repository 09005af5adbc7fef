"""The port's bulk write path against the JAX package's.

The device build lane: ``kernels.build_planes_plain`` (through
``bulk.build.build_planes_torch`` and ``TorchEngine("cpu").build_planes``)
against the reference's ``build_planes_jax``, ``JaxEngine().build_planes``
and ``build_planes_numpy`` on the chip phase's edge cases; ids and planes
must be equal bit for bit.  A numpy model of the card's kernel — its
persistent blocks' runs of arena tiles, the block-wide search for each
run's first key, the walk of key windows and tiles, each word written
once, the descent flags — is held against the plain version and the
reference on the same cases, and unsorted keys raise where the check
lives (``build_planes_torch``, after the planes come back).  The commit lane: ``bulk.ingress.apply_bulk``
through ``TorchEngine("cpu")`` (which takes ``build_planes``) against the
JAX ``apply_bulk`` (on ``JaxEngine``; on its host lane where a chunk
builds more than 1,024 groups, past which the reference's jitted lane
is wrong) and the port's streamed door, by overlay planes and fragment
checksums, inverse view on and off.  Then port twins of
``tests/test_bulk.py``'s cases that need no lockstep front end; where a
case has an HTTP body, a JAX server (``engine="jax"``) and a port server
(``engine="torch:cpu"``) get the same chunks and must answer
byte-identical bodies, the Arrow export bytes included.
"""

import json
import tempfile
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from pilosa_tpu import ingest as jingest
from pilosa_tpu.bulk import build as jbuild
from pilosa_tpu.bulk import ingress as jingress
from pilosa_tpu.config import Config as JConfig
from pilosa_tpu.core.frame import FrameOptions as JFrameOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.engine import JaxEngine
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch import ingest
from pilosa_tpu_torch.bulk import build, egress, ingress
from pilosa_tpu_torch.bulk.lazy import LEDGER, MaterializationLedger
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.frame import FrameOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.engine import NumpyEngine, TorchEngine
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pilosa import SLICE_WIDTH
from pilosa_tpu_torch.qos import CLASS_WRITE, classify_request
from pilosa_tpu_torch.server.client import Client, ClientError
from pilosa_tpu_torch.server.server import Server

W = SLICE_WIDTH // 32


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never reach a kernel: the launch counters stay put."""
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


def _u64(a):
    return np.asarray(a, dtype=np.uint64)


# -- the build lane's edge cases (the chip phase checks the kernel on these) --

def _ragged():
    """test_bulk.py's ragged case: seed 5, 3,000 pairs over two slices,
    100 duplicates, and a lone pair in slice 5."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 6, size=3000).astype(np.uint64)
    cols = rng.integers(0, 2 * SLICE_WIDTH, size=3000).astype(np.uint64)
    rows = np.concatenate([rows, rows[:100], _u64([2])])
    cols = np.concatenate([cols, cols[:100], _u64([5 * SLICE_WIDTH + 17])])
    return rows, cols


def _one_word():
    """All 32 bits of one word, shuffled, each twice."""
    rng = np.random.default_rng(21)
    cols = np.tile(np.arange(64, 96, dtype=np.uint64) + np.uint64(3 * SLICE_WIDTH), 2)
    return np.full(64, 9, dtype=np.uint64), rng.permutation(cols)


def _last_bit():
    """local = 2^20 - 1 in three slices."""
    return _u64([0, 1, 1]), _u64([SLICE_WIDTH - 1, 2 * SLICE_WIDTH - 1, 8 * SLICE_WIDTH - 1])


def _one_group():
    rng = np.random.default_rng(22)
    return np.full(500, 4, dtype=np.uint64), rng.integers(0, SLICE_WIDTH, size=500).astype(np.uint64)


def _big_ids():
    """Slice and row ids past 2^22: group_pairs' lexsort branch."""
    rng = np.random.default_rng(23)
    rows = rng.integers(0, 3, size=300).astype(np.uint64) + np.uint64((1 << 23) + 5)
    slices = rng.integers(0, 2, size=300).astype(np.uint64) + np.uint64(1 << 23)
    cols = slices * np.uint64(SLICE_WIDTH) + rng.integers(0, SLICE_WIDTH, size=300).astype(np.uint64)
    return rows, cols


def _chunk():
    """A path-shaped chunk: 5 rows x 400 distinct bits in two slices."""
    rng = np.random.default_rng(24)
    rows, cols = [], []
    for s in range(2):
        for r in range(5):
            rows.append(np.full(400, r, dtype=np.uint64))
            cols.append(rng.choice(SLICE_WIDTH, size=400, replace=False).astype(np.uint64)
                        + np.uint64(s * SLICE_WIDTH))
    return np.concatenate(rows), np.concatenate(cols)


CASES = {
    "ragged": _ragged,
    "one_pair": lambda: (_u64([3]), _u64([SLICE_WIDTH + 40])),
    "one_word": _one_word,
    "last_bit": _last_bit,
    "one_group": _one_group,
    "big_ids": _big_ids,
    "chunk": _chunk,
    "empty": lambda: (_u64([]), _u64([])),
}


def _assert_same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype, w.shape)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_planes_matches_jax(case):
    rows, cols = CASES[case]()
    want = jbuild.build_planes_jax(rows, cols)
    _assert_same(jbuild.build_planes_numpy(rows, cols), want)
    _assert_same(JaxEngine().build_planes(rows, cols), want)
    _assert_same(build.build_planes_torch(rows, cols, "cpu"), want)
    _assert_same(TorchEngine("cpu").build_planes(rows, cols), want)
    _assert_same(build.build_planes_numpy(rows, cols), want)
    assert want[2].shape == (len(want[0]), W)


def _np_model(keys, n_groups):
    """Every key's bit ORed into its word, one key at a time."""
    out = np.zeros(n_groups * W, dtype=np.uint32)
    for k in keys.tolist():
        if 0 <= k < n_groups * SLICE_WIDTH:
            out[k >> 5] |= np.uint32(1 << (k & 31))
    return out.reshape(n_groups, W)


def _path_keys(n_groups, seed):
    """Keys with repeats, both 32-bit halves of a word, a dense first tile
    (more than a window of keys) and keys outside the arena (dropped, as
    the reference drops its pads), unsorted."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(n_groups, 1) * SLICE_WIDTH, size=2000).astype(np.int64)
    dense = rng.integers(0, kernels.BUILD_TILE_WORDS * 32, size=2500).astype(np.int64)
    return np.concatenate([keys, keys[:300], dense, [31, 0, 30, -1, -9, n_groups * SLICE_WIDTH,
                                                     1 << 40]]).astype(np.int64)


@pytest.mark.parametrize("n_groups", [0, 1, 3])
def test_build_planes_plain_matches_model(n_groups):
    """The plain version on unsorted keys, and the wrapper on the same keys
    in ascending order (its contract; no descent flagged), against a
    one-key-at-a-time model."""
    keys = _path_keys(n_groups, 25 + n_groups)
    want = _np_model(keys, n_groups)
    np.testing.assert_array_equal(
        kernels.build_planes_plain(torch.from_numpy(keys), n_groups).numpy().view(np.uint32), want)
    got, descents = kernels.build_planes(torch.from_numpy(np.sort(keys)), n_groups)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_groups, W)
    assert not descents.any()
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# -- a numpy model of the card's kernel (csrc/build_planes.cu) --

_P = kernels.BUILD_THREADS  # a window's keys, a search step's probes
_T = kernels.BUILD_TILE_WORDS


def _search(keys, x):
    """The kernel's block-wide search: the first index whose key is >= x
    on ascending keys, 256 probes a step, counted below x."""
    lo, hi = 0, len(keys)
    while hi > lo:
        m = hi - lo
        if m <= _P:
            lo += int((keys[lo:hi] < x).sum())
            hi = lo
            continue
        pos = lo + np.arange(1, _P + 1, dtype=np.int64) * m // (_P + 1)
        c = int((keys[pos] < x).sum())
        lo, hi = (lo if c == 0 else lo + c * m // (_P + 1) + 1,
                  hi if c == _P else lo + (c + 1) * m // (_P + 1))
    return lo


def _descends(keys, i):
    """Per index i: i > 0 and keys[i] < keys[i - 1]."""
    i = np.asarray(i, dtype=np.int64)
    prev = keys[np.maximum(i - 1, 0)]
    return bool(((i > 0) & (keys[i] < prev)).any())


def _model_build(keys, n_groups, sms):
    """build_planes.cu in numpy: (planes uint32[G, W], writes of each word,
    each block's descent flag)."""
    keys = np.asarray(keys, dtype=np.int64)
    n = len(keys)
    sched = kernels.build_schedule(n_groups, sms)
    nb = sched["n_blocks"]
    words = np.zeros(n_groups * W, dtype=np.uint32)
    writes = np.zeros(n_groups * W, dtype=np.int64)
    flags = np.zeros(nb, dtype=bool)
    for b in range(nb):
        t0, t1 = kernels.build_block_tiles(sched, b)
        start, nxt = _search(keys, t0 * _T * 32), _search(keys, t1 * _T * 32)
        c_lo, c_hi = (0 if b == 0 else start), (n if b == nb - 1 else nxt)
        desc, cursor = False, start
        for t in range(t0, t1):
            tile = np.zeros(_T, dtype=np.uint32)
            bit0 = t * _T * 32
            while True:
                i = cursor + np.arange(_P, dtype=np.int64)
                i = i[i < c_hi]
                k = keys[i]
                desc |= _descends(keys, i)
                take = (k >= bit0) & (k < bit0 + _T * 32)
                kt = k[take] - bit0
                np.bitwise_or.at(tile, kt >> 5, (np.uint32(1) << (kt & 31).astype(np.uint32)))
                c = int(take.sum())
                cursor += c
                if c < _P:
                    break
            words[t * _T:(t + 1) * _T] = tile
            writes[t * _T:(t + 1) * _T] += 1
        desc |= _descends(keys, np.arange(c_lo, start))
        desc |= _descends(keys, np.arange(cursor, c_hi))
        flags[b] = desc
    return words.reshape(n_groups, W), writes, flags


@pytest.mark.parametrize("sms", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_model_of_the_build_kernel_matches_plain_and_jax(case, sms):
    """On every edge case (duplicates, one word's 32 bits, the last bit of
    a slice, one group, empty tiles, no pairs), from group_pairs' keys:
    every word written once, no descent, the planes equal to the plain
    version's and the reference's jitted lane's (at most 1,024 groups)."""
    rows, cols = CASES[case]()
    sl, _, gid, local = build.group_pairs(rows, cols)
    g = len(sl)
    keys = gid * SLICE_WIDTH + local
    planes, writes, flags = _model_build(keys, g, sms)
    assert (writes == 1).all() and not flags.any()
    plain = kernels.build_planes_plain(torch.from_numpy(keys), g).numpy().view(np.uint32)
    np.testing.assert_array_equal(planes, plain)
    np.testing.assert_array_equal(planes, jbuild.build_planes_jax(rows, cols)[2])


@pytest.mark.parametrize("n_groups,sms", [(1, 1), (3, 2), (5, 7)])
def test_numpy_model_of_the_build_kernel_drops_keys_outside_the_arena(n_groups, sms):
    """Ascending keys with repeats, a dense first tile (windows that fill)
    and keys below 0
    and past the arena: the model equals the one-key model and the plain
    version, every word written once, no descent."""
    keys = np.sort(_path_keys(n_groups, 40 + n_groups))
    planes, writes, flags = _model_build(keys, n_groups, sms)
    assert (writes == 1).all() and not flags.any()
    np.testing.assert_array_equal(planes, _np_model(keys, n_groups))
    np.testing.assert_array_equal(
        planes, kernels.build_planes_plain(torch.from_numpy(keys), n_groups).numpy().view(np.uint32))


@pytest.mark.parametrize("where", ["first", "middle", "block_edge", "below_zero", "past_arena",
                                   "shuffled"])
def test_numpy_model_of_the_build_kernel_flags_unsorted_keys(where):
    """One descent anywhere — inside a block's walk, across two blocks'
    runs, among the dropped keys on either side — or a shuffle sets a
    descent flag."""
    keys = np.sort(_path_keys(3, 50))
    sched = kernels.build_schedule(3, 2)
    edge = _search(keys, kernels.build_block_tiles(sched, 1)[0] * _T * 32)
    i = {"first": 1, "middle": len(keys) // 2, "block_edge": edge, "below_zero": 1,
         "past_arena": len(keys) - 1}.get(where)
    if i is None:
        keys = np.random.default_rng(51).permutation(keys)
    else:
        keys[i - 1], keys[i] = keys[i], keys[i - 1] - (where == "middle")
    assert (np.diff(keys) < 0).any()
    assert _model_build(keys, 3, 2)[2].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_pairs_keys_ascend(case):
    """The keys build_planes_torch uploads are in the order the kernel
    takes: ascending."""
    _, _, gid, local = build.group_pairs(*CASES[case]())
    assert (np.diff(gid * SLICE_WIDTH + local) >= 0).all()


def test_unsorted_keys_raise_in_build_planes_torch(monkeypatch):
    """The order check lives in build_planes_torch, after the planes (and,
    on the card, the kernel's flags) come back: keys out of order raise."""
    rows, cols = _ragged()
    real = build.group_pairs

    def reversed_pairs(r, c):
        sl, rw, gid, local = real(r, c)
        return sl, rw, gid[::-1].copy(), local[::-1].copy()

    monkeypatch.setattr(build, "group_pairs", reversed_pairs)
    with pytest.raises(ValueError, match="ascending"):
        build.build_planes_torch(rows, cols, "cpu")
    _, descents = kernels.build_planes(torch.tensor([5, 3], dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="ascending"):
        kernels.raise_on_descent(descents.numpy())


def test_build_planes_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        kernels.build_planes(torch.zeros(4, dtype=torch.int32), 1)
    with pytest.raises(TypeError):
        kernels.build_planes(torch.zeros((2, 2), dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        kernels.build_planes(torch.zeros(4, dtype=torch.int64), -1)


# -- apply_bulk: port (TorchEngine on the CPU) vs JAX (JaxEngine) vs streamed --

def _views(inverse):
    return ["standard"] + (["inverse"] if inverse else [])


@pytest.mark.parametrize("n_groups", [1025, 2049])
def test_build_planes_past_1024_groups_matches_reference_host_lane(n_groups):
    """Past 1,024 groups (an inverse view's chunk: one group per distinct
    column) the port's lane equals the reference's host lane.  The
    reference's jitted lane is not the yardstick there: without jax's
    64-bit mode its int64 keys become int32, and its pads' sentinel
    (from 1,025 groups) and its keys (from 2,049) overflow."""
    rng = np.random.default_rng(n_groups)
    rows = rng.permutation(n_groups).astype(np.uint64)
    cols = rng.integers(0, SLICE_WIDTH, size=n_groups).astype(np.uint64)
    want = jbuild.build_planes_numpy(rows, cols)
    _assert_same(build.build_planes_torch(rows, cols, "cpu"), want)
    _assert_same(TorchEngine("cpu").build_planes(rows, cols), want)


def _assert_same_overlay(view, jview):
    """Every fragment's pending bulk planes equal, row for row."""
    assert sorted(view.fragments) == sorted(jview.fragments)
    for s in view.fragments:
        ov, jov = view.fragment(s)._bulk_planes, jview.fragment(s)._bulk_planes
        assert sorted(ov) == sorted(jov), s
        for r, plane in ov.items():
            assert np.array_equal(plane, jov[r]), (s, r)


@pytest.mark.parametrize("inverse", [False, True], ids=["standard", "inverse"])
def test_apply_bulk_matches_jax_and_streamed(tmp_path, monkeypatch, inverse):
    """test_bulk.py:333's seeded chunks (seed 11, 20,000 pairs, 4,096-pair
    chunks) through the port's bulk door on TorchEngine("cpu") and the
    JAX bulk door: the pending overlays equal plane for plane; then every
    fragment checksum of the port's bulk frame equals the JAX and the
    port streamed doors' (and, standard view, the JAX bulk frame's).  The
    JAX door runs on JaxEngine for the standard view; the inverse view's
    chunks build up to 4,096 groups, past what the reference's jitted
    lane builds right (see the test above), so there it takes the
    reference's host lane."""
    calls = []

    def counted(keys, n_groups, _o=kernels.build_planes):
        calls.append(len(keys))
        return _o(keys, n_groups)

    monkeypatch.setattr(kernels, "build_planes", counted)
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 40, size=20000).astype(np.uint64)
    cols = rng.integers(0, 3 * SLICE_WIDTH, size=20000).astype(np.uint64)
    h = Holder(str(tmp_path / "t"))
    jh = JHolder(str(tmp_path / "j"))
    h.open()
    jh.open()
    try:
        opts = FrameOptions(inverse_enabled=inverse)
        fb = h.create_index("i").create_frame("b", opts)
        fs = h.index("i").create_frame("s", opts)
        jopts = JFrameOptions(inverse_enabled=inverse)
        jf = jh.create_index("i").create_frame("b", jopts)
        js = jh.index("i").create_frame("s", jopts)
        eng, jeng = TorchEngine("cpu"), None if inverse else JaxEngine()
        for i in range(0, len(rows), 4096):
            assert ingress.apply_bulk(fb, rows[i:i + 4096], cols[i:i + 4096], engine=eng) == \
                jingress.apply_bulk(jf, rows[i:i + 4096], cols[i:i + 4096], engine=jeng)
        assert len(calls) == -(-len(rows) // 4096) * (2 if inverse else 1)
        for vname in _views(inverse):
            _assert_same_overlay(fb.view(vname), jf.view(vname))
            if inverse:
                # Compared plane for plane; the JAX frame's close would
                # otherwise materialize its ~20,000 inverse planes through
                # the reference's unpacking of every bit of each.
                for s in jf.view(vname).fragments:
                    jf.view(vname).fragment(s)._bulk_planes.clear()
        ingress.complete_bulk(fb)
        ingest.apply_columnar(fs, rows, cols)
        ingest.recalc_frame_caches(fs)
        jingest.apply_columnar(js, rows, cols)
        for vname in _views(inverse):
            vb, vs, vj = fb.view(vname), fs.view(vname), js.view(vname)
            assert sorted(vb.fragments) == sorted(vs.fragments) == sorted(vj.fragments)
            for s in vb.fragments:
                want = vj.fragment(s).checksum()
                assert vb.fragment(s).checksum() == want, f"{vname}/{s}"
                assert vs.fragment(s).checksum() == want, f"{vname}/{s} streamed"
                if not inverse:
                    assert jf.view(vname).fragment(s).checksum() == want, f"{vname}/{s} jax bulk"
    finally:
        h.close()
        jh.close()


def test_plane_positions_matches_reference():
    """The port's plane_positions (the overlay's materialization and the
    Arrow egress) equals the reference's on empty, full, random and
    sparse planes."""
    rng = np.random.default_rng(26)
    sparse = np.zeros(W, dtype=np.uint32)
    idx = rng.choice(SLICE_WIDTH, size=2000, replace=False)
    np.bitwise_or.at(sparse, idx // 32, np.left_shift(np.uint32(1), (idx % 32).astype(np.uint32)))
    for words in (np.zeros(W, dtype=np.uint32), np.full(W, 0xFFFFFFFF, dtype=np.uint32),
                  rng.integers(0, 1 << 32, size=W, dtype=np.uint64).astype(np.uint32), sparse):
        for base in (0, 5 * SLICE_WIDTH):
            got, want = build.plane_positions(words, base), jbuild.plane_positions(words, base)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_numpy_engine_keeps_the_sparse_lane(tmp_path, monkeypatch):
    """A NumpyEngine server commits through build_words: no plane build."""
    monkeypatch.setattr(kernels, "build_planes", None)
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        fr = h.create_index("i").create_frame("f", FrameOptions())
        assert ingress.apply_bulk(fr, _u64([1, 1, 2]), _u64([5, 9, 7]), engine=NumpyEngine()) == 3
        assert fr.view("standard").fragment(0).row_count(1) == 2
    finally:
        h.close()


# -- twins of tests/test_bulk.py ------------------------------------------------

def test_apply_bulk_empty_and_slice_growth(tmp_path):
    """test_bulk.py:242: a zero-pair chunk commits nothing, and a later
    chunk touching new slices grows the fragment set, on TorchEngine."""
    h = Holder(str(tmp_path / "d"))
    h.open()
    eng = TorchEngine("cpu")
    try:
        fr = h.create_index("i").create_frame("f", FrameOptions())
        assert ingress.apply_bulk(fr, [], [], engine=eng) == 0
        std = fr.view("standard")
        assert std is None or not std.fragments
        ingress.apply_bulk(fr, _u64([1, 2]), _u64([5, 6]), engine=eng)
        assert sorted(fr.view("standard").fragments) == [0]
        ingress.apply_bulk(fr, _u64([1]), _u64([2 * SLICE_WIDTH + 7]), engine=eng)
        assert sorted(fr.view("standard").fragments) == [0, 2]
        assert fr.view("standard").fragment(2).row_count(1) == 1
    finally:
        h.close()


@pytest.fixture
def frag(tmp_path):
    f = Fragment(str(tmp_path / "0"), "i", "f", "standard", 0, cache_type="ranked")
    f.open()
    yield f
    if f._open:
        f.close()


def _commit_planes(f, rows, cols):
    s, r, planes = TorchEngine("cpu").build_planes(rows, cols)
    assert set(s.tolist()) <= {0}
    return f.bulk_set_planes(r, planes)


def test_close_with_debt_persists(tmp_path):
    """test_bulk.py:269, the overlay committed as dense planes."""
    f = Fragment(str(tmp_path / "0"), "i", "f", "standard", 0)
    f.open()
    _commit_planes(f, _u64([7, 7]), _u64([100, 200]))
    assert f._bulk_planes
    f.close()
    g = Fragment(f.path, "i", "f", "standard", 0)
    g.open()
    try:
        assert g.contains(7, 100) and g.contains(7, 200)
    finally:
        g.close()


def test_ledger_tracks_debt_and_budget_drain(frag):
    """test_bulk.py:288."""
    _commit_planes(frag, _u64([1]), _u64([5]))
    assert LEDGER.pending_count() >= 1
    assert LEDGER.materialize_some(0) == 0
    assert frag._bulk_planes
    assert LEDGER.materialize_some(5000) >= 1
    assert not frag._bulk_planes
    assert LEDGER.pending_count() == 0
    assert LEDGER.materialize_some(5000) == 0


def test_ledger_weakref_never_pins_fragments():
    """test_bulk.py:304."""
    import gc

    led = MaterializationLedger()

    class _F:
        def materialize_bulk(self):
            pass

    f = _F()
    led.note_pending(f)
    assert led.pending_count() == 1
    del f
    gc.collect()
    assert led.pending_count() == 0


def test_global_ledger_pays_on_touch(frag):
    """test_bulk.py:322."""
    before = LEDGER.pending_count()
    _commit_planes(frag, _u64([2]), _u64([9]))
    assert LEDGER.pending_count() == before + 1
    frag.checksum()
    assert LEDGER.pending_count() == before


def test_bulk_route_classifies_as_write():
    """test_bulk.py:368."""
    assert classify_request("POST", "/index/i/frame/f/bulk", b"") == CLASS_WRITE


# -- HTTP: a JAX server and a port server fed the same chunks -------------------

@pytest.fixture
def servers():
    with tempfile.TemporaryDirectory() as d:
        js = JServer(JConfig(data_dir=d + "/jax", host="127.0.0.1:0", engine="jax",
                             stats="expvar", qcache_enabled=False))
        ts = Server(Config(data_dir=d + "/torch", host="127.0.0.1:0", engine="torch:cpu",
                           stats="expvar", qcache_enabled=False))
        js.open()
        ts.open()
        try:
            assert ts.executor.engine.name == "torch" and ts.executor.engine.device.type == "cpu"
            for s in (js, ts):
                c = Client(s.host)
                c.create_index("i")
                c.create_frame("i", "f")
            yield js, ts
        finally:
            js.close()
            ts.close()


def _raw(host, method, path, body=b"", headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body or None, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _both(servers, method, path, body=b"", headers=None):
    """The same request to both servers: byte-identical answers."""
    js, ts = servers
    got = _raw(ts.host, method, path, body, headers)
    assert got == _raw(js.host, method, path, body, headers), path
    return got


def _query(servers, pql):
    status, body = _both(servers, "POST", "/index/i/query", pql.encode())
    assert status == 200, body
    return json.loads(body)["results"]


def _chunks(servers, frame, rows, cols, chunk_pairs, door="bulk"):
    """POST the same packed chunks to both servers' ``door``: every
    answer byte-identical.  Returns the last answer."""
    frames = [ingest.encode_packed(rows[i:i + chunk_pairs], cols[i:i + chunk_pairs])
              for i in range(0, len(rows), chunk_pairs)]
    assert frames == [jingest.encode_packed(rows[i:i + chunk_pairs], cols[i:i + chunk_pairs])
                      for i in range(0, len(rows), chunk_pairs)]
    total = sum(len(f) for f in frames)
    crc = 0
    for f in frames:
        crc = zlib.crc32(f, crc)
    off = 0
    for f in frames:
        status, body = _both(servers, "POST", f"/index/i/frame/{frame}/{door}?off={off}"
                             f"&total={total}&crc={crc}&ccrc={zlib.crc32(f)}", f)
        assert status == 200, body
        off += len(f)
    return json.loads(body)


def test_bulk_end_to_end_http(servers, monkeypatch):
    """test_bulk.py:388 on both servers: the bulk door's answers, served
    reads of the overlay and TopN byte-identical; the port's bulk frame
    equal by checksum to its streamed twin and to the JAX server's."""
    js, ts = servers
    calls = []

    def counted(keys, n_groups, _o=kernels.build_planes):
        calls.append(len(keys))
        return _o(keys, n_groups)

    monkeypatch.setattr(kernels, "build_planes", counted)
    rng = np.random.default_rng(12)
    rows = rng.integers(0, 30, size=20000).astype(np.uint64)
    cols = rng.integers(0, 2 * SLICE_WIDTH, size=20000).astype(np.uint64)
    out = _chunks(servers, "f", rows, cols, 4096)
    assert out["done"] and out["ops"] == 20000
    assert len(calls) == 5
    assert _query(servers, 'Count(Bitmap(rowID=7, frame="f"))')[0] == len(np.unique(cols[rows == 7]))
    uniq = {int(x): len(np.unique(cols[rows == x])) for x in np.unique(rows)}
    top = _query(servers, 'TopN(frame="f", n=1)')[0]
    assert top[0]["count"] == max(uniq.values())
    _query(servers, 'Count(Intersect(Bitmap(rowID=3, frame="f"), Bitmap(rowID=4, frame="f"))) '
                    'TopN(Bitmap(rowID=2, frame="f"), frame="f", n=5)')
    for s in (js, ts):
        Client(s.host).create_frame("i", "g")
    assert _chunks(servers, "g", rows, cols, 4096, door="ingest")["done"]
    idx, jidx = ts.holder.index("i"), js.holder.index("i")
    for sl in sorted(idx.frame("g").view("standard").fragments):
        want = jidx.frame("f").view("standard").fragment(sl).checksum()
        assert idx.frame("f").view("standard").fragment(sl).checksum() == want
        assert idx.frame("g").view("standard").fragment(sl).checksum() == want
    v = json.loads(_raw(ts.host, "GET", "/debug/vars")[1])
    assert v["bulk.pairs"] >= 20000
    flat = json.dumps(v)
    assert "bulk.commit_rows" in flat and "bulk.build" in flat


def test_arrow_export_reingest_roundtrip(servers):
    """test_bulk.py:419 on both servers: the Arrow export bytes equal, and
    an export re-ingested through the bulk door exports the same bytes."""
    js, ts = servers
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 20, size=5000).astype(np.uint64)
    cols = rng.integers(0, SLICE_WIDTH, size=5000).astype(np.uint64)
    assert _chunks(servers, "f", rows, cols, 65536)["done"]
    status, a = _both(servers, "GET", "/export?index=i&frame=f&view=standard&slice=0&format=arrow")
    assert status == 200
    assert a == egress.encode_arrow_pairs(*ts.holder.fragment("i", "f", "standard", 0).export_pairs())
    for s in (js, ts):
        Client(s.host).create_frame("i", "rt")
    crc = zlib.crc32(a)
    status, body = _both(servers, "POST", f"/index/i/frame/rt/bulk?off=0&total={len(a)}&crc={crc}"
                         f"&ccrc={crc}", a, {"Content-Type": ingest.ARROW_CONTENT_TYPE})
    assert status == 200 and json.loads(body)["done"]
    status, b = _both(servers, "GET", "/export?index=i&frame=rt&view=standard&slice=0&format=arrow")
    assert a == b
    r2, c2 = ingest.decode_arrow(a)
    assert sorted(set(zip(r2.tolist(), c2.tolist()))) == sorted(set(zip(rows.tolist(), cols.tolist())))
    # The port's client round trip: its bulk_stream with Arrow chunks.
    c = Client(ts.host)
    c.create_frame("i", "rc")
    assert c.bulk_stream("i", "rc", r2, c2, arrow=True)["done"]
    assert c.export_arrow("i", "rc", "standard", 0) == a


def test_arrow_ingest_hardening_http(servers):
    """test_bulk.py:440 on both servers: extra columns and dictionary-
    encoded ids apply; a missing column answers the same pointed 400."""
    import io

    import pyarrow as pa

    t = pa.table({
        "row": pa.array([1, 1, 2], type=pa.int32()).dictionary_encode(),
        "col": np.array([10, 11, 12], dtype=np.uint64),
        "extra": ["a", "b", "c"],
    })
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    body = sink.getvalue()
    crc = zlib.crc32(body)
    hdr = {"Content-Type": ingest.ARROW_CONTENT_TYPE}
    status, out = _both(servers, "POST", f"/index/i/frame/f/bulk?off=0&total={len(body)}&crc={crc}"
                        f"&ccrc={crc}", body, hdr)
    assert status == 200 and json.loads(out)["done"]
    assert _query(servers, 'Count(Bitmap(rowID=1, frame="f"))')[0] == 2
    t2 = pa.table({"row": np.array([1, 1, 2], dtype=np.uint64)})
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, t2.schema) as w:
        w.write_table(t2)
    body = sink.getvalue()
    crc = zlib.crc32(body)
    status, out = _both(servers, "POST", f"/index/i/frame/f/bulk?off=0&total={len(body)}&crc={crc}"
                        f"&ccrc={crc}", body, hdr)
    assert status == 400 and b"col" in out
    _, ts = servers
    with pytest.raises(ClientError) as ei:
        Client(ts.host).ingest_chunk("i", "f", 0, len(body), crc, body, ccrc=crc, door="bulk",
                                     arrow=True)
    assert ei.value.status == 400 and "col" in str(ei.value)


def test_arrow_egress_without_pyarrow_answers_415(monkeypatch):
    """No pyarrow: the egress raises IngestError 415, as the reference's."""
    import builtins

    real = builtins.__import__

    def no_pyarrow(name, *a, **k):
        if name == "pyarrow":
            raise ImportError("no pyarrow")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ingest.IngestError) as ei:
        egress.encode_arrow_pairs(_u64([1]), _u64([2]))
    assert ei.value.status == 415


def test_positions_to_pairs_matches_jax():
    from pilosa_tpu.bulk import egress as jegress

    pos = _u64([0, 5, SLICE_WIDTH + 3, 7 * SLICE_WIDTH - 1])
    for a, b in zip(egress.positions_to_pairs(pos, 3), jegress.positions_to_pairs(pos, 3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
