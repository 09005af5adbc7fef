"""The row-major gather lane ("rmgather") and the whole-row TopN scorer:
the port against the JAX package on the same seeded numpy inputs.

Kernels: the port's wrappers on CPU tensors (their plain PyTorch
versions) against ``fused_gather_count2_rowmajor``,
``fused_gather_count_multi_rowmajor`` and ``fused_topn_counts`` in
interpret mode, the Pallas kernels taking the (8, 128)-tiled row-major
transpose.  The row-major storage updates against JaxEngine's.  The lane
as a whole: the port's executor on ``TorchEngine("cpu")`` with
``supports_row_major_gather`` forced on (the CPU engine leaves it off, as
the reference's does off the TPU) against the JAX executor forced the
same way and the numpy engine — pool paging, the stale-plane refresh
after a write, mixed pair and 3-operand groups, and slice streaming —
and the port's server pinned to the "rmgather" lane against the JAX
server under the same pin, byte for byte.  Integer counts: every
comparison is exact (tolerance 0).
"""

import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pilosa_tpu.engine as jengine_mod
from pilosa_tpu.config import Config as JConfig
from pilosa_tpu.core.frame import FrameOptions as JFrameOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.engine import JaxEngine
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.core.frame import FrameOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.engine import TorchEngine
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bitwise, dispatch, kernels
from pilosa_tpu_torch.pilosa import SLICE_WIDTH
from pilosa_tpu_torch.server.server import Server

OPS = ("and", "or", "xor", "andnot")
PQL = {"and": "Intersect", "or": "Union", "andnot": "Difference", "xor": "Xor"}
WORDS = SLICE_WIDTH // 32


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _tiled_rowmajor(rm):
    """Slice-major uint32[S, R, W] -> the Pallas kernels' row-major tiled
    [R, S, W/128, 128]."""
    s, r, w = rm.shape
    return jnp.asarray(np.ascontiguousarray(rm.transpose(1, 0, 2)).reshape(r, s, w // 128, 128))


def _rowmajor(rm):
    return bitwise.to_words(rm.transpose(1, 0, 2))


@pytest.mark.parametrize("w", [1024, 32768])
@pytest.mark.parametrize("op", OPS)
def test_gather_count2_rowmajor_matches_pallas(op, w):
    rng = np.random.default_rng([OPS.index(op), w, 3])
    s, r, b = 2, 16, 5
    rm = _words(rng, (s, r, w))
    pairs = rng.integers(0, r, size=(b, 2), dtype=np.int32)
    want = np.asarray(pk.fused_gather_count2_rowmajor(
        op, _tiled_rowmajor(rm), jnp.asarray(pairs), interpret=True))
    got = kernels.gather_count2_rowmajor(op, _rowmajor(rm), pairs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dispatch.gather_count_rowmajor(op, _rowmajor(rm), pairs).numpy(), want)
    np.testing.assert_array_equal(kernels.gather_count2(op, bitwise.to_words(rm), pairs).numpy(), want)


def _pad_multi(rng, idx, op, width):
    """Pad each query's ids the executor's way: repeat an operand the fold
    ignores (and/or: any; andnot: any but the first)."""
    b, k = idx.shape
    lo = 1 if (op == "andnot" and k > 1) else 0
    extra = idx[np.arange(b)[:, None], rng.integers(lo, k, size=(b, width - k))]
    return np.concatenate([idx, extra], axis=1).astype(np.int32)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_gather_count_multi_rowmajor_matches_pallas(op, k, padded):
    """The left fold over a row-major matrix (andnot folds ``acc & ~row``
    in the Pallas kernel, ``a & ~(b | c | ...)`` in the plain version);
    padded id lists give the unpadded counts."""
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), k, int(padded), 4])
    s, r, b, w = 3, 12, 7, 1024
    rm = _words(rng, (s, r, w))
    idx = rng.integers(0, r, size=(b, k), dtype=np.int32)
    ids = _pad_multi(rng, idx, op, k + 3) if padded else idx
    want = np.asarray(pk.fused_gather_count_multi_rowmajor(
        op, _tiled_rowmajor(rm), jnp.asarray(idx), interpret=True))
    np.testing.assert_array_equal(np.asarray(pk.fused_gather_count_multi_rowmajor(
        op, _tiled_rowmajor(rm), jnp.asarray(ids), interpret=True)), want)
    got = kernels.gather_count_multi_rowmajor(op, _rowmajor(rm), ids)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dispatch.gather_count_multi_rowmajor(op, _rowmajor(rm), ids).numpy(), want)


@pytest.mark.parametrize("shape", [(3, 20, 1024), (2, 16, 32768)], ids=["r20_w1024", "r16_w32768"])
def test_topn_counts_matches_pallas(shape):
    rng = np.random.default_rng(list(shape))
    s, r, w = shape
    rm = _words(rng, (s, r, w))
    src = _words(rng, (s, w))
    want = np.asarray(pk.fused_topn_counts(jnp.asarray(rm), jnp.asarray(src), interpret=True))
    got = kernels.topn_counts(bitwise.to_words(rm), bitwise.to_words(src))
    assert got.dtype == torch.int32 and tuple(got.shape) == (r,)
    np.testing.assert_array_equal(got.numpy(), want)


_RM_STORAGE = {
    "grow_rows_rm": lambda e, m, rng: e.grow_rows_rm(m, 3),
    "set_rows_at_rm": lambda e, m, rng: e.set_rows_at_rm(m, [5, 1], _words(rng, (2, 3, 1024))),
    "set_plane_rows_rm": lambda e, m, rng: e.set_plane_rows_rm(
        m, [2, 0], [3, 6], _words(rng, (2, 2, 1024))),
}


@pytest.mark.parametrize("op", sorted(_RM_STORAGE))
def test_rowmajor_storage_matches_jax_and_copies_on_write(op):
    """The row-major pool's storage updates ([cap, S, W]) equal
    JaxEngine's, and leave the input matrix (a reader's snapshot)
    untouched."""
    te, je = TorchEngine("cpu"), JaxEngine()
    host = _words(np.random.default_rng(8), (8, 3, 1024))
    tm = te.matrix_rows(host)
    before = tm.clone()
    got = _RM_STORAGE[op](te, tm, np.random.default_rng(9))
    want = np.asarray(je.to_numpy(_RM_STORAGE[op](je, je.matrix_rows(host), np.random.default_rng(9))))
    np.testing.assert_array_equal(te.to_numpy(got), want.reshape(*want.shape[:2], -1))
    assert torch.equal(tm, before), f"{op} mutated its input matrix"


def test_prefer_rowmajor_follows_the_resident_gate():
    """The engine's static gate is the reference's predicate over the
    port's resident gate: row-major exactly where the resident kernel
    does not serve and the slice count keeps int32 counts."""
    te = TorchEngine("cpu")
    assert te.prefer_rowmajor(512, 32, WORDS, 256, 2)   # 512 rows: no chunk fits shared memory
    assert not te.prefer_rowmajor(256, 64, WORDS, 256, 2)  # resident: R < 2B, 128-word chunk
    assert te.prefer_rowmajor(32, 64, WORDS, 16, 2)      # R == 2B: gather
    assert te.prefer_rowmajor(16, 64, WORDS, 0, 4)       # no pair group: folds always gather
    assert not te.prefer_rowmajor(512, 2048, WORDS, 256, 2)  # past the int32 slice bound
    assert dispatch.rowmajor_ok(2047, WORDS, 64) and not dispatch.rowmajor_ok(2048, WORDS)


# ---------------------------------------------------------------------------
# the lane through the executor
# ---------------------------------------------------------------------------

N_SLICES, N_ROWS, BITS = 2, 160, 12
# A 64-row pool at 2 slices: working sets of 128 rows page in parts.
POOL_BYTES = 64 * N_SLICES * WORDS * 4


def _load(holder, frame_options, seed=9):
    idx = holder.create_index("i")
    idx.create_frame("f", frame_options())
    fr = idx.frame("f")
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N_ROWS, dtype=np.uint64), BITS)
    for s in range(N_SLICES):
        cols = rng.integers(0, SLICE_WIDTH, size=len(rows)).astype(np.uint64)
        fr.import_bits(rows, cols + np.uint64(s * SLICE_WIDTH))


def _force_rowmajor(monkeypatch):
    """Both engines take the row-major lane on the CPU (off by default
    there: JaxEngine off the TPU, TorchEngine off the card)."""
    monkeypatch.setattr(jengine_mod.JaxEngine, "supports_row_major_gather", property(lambda self: True))
    monkeypatch.setattr(TorchEngine, "supports_row_major_gather", property(lambda self: True))


def _spy_rowmajor(monkeypatch):
    calls = {"pair": 0, "multi": 0}
    for name, key in (("gather_count2_rowmajor_plain", "pair"),
                      ("gather_count_multi_rowmajor_plain", "multi")):
        def spy(*a, _o=getattr(kernels, name), _k=key, **kw):
            calls[_k] += 1
            return _o(*a, **kw)

        monkeypatch.setattr(kernels, name, spy)
    return calls


def _bm(r):
    return f'Bitmap(rowID={int(r)}, frame="f")'


def _bodies(rng):
    perm = rng.permutation(N_ROWS)
    pairs = " ".join(
        f"Count({PQL[OPS[i % 4]]}({_bm(perm[2 * i])}, {_bm(perm[2 * i + 1])}))" for i in range(64))
    tri_ids = rng.integers(0, N_ROWS, size=(8, 3))
    tris = " ".join(
        f"Count({('Union', 'Intersect', 'Difference')[i % 3]}({', '.join(_bm(r) for r in t)}))"
        for i, t in enumerate(tri_ids))
    wide = rng.choice(N_ROWS, size=100, replace=False)
    stream = (f"Count(Union({', '.join(_bm(r) for r in wide)})) "
              f"Count(Intersect({_bm(wide[0])}, {_bm(wide[1])}))")
    # The last call's rows sit in the last part: resident after the batch.
    return {"pairs": pairs, "mixed": pairs + " " + tris, "stream": stream}, int(tri_ids[-1][0])


@pytest.mark.parametrize("scenario", ["pairs", "mixed", "write", "stream"])
def test_executor_rowmajor_lane_matches_jax(tmp_path, monkeypatch, scenario):
    """pairs: the flat pair lane pages 128 rows through a 64-row row-major
    pool; mixed: pair and 3-operand groups on the AST fused path, paging;
    write: a write to a resident row, then the mixed batch again (the
    pool refreshes the written plane); stream: one Union over 100 rows
    (more than the pool holds) streams its slices through row-major
    transients, one slice per chunk."""
    monkeypatch.setenv("PILOSA_TPU_POOL_BYTES", str(POOL_BYTES))
    _force_rowmajor(monkeypatch)
    calls = _spy_rowmajor(monkeypatch)
    jh, th = JHolder(str(tmp_path / "jax")), Holder(str(tmp_path / "torch"))
    jh.open()
    th.open()
    try:
        _load(jh, JFrameOptions)
        _load(th, FrameOptions)
        stream = 100 * WORDS * 4 if scenario == "stream" else 0
        ej = JExecutor(jh, no_gram=True, stream_bytes=stream)
        et = Executor(th, engine=TorchEngine("cpu"), no_gram=True, stream_bytes=stream)
        en = Executor(th, engine="numpy")
        bodies, written = _bodies(np.random.default_rng(21))
        body = bodies["mixed" if scenario == "write" else scenario]

        def same(q):
            got = et.execute("i", q)
            assert got == ej.execute("i", q), q[:160]
            assert got == en.execute("i", q), q[:160]

        same(body)
        pool = et._pool_for("i", "f", "standard", list(range(N_SLICES)), lane="rmgather")
        if scenario == "write":
            patched = pool.stat_patch_planes
            col = 5 + SLICE_WIDTH
            assert et.execute("i", f'SetBit(rowID={written}, frame="f", columnID={col})') == [True]
            assert ej.execute("i", f'SetBit(rowID={written}, frame="f", columnID={col})') == [True]
            same(body)
            assert pool.stat_patch_planes > patched  # set_plane_rows_rm refreshed the plane
            assert tf_checksums(th) == tf_checksums(jh)
        if scenario == "stream":
            assert calls["multi"] == 2  # one per slice chunk
        else:
            assert pool.row_major and pool.cap == 64
            assert pool.stat_evictions > 0  # 128 rows paged through 64 slots
            assert calls["pair"] > 0
            assert calls["multi"] > 0 or scenario == "pairs"
    finally:
        jh.close()
        th.close()


def tf_checksums(holder):
    return [holder.fragment("i", "f", "standard", s).checksum() for s in range(N_SLICES)]


# ---------------------------------------------------------------------------
# the lane through the server, pinned by the planner
# ---------------------------------------------------------------------------

def _post(host, path, body):
    req = urllib.request.Request(f"http://{host}{path}", data=body or None, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_server_pinned_rmgather_matches_jax(tmp_path, monkeypatch):
    """Both servers with ``planner_pin_lane="rmgather"``: pair, N-ary and
    mixed batches, a write and a re-query answer with byte-identical
    bodies, and the port's answers ran through the row-major lane."""
    _force_rowmajor(monkeypatch)
    calls = _spy_rowmajor(monkeypatch)
    js = JServer(JConfig(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", engine="jax",
                         planner_pin_lane="rmgather"))
    ts = Server(Config(data_dir=str(tmp_path / "torch"), host="127.0.0.1:0", engine="torch:cpu",
                       planner_pin_lane="rmgather"))
    js.open()
    ts.open()
    try:
        assert ts.planner is not None and ts.planner.pin == "rmgather"
        rng = np.random.default_rng(31)
        sets = " ".join(
            f'SetBit(rowID={r}, frame="f", columnID={int(c) + s * SLICE_WIDTH})'
            for r in range(12) for s in range(2) for c in rng.integers(0, SLICE_WIDTH, size=30))
        ids = rng.integers(0, 12, size=(24, 3))
        pairs = " ".join(f"Count({PQL[OPS[i % 4]]}({_bm(a)}, {_bm(b)}))"
                         for i, (a, b, _) in enumerate(ids))
        nary = " ".join(f"Count({('Union', 'Intersect', 'Difference')[i % 3]}({_bm(a)}, {_bm(b)}, {_bm(c)}))"
                        for i, (a, b, c) in enumerate(ids))
        steps = [("/index/i", ""), ("/index/i/frame/f", ""), ("/index/i/query", sets),
                 ("/index/i/query", pairs), ("/index/i/query", nary),
                 ("/index/i/query", pairs + " " + nary),
                 ("/index/i/query", f'SetBit(rowID={ids[0][0]}, frame="f", columnID=9)'),
                 ("/index/i/query", pairs), ("/index/i/query", nary)]
        for path, body in steps:
            got = _post(ts.host, path, body.encode())
            assert got == _post(js.host, path, body.encode()), (path, body[:120])
        assert calls["pair"] > 0 and calls["multi"] > 0
    finally:
        js.close()
        ts.close()
