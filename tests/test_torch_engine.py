"""TorchEngine("cpu") against the JAX package's JaxEngine on the CPU.

Same seeded numpy inputs through both engines' protocol methods: storage
updates, counts, the Gram and its rank-k repair.  Integer counts and
words, so every comparison is exact (tolerance 0).  Also holds the
copy-on-write contract the row pool's snapshots rely on.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu.engine import JaxEngine
from pilosa_tpu_torch.engine import NumpyEngine, TorchEngine, new_engine

S, R, W = 3, 8, 1024
OPS = ("and", "or", "xor", "andnot")


@pytest.fixture(scope="module")
def engines():
    return TorchEngine("cpu"), JaxEngine()


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _host(eng, m):
    """Engine matrix -> logical uint32[S, R, W] host array."""
    a = np.asarray(eng.to_numpy(m))
    return a.reshape(*a.shape[:2], -1) if a.ndim == 4 else a


def test_matrix_roundtrip_keeps_uint32_words(engines):
    te, _ = engines
    host = _words(np.random.default_rng(0), (S, R, W))
    m = te.matrix(host)
    assert m.dtype == torch.int32 and tuple(m.shape) == (S, R, W)
    out = te.to_numpy(m)
    assert out.dtype == np.uint32
    np.testing.assert_array_equal(out, host)
    assert te.stat_upload_bytes == host.nbytes
    gram = np.arange(4, dtype=np.int64).reshape(2, 2)
    np.testing.assert_array_equal(te.to_numpy(gram), gram)  # numpy passes through


_STORAGE = {
    "set_rows_at": lambda e, m, rng: e.set_rows_at(m, [5, 1], _words(rng, (S, 2, W))),
    "set_plane_rows": lambda e, m, rng: e.set_plane_rows(m, [2, 0], [3, 6], _words(rng, (2, 2, W))),
    "update_slices": lambda e, m, rng: e.update_slices(m, [1], _words(rng, (1, R, W))),
    "set_rows": lambda e, m, rng: e.set_rows(m, 4, _words(rng, (S, 3, W))),
    "grow_rows": lambda e, m, rng: e.grow_rows(m, 4),
    "append_rows": lambda e, m, rng: e.append_rows(m, _words(rng, (S, 2, W))),
}


@pytest.mark.parametrize("op", sorted(_STORAGE))
def test_storage_update_matches_jax_and_copies_on_write(engines, op):
    """Each update equals JaxEngine's functional update, and the input
    matrix (a reader's snapshot) is left untouched."""
    te, je = engines
    host = _words(np.random.default_rng(1), (S, R, W))
    tm = te.matrix(host)
    before = tm.clone()
    got = _STORAGE[op](te, tm, np.random.default_rng(2))
    want = _STORAGE[op](je, je.matrix(host), np.random.default_rng(2))
    np.testing.assert_array_equal(_host(te, got), _host(je, want))
    assert torch.equal(tm, before), f"{op} mutated its input matrix"
    assert got.data_ptr() != tm.data_ptr()


def test_pool_snapshot_survives_later_writes(engines):
    """A reader holding (positions, matrix) keeps consistent counts while
    the pool pages new rows into the same slots."""
    te, _ = engines
    rng = np.random.default_rng(3)
    host = _words(rng, (S, R, W))
    snap = te.matrix(host)
    pairs = np.array([[0, 1], [2, 3]], dtype=np.int32)
    first = te.gather_count("and", snap, pairs)
    newer = te.set_rows_at(snap, [0, 1, 2, 3], _words(rng, (S, 4, W)))
    newer = te.set_plane_rows(newer, [0], [1], _words(rng, (1, 1, W)))
    np.testing.assert_array_equal(te.gather_count("and", snap, pairs), first)
    np.testing.assert_array_equal(_host(te, snap), host)


def test_counts_match_jax(engines):
    te, je = engines
    rng = np.random.default_rng(4)
    host = _words(rng, (S, R, W))
    tm, jm = te.matrix(host), je.matrix(host)
    stack = _words(rng, (S, W))
    got = te.count(te.asarray(stack))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, je.count(je.asarray(stack)))
    rows, src = host[1, [0, 3, 5]], host[2, 7]
    np.testing.assert_array_equal(
        te.batch_intersection_count(te.asarray(rows), te.asarray(src)),
        je.batch_intersection_count(je.asarray(rows), je.asarray(src)),
    )
    pos = np.array([4, 0, 7, 4], dtype=np.int32)
    src_stack = _words(rng, (S, W))
    np.testing.assert_array_equal(
        te.topn_scorer_counts(tm, pos, te.prepare_topn_src(src_stack)),
        je.topn_scorer_counts(jm, pos, je.prepare_topn_src(src_stack)),
    )
    assert te.count(te.asarray(np.zeros((0, W), np.uint32))).shape == (0,)


@pytest.mark.parametrize("b", [2, 9], ids=["gather", "resident"])
@pytest.mark.parametrize("op", OPS)
def test_gather_count_matches_jax(engines, op, b):
    te, je = engines
    rng = np.random.default_rng(b + OPS.index(op))
    host = _words(rng, (S, R, W))
    pairs = rng.integers(0, R, size=(b, 2), dtype=np.int32)
    tm, jm = te.matrix(host), je.matrix(host)
    got = te.gather_count(op, tm, pairs)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, je.gather_count(op, jm, pairs))
    np.testing.assert_array_equal(te.to_numpy(te.gather_count_dev(op, tm, pairs)), got)


def test_multi_and_tree_lanes_match_jax_on_cpu(engines):
    te, je = engines
    rng = np.random.default_rng(5)
    host = _words(rng, (S, R, W))
    tm, jm = te.matrix(host), je.matrix(host)
    idx = rng.integers(0, R, size=(4, 3), dtype=np.int32)
    for op in ("and", "or", "andnot"):
        np.testing.assert_array_equal(
            te.gather_count_multi(op, tm, idx), je.gather_count_multi(op, jm, idx)
        )
    leaves = rng.integers(0, R, size=(3, 4), dtype=np.int32)
    opc = rng.integers(0, 5, size=(3, 3), dtype=np.int32)
    np.testing.assert_array_equal(
        te.gather_count_tree(tm, leaves, opc), je.gather_count_tree(jm, leaves, opc)
    )


def test_pair_gram_matches_jax(engines):
    te, je = engines
    host = _words(np.random.default_rng(6), (S, R, W))
    got = te.pair_gram(te.matrix(host))
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, je.pair_gram(je.matrix(host)))


@pytest.mark.parametrize("mode", ["full", "delta"])
def test_gram_update_rows_matches_jax(engines, mode):
    """Rank-k repair after rewriting rows 2 and 5 in slice 1: full
    recompute, and the per-(row, slice) delta over the written slice.
    Both equal JaxEngine's repair and a from-scratch Gram."""
    te, je = engines
    s = 4
    rng = np.random.default_rng(7)
    old = _words(rng, (s, R, W))
    new = old.copy()
    new[1, [2, 5]] = _words(rng, (2, W))
    gram = te.pair_gram(te.matrix(old))
    gram0 = gram.copy()
    kw = dict(old_matrix=None, slice_idxs=None)
    jkw = dict(kw)
    if mode == "delta":
        kw = dict(old_matrix=te.matrix(old), slice_idxs=[1])
        jkw = dict(old_matrix=je.matrix(old), slice_idxs=[1])
    got = te.gram_update_rows(te.matrix(new), gram, [5, 2], **kw)
    want = je.gram_update_rows(je.matrix(new), gram, [5, 2], **jkw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, te.pair_gram(te.matrix(new)))
    np.testing.assert_array_equal(gram, gram0)  # readers' old Gram is untouched


def test_engine_factory_and_devices():
    assert isinstance(new_engine("numpy"), NumpyEngine)
    with pytest.raises(ValueError):
        new_engine("jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TorchEngine("cuda")
    te = TorchEngine("cpu")
    assert te.wants_static_shapes is False
    # Off on the CPU (the lane would only transpose back there), as the
    # reference's is off the TPU; the int32 slice bound admits 4 slices.
    assert te.supports_row_major_gather is False
    assert te.rowmajor_ok(4, W) is True
    # The bulk build lane is ported: the plain version on the CPU.
    got = te.build_planes(np.array([2, 2], np.uint64), np.array([5, 37], np.uint64))
    want = NumpyEngine().build_planes(np.array([2, 2], np.uint64), np.array([5, 37], np.uint64))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        te.batch_intersection_count(te.asarray(np.zeros((2, W), np.uint32)),
                                    te.asarray(np.zeros(W, np.uint32)), tiled=True)
