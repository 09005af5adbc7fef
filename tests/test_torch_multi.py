"""The staged multi fold (``resident_count_multi``) against the JAX package.

``resident_count_multi`` compacts the rows a batch of K-operand folds
names on the host (``kernels.compact_rows``) before its kernel stages
those rows through shared memory, over a slice-major [S, R, W] or a
row-major [R, S, W] matrix; on the CPU the wrapper runs the same remap
and then the plain fold over the compacted rows.  These tests hold that
path, and the multi dispatch's choice between the staged and the gather
kernels, against ``fused_gather_count_multi`` and
``fused_gather_count_multi_rowmajor`` in interpret mode, exactly (integer
counts, tolerance 0): and / or / andnot, K = 1 to 23, padded and
unpadded id lists, duplicate ids within a query and unreferenced rows.
They also pin the tilings the wrapper hands the kernel and the gate's
admitted set.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pilosa_tpu.ops import bitwise as jbw
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitwise, dispatch, kernels

LAYOUTS = ("slice", "row")
W = 32768


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _matrix(rm, layout):
    """The port's matrix of a slice-major uint32[S, R, W] in ``layout``."""
    return bitwise.to_words(rm if layout == "slice" else rm.transpose(1, 0, 2))


def _pallas(op, rm, idx, layout):
    """The Pallas fold over the same rows, in interpret mode."""
    if layout == "slice":
        return np.asarray(pk.fused_gather_count_multi(
            op, jnp.asarray(rm), jnp.asarray(idx), interpret=True))
    s, r, w = rm.shape
    tiled = jnp.asarray(np.ascontiguousarray(rm.transpose(1, 0, 2)).reshape(r, s, w // 128, 128))
    return np.asarray(pk.fused_gather_count_multi_rowmajor(op, tiled, jnp.asarray(idx), interpret=True))


def _pad(rng, idx, op, width):
    """Pad each query's ids the executor's way: repeat an operand the
    fold ignores a second time (and / or: any; andnot: any but the
    first)."""
    b, k = idx.shape
    lo = 1 if (op == "andnot" and k > 1) else 0
    extra = idx[np.arange(b)[:, None], rng.integers(lo, k, size=(b, width - k))]
    return np.concatenate([idx, extra], axis=1).astype(np.int32)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", [1, 2, 3, 5, 16, 23])
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_resident_count_multi_matches_pallas(op, k, layout):
    """Unpadded and padded id lists over a small pool (duplicate ids within
    a query are common there) give the Pallas fold's counts."""
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), k, len(layout)])
    s, r, b, w = 2, 12, 5, 1024
    rm = _words(rng, (s, r, w))
    idx = rng.integers(0, r, size=(b, k), dtype=np.int32)
    want = _pallas(op, rm, idx, layout)
    m = _matrix(rm, layout)
    got = kernels.resident_count_multi(op, m, idx, row_major=layout == "row")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if op == "andnot" and k == 1:
        return  # a lone Difference operand has no pad: a repeat of it clears the fold
    padded = _pad(rng, idx, op, k + 3)
    np.testing.assert_array_equal(
        kernels.resident_count_multi(op, m, padded, row_major=layout == "row").numpy(), want)
    np.testing.assert_array_equal(kernels.resident_count_multi_plain(
        op, m, padded, row_major=layout == "row").numpy(), want)


def _case(rng, case, r, b, k):
    if case == "duplicates":  # every query names one of three rows, many times
        return rng.integers(0, 3, size=(b, k)).astype(np.int32)
    if case == "unreferenced":  # only the top quarter of the pool is named
        return rng.integers(3 * r // 4, r, size=(b, k)).astype(np.int32)
    return rng.integers(0, r, size=(b, k)).astype(np.int32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", ["duplicates", "unreferenced"])
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_resident_count_multi_edge_cases_match_pallas(op, case, layout):
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), len(case), len(layout), 9])
    s, r, b, k, w = 2, 16, 6, 7, 1024
    rm = _words(rng, (s, r, w))
    idx = _case(rng, case, r, b, k)
    ids, local = kernels.compact_rows(idx, r, "idx")
    assert ids.size <= r // 4
    want = _pallas(op, rm, idx, layout)
    np.testing.assert_array_equal(
        kernels.resident_count_multi(op, _matrix(rm, layout), idx, row_major=layout == "row").numpy(),
        want)
    # The compacted rows and the remapped ids fold to the same counts.
    np.testing.assert_array_equal(jbw.np_gather_count_multi(op, rm[:, ids], local), want)


def _spy(monkeypatch):
    seen = []
    for name in ("resident_count_multi", "gather_count_multi", "gather_count_multi_rowmajor"):
        def spy(*a, _o=getattr(kernels, name), _n=name, **kw):
            seen.append(_n)
            return _o(*a, **kw)
        monkeypatch.setattr(kernels, name, spy)
    return seen


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_multi_dispatch_matches_pallas(op, layout, monkeypatch):
    """A batch of 64 folds of about 18 distinct operands naming few rows
    many times takes the staged kernel; a sparse one, one of six-operand
    folds however few rows it names, and one of 16-operand folds over 8
    rows (8 distinct operands at most) the gather kernel of its layout;
    all equal Pallas."""
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), len(layout), 5])
    s, w = 2, 1024
    entry = dispatch.gather_count_multi if layout == "slice" else dispatch.gather_count_multi_rowmajor
    gather = "gather_count_multi" if layout == "slice" else "gather_count_multi_rowmajor"
    for r, b, k, staged in ((40, 64, 24, True), (96, 3, 4, False), (8, 64, 4, False),
                            (8, 64, 16, False)):
        rm = _words(rng, (s, r, w))
        idx = _pad(rng, rng.integers(0, r, size=(b, k)), op, k + 2)
        u = len(np.unique(idx))
        assert dispatch.multi_strategy(u, w, b, k + 2, s, dispatch.fold_refs(idx)) == staged
        seen = _spy(monkeypatch)
        got = entry(op, _matrix(rm, layout), idx)
        monkeypatch.undo()
        assert seen == ["resident_count_multi" if staged else gather]
        np.testing.assert_array_equal(got.numpy(), _pallas(op, rm, idx, layout))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_multi_dispatch_compacts_the_batch_once(layout, monkeypatch):
    """The gate and the staged kernel share one compaction of the ids; a
    batch the gate declines on B and K alone is not compacted at all."""
    rng = np.random.default_rng(6)
    rm = _words(rng, (2, 30, 1024))
    entry = dispatch.gather_count_multi if layout == "slice" else dispatch.gather_count_multi_rowmajor
    calls = []
    real = kernels.compact_rows
    monkeypatch.setattr(kernels, "compact_rows", lambda *a: calls.append(a) or real(*a))
    for b, k, compactions in ((64, 40, 1), (12, 5, 0)):
        calls.clear()
        idx = rng.integers(0, 30, size=(b, k)).astype(np.int32)
        got = entry("or", _matrix(rm, layout), idx).numpy()
        assert len(calls) == compactions
        np.testing.assert_array_equal(got, jbw.np_gather_count_multi("or", rm, idx))


@pytest.mark.parametrize("u,b,k,s,want", [
    (563, 128, 23, 64, (64, 1)),   # range-1: one stage of 64-word chunks
    (507, 128, 23, 64, (64, 1)),   # the timed Range batch
    (240, 128, 19, 64, (64, 2)),   # range-wide: two stages
    (850, 512, 16, 4, (64, 1)),    # the one-stage edge chip_smoke checks
    (900, 128, 23, 64, (0, 0)),    # no stage of 64-word chunks fits
    (250, 64, 16, 64, (64, 2)),    # the pool's K=16 batch
    (136, 64, 3, 64, (128, 2)),    # few rows: wider chunks
    (1024, 512, 16, 32, (0, 0)),   # every row of the tall pool: no stage fits
    (1800, 128, 4, 64, (0, 0)),    # no stage of 1,800 rows fits
])
def test_multi_tiling(u, b, k, s, want):
    assert kernels.multi_tiling(u, W, b, k, s) == want
    if want[0]:
        assert kernels.staged_smem_bytes(
            u, *want, kernels.multi_group_ints(b, k)) <= kernels.SMEM_BYTES


def test_multi_gate_needs_operands_references_reuse_and_a_tiling():
    """The gate reads distinct operands: a Range cover's pads count
    once."""
    kmin, refs, reuse = dispatch.MULTI_K_MIN, dispatch.MULTI_REFS_MIN, dispatch.MULTI_REUSE_MIN
    ms = dispatch.multi_strategy
    assert ms(240, W, 128, 19, 64, 2280)          # range-wide: 17.8 operands, 9.5 a row
    assert not ms(563, W, 128, 23, 64, 1482)      # range-1: 11.6 operands a fold
    assert not ms(435, W, 90, 23, 64, 875)        # range-2: 9.7
    assert not ms(100, W, 128, 23, 64, 128 * 10)  # 12.8 a row, but 10 operands
    assert ms(250, W, 64, 16, 64, 995)            # the pool's K=16: 15.5 operands, 4.0 a row
    assert not ms(136, W, 64, 3, 64, 64 * 3)      # http nary: K=3
    assert not ms(16, W, 128, 4, 64, 128 * 4)     # 32 a row, but K=4
    assert not ms(135, W, 45, 3, 32, 45 * 3)      # a tall-nary part
    assert not ms(640, W, 1, 640, 25, 640)        # the wide Union: once a row
    assert not ms(8, W, 16, 16, 64, 16 * 16)      # 256 references a group
    assert not ms(64, W, 128, 8, 64, 128 * 8)     # 16 a row, but K=8
    # B=512 K=16 names 512 rows 16 times, but every one of 4 groups stages them.
    assert ms(512, W, 512, 16, 32, 512 * 16) == (16 >= reuse * 7)
    assert ms(512, W, 256, 16, 32, 256 * 16)      # 2 groups, 8 a row
    assert not ms(820, W, 256, 16, 32, 256 * 16)  # 2 groups, 5 a row
    # The rows and offsets must fit.
    assert not ms(900, W, 128, 23, 64, 128 * 23)  # 3.3 a row, no stage fits
    assert not ms(4, 48, 64, 16, 64, 64 * 16)     # no chunk of 64+ words divides W
    for k in (kmin, 23, 64):
        b = max(-(-refs // k), 16)
        u = int(b * k // reuse)
        assert ms(u, W, b, k, 64, b * k) == (kernels.multi_tiling(u, W, b, k, 64)[0] > 0)
        assert not ms(u + 1, W, b, k, 64, b * k)
        # One operand fewer a fold on average than the gate asks.
        assert not ms(1, W, b, k, 64, b * (kmin - 1)) or kmin <= 1
    assert not ms(1, W, -(-refs // kmin) - 1, kmin, 64, (-(-refs // kmin) - 1) * kmin)


def test_resident_count_multi_checks_its_arguments():
    rm = torch.zeros((2, 4, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported multi-op"):
        kernels.resident_count_multi("xor", rm, np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="want \\[B, K >= 1\\]"):
        kernels.resident_count_multi("and", rm, np.zeros((1, 0), np.int32))
    with pytest.raises(ValueError, match="want \\[B, K >= 1\\]"):
        kernels.resident_count_multi("and", rm, np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="want 3 dims"):
        kernels.resident_count_multi("and", rm[0], np.zeros((1, 2), np.int32))
    with pytest.raises(IndexError, match="out of range"):
        kernels.resident_count_multi("or", rm, np.full((1, 2), 4, np.int32))
    with pytest.raises(IndexError, match="out of range"):  # row-major: R is the first dim
        kernels.resident_count_multi("or", rm, np.full((1, 2), 2, np.int32), row_major=True)
    assert kernels.resident_count_multi("or", rm, np.zeros((0, 3), np.int32)).shape == (0,)


@pytest.mark.parametrize("k", [1, 2, 5, 23])
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_fold_lists_drop_repeats_and_keep_the_counts(op, k):
    """The staged kernel's operand lists: each query's repeats dropped
    (andnot keeps its first operand apart), padded to a multiple of four
    with an operand the fold ignores, longest first; folding each row's
    first 4 x n_groups entries gives the unpadded counts."""
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), k, 8])
    s, r, b, w = 2, 6, 9, 64
    rm = _words(rng, (s, r, w))
    local = rng.integers(0, r, size=(b, k)).astype(np.int32)
    fop = "and" if k == 1 else op  # one operand folds as itself
    lists, n_groups, order = kernels.fold_lists(fop, local)
    assert lists.shape[1] % 4 == 0 and sorted(order.tolist()) == list(range(b))
    assert (np.diff(n_groups) <= 0).all() and n_groups.min() >= 1
    assert 4 * n_groups.max() == lists.shape[1] <= -(-min(k, r + 1) // 4) * 4
    got = np.zeros(b, dtype=np.int64)
    for row, q in enumerate(order):
        got[q] = jbw.np_gather_count_multi(fop, rm, lists[row:row + 1, :4 * n_groups[row]])[0]
    np.testing.assert_array_equal(got, jbw.np_gather_count_multi(fop, rm, local))
