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
    (563, 128, 23, 64, (32, 2)),   # range-1, at the gate's bound on the plan
    (507, 128, 23, 64, (32, 3)),   # the timed Range batch
    (240, 128, 19, 64, (64, 3)),   # range-wide: three stages of 64 words
    (435, 90, 23, 64, (32, 3)),    # range-2
    (850, 512, 16, 4, (32, 1)),    # one stage of 32-word chunks
    (900, 128, 23, 64, (32, 1)),
    (250, 64, 16, 64, (64, 3)),    # the pool's K=16 batch
    (136, 64, 3, 64, (64, 3)),     # few rows
    (1024, 512, 16, 32, (32, 1)),  # every row of the tall pool: one stage
    (1600, 128, 23, 64, (32, 1)),  # the most rows one stage holds here
    (1700, 128, 23, 64, (0, 0)),   # no stage fits
    (1800, 128, 4, 64, (0, 0)),    # no stage of 1,800 rows fits
])
def test_multi_tiling(u, b, k, s, want):
    """The gate's tiling: at ``multi_group_ints``, which bounds the plan
    ints a block copies, the first of MULTI_TILINGS that fits."""
    own = kernels.multi_group_ints(b, k)
    assert kernels.multi_tiling(u, W, own) == want
    if want[0]:
        assert kernels.multi_smem_bytes(u, *want, own) <= kernels.SMEM_BYTES
        for t in kernels.MULTI_TILINGS[:kernels.MULTI_TILINGS.index(want)]:
            assert kernels.multi_smem_bytes(u, *t, own) > kernels.SMEM_BYTES
    assert kernels.multi_tiling(u, 48, own) == (0, 0)  # no 32-word chunk divides W


def test_multi_gate_needs_operands_references_reuse_and_a_tiling():
    """The gate reads distinct operands: a Range cover's pads count
    once."""
    kmin, refs, reuse = dispatch.MULTI_K_MIN, dispatch.MULTI_REFS_MIN, dispatch.MULTI_REUSE_MIN
    ms = dispatch.multi_strategy
    assert ms(240, W, 128, 19, 64, 2280)          # range-wide: 17.8 operands, 9.5 a row
    assert ms(563, W, 128, 23, 64, 1482)          # range-1: 11.6 operands a fold, 2.6 a row
    assert ms(435, W, 90, 23, 64, 875)            # range-2: 9.7, 2.01
    assert not ms(438, W, 90, 23, 64, 875)        # 1.99 a row
    assert not ms(100, W, 128, 23, 64, 128 * 8)   # 10.2 a row, but 8 operands
    assert ms(250, W, 64, 16, 64, 995)            # the pool's K=16: 15.5 operands, 4.0 a row
    assert not ms(136, W, 64, 3, 64, 64 * 3)      # http nary: K=3
    assert not ms(16, W, 128, 4, 64, 128 * 4)     # 32 a row, but K=4
    assert not ms(135, W, 45, 3, 32, 45 * 3)      # a tall-nary part
    assert not ms(640, W, 1, 640, 25, 640)        # the wide Union: once a row
    assert not ms(8, W, 16, 16, 64, 16 * 16)      # 256 references a group
    assert not ms(64, W, 128, 8, 64, 128 * 8)     # 16 a row, but K=8
    # B=512 K=16 names 512 rows 16 times, but every one of 4 blocks stages them.
    assert ms(512, W, 512, 16, 32, 512 * 16) == (16 >= reuse * 7)
    assert ms(4096 // (3 * reuse), W, 256, 16, 32, 256 * 16)  # 2 blocks, 3 x MULTI_REUSE_MIN a row
    assert not ms(4096 // (3 * reuse) + 1, W, 256, 16, 32, 256 * 16)
    assert not ms(820, W, 256, 16, 32, 256 * 16)  # 2 blocks, 5 a row
    # The rows and plan must fit two stages.
    assert kernels.multi_tiling(900, W, kernels.multi_group_ints(128, 23)) == (32, 1)
    assert not ms(900, W, 128, 23, 64, 128 * 23)  # 3.3 a row, but one stage only
    assert not ms(4, 48, 64, 16, 64, 64 * 16)     # no chunk of 32+ words divides W
    for k in (kmin, 23, 64):
        b = max(-(-refs // k), 16)
        u = int(b * k // reuse)
        two = kernels.multi_tiling(u, W, kernels.multi_group_ints(b, k))[1] >= 2
        assert ms(u, W, b, k, 64, b * k) == two
        assert not ms(u + 1, W, b, k, 64, b * k)
        # One operand fewer a fold on average than the gate asks.
        assert not ms(1, W, b, k, 64, b * (kmin - 1)) or kmin <= 1
    assert not ms(1, W, -(-refs // kmin) - 1, kmin, 64, (-(-refs // kmin) - 1) * kmin)


def test_multi_gate_reads_the_plans_sharing():
    """Past the shape clauses the gate reads the plan: groups whose rows
    are at most MULTI_SHARE_MAX of the references, or wide folds named
    often enough."""
    sh, share = dispatch.multi_shares, dispatch.MULTI_SHARE_MAX
    assert sh(831, 128, 563, 1482)                     # range-1: 0.56 of its references
    assert sh(int(share * 1000), 128, 400, 1000)
    assert not sh(int(share * 1000) + 1, 128, 400, 1000)
    assert sh(845, 64, 250, 995)                       # the pool's K=16: wide, 3.98 a row
    wide_k, wide_reuse = dispatch.MULTI_WIDE_K, dispatch.MULTI_WIDE_REUSE
    b, u = 64, 100
    refs = max(wide_k * b, wide_reuse * u)
    assert sh(refs, b, u, refs)
    assert not sh(refs, b, u, refs - 1)
    assert not sh(1000, 128, 512, 1024)                # random K=8 folds: little shared
    assert not sh(1020, 256, 300, 1024)                # two blocks at 3.4 a row


@pytest.mark.parametrize("layout", LAYOUTS)
def test_multi_gate_takes_range_batches_not_random_ones(layout, monkeypatch):
    """A Range-like batch (Counts of a few bitmap rows over overlapping
    spans) and a random one of the same width and references a row: the
    first shares its rows within groups and takes the staged kernel, the
    second the gather kernel; both equal Pallas."""
    rng = np.random.default_rng([len(layout), 13])
    s, w, bitmaps, views, k = 2, 1024, 4, 30, 12
    rm = _words(rng, (s, bitmaps * views, w))
    spans = np.empty((128, k), dtype=np.int32)
    for q in range(128):
        v0 = int(rng.integers(0, views - k + 1))
        spans[q] = (v0 + np.arange(k)) * bitmaps + q % bitmaps
    rand = np.stack([rng.choice(bitmaps * views, size=k, replace=False) for _ in range(128)])
    entry = dispatch.gather_count_multi if layout == "slice" else dispatch.gather_count_multi_rowmajor
    gather = "gather_count_multi" if layout == "slice" else "gather_count_multi_rowmajor"
    for idx, staged in ((spans[rng.permutation(128)], True), (rand.astype(np.int32), False)):
        ids, local = kernels.compact_rows(idx, bitmaps * views, "idx")
        refs = dispatch.fold_refs(local)
        assert dispatch.multi_strategy(ids.size, w, 128, k, s, refs)
        plan = kernels.multi_plan("or", ids, local)
        assert dispatch.multi_shares(plan.group_rows, 128, ids.size, refs) == staged
        seen = _spy(monkeypatch)
        got = entry("or", _matrix(rm, layout), idx)
        monkeypatch.undo()
        assert seen == ["resident_count_multi" if staged else gather]
        np.testing.assert_array_equal(got.numpy(), _pallas("or", rm, idx, layout))


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
