"""The staged resident kernels' host side against the JAX package.

``resident_count2`` and ``resident_count_tree`` compact the rows a batch
names on the host (``kernels.compact_rows``) before their kernels stage
those rows through shared memory; on the CPU the wrappers run the same
remap and then the plain version over the compacted rows.  These tests
hold that path, and the tree dispatch's choice between the staged and
the gather kernel, against the Pallas kernels in interpret mode, exactly
(integer counts, tolerance 0), for every op and opcode, duplicate ids,
self-pairs, pools with unreferenced rows and padded trees.  They also
pin the tilings the wrappers hand the kernels and the resident gate's
admitted set.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pilosa_tpu.ops import bitwise as jbw
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitwise, dispatch, kernels

OPS = ("and", "or", "xor", "andnot")


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _t(a):
    return bitwise.to_words(a)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("shape", [(0, 2), (1, 2), (7, 2), (5, 4), (3, 16)])
def test_compact_rows_remaps_into_the_distinct_rows(shape):
    rng = np.random.default_rng(sum(shape))
    ids = rng.integers(0, 9, size=shape).astype(np.int32)
    uniq, local = kernels.compact_rows(ids, 9, "ids")
    assert uniq.dtype == np.int32 and local.dtype == np.int32 and local.shape == ids.shape
    np.testing.assert_array_equal(uniq, np.unique(ids))
    np.testing.assert_array_equal(uniq[local], ids)
    with pytest.raises(IndexError, match="out of range"):
        kernels.compact_rows(np.full(shape[1], 9), 9, "ids")


def _pairs(rng, case, r, b):
    """Pair batches of the resident lane's edge cases."""
    if case == "duplicates":  # the same pair many times, few rows
        base = rng.integers(0, r, size=(3, 2))
        return base[rng.integers(0, 3, size=b)].astype(np.int32)
    if case == "self_pairs":  # (a, a) beside ordinary pairs
        p = rng.integers(0, r, size=(b, 2))
        p[::2, 1] = p[::2, 0]
        return p.astype(np.int32)
    if case == "unreferenced":  # only the top quarter of the pool is named
        return rng.integers(3 * r // 4, r, size=(b, 2)).astype(np.int32)
    return rng.integers(0, r, size=(b, 2)).astype(np.int32)  # "ragged": b % 8 != 0


@pytest.mark.parametrize("case", ["duplicates", "self_pairs", "unreferenced", "ragged"])
@pytest.mark.parametrize("op", OPS)
def test_resident_count2_remap_matches_pallas(op, case):
    rng = np.random.default_rng([OPS.index(op), len(case)])
    s, r, w, b = 2, 16, 1024, 13
    rm = _words(rng, (s, r, w))
    pairs = _pairs(rng, case, r, b)
    assert dispatch.resident_strategy(r, w, b)
    want = np.asarray(pk.fused_resident_count2(op, jnp.asarray(rm), jnp.asarray(pairs), interpret=True))
    np.testing.assert_array_equal(kernels.resident_count2(op, _t(rm), pairs).numpy(), want)
    ids, local = kernels.compact_rows(pairs, r, "pairs")
    if case in ("duplicates", "unreferenced"):
        assert ids.size <= r // 2
    np.testing.assert_array_equal(
        kernels.resident_count2_plain(op, _t(rm[:, ids]), local).numpy(), want)
    np.testing.assert_array_equal(dispatch.gather_count(op, _t(rm), pairs).numpy(), want)


def _trees(rng, case, r, b, k):
    """Leaves and opcodes of the tree lane's edge cases: opcodes drawn
    from 0-5 (4 and 5 pass the left child), duplicate leaves, pools with
    unreferenced rows, and padded trees (a TREE_PASS root over a left
    subtree whose leaves the right subtree repeats)."""
    leaves = rng.integers(0, r, size=(b, k))
    opc = rng.integers(0, 6, size=(b, k - 1))
    if case == "duplicates":
        leaves = rng.integers(0, 3, size=(b, k))
    elif case == "unreferenced":
        leaves = rng.integers(r // 2, r, size=(b, k))
    elif case == "padded":  # the root passes its left subtree; the right repeats it
        leaves[:, k // 2:] = leaves[:, :k // 2]
        opc[:, -1] = bitwise.TREE_PASS
    return leaves.astype(np.int32), opc.astype(np.int32)


def _spy(monkeypatch):
    seen = []
    for name in ("resident_count_tree", "gather_count_tree"):
        def spy(*a, _o=getattr(kernels, name), _n=name, **kw):
            seen.append(_n)
            return _o(*a, **kw)
        monkeypatch.setattr(kernels, name, spy)
    return seen


@pytest.mark.parametrize("case", ["random", "duplicates", "unreferenced", "padded"])
@pytest.mark.parametrize("k", kernels.TREE_LEAVES)
def test_tree_dispatch_matches_pallas(k, case, monkeypatch):
    """A batch naming few rows many times takes the staged kernel, a
    sparse one the gather kernel; both equal the Pallas tree fold."""
    rng = np.random.default_rng([k, len(case)])
    s, w = 2, 1024
    for r, b, staged in ((12, 48, True), (96, 3, False)):
        rm = _words(rng, (s, r, w))
        leaves, opc = _trees(rng, case, r, b, k)
        u = len(np.unique(leaves))
        live = kernels.tree_live_leaves(opc).sum()
        assert dispatch.tree_strategy(u, w, opc, s) == (live >= dispatch.TREE_REUSE_MIN * u)
        want = np.asarray(pk.fused_gather_count_tree(
            jnp.asarray(rm), jnp.asarray(leaves), jnp.asarray(opc), interpret=True))
        seen = _spy(monkeypatch)
        np.testing.assert_array_equal(dispatch.gather_count_tree(_t(rm), leaves, opc).numpy(), want)
        expect = "resident_count_tree" if dispatch.tree_strategy(u, w, opc, s) else "gather_count_tree"
        assert seen == [expect]
        if staged:
            assert expect == "resident_count_tree"
        monkeypatch.undo()
        np.testing.assert_array_equal(kernels.resident_count_tree(_t(rm), leaves, opc).numpy(), want)
        ids, local = kernels.compact_rows(leaves, r, "leaves")
        np.testing.assert_array_equal(
            kernels.resident_count_tree_plain(_t(rm[:, ids]), local, opc).numpy(), want)


@pytest.mark.parametrize("k", [4, 16])
def test_resident_count_tree_plain_matches_jax(k):
    rng = np.random.default_rng(40 + k)
    rm = _words(rng, (3, 10, 1024))
    leaves = rng.integers(0, 10, size=(7, k), dtype=np.int32)
    opc = rng.integers(0, 6, size=(7, k - 1), dtype=np.int32)
    want = np.asarray(jbw.gather_count_tree(jnp.asarray(rm), jnp.asarray(leaves), jnp.asarray(opc)))
    np.testing.assert_array_equal(kernels.resident_count_tree_plain(_t(rm), leaves, opc).numpy(), want)
    np.testing.assert_array_equal(jbw.np_gather_count_tree(rm, leaves, opc), want)


def _pr1_gate(n_rows, w, batch):
    """The resident gate of the first resident kernel: an all-rows tile
    of the narrowest (128-word) chunk plus the per-pair sums in 227 KB."""
    best, c = 0, 128
    while c <= min(w, 2048):
        if w % c == 0 and n_rows * c * 4 + batch * 4 <= kernels.SMEM_BYTES:
            best = c
        c *= 2
    return n_rows < 2 * batch and bool(best)


@pytest.mark.parametrize("w", [128, 1024, 3072, 32768])
def test_resident_gate_admits_the_same_set_and_tiles_it(w):
    """``resident_strategy`` admits exactly what the first resident
    kernel's gate did, and every admitted shape has a staged tiling even
    when every row is named (U = R)."""
    for r in list(range(1, 24)) + list(range(200, 470, 7)) + [452, 453]:
        for b in (1, 2, 7, 12, 100, 227, 230, 256, 300, 4096, 60000):
            admitted = dispatch.resident_strategy(r, w, b)
            assert admitted == _pr1_gate(r, w, b), (r, w, b)
            if admitted:
                chunk, stages = kernels.resident_tiling(r, w, b, 1)
                assert chunk >= 64 and w % chunk == 0 and stages in (1, 2), (r, w, b)
                assert kernels.staged_smem_bytes(
                    r, chunk, stages, kernels.pair_span_ints(b)) <= kernels.SMEM_BYTES


@pytest.mark.parametrize("u,k,want", [
    (251, 16, (64, 2)),     # the timed K=16 batch: 64-word chunks, half-warp trees
    (221, 8, (64, 2)),
    (60, 4, (256, 2)),      # few rows: wider chunks
    (160, 16, (128, 2)),
])
def test_tree_tiling(u, k, want):
    assert kernels.tree_tiling(u, 32768, k, 64) == want


def _live(b, k):
    """Opcodes of b trees of k leaves that keep every leaf live."""
    return np.zeros((b, k - 1), np.int32)


def test_tree_gate_needs_reuse_in_each_group_and_a_tiling():
    w = 32768
    assert dispatch.tree_strategy(251, w, _live(64, 16), 64)
    assert dispatch.tree_strategy(256, w, _live(256, 16), 64)  # four groups, each 1,024 references
    assert not dispatch.tree_strategy(160, w, _live(16, 16), 64)  # 256 references of 160 rows
    assert not dispatch.tree_strategy(400, w, _live(128, 16), 64)  # 2,048 references, 1,024 a group
    assert not dispatch.tree_strategy(4, 96, _live(64, 16), 64)  # no chunk of 64+ words divides W
    assert kernels.tree_tiling(430, w, 16, 64) == (64, 1)
    assert kernels.tree_tiling(1000, w, 16, 64) == (0, 0)
    # Within one group the reuse clause keeps U <= 64 x 16 / 4 = 256 rows,
    # whose two stages fit at every K.
    for k in kernels.TREE_LEAVES:
        u = kernels.TREE_GROUP * k // dispatch.TREE_REUSE_MIN
        assert dispatch.tree_strategy(u, w, _live(kernels.TREE_GROUP, k), 64)


def test_tree_dispatch_compacts_the_batch_once(monkeypatch):
    """The gate and the staged kernel share one compaction of the leaves."""
    rng = np.random.default_rng(5)
    rm = _words(rng, (2, 12, 1024))
    leaves, opc = _trees(rng, "random", 12, 24, 8)
    calls = []
    real = kernels.compact_rows
    monkeypatch.setattr(kernels, "compact_rows", lambda *a: calls.append(a) or real(*a))
    got = dispatch.gather_count_tree(_t(rm), leaves, opc).numpy()
    assert len(calls) == 1
    np.testing.assert_array_equal(got, jbw.np_gather_count_tree(rm, leaves, opc))


def test_staged_wrappers_check_their_arguments():
    rm = torch.zeros((2, 4, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="pair op"):
        kernels.resident_count2("none", rm, np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="want \\[B, 2\\]"):
        kernels.resident_count2("and", rm, np.zeros((1, 3), np.int32))
    with pytest.raises(ValueError, match="want \\[B, K in"):
        kernels.resident_count_tree(rm, np.zeros((1, 3), np.int32), np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="opc shape"):
        kernels.resident_count_tree(rm, np.zeros((1, 4), np.int32), np.zeros((1, 2), np.int32))
    with pytest.raises(IndexError, match="out of range"):
        kernels.resident_count_tree(rm, np.full((1, 2), 4, np.int32), np.zeros((1, 1), np.int32))
