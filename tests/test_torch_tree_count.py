"""The redesigned tree and count kernels' host side, on the CPU.

``gather_count_tree.cu`` loads only the leaves that reach the root
(``kernels.tree_live_leaves``) and reads each tree's opcodes packed four
bits apiece (``kernels.tree_opcode_words``); ``count_rows.cu`` splits each
row into segments (``kernels.count_rows_segments``).  These tests hold the
liveness rule against the JAX package (Pallas in interpret mode and the
JAX executor's own tree encodings), a numpy model of each kernel's
arithmetic against Pallas, and the plain versions against Pallas at the
batch sizes the executor and HTTP paths hand the kernels.  Integer counts:
every comparison is exact (tolerance 0).  The kernels themselves run only
on the card (``chip_smoke.py`` holds them against these plain versions).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from pilosa_tpu.core.frame import FrameOptions as JFrameOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.pql.parser import parse as jparse
from pilosa_tpu_torch.core.frame import FrameOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bitwise, dispatch, kernels
from pilosa_tpu_torch.pql.parser import parse

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "pilosa_tpu_torch", "csrc")
PASS = bitwise.TREE_PASS


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _t(a):
    return bitwise.to_words(a)


def _popcount(a):
    """Set bits over the last axis of a uint32 array."""
    return np.bitwise_count(a).sum(axis=-1, dtype=np.int64)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never reach a kernel: the launch counters stay put."""
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


def _pallas_tree(rm, leaves, opc):
    return np.asarray(pk.fused_gather_count_tree(
        jnp.asarray(rm), jnp.asarray(leaves), jnp.asarray(opc), interpret=True))


def _trees(rng, b, k, r):
    """Random perfect trees over r rows whose opcodes pass their left
    child about a third of the time (-1, 4 and 5 all pass)."""
    leaves = rng.integers(0, r, size=(b, k), dtype=np.int32)
    opc = rng.integers(-1, 6, size=(b, k - 1), dtype=np.int32)
    return leaves, opc


def _kernel_model(rm, leaves, opc):
    """gather_count_tree.cu's arithmetic in numpy: the opcodes unpacked
    from their packed words, each dead leaf a row of zeros (the kernel
    never loads it), the fold level by level, the root's bits summed over
    slices."""
    b, k = leaves.shape
    words = kernels.tree_opcode_words(opc).view(np.uint32)
    ops = np.stack([(words[:, i // 8] >> np.uint32(4 * (i % 8))) & np.uint32(15)
                    for i in range(k - 1)], axis=1)
    live = kernels.tree_live_leaves(opc)
    vals = np.where(live[None, :, :, None], rm[:, leaves], np.uint32(0))  # [S, B, K, W]
    off, n = 0, k // 2
    while n >= 1:
        o = ops[None, :, off:off + n, None]
        vals = bitwise.tree_select(o, vals[:, :, 0::2], vals[:, :, 1::2])
        off += n
        n //= 2
    return _popcount(vals[:, :, 0]).sum(axis=0).astype(np.int32)


# ---------------------------------------------------------------------------
# (a) the liveness rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", kernels.TREE_LEAVES)
def test_dead_leaves_never_change_a_count(k, seed):
    """Replacing every dead leaf's row with any other in-range row leaves
    the port's plain fold, the Pallas kernel and the kernel's numpy model
    unchanged, and all three agree."""
    rng = np.random.default_rng([k, seed])
    s, r, b, w = 2, 12, 8, 1024
    rm = _words(rng, (s, r, w))
    leaves, opc = _trees(rng, b, k, r)
    live = kernels.tree_live_leaves(opc)
    assert live[:, 0].all() and not live.all()
    moved = leaves.copy()
    moved[~live] = (leaves[~live] + rng.integers(1, r, size=int((~live).sum()))) % r
    assert (moved[~live] != leaves[~live]).all()
    want = _pallas_tree(rm, leaves, opc)
    np.testing.assert_array_equal(_pallas_tree(rm, moved, opc), want)
    for lv in (leaves, moved):
        np.testing.assert_array_equal(kernels.gather_count_tree(_t(rm), lv, opc).numpy(), want)
        np.testing.assert_array_equal(_kernel_model(rm, lv, opc), want)


@pytest.mark.parametrize("k", kernels.TREE_LEAVES)
def test_live_leaves_follow_the_pass_nodes(k):
    """Every opcode 0-3: all leaves live.  Every opcode a PASS: only the
    leftmost.  A PASS root: the left half, as its left subtree decides."""
    b = 5
    rng = np.random.default_rng(k)
    ops = rng.integers(0, 4, size=(b, k - 1))
    assert kernels.tree_live_leaves(ops).all()
    every = kernels.tree_live_leaves(np.full((b, k - 1), PASS))
    assert every[:, 0].all() and not every[:, 1:].any()
    ops[:, -1] = PASS
    live = kernels.tree_live_leaves(ops)
    assert live[:, :k // 2].all() and not live[:, k // 2:].any()


@pytest.mark.parametrize("k", kernels.TREE_LEAVES)
def test_tree_opcode_words_round_trip(k):
    """Opcode i sits in bits 4 (i % 8) of word i // 8; every value outside
    0-3 packs as TREE_PASS."""
    rng = np.random.default_rng(30 + k)
    opc = rng.integers(-3, 10, size=(40, k - 1))
    words = kernels.tree_opcode_words(opc)
    assert words.dtype == np.int32 and words.shape == (40, 2)
    u = words.view(np.uint32).astype(np.int64)
    got = np.stack([(u[:, i // 8] >> (4 * (i % 8))) & 15 for i in range(k - 1)], axis=1)
    np.testing.assert_array_equal(got, np.where((opc >= 0) & (opc <= 3), opc, PASS))
    assert not (u[:, 1] >> (4 * max(k - 1 - 8, 0))).any()  # nothing past the last opcode


# ---------------------------------------------------------------------------
# (b) the executor's own encodings of the paths' tree shapes
# ---------------------------------------------------------------------------

# chip_smoke._tree_call's four shapes, over fixed rows: the 3-operand Xor
# and the nested Counts of depth 2, 3 and 4, and their live leaves.
TREE_SHAPES = (
    ("Xor(B1, B2, B3)", 4, 3),
    ("Intersect(Union(B1, B2), Difference(B3, B4))", 4, 4),
    ("Union(Intersect(Xor(B1, B2), B3), Difference(B4, Union(B5, B6)))", 8, 6),
    ("Xor(Union(Intersect(Xor(B1, B2), B3), B4), Difference(B5, Intersect(B6, Union(B7, B8))))",
     16, 8),
)


def _count(shape):
    return "Count(" + re.sub(r"B(\d)", lambda m: f'Bitmap(rowID={3 * int(m.group(1)) + 1}, frame="f")',
                             shape) + ")"


def _port_encoding(path, call):
    """The port's executor's tree encoding of one Count call over frame
    "f" of an empty index at ``path``."""
    h = Holder(str(path))
    h.open()
    try:
        h.create_index("i").create_frame("f", FrameOptions())
        return Executor(h, engine="numpy")._compile_count_tree("i", parse(call).calls[0].children[0])
    finally:
        h.close()


@pytest.mark.parametrize("shape,k,n_live", TREE_SHAPES, ids=["xor3", "depth2", "depth3", "depth4"])
def test_live_leaves_of_the_executors_tree_shapes(tmp_path, shape, k, n_live):
    """The port's executor encodes each shape as the JAX executor does;
    its live leaves are the shape's own Bitmaps (3/4, 4/4, 6/8, 8/16),
    each named once, and every dead leaf is the fill (the leftmost
    leaf)."""
    jh = JHolder(str(tmp_path / "jax"))
    jh.open()
    try:
        jh.create_index("i").create_frame("f", JFrameOptions())
        call = _count(shape)
        got = _port_encoding(tmp_path / "torch", call)
        want = JExecutor(jh)._compile_count_tree("i", jparse(call).calls[0].children[0])
    finally:
        jh.close()
    assert got == want
    _, _, bucket, leaves, opc = got
    assert bucket == ("tree", k)
    live = kernels.tree_live_leaves(np.array([opc]))[0]
    lv = np.array(leaves)
    assert live.sum() == n_live
    assert sorted(lv[live]) == [3 * i + 1 for i in range(1, n_live + 1)]
    assert (lv[~live] == lv[0]).all()


# ---------------------------------------------------------------------------
# (b2) the tree gate counts live leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k,n_rows", [(TREE_SHAPES[0][0], 4, 60), (TREE_SHAPES[2][0], 8, 120),
                                            (TREE_SHAPES[3][0], 16, 200)], ids=["xor3", "depth3", "depth4"])
def test_tree_gate_counts_live_leaves(tmp_path, monkeypatch, shape, k, n_rows):
    """64 trees padded as the executor pads the shape (every dead leaf the
    tree's leftmost row) whose leaves name their rows TREE_REUSE_MIN times
    a row, but whose live leaves do not, take the gather kernel; the same
    leaves under opcodes that keep every leaf live take the staged kernel.
    Both answers equal Pallas."""
    *_, opc1 = _port_encoding(tmp_path, _count(shape))
    dead = ~kernels.tree_live_leaves(np.array([opc1]))[0]
    rng = np.random.default_rng(k)
    b = kernels.TREE_GROUP
    leaves = rng.integers(0, n_rows, size=(b, k)).astype(np.int32)
    leaves[:, dead] = leaves[:, :1]
    padded = np.tile(np.array(opc1, np.int32), (b, 1))
    every = np.where(padded > 3, 0, padded).astype(np.int32)
    u = len(np.unique(leaves))
    live = int(kernels.tree_live_leaves(padded).sum())
    assert b * k >= dispatch.TREE_REUSE_MIN * u > live
    s, w = 2, 1024
    assert not dispatch.tree_strategy(u, w, padded, s)
    assert dispatch.tree_strategy(u, w, every, s)
    rm = _words(rng, (s, n_rows, w))
    for opc, kernel in ((padded, "gather_count_tree"), (every, "resident_count_tree")):
        seen = []
        for name in ("resident_count_tree", "gather_count_tree"):
            monkeypatch.setattr(kernels, name, lambda *a, _o=getattr(kernels, name), _n=name, **kw:
                                seen.append(_n) or _o(*a, **kw))
        got = dispatch.gather_count_tree(_t(rm), leaves, opc).numpy()
        monkeypatch.undo()
        assert seen == [kernel]
        np.testing.assert_array_equal(got, _pallas_tree(rm, leaves, opc))


# ---------------------------------------------------------------------------
# (c) count_rows's segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("w", [4, 1028, 8196, 32768])
@pytest.mark.parametrize("m", [1, 2, 63, 64, 65, 131, 256, 300])
def test_count_rows_segments_cover_each_word_once(m, w, sms):
    """A numpy model of count_rows.cu's coverage: segment g of a row holds
    vectors [g * seg_vecs, min((g + 1) * seg_vecs, W / 4)); its block's
    threads step 8 vectors of 256 at a time.  Every 16-byte vector of a
    row is read exactly once, no segment is empty, and the M x n_seg
    blocks cover COUNT_WAVES waves of the SMs unless a segment would fall
    under one block step."""
    n_seg, seg_vecs = kernels.count_rows_segments(m, w, sms)
    wv = w // 4
    assert n_seg >= 1 and (n_seg - 1) * seg_vecs < max(wv, 1) <= n_seg * seg_vecs
    threads, vecs = 256, kernels.COUNT_STEP_VECS // 256
    seen = np.zeros(wv, dtype=np.int64)
    for g in range(n_seg):
        lo, hi = g * seg_vecs, min((g + 1) * seg_vecs, wv)
        steps = -(-(hi - lo) // kernels.COUNT_STEP_VECS)
        j = (lo + np.arange(threads)[:, None, None] + np.arange(steps)[None, :, None]
             * kernels.COUNT_STEP_VECS + np.arange(vecs)[None, None, :] * threads).ravel()
        np.add.at(seen, j[j < hi], 1)
    assert (seen == 1).all()
    if m * n_seg < kernels.COUNT_WAVES * sms:
        assert -(-wv // (2 * n_seg)) < kernels.COUNT_STEP_VECS
    else:
        assert m * n_seg // 2 < kernels.COUNT_WAVES * sms or n_seg == 1


def test_count_rows_segments_at_the_paths_shapes():
    """[64, W] (a Count over 64 slices): 4 segments of one step each, 256
    blocks; [256, W] (TopN's candidates): 2 segments, 512 blocks; a
    32-bit row stays one unit."""
    assert kernels.count_rows_segments(64, 32768, 132) == (4, 2048)
    assert kernels.count_rows_segments(256, 32768, 132) == (2, 4096)
    assert kernels.count_rows_segments(1, 4, 132) == (1, 1)


def _count_model(a, b, op, sms=132):
    """count_rows.cu's sums in numpy: each row's segments counted apart
    and added, as the blocks add theirs into out."""
    m, w = a.shape
    n_seg, seg_vecs = kernels.count_rows_segments(m, w, sms)
    x = a if b is None else {"and": a & b, "or": a | b, "xor": a ^ b, "andnot": a & ~b}[op]
    segs = [_popcount(x[:, 4 * g * seg_vecs:4 * (g + 1) * seg_vecs]) for g in range(n_seg)]
    return np.sum(segs, axis=0).astype(np.int32)


# ---------------------------------------------------------------------------
# (d) the plain versions against Pallas at the paths' batch sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 8, 16])
@pytest.mark.parametrize("b", [2, 4, 16, 32])
def test_plain_tree_matches_pallas_at_the_paths_batches(b, k):
    """The batches the executor ("gather-3": B = 2-4) and HTTP ("tree":
    B = 16-32) paths hand the tree kernel, PASS nodes included: the plain
    version, the dispatch and the kernel's numpy model equal Pallas."""
    rng = np.random.default_rng([b, k])
    rm = _words(rng, (2, 24, 1024))
    leaves, opc = _trees(rng, b, k, 24)
    want = _pallas_tree(rm, leaves, opc)
    np.testing.assert_array_equal(kernels.gather_count_tree(_t(rm), leaves, opc).numpy(), want)
    np.testing.assert_array_equal(dispatch.gather_count_tree(_t(rm), leaves, opc).numpy(), want)
    np.testing.assert_array_equal(_kernel_model(rm, leaves, opc), want)


@pytest.mark.parametrize("m", [1, 64, 256])
def test_plain_count_rows_matches_pallas_at_the_paths_shapes(m):
    """The sequential Count's stack (no op) and TopN's candidates against
    one shared src (and): the plain version and the numpy model of the
    kernel's segment sums equal fused_count1 / fused_count2."""
    rng = np.random.default_rng(m)
    w = 32768
    a = _words(rng, (m, w))
    src = _words(rng, (w,))
    want1 = np.asarray(pk.fused_count1(jnp.asarray(a), interpret=True))
    np.testing.assert_array_equal(kernels.count_rows(_t(a)).numpy(), want1)
    np.testing.assert_array_equal(dispatch.count(_t(a)).numpy(), want1)
    np.testing.assert_array_equal(_count_model(a, None, "none"), want1)
    want2 = np.asarray(pk.fused_count2("and", jnp.asarray(a), jnp.asarray(src), interpret=True))
    np.testing.assert_array_equal(kernels.count_rows(_t(a), _t(src), "and").numpy(), want2)
    np.testing.assert_array_equal(dispatch.batch_intersection_count(_t(a), _t(src)).numpy(), want2)
    np.testing.assert_array_equal(_count_model(a, src, "and"), want2)


def _constexpr(source, name):
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def test_wrapper_constants_match_the_cuda_sources():
    assert kernels.TREE_PARAM_INTS == _constexpr("gather_count_tree.cu", "kParamInts")
    assert kernels.COUNT_STEP_VECS == (_constexpr("count_rows.cu", "kThreads")
                                       * _constexpr("count_rows.cu", "kVecs"))
