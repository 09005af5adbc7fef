"""The port's kernel wrappers (on CPU tensors: their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode.

Same seeded numpy inputs through both; integer counts, so every
comparison is exact (tolerance 0).  The ported rows of the TPU kernel
table: fused_count1, fused_count2, fused_resident_count2,
fused_gather_count2, fused_gather_src_counts, fused_gather_count_multi
(with fused_gather_count_or) and fused_gather_count_tree — plus
pair_gram against the JAX Gram.  The row-major kernels and
fused_topn_counts are held in ``test_torch_rowmajor.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pilosa_tpu.ops import bitwise as jbw
from pilosa_tpu.ops import dispatch as jdispatch
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitwise, dispatch, kernels

OPS = ("and", "or", "xor", "andnot")


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _t(a):
    return bitwise.to_words(a)


def _np(t):
    return t.numpy()


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never reach a kernel: the launch counters stay put."""
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("w", [1024, 32768])
def test_count_rows_matches_fused_count1(w):
    rng = np.random.default_rng(w)
    a = _words(rng, (3, 4, w))
    want = np.asarray(pk.fused_count1(jnp.asarray(a), interpret=True))
    got = dispatch.count(_t(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(kernels.count_rows(_t(a.reshape(-1, w)))), want.reshape(-1))


@pytest.mark.parametrize("w", [1024, 32768])
@pytest.mark.parametrize("shared", [False, True], ids=["per_row", "shared"])
@pytest.mark.parametrize("op", OPS)
def test_count_rows_matches_fused_count2(op, shared, w):
    rng = np.random.default_rng([OPS.index(op), int(shared), w])
    a = _words(rng, (5, w))
    b = _words(rng, (w,) if shared else (5, w))
    want = np.asarray(pk.fused_count2(op, jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(_np(kernels.count_rows(_t(a), _t(b), op)), want)
    np.testing.assert_array_equal(_np(getattr(bitwise, f"count_{op}")(_t(a), _t(b))), want)
    if shared:
        np.testing.assert_array_equal(_np(dispatch.batch_intersection_count(_t(a), _t(b))),
                                      want if op == "and" else _np(bitwise.count_and(_t(a), _t(b))))


def test_count_edge_words():
    """SWAR popcount over int32 views: sign bit, all ones, zero."""
    a = np.array([[0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1, 0x55555555, 0xAAAAAAAA, 3]],
                 dtype=np.uint32)
    np.testing.assert_array_equal(_np(bitwise.popcount_words(_t(a))), jbw.np_popcount(a))
    assert int(dispatch.count(_t(a))[0]) == jbw.np_count(a)


@pytest.mark.parametrize("w", [1024, 32768])
@pytest.mark.parametrize("op", OPS)
def test_resident_count2_matches_pallas(op, w):
    """B above R/2: the resident kernel's regime."""
    rng = np.random.default_rng([OPS.index(op), w, 1])
    s, r, b = 3, 16, 12
    rm = _words(rng, (s, r, w))
    pairs = rng.integers(0, r, size=(b, 2), dtype=np.int32)
    assert dispatch.resident_strategy(r, w, b)
    want = np.asarray(pk.fused_resident_count2(op, jnp.asarray(rm), jnp.asarray(pairs), interpret=True))
    np.testing.assert_array_equal(_np(kernels.resident_count2(op, _t(rm), pairs)), want)
    np.testing.assert_array_equal(_np(dispatch.gather_count(op, _t(rm), pairs)), want)


@pytest.mark.parametrize("w", [1024, 32768])
@pytest.mark.parametrize("op", OPS)
def test_gather_count2_matches_pallas(op, w):
    """B below R/2: the gather kernel's regime."""
    rng = np.random.default_rng([OPS.index(op), w, 2])
    s, r, b = 2, 16, 5
    rm = _words(rng, (s, r, w))
    pairs = rng.integers(0, r, size=(b, 2), dtype=np.int32)
    assert not dispatch.resident_strategy(r, w, b)
    want = np.asarray(pk.fused_gather_count2(op, jnp.asarray(rm), jnp.asarray(pairs), interpret=True))
    np.testing.assert_array_equal(_np(kernels.gather_count2(op, _t(rm), pairs)), want)
    np.testing.assert_array_equal(_np(dispatch.gather_count(op, _t(rm), pairs)), want)


@pytest.mark.parametrize("w", [1024, 32768])
def test_gather_src_counts_matches_pallas(w):
    rng = np.random.default_rng(w + 5)
    s, r, k = 3, 12, 7
    rm = _words(rng, (s, r, w))
    src = _words(rng, (s, w))
    pos = rng.integers(0, r, size=(k,), dtype=np.int32)
    want = np.asarray(
        pk.fused_gather_src_counts(jnp.asarray(rm), jnp.asarray(pos), jnp.asarray(src), interpret=True)
    )
    got = kernels.gather_src_counts(_t(rm), pos, _t(src))
    assert tuple(got.shape) == (s, k)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(dispatch.topn_scorer_counts(_t(rm), pos, _t(src))), want)


@pytest.mark.parametrize("b", [3, 40], ids=["below_half_r", "above_half_r"])
@pytest.mark.parametrize("op", OPS)
def test_dispatch_gather_count_matches_jax_dispatch(op, b):
    rng = np.random.default_rng(b * 7 + len(op))
    rm = _words(rng, (3, 16, 1024))
    pairs = rng.integers(0, 16, size=(b, 2), dtype=np.int32)
    want = np.asarray(jdispatch.gather_count(op, jnp.asarray(rm), jnp.asarray(pairs)))
    np.testing.assert_array_equal(_np(dispatch.gather_count(op, _t(rm), pairs)), want)


def test_resident_gate_follows_shared_memory():
    """R < 2B, and R rows of a 128-word chunk plus 4 bytes a pair fit
    227 KB (the admitted set of the first resident kernel).  The staged
    kernel tiles the distinct rows the pairs name: two stages of 128-word
    chunks at 220 rows, of 64-word chunks at 256, one stage at the gate's
    edge (452 rows), wide chunks for a few rows."""
    w = 32768
    assert kernels.resident_tiling(220, w, 256, 64) == (128, 2)
    assert kernels.resident_tiling(256, w, 256, 64) == (64, 2)
    assert kernels.resident_tiling(256, w, 4096, 64) == (64, 2)  # 16 groups, 32 KiB of sums
    assert kernels.resident_tiling(452, w, 230, 64) == (64, 1)
    assert kernels.resident_tiling(16, w, 12, 64) == (512, 2)
    assert kernels.resident_tiling(16, w, 12, 1) == (64, 2)  # one slice: narrow for tiles
    assert kernels.resident_tiling(1024, w, 4096, 64)[0] == 0
    assert dispatch.resident_strategy(256, w, 256)
    assert dispatch.resident_strategy(452, w, 230)
    assert not dispatch.resident_strategy(453, w, 230)
    assert not dispatch.resident_strategy(256, w, 128)
    assert not dispatch.resident_strategy(512, w, 4096)


@pytest.mark.parametrize(
    "step_bytes", [bitwise.GRAM_STEP_BYTES, 16 * 128 * 32 * 4], ids=["one_step", "streamed"]
)
@pytest.mark.parametrize("w", [1024, 32768])
def test_pair_gram_matches_jax(w, step_bytes):
    """Exact all-pairs AND counts; the small step budget forces 128-word
    chunks (the streamed path) and must not change a count."""
    rng = np.random.default_rng(w)
    rm = _words(rng, (3, 16, w))
    want = np.asarray(jbw.pair_gram(jnp.asarray(rm)))
    got = bitwise.pair_gram(_t(rm), step_bytes=step_bytes)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_np(got), want)
    pairs = rng.integers(0, 16, size=(9, 2))
    for op in OPS:
        np.testing.assert_array_equal(
            _np(bitwise.gram_pair_counts(op, got, torch.as_tensor(pairs))),
            np.asarray(jbw.gram_pair_counts(op, want, pairs)),
        )


def test_pair_gram_jax_streamed_reference():
    """Both packages' streamed Gram paths agree past the one-shot budget."""
    rng = np.random.default_rng(3)
    rm = _words(rng, (2, 8, 1024))
    old = jbw.GRAM_ONESHOT_BYTES, jbw.GRAM_STEP_BYTES
    try:
        jbw.GRAM_ONESHOT_BYTES = 0
        jbw.GRAM_STEP_BYTES = 8 * 256 * 32
        want = np.asarray(jbw.pair_gram(jnp.asarray(rm)))
    finally:
        jbw.GRAM_ONESHOT_BYTES, jbw.GRAM_STEP_BYTES = old
    got = bitwise.pair_gram(_t(rm), step_bytes=8 * 256 * 32 * 4)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("op", ["and", "or", "andnot"])
def test_plain_gather_count_multi_matches_jax(op):
    rng = np.random.default_rng(len(op))
    rm = _words(rng, (2, 10, 1024))
    idx = rng.integers(0, 10, size=(6, 4), dtype=np.int32)
    want = np.asarray(jbw.gather_count_multi(op, jnp.asarray(rm), jnp.asarray(idx)))
    np.testing.assert_array_equal(_np(dispatch.gather_count_multi(op, _t(rm), idx)), want)


def _pad_multi(rng, idx, op, width):
    """Pad each query's ids to ``width`` the way the executor does: repeat
    an operand the fold ignores (and/or: any; andnot: any but the first)."""
    b, k = idx.shape
    lo = 1 if (op == "andnot" and k > 1) else 0
    extra = idx[np.arange(b)[:, None], rng.integers(lo, k, size=(b, width - k))]
    return np.concatenate([idx, extra], axis=1).astype(np.int32)


@pytest.mark.parametrize("w", [1024, 2048])
@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_gather_count_multi_matches_pallas(op, k, w):
    """The plain version of the multi fold against the Pallas kernel
    (``acc & ~row`` left fold for andnot, ``a & ~(b | c | ...)`` in the
    plain version), unpadded and padded the executor's way."""
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), k, w])
    s, r, b = 2, 12, 7
    rm = _words(rng, (s, r, w))
    idx = rng.integers(0, r, size=(b, k), dtype=np.int32)
    padded = _pad_multi(rng, idx, op, k + 3)
    want = np.asarray(pk.fused_gather_count_multi(op, jnp.asarray(rm), jnp.asarray(idx), interpret=True))
    np.testing.assert_array_equal(
        np.asarray(pk.fused_gather_count_multi(op, jnp.asarray(rm), jnp.asarray(padded), interpret=True)),
        want)
    for ids in (idx, padded):
        np.testing.assert_array_equal(_np(kernels.gather_count_multi(op, _t(rm), ids)), want)
        np.testing.assert_array_equal(_np(dispatch.gather_count_multi(op, _t(rm), ids)), want)
    if op == "or":
        np.testing.assert_array_equal(
            np.asarray(pk.fused_gather_count_or(jnp.asarray(rm), jnp.asarray(idx), interpret=True)), want)


@pytest.mark.parametrize("k", kernels.TREE_LEAVES)
def test_gather_count_tree_matches_pallas(k):
    """Perfect trees of depth 1-4 with opcodes drawn from 0-5 (4 and 5
    pass the left child)."""
    rng = np.random.default_rng(100 + k)
    s, r, b, w = 2, 12, 6, 1024
    rm = _words(rng, (s, r, w))
    leaves = rng.integers(0, r, size=(b, k), dtype=np.int32)
    opc = rng.integers(0, 6, size=(b, k - 1), dtype=np.int32)
    want = np.asarray(pk.fused_gather_count_tree(
        jnp.asarray(rm), jnp.asarray(leaves), jnp.asarray(opc), interpret=True))
    np.testing.assert_array_equal(_np(kernels.gather_count_tree(_t(rm), leaves, opc)), want)
    np.testing.assert_array_equal(_np(dispatch.gather_count_tree(_t(rm), leaves, opc)), want)
    np.testing.assert_array_equal(jbw.np_gather_count_tree(rm, leaves, opc), want)


def test_plain_gather_count_tree_matches_jax():
    rng = np.random.default_rng(11)
    rm = _words(rng, (2, 10, 1024))
    leaves = rng.integers(0, 10, size=(5, 8), dtype=np.int32)
    opc = rng.integers(0, 5, size=(5, 7), dtype=np.int32)
    want = np.asarray(jbw.gather_count_tree(jnp.asarray(rm), jnp.asarray(leaves), jnp.asarray(opc)))
    np.testing.assert_array_equal(_np(dispatch.gather_count_tree(_t(rm), leaves, opc)), want)
    np.testing.assert_array_equal(jbw.np_gather_count_tree(rm, leaves, opc), want)


def test_unported_lanes_raise_off_the_cpu():
    """No lane is left unported: every wrapper, the row-major ones
    included, raises its device error on a tensor that is neither on the
    CPU nor on the card (a meta tensor stands in) instead of running
    plain code."""
    rm = torch.empty((2, 4, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        kernels.gather_count2_rowmajor("and", rm, np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="device meta"):
        kernels.gather_count_multi_rowmajor("or", rm, np.zeros((2, 3), np.int32))
    with pytest.raises(ValueError, match="device meta"):
        kernels.count_rows(rm[0])


@pytest.mark.parametrize("lane", ["multi", "or_multi", "tree", "rmgather", "rmmulti", "topn",
                                  "resident", "staged_tree"])
def test_ported_lanes_reach_their_kernel_off_the_cpu(lane):
    """The multi, tree, row-major, whole-row TopN and staged lanes do not
    stop in dispatch or the engine: a non-CPU tensor reaches the kernel
    wrapper, which raises its device error (a CUDA tensor would launch
    the kernel)."""
    from pilosa_tpu_torch.engine import TorchEngine

    rm = torch.empty((2, 4, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        if lane == "multi":
            dispatch.gather_count_multi("and", rm, np.zeros((2, 3), np.int32))
        elif lane == "or_multi":
            TorchEngine("cpu").gather_count_or_multi(rm, np.zeros((2, 3), np.int32))
        elif lane == "tree":
            dispatch.gather_count_tree(rm, np.zeros((2, 4), np.int32), np.zeros((2, 3), np.int32))
        elif lane == "rmgather":
            TorchEngine("cpu").gather_count_rowmajor_dev("xor", rm, np.zeros((2, 2), np.int32))
        elif lane == "rmmulti":
            TorchEngine("cpu").gather_count_multi_rowmajor_dev("andnot", rm, np.zeros((2, 3), np.int32))
        elif lane == "resident":
            dispatch.gather_count("xor", rm, np.zeros((8, 2), np.int32))
        elif lane == "staged_tree":
            dispatch.gather_count_tree(rm, np.zeros((8, 2), np.int32), np.zeros((8, 1), np.int32))
        else:
            kernels.topn_counts(rm, rm[:, 0])


def test_kernel_wrappers_check_their_arguments():
    rm = torch.zeros((2, 4, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="multi-op"):
        kernels.gather_count_multi("xor", rm, np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="multi-op"):
        kernels.gather_count_multi_rowmajor("xor", rm, np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="pair op"):
        kernels.gather_count2_rowmajor("none", rm, np.zeros((1, 2), np.int32))
