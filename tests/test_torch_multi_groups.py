"""The staged multi fold's launch plan (``kernels.multi_plan``) against the JAX package.

``resident_count_multi``'s wrapper cuts a batch of K-operand folds into
groups of ``MULTI_Q`` queries that share rows and splits each group's rows
into classes by the exact subset of the group's queries that name them;
the kernel folds each class's rows once and applies the result to the
queries of its mask.  ``kernels.multi_plan_fold`` is a plain model of that
fold over the same int array the wrapper hands the kernel.  These tests
hold the plan's structure (every query in exactly one group, its out index
mapping back, each class exactly the rows its queries share) and the
model's counts against ``fused_gather_count_multi`` and
``fused_gather_count_multi_rowmajor`` in interpret mode, exactly (integer
counts, tolerance 0): and / or / andnot, both layouts, K = 1 to 23,
Range-like batches with block structure, batches that share nothing,
identical queries, B not a multiple of MULTI_Q, batches of several blocks,
and andnot whose first operands appear in other queries' rests.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pilosa_tpu.ops import bitwise as jbw
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitwise, kernels

LAYOUTS = ("slice", "row")
Q = kernels.MULTI_Q


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _pallas(op, rm, idx, layout):
    """The Pallas fold over the same rows, in interpret mode."""
    if layout == "slice":
        return np.asarray(pk.fused_gather_count_multi(
            op, jnp.asarray(rm), jnp.asarray(idx), interpret=True))
    s, r, w = rm.shape
    tiled = jnp.asarray(np.ascontiguousarray(rm.transpose(1, 0, 2)).reshape(r, s, w // 128, 128))
    return np.asarray(pk.fused_gather_count_multi_rowmajor(op, tiled, jnp.asarray(idx), interpret=True))


def _model(op, rm, idx, layout):
    """The plan's model over the port's matrix of ``rm`` in ``layout``:
    the staged rows gathered as the kernel stages them."""
    r = rm.shape[1]
    ids, local = kernels.compact_rows(idx, r, "idx")
    plan = kernels.multi_plan(op, ids, local)
    rows = torch.from_numpy(ids).long()
    if layout == "slice":
        staged = bitwise.to_words(rm)[:, rows]
    else:
        staged = bitwise.to_words(np.ascontiguousarray(rm.transpose(1, 0, 2)))[rows].transpose(0, 1)
    return plan, kernels.multi_plan_fold(plan, staged)


def _records(plan):
    """(out indices, first rows, [(mask, rows)]) of each group's record."""
    ints, u = plan.ints, plan.u
    starts = ints[u:u + plan.groups + 1]
    out = []
    for g in range(plan.groups):
        at, end = int(starts[g]), int(starts[g + 1])
        assert at % 4 == 0 and (end - at) % 4 == 0
        qs, firsts = ints[at:at + Q].tolist(), ints[at + Q:at + 2 * Q].tolist()
        classes = []
        at += 2 * Q
        while at < end:
            m, n = int(ints[at]) & 15, int(ints[at]) >> 4
            classes.append((m, ints[at + 1:at + 1 + n].tolist()))
            at += 4 * ((n + 4) // 4)
        assert at == end
        out.append((qs, firsts, classes))
    return out


def _range_like(rng, b, bitmaps, views, k):
    """B Counts of bitmap row q mod ``bitmaps`` over spans of consecutive
    views (rows view * bitmaps + bitmap row: block-diagonal), padded to K
    by repeating the first id."""
    idx = np.empty((b, k), dtype=np.int32)
    for q in range(b):
        n = int(rng.integers(1, min(k, views) + 1))
        v0 = int(rng.integers(0, views - n + 1))
        idx[q, :n] = (v0 + np.arange(n)) * bitmaps + q % bitmaps
        idx[q, n:] = idx[q, 0]
    return idx[rng.permutation(b)]


def _case(rng, case, op):
    """(rm, idx) of a named batch over a small matrix."""
    s, w = 2, 1024
    if case == "range-like":
        bitmaps, views = 4, 12
        return _words(rng, (s, bitmaps * views, w)), _range_like(rng, 38, bitmaps, views, 9)
    if case == "shares nothing":
        r = 60
        return _words(rng, (s, r, w)), rng.permutation(r)[:57].reshape(19, 3).astype(np.int32)
    if case == "identical queries":
        r = 20
        return _words(rng, (s, r, w)), np.tile(rng.integers(0, r, size=(1, 6)), (11, 1)).astype(np.int32)
    if case == "B not a multiple of Q":
        r = 24
        return _words(rng, (s, r, w)), rng.integers(0, r, size=(4 * 5 + 3, 7)).astype(np.int32)
    if case == "several blocks":
        r = 40
        return _words(rng, (s, r, w)), rng.integers(0, r, size=(kernels.MULTI_GROUP + 37, 5)).astype(
            np.int32)
    if case == "firsts in other rests":
        # Each query's first operand is the second operand of the next.
        r = 16
        first = rng.integers(0, r, size=17)
        rest = rng.integers(0, r, size=(17, 4))
        rest[:, 0] = np.roll(first, -1)
        return _words(rng, (s, r, w)), np.concatenate([first[:, None], rest], axis=1).astype(np.int32)
    raise AssertionError(case)


CASES = ("range-like", "shares nothing", "identical queries", "B not a multiple of Q",
         "several blocks", "firsts in other rests")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_multi_plan_model_matches_pallas_on_cases(op, case, layout):
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), CASES.index(case), len(layout)])
    rm, idx = _case(rng, case, op)
    plan, got = _model(op, rm, idx, layout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _pallas(op, rm, idx, layout))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 12, 16, 19, 23])
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_multi_plan_model_matches_pallas(op, k, layout):
    """Random folds over a small pool (repeats within a query are common)
    and the same folds padded the executor's way."""
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), k, len(layout), 3])
    s, r, b, w = 2, 14, 9, 1024
    rm = _words(rng, (s, r, w))
    idx = rng.integers(0, r, size=(b, k), dtype=np.int32)
    want = _pallas(op, rm, idx, layout)
    np.testing.assert_array_equal(_model(op, rm, idx, layout)[1].numpy(), want)
    if k > 1:
        lo = 1 if op == "andnot" else 0
        pad = idx[np.arange(b)[:, None], rng.integers(lo, k, size=(b, 3))]
        padded = np.concatenate([idx, pad], axis=1)
        np.testing.assert_array_equal(_model(op, rm, padded, layout)[1].numpy(), want)


@pytest.mark.parametrize("case", CASES + ("random K=23",))
@pytest.mark.parametrize("op", kernels.MULTI_OPS)
def test_multi_plan_groups_and_classes(op, case):
    """Every query lies in exactly one group, its out index maps back to
    ``out``; a group's classes partition the rows its queries fold (after
    the first for andnot), each class exactly the rows that the queries
    of its mask, and only they, name; the offsets and ``block_ints`` say
    what a block copies."""
    rng = np.random.default_rng([kernels.MULTI_OPS.index(op), len(case), 4])
    if case == "random K=23":
        idx = rng.integers(0, 300, size=(200, 23)).astype(np.int32)
        r = 300
    else:
        rm, idx = _case(rng, case, op)
        r = rm.shape[1]
    ids, local = kernels.compact_rows(idx, r, "idx")
    plan = kernels.multi_plan(op, ids, local)
    b, k = local.shape
    assert plan.u == ids.size and (plan.ints[:plan.u] == ids).all()
    assert plan.groups == -(-b // Q)
    assert plan.op == ("and" if k == 1 else op)
    lead = plan.op == "andnot"
    seen = []
    for g, (qs, firsts, classes) in enumerate(_records(plan)):
        live = [q for q in qs if q >= 0]
        assert qs[:len(live)] == live  # the last group's empty slots come last
        assert len(live) == Q or g == plan.groups - 1
        seen += live
        named = {}
        for j, q in enumerate(live):
            for x in set(local[q, 1:] if lead else local[q]):
                named[int(x)] = named.get(int(x), 0) | 1 << j
            if lead:
                assert firsts[j] == local[q, 0]
        got = {}
        for m, rows in classes:
            assert 0 < m < 1 << len(live)
            for x in rows:
                assert x not in got
                got[x] = m
        assert got == named
        assert len({m for m, _ in classes}) == len(classes)
    assert sorted(seen) == list(range(b))
    starts = plan.ints[plan.u:plan.u + plan.groups + 1]
    per = kernels.MULTI_GROUPS_PER_BLOCK
    recs = [int(starts[min(g + per, plan.groups)] - starts[g]) for g in range(0, plan.groups, per)]
    assert plan.block_ints == max(recs) + min(per, plan.groups) + 1
    assert plan.block_ints <= kernels.multi_group_ints(b, k)
    assert plan.ints.size == starts[-1] and starts[0] % 4 == 0


def test_multi_plan_groups_range_rows_together():
    """A Range batch of a few bitmap rows over overlapping spans: the
    queries of one bitmap row share a component, so no group mixes two
    bitmap rows unless a row's queries do not fill whole groups, and the
    groups' rows are far fewer than the queries' operands."""
    rng = np.random.default_rng(12)
    bitmaps, views = 8, 31
    idx = _range_like(rng, 128, bitmaps, views, 23)
    ids, local = kernels.compact_rows(idx, bitmaps * views, "idx")
    plan = kernels.multi_plan("or", ids, local)
    mixed = 0
    union = 0
    for qs, _, classes in _records(plan):
        mixed += len({int(idx[q, 0]) % bitmaps for q in qs if q >= 0}) > 1
        union += sum(len(rows) for _, rows in classes)
    assert mixed <= bitmaps
    refs = sum(len(set(row)) for row in idx.tolist())
    assert union < 0.75 * refs


def test_multi_plan_fold_of_one_operand_is_the_row():
    rng = np.random.default_rng(5)
    rm = _words(rng, (2, 6, 64))
    idx = rng.integers(0, 6, size=(7, 1)).astype(np.int32)
    for op in kernels.MULTI_OPS:
        plan, got = _model(op, rm, idx, "slice")
        assert plan.op == "and"
        np.testing.assert_array_equal(got.numpy(), jbw.np_gather_count_multi("and", rm, idx))
