"""The mixed multi fold (``kernels.gather_count_multi_mixed``): one launch
for a batch whose queries carry their own op and K, and the fused lane's
one launch a resident part for all of its N-ary groups.

The plain version (and the wrapper on a CPU tensor) is held exactly
(tolerance 0) against the JAX package's Pallas ``fused_gather_count_multi``
in interpret mode, run group by group; a numpy model that decodes the
kernel's int layout the way the CUDA blocks do is held against the plain
version; the dispatch keeps each group the staged gate admits on its
staged launch; and the executor makes one mixed engine call a part, with
the counts of the per-group path, of ``benchport/reference.py``'s plain
recount and of the numpy engine.
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from benchport import reference
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch import executor as executor_mod
from pilosa_tpu_torch.core.frame import FrameOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.engine import NumpyEngine, TorchEngine
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bitwise, dispatch, kernels
from pilosa_tpu_torch.pilosa import SLICE_WIDTH

S, R, W = 2, 40, 1024
LIMIT = kernels.MIXED_PARAM_INTS


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never reach a kernel: the launch counters stay put."""
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


def _n_ints(ks) -> int:
    b = len(ks)
    return b + 1 + -(-b // 8) + int(sum(ks))


def _batch(seed, b, ks, n_ints=None):
    """A ragged batch: ``b`` queries, each of a random op of and / or /
    andnot and a K drawn from ``ks``; every fifth query repeats an id,
    and each andnot's first operand is named by the next query too.
    With ``n_ints`` the last query's K is set so that the kernel's layout
    holds exactly that many ints."""
    rng = np.random.default_rng(seed)
    ops = [kernels.MULTI_OPS[i] for i in rng.integers(0, 3, size=b)]
    k = rng.choice(ks, size=b)
    if n_ints is not None:
        k[-1] += n_ints - _n_ints(k)
        assert k[-1] >= 1
    off = np.concatenate([[0], np.cumsum(k)]).astype(np.int32)
    ids = rng.integers(0, R, size=int(off[-1])).astype(np.int32)
    for q in range(0, b, 5):
        if k[q] > 1:
            ids[off[q] + 1] = ids[off[q]]
    for q in range(b - 1):
        if ops[q] == "andnot":
            ids[off[q + 1]] = ids[off[q]]
    return ops, off, ids


CASES = {
    "mixed": (1, 60, np.arange(1, 24), None),
    "params_edge": (2, 390, np.array([1, 2, 3, 5, 8, 16, 23]), LIMIT),
    "array": (3, 390, np.array([1, 2, 3, 5, 8, 16, 23]), LIMIT + 1),
}


def _words(seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(S, R, W), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _pallas_counts(case):
    """The batch's counts from the Pallas kernel, one call an (op, K)
    group (a group's size rounded up to 8 queries by repeating its first,
    so that the interpreter compiles few shapes)."""
    seed, b, ks, n = CASES[case]
    ops, off, ids = _batch(seed, b, ks, n)
    rm = jnp.asarray(_words(seed))
    k = np.diff(off)
    want = np.zeros(b, dtype=np.int64)
    for op, kk in sorted({(o, int(x)) for o, x in zip(ops, k)}):
        qs = [q for q in range(b) if ops[q] == op and k[q] == kk]
        idx = np.stack([ids[off[q]:off[q + 1]] for q in qs])
        padded = np.concatenate([idx, np.repeat(idx[:1], -len(qs) % 8, axis=0)])
        got = np.asarray(pk.fused_gather_count_multi(op, rm, jnp.asarray(padded), interpret=True))
        want[qs] = got[:len(qs)]
    return want


@pytest.mark.parametrize("layout", ["slice", "row"])
@pytest.mark.parametrize("case", list(CASES))
def test_mixed_matches_pallas_group_by_group(case, layout):
    seed, b, ks, n = CASES[case]
    ops, off, ids = _batch(seed, b, ks, n)
    if n is not None:
        assert kernels.multi_mixed_ints(ops, off, ids).size == n
    want = _pallas_counts(case)
    rm = bitwise.to_words(_words(seed))
    m = rm if layout == "slice" else rm.transpose(0, 1).contiguous()
    row_major = layout == "row"
    for fn in (kernels.gather_count_multi_mixed_plain, kernels.gather_count_multi_mixed):
        got = fn(m, ops, off, ids, row_major)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _kernel_model(rm: np.ndarray, ints: np.ndarray, b: int) -> np.ndarray:
    """gather_count_multi_mixed.cu's decode and fold in numpy: query q's
    offsets ints[q], ints[q + 1]; its op nibble q % 8 of word b + 1 + q // 8;
    its ids from b + 1 + ceil(b / 8) + ints[q]; acc starts at the first
    operand and folds each next one with the op (andnot: acc & ~row)."""
    out = np.zeros(b, dtype=np.int64)
    ids0 = b + 1 + (b + 7) // 8
    for q in range(b):
        k0, k1 = int(ints[q]), int(ints[q + 1])
        op = (int(ints[b + 1 + (q >> 3)]) & 0xFFFFFFFF) >> (4 * (q & 7)) & 15
        acc = rm[:, ints[ids0 + k0]]
        for j in range(k0 + 1, k1):
            row = rm[:, ints[ids0 + j]]
            acc = {1: acc & row, 2: acc | row, 4: acc & ~row}[op]
        out[q] = int(bitwise.popcount_words(torch.from_numpy(acc.view(np.int32))).sum())
    return out


@pytest.mark.parametrize("b", [1, 7, 8, 9, 60])
def test_kernel_layout_decodes_to_the_plain_counts(b):
    ops, off, ids = _batch(10 + b, b, np.arange(1, 24))
    rm = _words(b)
    ints = kernels.multi_mixed_ints(ops, off, ids)
    assert ints.dtype == np.int32 and ints.size == _n_ints(np.diff(off))
    want = kernels.gather_count_multi_mixed_plain(bitwise.to_words(rm), ops, off, ids)
    np.testing.assert_array_equal(_kernel_model(rm, ints, b), want.numpy())


def _group(rng, op, b, k, rows=R):
    return op, rng.integers(0, rows, size=(b, k)).astype(np.int32)


def _spy(monkeypatch, mod, name, calls):
    orig = getattr(mod, name)

    def spy(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("staged", [0, 1, 2])
def test_dispatch_keeps_staged_groups_and_mixes_the_rest(monkeypatch, staged):
    """Groups the staged gate admits (128 folds of 16 operands over 64
    shared rows) keep their staged launch; the rest go in one mixed
    launch; the counts are the per-group dispatch's, in group order."""
    rng = np.random.default_rng(staged)
    rm = bitwise.to_words(rng.integers(0, 1 << 32, size=(S, 256, W), dtype=np.uint32))
    wide = [_group(rng, op, 128, 16, rows=64) for op in ("or", "andnot")[:staged]]
    small = [_group(rng, "and", 3, 3, 256), _group(rng, "or", 5, 12, 256),
             _group(rng, "andnot", 2, 4, 256)]
    groups = small[:1] + wide + small[1:]
    for op, idx in wide:
        assert dispatch.staged_multi_batch(op, idx, S, 256, W) is not None
    calls = []
    _spy(monkeypatch, kernels, "resident_count_multi", calls)
    _spy(monkeypatch, kernels, "gather_count_multi_mixed", calls)
    got = dispatch.gather_count_multi_mixed(rm, groups)
    assert calls.count("resident_count_multi") == staged
    assert calls.count("gather_count_multi_mixed") == 1
    want = torch.cat([dispatch.gather_count_multi(op, rm, idx) for op, idx in groups])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    rmt = rm.transpose(0, 1).contiguous()
    got_rm = dispatch.gather_count_multi_mixed(rmt, groups, row_major=True)
    np.testing.assert_array_equal(got_rm.numpy(), want.numpy())


def test_dispatch_all_staged_makes_no_mixed_launch(monkeypatch):
    rng = np.random.default_rng(5)
    rm = bitwise.to_words(rng.integers(0, 1 << 32, size=(S, 256, W), dtype=np.uint32))
    groups = [_group(rng, "or", 128, 16, rows=64)]
    calls = []
    _spy(monkeypatch, kernels, "gather_count_multi_mixed", calls)
    got = dispatch.gather_count_multi_mixed(rm, groups)
    assert calls == []
    np.testing.assert_array_equal(got.numpy(), dispatch.gather_count_multi("or", rm, groups[0][1]).numpy())


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_engines_mixed_counts_follow_group_order(engine):
    rng = np.random.default_rng(9)
    host = rng.integers(0, 1 << 32, size=(S, R, W), dtype=np.uint32)
    groups = [_group(rng, "and", 4, 3), _group(rng, "or", 2, 9), _group(rng, "andnot", 3, 5)]
    eng = NumpyEngine() if engine == "numpy" else TorchEngine("cpu")
    m = eng.matrix(host)
    got = eng.to_numpy(eng.gather_count_multi_mixed_dev(m, groups))
    want = np.concatenate([eng.to_numpy(eng.gather_count_multi_dev(op, m, idx)) for op, idx in groups])
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("bad", ["op", "k0", "end", "range", "shape"])
def test_mixed_rejects_bad_batches(bad):
    rm = bitwise.to_words(_words(0))
    ops, off, ids = ["and", "or"], np.array([0, 2, 5], np.int32), np.array([1, 2, 3, 4, 5], np.int32)
    if bad == "op":
        ops = ["and", "xor"]
    elif bad == "k0":
        off = np.array([0, 0, 5], np.int32)
    elif bad == "end":
        off = np.array([0, 2, 4], np.int32)
    elif bad == "range":
        ids = np.array([1, 2, 3, 4, R], np.int32)
    else:
        off = np.array([0, 2], np.int32)
    err = IndexError if bad == "range" else ValueError
    with pytest.raises(err):
        kernels.gather_count_multi_mixed(rm, ops, off, ids)


# ---------------------------------------------------------------------------
# the fused lane: one mixed launch a resident part
# ---------------------------------------------------------------------------

N_SLICES, N_ROWS = 2, 48
PQL = {"and": "Intersect", "or": "Union", "andnot": "Difference"}
REF_OP = {"and": "Intersect", "or": "Union", "andnot": "Difference"}


def _load(holder):
    idx = holder.create_index("i")
    rng = np.random.default_rng(17)
    for name in ("f", "g"):
        idx.create_frame(name, FrameOptions())
        rows = np.repeat(np.arange(N_ROWS, dtype=np.uint64), 300)
        for s in range(N_SLICES):
            cols = rng.integers(0, SLICE_WIDTH, size=len(rows)).astype(np.uint64)
            idx.frame(name).import_bits(rows, cols + np.uint64(s * SLICE_WIDTH))


@pytest.fixture
def holder(tmp_path):
    h = Holder(str(tmp_path / "h"))
    h.open()
    _load(h)
    yield h
    h.close()


def _request(seed):
    """N-ary Counts of both frames (Union of 8-16, Intersect of 3-4,
    Difference of 3-5 rows), a pair Count and a nested tree Count: ((op,
    frame, rows) of the N-ary calls, the PQL body)."""
    rng = np.random.default_rng(seed)
    nary, calls = [], []
    for i in range(24):
        op = ("or", "and", "andnot")[i % 3]
        lo, hi = {"or": (8, 16), "and": (3, 4), "andnot": (3, 5)}[op]
        frame = "fg"[i % 2]
        rows = [int(r) for r in rng.choice(N_ROWS, size=int(rng.integers(lo, hi + 1)), replace=False)]
        nary.append((op, frame, rows))
        leaves = ", ".join(f'Bitmap(rowID={r}, frame="{frame}")' for r in rows)
        calls.append(f"Count({PQL[op]}({leaves}))")
    calls.insert(5, 'Count(Intersect(Bitmap(rowID=1, frame="f"), Bitmap(rowID=2, frame="f")))')
    calls.insert(11, 'Count(Difference(Union(Bitmap(rowID=3, frame="f"), Bitmap(rowID=4, frame="f")), '
                     'Intersect(Bitmap(rowID=5, frame="f"), Bitmap(rowID=6, frame="f"))))')
    return nary, " ".join(calls)


def _dense(holder, frame) -> torch.Tensor:
    """int32 [rows, slices, W] of a frame, for the plain recount."""
    frags = [holder.fragment("i", frame, "standard", s) for s in range(N_SLICES)]
    m = np.stack([np.stack([f.row_dense(r) for f in frags]) for r in range(N_ROWS)])
    return torch.from_numpy(np.ascontiguousarray(m).view(np.int32))


def test_fused_lane_launches_once_a_part(holder, monkeypatch):
    nary, body = _request(3)
    eng = TorchEngine("cpu")
    calls = {"mixed": 0, "multi": 0}
    for name, key in (("gather_count_multi_mixed_dev", "mixed"), ("gather_count_multi_dev", "multi")):
        def spy(*a, _o=getattr(eng, name), _k=key, **k):
            calls[_k] += 1
            return _o(*a, **k)

        monkeypatch.setattr(eng, name, spy)
    got = Executor(holder, engine=eng).execute("i", body)
    # Two parts (frames f and g), each one mixed launch; no per-group launch.
    assert calls == {"mixed": 2, "multi": 0}
    nary_got = [got[i] for i in range(len(got)) if i not in (5, 11)]
    dense = {fr: _dense(holder, fr) for fr in "fg"}
    want = [reference.count(dense[fr], REF_OP[op], rows) for op, fr, rows in nary]
    assert nary_got == want
    assert got == Executor(holder, engine="numpy").execute("i", body)

    # The per-group path (one launch and fetch an (op, K) group) answers alike.
    def per_group(groups):
        return [[kv] for kv in sorted(groups.items(), key=executor_mod._group_sort_key)]

    group_counts = Executor._group_counts

    def unmixed(self, *a, **k):
        k["mixed"] = False
        return group_counts(self, *a, **k)

    monkeypatch.setattr(executor_mod, "_launch_batches", per_group)
    monkeypatch.setattr(Executor, "_group_counts", unmixed)
    assert Executor(holder, engine=TorchEngine("cpu")).execute("i", body) == got


def test_launch_batches_put_every_nary_group_in_one():
    groups = {("or", 9): [0], ("and", 3): [1, 4], ("and", 2): [2], (("tree", 4), 4): [3],
              ("andnot", 5): [5]}
    batches = executor_mod._launch_batches(groups)
    assert batches == [[(("and", 2), [2])], [(("and", 3), [1, 4]), (("andnot", 5), [5]), (("or", 9), [0])],
                       [((("tree", 4), 4), [3])]]
