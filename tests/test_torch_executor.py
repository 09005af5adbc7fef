"""The slice as a whole: the port's Executor.execute against the JAX
package's, over the same seeded data.

The same ``import_bits`` data go into a ``pilosa_tpu`` holder and a
``pilosa_tpu_torch`` holder; the same PQL sequence runs through the JAX
executor (JaxEngine on the CPU) and the port's executor
(``TorchEngine("cpu")``): batched pair Counts through the direct kernel,
the cached Gram and the native lookup lane, a ``no_gram`` executor, single
Counts, TopN with and without ids, and writes followed by re-queries
(the pool patch and the Gram repair).  Results must be equal, and so must
every fragment's checksum.  A second test sends N-ary, nested,
multi-operand Xor and time-range Count batches, which reach the multi-fold
and tree-fold lanes (``dispatch.gather_count_multi`` / ``_tree``).
"""

from datetime import datetime

import numpy as np
import pytest

from pilosa_tpu.core.frame import FrameOptions as JFrameOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu_torch.core.frame import FrameOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.engine import TorchEngine
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import dispatch
from pilosa_tpu_torch.pilosa import PilosaError, SLICE_WIDTH

PQL = {"and": "Intersect", "or": "Union", "andnot": "Difference", "xor": "Xor"}


def _load(holder, frame_options, n_slices, n_rows, bits, seed):
    idx = holder.create_index("i")
    idx.create_frame("f", frame_options())
    fr = idx.frame("f")
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.uint64), bits)
    for s in range(n_slices):
        cols = rng.integers(0, SLICE_WIDTH, size=len(rows)).astype(np.uint64)
        fr.import_bits(rows, cols + np.uint64(s * SLICE_WIDTH))


class _Spy:
    """Counts calls to selected engine methods (lane checks)."""

    def __init__(self, engine, names):
        self.calls = dict.fromkeys(names, 0)
        for n in names:
            orig = getattr(engine, n)

            def wrap(*a, _o=orig, _n=n, **k):
                self.calls[_n] += 1
                return _o(*a, **k)

            setattr(engine, n, wrap)


def _norm(res):
    out = []
    for r in res:
        if isinstance(r, list):
            out.append([(p.id, p.count) for p in r])
        elif hasattr(r, "bits"):
            out.append(r.bits())
        else:
            out.append(r)
    return out


@pytest.fixture
def pair(tmp_path, request):
    n_slices, n_rows, bits, seed = request.param
    jh = JHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(str(tmp_path / "torch"))
    th.open()
    _load(jh, JFrameOptions, n_slices, n_rows, bits, seed)
    _load(th, FrameOptions, n_slices, n_rows, bits, seed)
    yield jh, th, n_rows, seed
    jh.close()
    th.close()


def _pair_body(rng, n_rows, n, ops=tuple(PQL)):
    pairs = rng.integers(0, n_rows, size=(n, 2))
    pairs[:, 0] = np.resize(rng.permutation(n_rows), n)  # name every row
    return "".join(
        f'Count({PQL[ops[i % len(ops)]]}(Bitmap(rowID={a}, frame="f"), '
        f'Bitmap(rowID={b}, frame="f")))'
        for i, (a, b) in enumerate(pairs)
    )


@pytest.mark.parametrize(
    "pair", [(2, 12, 300, 1), (4, 16, 150, 2)], indirect=True, ids=["s2_r12", "s4_r16"]
)
def test_executor_sequence_matches_jax(pair):
    jh, th, n_rows, seed = pair
    ej = JExecutor(jh)
    ej_ng = JExecutor(jh, no_gram=True)
    te = TorchEngine("cpu")
    et = Executor(th, engine=te)
    et_ng = Executor(th, engine=TorchEngine("cpu"), no_gram=True)
    spy = _Spy(te, ["gather_count", "pair_gram", "gram_update_rows", "count",
                    "batch_intersection_count", "topn_scorer_counts"])
    rng = np.random.default_rng(seed + 100)

    def same(body, j=ej, t=et):
        want = _norm(j.execute("i", body))
        got = _norm(t.execute("i", body))
        assert got == want, body[:120]
        return got

    # 1st request: direct pair kernels; 2nd: the Gram builds and answers;
    # 3rd: the native lookup lane.
    same(_pair_body(rng, n_rows, 2 * n_rows))
    assert spy.calls["gather_count"] > 0 and spy.calls["pair_gram"] == 0
    same(_pair_body(rng, n_rows, 2 * n_rows))
    assert spy.calls["pair_gram"] == 1
    same(_pair_body(rng, n_rows, 2 * n_rows))
    # no_gram executors: direct kernels every time, small batches.
    for _ in range(2):
        same(_pair_body(rng, n_rows, 5, ("xor", "and")), ej_ng, et_ng)
    # Single Counts take the sequential path (engine.count).
    before = spy.calls["count"]
    same('Count(Intersect(Bitmap(rowID=1, frame="f"), Bitmap(rowID=2, frame="f")))')
    same('Count(Bitmap(rowID=3, frame="f"))')
    assert spy.calls["count"] == before + 2
    same('TopN(Bitmap(rowID=0, frame="f"), frame="f", n=5)')
    same('TopN(Bitmap(rowID=1, frame="f"), frame="f", ids=[2, 3, 5, 7])')
    same('TopN(frame="f", n=4)')
    same('Union(Bitmap(rowID=4, frame="f"), Bitmap(rowID=5, frame="f"))')
    # Writes, then re-queries: the pool patches the written rows and the
    # Gram is repaired (rank-k) instead of rebuilt.
    same('SetBit(rowID=2, frame="f", columnID=17) ClearBit(rowID=3, frame="f", columnID=17)')
    same(f'SetBit(rowID=4, frame="f", columnID={SLICE_WIDTH + 9})')
    cols = rng.integers(0, SLICE_WIDTH, size=3)
    same(f'ClearBit(rowID=1, frame="f", columnID={int(cols[0])}) '
         f'Count(Intersect(Bitmap(rowID=1, frame="f"), Bitmap(rowID=4, frame="f")))')
    same(_pair_body(rng, n_rows, 2 * n_rows))
    assert spy.calls["gram_update_rows"] >= 1
    same(_pair_body(rng, n_rows, 5), ej_ng, et_ng)
    same('TopN(Bitmap(rowID=2, frame="f"), frame="f", n=6)')
    assert spy.calls["batch_intersection_count"] > 0
    assert spy.calls["topn_scorer_counts"] > 0

    for s in range(jh.index("i").max_slice() + 1):
        jf = jh.fragment("i", "f", "standard", s)
        tf = th.fragment("i", "f", "standard", s)
        assert tf.checksum() == jf.checksum(), s


# Time-quantum data as bench.py stamps it: 48 stamps in 2017 (months 1-12
# x days {1, 15} x hours {0, 12}); Range spans from its dashboard pool.
STAMPS = [datetime(2017, m, d, hh) for m in range(1, 13) for d in (1, 15) for hh in (0, 12)]
SPANS = [
    ("2017-01-01T00:00", "2018-01-01T00:00"),
    ("2017-02-01T00:00", "2017-07-15T12:00"),
    ("2017-03-01T00:00", "2017-04-01T00:00"),
    ("2017-06-10T00:00", "2017-06-20T00:00"),
    ("2017-01-05T00:00", "2017-01-20T00:00"),
    ("2017-01-27T00:00", "2017-02-16T00:00"),
]


def _load_time(holder, frame_options, n_slices, n_rows, bits, seed):
    """Frame ``t`` (quantum YMD) beside frame ``f``: ``bits`` stamped
    bits per row per slice."""
    holder.index("i").create_frame("t", frame_options(time_quantum="YMD"))
    fr = holder.index("i").frame("t")
    rng = np.random.default_rng(seed + 50)
    rows = np.repeat(np.arange(n_rows, dtype=np.uint64), bits * n_slices)
    cols = (rng.integers(0, SLICE_WIDTH, size=len(rows))
            + np.tile(np.repeat(np.arange(n_slices) * SLICE_WIDTH, bits), n_rows)).astype(np.uint64)
    fr.import_bits(rows, cols, [STAMPS[i] for i in rng.integers(0, len(STAMPS), size=len(rows))])


def _bm(r, frame="f"):
    return f'Bitmap(rowID={int(r)}, frame="{frame}")'


def _nary_body(rng, n_rows, n):
    """Count over 3-5 operand Intersect / Union / Difference."""
    calls = []
    for i in range(n):
        op = ("Intersect", "Union", "Difference")[i % 3]
        k = 3 + i % 3
        calls.append(f"Count({op}({', '.join(_bm(r) for r in rng.integers(0, n_rows, size=k))}))")
    return " ".join(calls)


def _tree_body(rng, n_rows, n):
    """Nested Counts of depth 2-4 (two or more depth buckets)."""
    def b():
        return _bm(rng.integers(0, n_rows))
    shapes = [
        lambda: f"Intersect(Union({b()}, {b()}), Difference({b()}, {b()}))",
        lambda: f"Union(Intersect(Xor({b()}, {b()}), {b()}), Difference({b()}, Union({b()}, {b()})))",
        lambda: (f"Xor(Union(Intersect(Xor({b()}, {b()}), {b()}), {b()}), "
                 f"Difference({b()}, Intersect({b()}, Union({b()}, {b()}))))"),
        lambda: f"Difference(Union({b()}, {b()}, {b()}), {b()})",
    ]
    return " ".join(f"Count({shapes[i % len(shapes)]()})" for i in range(n))


def _xor_body(rng, n_rows, n):
    """Multi-operand Xor (3-5 operands): the tree lane."""
    return " ".join(
        f"Count(Xor({', '.join(_bm(r) for r in rng.integers(0, n_rows, size=3 + i % 3))}))"
        for i in range(n)
    )


def _range_body(rng, n_rows, n):
    return " ".join(
        f'Count(Range(rowID={int(r)}, frame="t", start="{SPANS[j][0]}", end="{SPANS[j][1]}"))'
        for r, j in zip(rng.integers(0, n_rows, size=n), rng.integers(0, len(SPANS), size=n))
    )


@pytest.fixture
def tq_pair(tmp_path):
    n_slices, n_rows, seed = 2, 8, 5
    jh = JHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(str(tmp_path / "torch"))
    th.open()
    for h, fo in ((jh, JFrameOptions), (th, FrameOptions)):
        _load(h, fo, n_slices, n_rows, 200, seed)
        _load_time(h, fo, n_slices, n_rows, 60, seed)
    yield jh, th, n_rows, seed
    jh.close()
    th.close()


@pytest.mark.parametrize(
    "kind,lane",
    [("nary", "multi"), ("tree", "tree"), ("xor", "tree"), ("range", "multi")],
)
def test_fold_lanes_match_jax(tq_pair, monkeypatch, kind, lane):
    """N-ary, nested, multi-Xor and Count(Range) batches: the port's
    executor on TorchEngine("cpu") answers exactly as the JAX executor,
    through the multi-fold or tree-fold lane; a write then a re-query
    covers the Range matrix's rebuild on a generation change."""
    jh, th, n_rows, seed = tq_pair
    calls = {"multi": 0, "tree": 0}
    for name, key in (("gather_count_multi", "multi"), ("gather_count_multi_mixed", "multi"),
                      ("gather_count_tree", "tree")):
        def spy(*a, _o=getattr(dispatch, name), _k=key, **k):
            calls[_k] += 1
            return _o(*a, **k)

        monkeypatch.setattr(dispatch, name, spy)
    ej, et = JExecutor(jh), Executor(th, engine=TorchEngine("cpu"))
    body = {"nary": _nary_body, "tree": _tree_body, "xor": _xor_body, "range": _range_body}[kind]
    rng = np.random.default_rng([seed, len(kind)])

    def same(q):
        want = _norm(ej.execute("i", q))
        got = _norm(et.execute("i", q))
        assert got == want, q[:160]

    for _ in range(2):
        same(body(rng, n_rows, 12))
    reached = calls[lane]
    assert reached > 0, calls
    col = int(rng.integers(0, 2 * SLICE_WIDTH))
    if kind == "range":
        same(f'SetBit(rowID=1, frame="t", columnID={col}, timestamp="2017-01-15T00:00")')
    else:
        same(f'SetBit(rowID=1, frame="f", columnID={col})')
    same(body(rng, n_rows, 12))
    assert calls[lane] > reached, calls


@pytest.mark.parametrize("pair", [(2, 6, 50, 3)], indirect=True)
def test_errors_match_jax(pair):
    jh, th, _, _ = pair
    ej, et = JExecutor(jh), Executor(th, engine=TorchEngine("cpu"))
    for body in ('Count(Bitmap(rowID=1, frame="nope"))', "Count()", 'TopN(frame="f", n=1'):
        with pytest.raises(Exception) as je:
            ej.execute("i", body)
        with pytest.raises(Exception) as te:
            et.execute("i", body)
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)
    with pytest.raises(PilosaError):
        et.execute("i", 'Count(Bitmap(rowID=1, frame="nope"))')


def test_default_engine_needs_cuda(tmp_path):
    """``Executor(holder)`` resolves to TorchEngine("cuda"): without a
    card it raises instead of falling back to the host."""
    import torch

    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        if torch.cuda.is_available():
            assert Executor(h).engine.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                Executor(h)
        assert Executor(h, engine="numpy").engine.name == "numpy"
    finally:
        h.close()
