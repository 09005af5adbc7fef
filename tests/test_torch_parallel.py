"""The port's slice-sharded layer (``pilosa_tpu_torch.parallel``, the
``MeshEngine``) against the JAX package's meshes.

Real ``torch.distributed`` jobs of 1, 2 and 4 gloo ranks on the CPU run
this file's ``__main__`` branch (one process per rank, no JAX imported):
every sharded composition over seeded numpy inputs, the 2 x 2
(slice x replica) mesh, the process-local stack build and its fetch,
the divisibility guard and the ragged-slice replicate rule, and the
port's executor over a ``MeshEngine`` on a seeded holder.  The test
process runs the same inputs through the JAX ``SliceMesh`` /
``ReplicaMesh`` on conftest's 8 virtual devices (Pallas kernels in
interpret mode, as tests/test_parallel.py runs them) and the JAX
executor over its ``MeshEngine`` and the numpy engine; every result must
be equal.

    python tests/test_torch_parallel.py rank <coordinator> <n> <rank>

runs one rank and prints its results as one JSON line.
"""

import json
import os
import socket
import subprocess
import sys
from datetime import datetime

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
JOB_TIMEOUT_S = 150

# Composition inputs: 8 slices divide over 1, 2, 4 ranks and 8 devices.
S, R, W = 8, 6, 1024
OPS = ("and", "or", "xor", "andnot")
MULTI_OPS = ("and", "or", "andnot")
K_SCORE = 4
REPLICA_BATCH = 12


def composition_inputs():
    rng = np.random.default_rng(12)
    u = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    return {
        "a": u(S, W), "b": u(S, W), "rows": u(S, R, W), "src": u(S, W),
        "pairs": rng.integers(0, R, size=(5, 2)).astype(np.int32),
        "idx": rng.integers(0, R, size=(3, 4)).astype(np.int32),
        "leaves": rng.integers(0, R, size=(4, 8)).astype(np.int32),
        "opc": rng.integers(0, 5, size=(4, 7)).astype(np.int32),
        "ids": rng.integers(0, R, size=K_SCORE).astype(np.int32),
        "rpairs": rng.integers(0, R, size=(REPLICA_BATCH, 2)).astype(np.int32),
    }


# Executor inputs: index "i" over 8 slices (shards at 1, 2 and 4 ranks)
# with a time frame, and index "r" over 3 slices (ragged at 2 and 4
# ranks: replicated, computed whole on every rank).
EX_SLICES, EX_ROWS, EX_BITS = 8, 16, 60
RAGGED_SLICES = 3
STAMPS = [datetime(2017, m, d) for m in (1, 2, 3) for d in (1, 10, 20)]


def _pql_pairs(rng, n, ops, frame="f"):
    names = {"and": "Intersect", "or": "Union", "andnot": "Difference", "xor": "Xor"}
    return " ".join(
        f'Count({names[ops[i % len(ops)]]}(Bitmap(rowID={a}, frame="{frame}"), '
        f'Bitmap(rowID={b}, frame="{frame}")))'
        for i, (a, b) in enumerate(rng.integers(0, EX_ROWS, size=(n, 2)))
    )


def executor_requests() -> list:
    """(name, index, pql, engine flavour) in the order every rank runs
    them: the sequential path, the fused pair lane cold (direct kernel)
    and warm (the Gram), a no-Gram gather batch, N-ary and Range folds,
    nested trees, TopN with and without a src, a write and a re-read, and
    the ragged index."""
    rng = np.random.default_rng(21)
    b = lambda r, f="f": f'Bitmap(rowID={int(r)}, frame="{f}")'  # noqa: E731
    pairs = _pql_pairs(rng, 24, OPS)
    nary = " ".join(
        [f"Count(Intersect({b(1)}, {b(2)}, {b(3)}))", f"Count(Union({b(0)}, {b(4)}, {b(5)}, {b(6)}))",
         f"Count(Difference({b(7)}, {b(8)}, {b(9)}))", f"Count(Xor({b(1)}, {b(10)}, {b(11)}))"])
    trees = " ".join(
        [f"Count(Intersect(Union({b(1)}, {b(2)}), Difference({b(3)}, {b(4)})))",
         f"Count(Union(Intersect(Xor({b(5)}, {b(6)}), {b(7)}), Difference({b(8)}, Union({b(9)}, {b(0)}))))",
         f"Count(Xor(Union({b(2)}, {b(12)}), Intersect({b(13)}, {b(14)})))"])
    ranges = " ".join(
        f'Count(Range(rowID={r}, frame="t", start="{s}", end="{e}"))'
        for r, s, e in ((0, "2017-01-01T00:00", "2017-03-01T00:00"),
                        (1, "2017-01-05T00:00", "2017-02-15T00:00"),
                        (2, "2017-01-01T00:00", "2018-01-01T00:00"),
                        (3, "2017-02-01T00:00", "2017-03-11T00:00")))
    return [
        ("count-single", "i", f"Count(Intersect({b(0)}, {b(1)}))", "mesh"),
        ("count-union", "i", f"Count(Union({b(2)}, {b(3)}))", "mesh"),
        ("bitmap", "i", b(1), "mesh"),
        ("pairs-cold", "i", pairs, "mesh"),
        ("pairs-warm", "i", pairs, "mesh"),
        ("pairs-gram", "i", pairs, "mesh"),
        ("gather-nogram", "i", _pql_pairs(rng, 6, ("xor", "and")), "nogram"),
        ("nary", "i", nary, "mesh"),
        ("tree", "i", trees, "mesh"),
        ("range", "i", ranges, "mesh"),
        ("topn", "i", 'TopN(frame="f", n=3)', "mesh"),
        ("topn-src", "i", f'TopN({b(0)}, frame="f", n=5)', "mesh"),
        ("setbit", "i", f'SetBit(rowID=1, frame="f", columnID={3 * (1 << 20) + 77})', "mesh"),
        ("pairs-after-write", "i", pairs, "mesh"),
        ("ragged-pairs", "r", _pql_pairs(rng, 8, OPS), "mesh"),
        ("ragged-bitmap", "r", b(2), "mesh"),
        ("ragged-count", "r", f"Count(Xor({b(2)}, {b(3)}))", "mesh"),
    ]


def load_holder(holder, frame_options):
    """The executor's seeded data, through either package's Holder."""
    from_slice = 1 << 20
    rng = np.random.default_rng(22)
    for name, n_slices in (("i", EX_SLICES), ("r", RAGGED_SLICES)):
        idx = holder.create_index(name)
        idx.create_frame("f", frame_options())
        rows = np.repeat(np.arange(EX_ROWS, dtype=np.uint64), EX_BITS)
        for s in range(n_slices):
            cols = rng.integers(0, 4000, size=len(rows)).astype(np.uint64)
            idx.frame("f").import_bits(rows, cols + np.uint64(s * from_slice))
    idx = holder.index("i")
    idx.create_frame("t", frame_options(time_quantum="YMD"))
    rows = np.repeat(np.arange(4, dtype=np.uint64), EX_BITS)
    for s in range(EX_SLICES):
        cols = rng.integers(0, 4000, size=len(rows)).astype(np.uint64) + np.uint64(s * from_slice)
        idx.frame("t").import_bits(rows, cols, [STAMPS[i] for i in rng.integers(0, len(STAMPS), len(rows))])


def norm(results) -> list:
    out = []
    for r in results:
        if hasattr(r, "bits"):
            out.append(["bits", [int(x) for x in r.bits()]])
        elif isinstance(r, list):
            out.append([[int(p.id), int(p.count)] for p in r])
        elif isinstance(r, (bool, np.bool_)):
            out.append(bool(r))
        else:
            out.append(int(r))
    return out


# ---------------------------------------------------------------------------
# one rank (the __main__ branch): imports torch and the port only
# ---------------------------------------------------------------------------

def _ints(t) -> list:
    return np.asarray(t.cpu() if hasattr(t, "cpu") else t).astype(np.int64).tolist()


def rank_compositions(n: int) -> dict:
    from pilosa_tpu_torch.parallel import (
        MultiHostSliceMesh,
        ReplicaMesh,
        replica_gather_count,
        sharded_count_and,
        sharded_count_call,
        sharded_union_reduce,
    )
    from pilosa_tpu_torch.parallel import sharded as sh

    x = composition_inputs()
    mesh = MultiHostSliceMesh(device="cpu")
    a, b = mesh.shard_stack(x["a"]), mesh.shard_stack(x["b"])
    rows, src = mesh.shard_stack(x["rows"]), mesh.shard_stack(x["src"])
    out = {"count_and": int(sharded_count_and(mesh, a, b))}
    out["count_call"] = {op: int(sharded_count_call(mesh, op, a, b)) for op in OPS}
    out["union"] = mesh.fetch_global(sharded_union_reduce(mesh, [a, b])).tolist()
    out["gather"] = {op: _ints(sh.sharded_gather_count(mesh, op, rows, x["pairs"])) for op in OPS}
    out["multi"] = {op: _ints(sh.sharded_gather_count_multi(mesh, op, rows, x["idx"]))
                    for op in MULTI_OPS}
    out["tree"] = _ints(sh.sharded_gather_count_tree(mesh, rows, x["leaves"], x["opc"]))
    out["scorer"] = _ints(sh.sharded_scorer_counts(mesh, rows, x["ids"], src))
    out["topn"] = _ints(sh.sharded_topn_counts(mesh, rows, src))
    owned = mesh.owned_slices(S)
    local = mesh.shard_stack_local({s: x["a"][s] for s in owned}, S, (W,))
    out["owned"] = owned
    out["fetch"] = mesh.fetch_global(local).tolist()
    try:
        mesh.shard_stack_local({s: x["a"][s].astype(np.int64) for s in owned}, S, (W,))
        out["dtype_guard"] = None
    except TypeError as e:
        out["dtype_guard"] = str(e)
    try:
        mesh.shard_stack(np.zeros((S + 1, W), dtype=np.uint32))
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    if n % 2 == 0:
        rmesh = ReplicaMesh(n_replicas=2, device="cpu", hybrid=True)
        out["replica"] = {
            "hybrid": rmesh.hybrid, "n_devices": rmesh.n_devices, "n_replicas": rmesh.n_replicas,
            "counts": {op: _ints(replica_gather_count(rmesh, op, rmesh.shard_stack(x["rows"]),
                                                      x["rpairs"])) for op in OPS},
        }
        try:
            replica_gather_count(rmesh, "and", rmesh.shard_stack(x["rows"]), x["rpairs"][:11])
            out["replica"]["batch_guard"] = None
        except ValueError as e:
            out["replica"]["batch_guard"] = str(e)
    return out


def rank_executor(n: int) -> dict:
    import tempfile

    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.engine import MeshEngine, SliceShard
    from pilosa_tpu_torch.executor import Executor

    out = {}
    with tempfile.TemporaryDirectory() as d:
        h = Holder(d)
        h.open()
        load_holder(h, FrameOptions)
        eng = MeshEngine(device="cpu")
        ex = {"mesh": Executor(h, engine=eng),
              "nogram": Executor(h, engine=MeshEngine(device="cpu"), no_gram=True)}
        for name, index, pql, flavour in executor_requests():
            out[name] = norm(ex[flavour].execute(index, pql))
        # The shard rule at the engine: 8 slices shard, 3 do not (at 2 and
        # 4 ranks) and run whole with no collective.
        m8 = eng.matrix(np.zeros((EX_SLICES, 2, 64), dtype=np.uint32))
        m3 = eng.matrix(np.ones((RAGGED_SLICES, 2, 64), dtype=np.uint32))
        c0 = eng.mesh.stat_collectives
        ragged = eng.gather_count("and", m3, np.array([[0, 1]], dtype=np.int32)).tolist()
        out["shard_rule"] = {
            "8": [isinstance(m8, SliceShard), int(m8.shape[0])],
            "3": [isinstance(m3, SliceShard), int(m3.shape[0])],
            "ragged_counts": ragged, "ragged_collectives": eng.mesh.stat_collectives - c0,
            "single_slice_score": eng.supports_single_slice_score,
        }
        # The fused lane's mixed launch: three fold groups, one local
        # launch and one all_reduce for all of them.
        mm = eng.matrix(mixed_matrix())
        c0 = eng.mesh.stat_collectives
        counts = eng.to_numpy(eng.gather_count_multi_mixed_dev(mm, MIXED_GROUPS))
        out["mixed"] = {"counts": counts.astype(np.int64).tolist(),
                        "collectives": eng.mesh.stat_collectives - c0}
        h.close()
    return out


# Fold groups (op, ids) over a [EX_SLICES, 6, 64] matrix for the mixed
# launch on the mesh.
MIXED_GROUPS = (("and", np.array([[0, 1, 2], [1, 2, 3]], np.int32)),
                ("or", np.array([[0, 1, 2, 3, 4]], np.int32)),
                ("andnot", np.array([[5, 0, 1, 2], [2, 2, 5, 3]], np.int32)))


def mixed_matrix() -> np.ndarray:
    return np.random.default_rng(23).integers(0, 1 << 32, size=(EX_SLICES, 6, 64), dtype=np.uint32)


def rank_main(coordinator: str, n: int, pid: int) -> int:
    from pilosa_tpu_torch.parallel import init_multihost

    init_multihost(coordinator, n, pid, device="cpu", timeout_s=60)
    res = {"rank": pid, "compositions": rank_compositions(n), "executor": rank_executor(n),
           "jax_loaded": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
           "pilosa_tpu_loaded": any(m == "pilosa_tpu" or m.startswith("pilosa_tpu.")
                                    for m in sys.modules)}
    print(json.dumps(res), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the tests (JAX side in this process)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_job(script: str, n: int, args=()) -> list:
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    return [
        subprocess.Popen([sys.executable, script, "rank", coord, str(n), str(pid), *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env,
                         text=True)
        for pid in range(n)
    ]


def collect_job(procs, timeout=JOB_TIMEOUT_S) -> list:
    """Every rank's last JSON line; a rank past ``timeout`` fails the job
    (and every rank is killed) instead of hanging the suite."""
    import time

    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank of a {len(procs)}-rank job passed {timeout} s")
            assert p.returncode == 0, f"rank failed:\nstdout={out[-2000:]}\nstderr={err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def jobs():
    """One job each of 1, 2 and 4 ranks, one after the other (at most 4
    rank processes at a time beside the suite's other workers)."""
    return {n: collect_job(start_job(os.path.abspath(__file__), n)) for n in WORLDS}


@pytest.fixture(scope="module")
def jax_comp():
    """The compositions on the JAX meshes (8 virtual devices, Pallas in
    interpret mode)."""
    import jax

    from pilosa_tpu.parallel import (
        MultiHostSliceMesh as JMultiHostSliceMesh,
        ReplicaMesh as JReplicaMesh,
        SliceMesh as JSliceMesh,
        replica_gather_count as jreplica_gather_count,
        sharded_count_and as jcount_and,
        sharded_count_call as jcount_call,
        sharded_union_reduce as junion,
    )
    from pilosa_tpu.parallel import sharded as jsh

    if len(jax.devices()) < 8:
        pytest.skip("needs conftest's 8 virtual devices")
    x = composition_inputs()
    mesh = JSliceMesh(jax.devices())
    a, b = mesh.shard_stack(x["a"]), mesh.shard_stack(x["b"])
    rows, src = mesh.shard_stack(x["rows"]), mesh.shard_stack(x["src"])
    ints = lambda v: np.asarray(v).astype(np.int64).tolist()  # noqa: E731
    out = {"count_and": int(jcount_and(mesh, a, b))}
    out["count_call"] = {op: int(jcount_call(mesh, op, a, b)) for op in OPS}
    out["union"] = np.asarray(junion(mesh, [a, b])).tolist()
    out["gather"] = {op: ints(jsh.sharded_gather_count(mesh, op, rows, x["pairs"], interpret=True))
                     for op in OPS}
    out["multi"] = {op: ints(jsh.sharded_gather_count_multi(mesh, op, rows, x["idx"], interpret=True))
                    for op in MULTI_OPS}
    out["tree"] = ints(jsh.sharded_gather_count_tree(mesh, rows, x["leaves"], x["opc"], interpret=True))
    out["scorer"] = ints(jsh.sharded_scorer_counts(mesh, rows, jax.numpy.asarray(x["ids"]), src))
    out["topn"] = ints(jsh.sharded_topn_counts(mesh, rows, src))
    mh = JMultiHostSliceMesh(jax.devices())
    out["fetch"] = mh.fetch_global(
        mh.shard_stack_local({s: x["a"][s] for s in range(S)}, S, (W,))).tolist()
    try:
        jsh._require_divisible(S + 1, 2)
    except ValueError as e:
        out["divisibility"] = str(e).replace(f"mesh size {2}", "mesh size {n}")
    rmesh = JReplicaMesh(n_replicas=2, devices=jax.devices()[:8], hybrid=True)
    out["replica"] = {
        "hybrid": rmesh.hybrid,
        "counts": {op: ints(jreplica_gather_count(rmesh, op, rmesh.shard_stack(x["rows"]),
                                                  jax.numpy.asarray(x["rpairs"]), interpret=True))
                   for op in OPS},
    }
    return out


@pytest.fixture(scope="module")
def jax_exec(tmp_path_factory):
    """The executor requests through the JAX MeshEngine and numpy engine."""
    from pilosa_tpu.core.frame import FrameOptions
    from pilosa_tpu.core.holder import Holder
    from pilosa_tpu.executor import Executor

    h = Holder(str(tmp_path_factory.mktemp("jmesh")))
    h.open()
    load_holder(h, FrameOptions)
    ex = {"mesh": Executor(h, engine="mesh"), "nogram": Executor(h, engine="mesh", no_gram=True)}
    ex_np = Executor(h, engine="numpy")
    out = {}
    for name, index, pql, flavour in executor_requests():
        out[name] = norm(ex[flavour].execute(index, pql))
        if not pql.startswith("SetBit"):
            assert norm(ex_np.execute(index, pql)) == out[name], name
    h.close()
    return out


def _rank(jobs, n, k=0):
    return jobs[n][k]


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_import_no_jax(jobs, n):
    for r in jobs[n]:
        assert not r["jax_loaded"] and not r["pilosa_tpu_loaded"]


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_count_and(jobs, jax_comp, n):
    assert {r["compositions"]["count_and"] for r in jobs[n]} == {jax_comp["count_and"]}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_count_call(jobs, jax_comp, n, op):
    assert {r["compositions"]["count_call"][op] for r in jobs[n]} == {jax_comp["count_call"][op]}


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_union_reduce(jobs, jax_comp, n):
    for r in jobs[n]:
        assert r["compositions"]["union"] == jax_comp["union"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_gather_count(jobs, jax_comp, n, op):
    for r in jobs[n]:
        assert r["compositions"]["gather"][op] == jax_comp["gather"][op]


@pytest.mark.parametrize("op", MULTI_OPS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_gather_count_multi(jobs, jax_comp, n, op):
    for r in jobs[n]:
        assert r["compositions"]["multi"][op] == jax_comp["multi"][op]


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_gather_count_tree(jobs, jax_comp, n):
    for r in jobs[n]:
        assert r["compositions"]["tree"] == jax_comp["tree"]


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_scorer_counts(jobs, jax_comp, n):
    for r in jobs[n]:
        assert r["compositions"]["scorer"] == jax_comp["scorer"]
        assert np.shape(r["compositions"]["scorer"]) == (S, K_SCORE)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_topn_counts(jobs, jax_comp, n):
    for r in jobs[n]:
        assert r["compositions"]["topn"] == jax_comp["topn"]


@pytest.mark.parametrize("n", WORLDS)
def test_shard_stack_local_fetch_global(jobs, jax_comp, n):
    owned = [r["compositions"]["owned"] for r in jobs[n]]
    assert sorted(s for o in owned for s in o) == list(range(S))
    for k, o in enumerate(owned):
        assert o == list(range(k * S // n, (k + 1) * S // n))
    for r in jobs[n]:
        assert r["compositions"]["fetch"] == jax_comp["fetch"]
        assert "!= declared uint32" in r["compositions"]["dtype_guard"]


@pytest.mark.parametrize("n", (2, 4))
def test_divisibility_guard(jobs, jax_comp, n):
    want = jax_comp["divisibility"].replace("{n}", str(n))
    for r in jobs[n]:
        assert r["compositions"]["divisibility"] == want


def test_replica_gather_count_2x2(jobs, jax_comp):
    """4 ranks as a (2, 2) slice x replica mesh against the JAX (4, 2)
    mesh on 8 devices: the same counts, each replica group answering
    half of the batch."""
    for r in jobs[4]:
        rep = r["compositions"]["replica"]
        assert rep["n_devices"] == 2 and rep["n_replicas"] == 2
        assert rep["counts"] == jax_comp["replica"]["counts"]
        assert "not divisible by 2 replicas" in rep["batch_guard"]


@pytest.mark.parametrize("n", (2, 4))
def test_replica_mesh_hybrid_fallback(jobs, jax_comp, n):
    """hybrid=True on one host builds the flat layout, as the reference's
    does without a second granule; ``hybrid`` records it."""
    assert jax_comp["replica"]["hybrid"] is False
    for r in jobs[n]:
        assert r["compositions"]["replica"]["hybrid"] is False


@pytest.mark.parametrize("name", [q[0] for q in executor_requests()])
@pytest.mark.parametrize("n", WORLDS)
def test_mesh_engine_executor_matches_jax(jobs, jax_exec, n, name):
    """Executor(h, engine=MeshEngine) on every rank equals the JAX
    executor over its MeshEngine (and the numpy engine)."""
    for r in jobs[n]:
        assert r["executor"][name] == jax_exec[name]


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_engine_shard_rule(jobs, n):
    """A slice axis that divides over the ranks is sharded (each rank
    one block); a ragged one is replicated and computed whole with no
    collective."""
    for r in jobs[n]:
        rule = r["executor"]["shard_rule"]
        assert rule["8"] == [True, EX_SLICES // n]
        assert rule["3"] == ([True, RAGGED_SLICES] if n == 1 else [False, RAGGED_SLICES])
        assert rule["ragged_counts"] == [RAGGED_SLICES * 64]  # words of 1: one bit each
        assert rule["ragged_collectives"] == (1 if n == 1 else 0)
        assert rule["single_slice_score"] is (n == 1)


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_engine_mixed_launch_one_collective(jobs, n):
    """MeshEngine.gather_count_multi_mixed_dev: every group's counts, in
    group order, from one local mixed launch and ONE all_reduce."""
    from pilosa_tpu_torch.ops.bitwise import np_gather_count_multi

    m = mixed_matrix()
    want = [int(v) for op, idx in MIXED_GROUPS for v in np_gather_count_multi(op, m, idx)]
    for r in jobs[n]:
        assert r["executor"]["mixed"] == {"counts": want, "collectives": 1}


def test_new_engine_mesh(monkeypatch):
    """new_engine("mesh") takes the card and raises without one; the CPU
    is asked for, as for "torch:cpu"."""
    import torch

    from pilosa_tpu_torch.engine import MeshEngine, new_engine

    eng = new_engine("mesh:cpu")
    assert isinstance(eng, MeshEngine) and eng.device.type == "cpu"
    assert eng.mesh.n_devices == 1 and not eng.supports_row_major_gather
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        new_engine("mesh")


def test_backend_rule():
    import torch

    from pilosa_tpu_torch.parallel.multihost import choose_backend

    assert choose_backend(torch.device("cpu"), 4, 0) == "gloo"
    assert choose_backend(torch.device("cuda", 0), 1, 1) == "nccl"
    assert choose_backend(torch.device("cuda", 0), 4, 8) == "nccl"
    assert choose_backend(torch.device("cuda", 0), 2, 1) == "gloo"


def test_init_multihost_needs_its_job():
    from pilosa_tpu_torch.parallel import init_multihost

    with pytest.raises(ValueError, match="coordinator"):
        init_multihost(None, 2, 0, device="cpu")


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        sys.exit(rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(f"usage: {sys.argv[0]} rank <coordinator> <n> <rank>")
