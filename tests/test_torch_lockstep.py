"""The port's lockstep service (``pilosa_tpu_torch.parallel.service``)
against the JAX package's: the lockstep cases of tests/test_multihost.py,
the in-process single-rank cases of tests/test_replica.py and
tests/test_replica_recovery.py, and the lockstep bulk cases of
tests/test_bulk.py, run through the port.

Multi-rank cases spawn real ``torch.distributed`` jobs of gloo ranks on
the CPU; each rank runs this file's ``__main__`` branch (no JAX imported):
it joins the job (``init_multihost``), seeds the same holder as every
other rank (tests/lockstep_worker.py's data), serves (rank 0: HTTP and
the control plane) or replays (the others), and at shutdown prints its
holder's probes and digest.  Every job has its own timeout.  Where the
reference's tests compare response bodies, the same requests also go to
a JAX ``LockstepService`` seeded alike in this process, and the bodies
must be byte-identical.

    python tests/test_torch_lockstep.py rank <coordinator> <n> <rank> <control_port> <http_port>

runs one rank (rank 0 shuts down when a line arrives on stdin).
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_WIDTH = 1 << 20
JOB_TIMEOUT_S = 120

Q_COUNT = 'Count(Bitmap(rowID=0, frame="f"))'


def seed_holder(holder, frame_options, n_slices: int) -> None:
    """tests/lockstep_worker.py's seed (through either package): index g,
    frame f (time quantum YM), 4 rows x n_slices slices x 2 bits, and
    the empty frames b and s the bulk cases load."""
    idx = holder.create_index("g")
    idx.create_frame("f", frame_options(time_quantum="YM"))
    idx.create_frame("b", frame_options())
    idx.create_frame("s", frame_options())
    fr = idx.frame("f")
    for r in range(4):
        for s in range(n_slices):
            fr.set_bit("standard", r, s * SLICE_WIDTH + 10 + r)
            fr.set_bit("standard", r, s * SLICE_WIDTH + 500)


def job_slices(n_ranks: int) -> int:
    return max(4, 2 * n_ranks)


def frame_checksums(holder, index: str, frame: str) -> dict:
    view = holder.index(index).frame(frame).view("standard")
    return {str(s): f.checksum().hex()
            for s, f in sorted(view.fragments.items())} if view is not None else {}


# ---------------------------------------------------------------------------
# one rank (the __main__ branch): imports torch and the port only
# ---------------------------------------------------------------------------

def rank_main(coordinator, nprocs, pid, control_port, http_port) -> int:
    from pilosa_tpu_torch.parallel.multihost import init_multihost

    init_multihost(coordinator, nprocs, pid, device="cpu", timeout_s=60)

    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel.service import LockstepService
    from pilosa_tpu_torch.replica.digest import holder_digest

    n_slices = job_slices(nprocs)
    with tempfile.TemporaryDirectory() as d:
        h = Holder(d)
        h.open()
        seed_holder(h, FrameOptions, n_slices)
        svc = LockstepService(
            h,
            control_addr=("127.0.0.1", control_port),
            http_addr=("127.0.0.1", http_port) if pid == 0 else None,
            device="cpu",
        )
        if pid == 0:
            t = threading.Thread(target=svc.serve_forever, daemon=True)
            t.start()
            deadline = time.monotonic() + 60
            while svc._httpd is None and time.monotonic() < deadline:
                time.sleep(0.05)
            print(json.dumps({"ready": True}), flush=True)
            sys.stdin.readline()  # the test signals shutdown
            svc.shutdown()
            t.join(timeout=30)
        else:
            svc.serve_forever()

        # Post-run probes through the plain numpy path: every write served
        # over HTTP must have replicated to every rank's holder.
        e = Executor(h, engine="numpy")
        (probe,) = e.execute("g", Q_COUNT)
        (rprobe,) = e.execute(
            "g",
            'Count(Range(rowID=0, frame="f", start="2017-01-01T00:00", end="2018-01-01T00:00"))',
        )
        # The 2 x 2 (slice x replica) collective over the job's ranks:
        # each replica group answers half of the batch against its
        # blocks, and the counts must equal this rank's numpy truth.
        replica_probe = -1
        if nprocs >= 4 and nprocs % 2 == 0:
            from pilosa_tpu_torch.parallel import ReplicaMesh, replica_gather_count
            from pilosa_tpu_torch.ops.bitwise import np_popcount

            frags = [h.fragment("g", "f", "standard", s) for s in range(n_slices)]
            mat = np.stack([np.stack([f.row_dense(r) for r in range(4)]) for f in frags])
            rmesh = ReplicaMesh(n_replicas=2, device="cpu")
            pairs = np.array([[a, b] for a in range(4) for b in range(2)], dtype=np.int32)
            got = replica_gather_count(rmesh, "and", rmesh.shard_stack(mat), pairs).tolist()
            want = [int(np_popcount(mat[:, a] & mat[:, b]).sum()) for a, b in pairs]
            assert got == want, f"replica probe mismatch: {got} != {want}"
            replica_probe = int(sum(got))
        digest = holder_digest(h)["digest"]
        sums = {fr: frame_checksums(h, "g", fr) for fr in ("b", "s")}
        h.close()

    traces = svc.tracer.traces_json(limit=10000) if svc.tracer is not None else []
    print(json.dumps({
        "pid": pid,
        "probe": int(probe),
        "range_probe": int(rprobe),
        "replica_probe": replica_probe,
        "digest": digest,
        "checksums": sums,
        "batches": svc.stat_batches,
        "requests": svc.stat_requests,
        "shed": svc.stat_shed,
        "expired": svc.stat_expired,
        "qcache_hits": getattr(svc.executor.qcache, "hits", -1),
        "qcache_misses": getattr(svc.executor.qcache, "misses", -1),
        "qcache_stores": getattr(svc.executor.qcache, "stores", -1),
        "traced": svc.stat_traced,
        "tenants": svc.stat_tenants,
        "trace_ring": len(traces),
        "trace_phases": sorted({c["name"] for t in traces for c in t["spans"].get("children", [])}),
        "engine": svc.engine.name,
        "collectives": svc.engine.mesh.stat_collectives,
        "jax_loaded": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
    }), flush=True)
    return 0


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(base, path, data, timeout=30, headers=None):
    rq = urllib.request.Request(base + path, data=data, method="POST")
    for k, v in (headers or {}).items():
        rq.add_header(k, v)
    with urllib.request.urlopen(rq, timeout=timeout) as resp:
        return resp.read()


class _LockstepJob:
    """Spawns n ranks of this file, drains stdout, keeps stderr in temp
    files surfaced on failure, and collects the final per-rank JSON.
    Every wait is bounded; ``cleanup`` (always, in ``finally``) kills any
    rank still alive."""

    def __init__(self, n_ranks: int, env_extra=None):
        self.n = n_ranks
        self.coord, self.control, self.http = _free_port(), _free_port(), _free_port()
        env = dict(os.environ, PYTHONPATH=REPO)
        env.update(env_extra or {})
        self.errfiles = [tempfile.NamedTemporaryFile("w+", delete=False) for _ in range(n_ranks)]
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "rank", f"127.0.0.1:{self.coord}",
                 str(n_ranks), str(pid), str(self.control), str(self.http)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.errfiles[pid],
                cwd=REPO, env=env, text=True,
            )
            for pid in range(n_ranks)
        ]
        self.out_lines = [[] for _ in range(n_ranks)]
        self.drainers = [threading.Thread(target=self._drain, args=(i,), daemon=True)
                         for i in range(n_ranks)]
        for t in self.drainers:
            t.start()
        self.base = f"http://127.0.0.1:{self.http}"

    def _drain(self, i):
        for line in self.procs[i].stdout:
            self.out_lines[i].append(line)

    def stderr_tail(self, i):
        self.errfiles[i].flush()
        with open(self.errfiles[i].name) as f:
            return f.read()[-2000:]

    def _all_stderr(self):
        return "\n".join(f"rank {i}: {self.stderr_tail(i)}" for i in range(self.n))

    def wait_ready(self, timeout=JOB_TIMEOUT_S):
        t0 = time.monotonic()
        while not self.out_lines[0] and time.monotonic() - t0 < timeout:
            if any(p.poll() is not None for p in self.procs):
                pytest.fail(f"a rank died at startup:\n{self._all_stderr()}")
            time.sleep(0.05)
        assert self.out_lines[0], f"rank 0 never became ready:\n{self._all_stderr()}"
        assert json.loads(self.out_lines[0][0]).get("ready"), self.out_lines[0][0]

    def raw(self, q, timeout=60, headers=None, path="/index/g/query"):
        return _post(self.base, path, q.encode() if isinstance(q, str) else q, timeout, headers)

    def query(self, q, timeout=60, headers=None):
        return json.loads(self.raw(q, timeout, headers))

    def shutdown_and_collect(self):
        self.procs[0].stdin.write("\n")
        self.procs[0].stdin.flush()
        outs = []
        for i, p in enumerate(self.procs):
            p.wait(timeout=JOB_TIMEOUT_S)
            self.drainers[i].join(timeout=30)
            assert p.returncode == 0, (
                f"rank {i} failed:\nstdout={''.join(self.out_lines[i])}\n"
                f"stderr={self.stderr_tail(i)}")
            outs.append(json.loads(self.out_lines[i][-1]))
        for o in outs:
            assert o["engine"] == "mesh" and not o["jax_loaded"]
        return outs

    def cleanup(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for f in self.errfiles:
            f.close()
            os.unlink(f.name)


def _serve_in_process(svc):
    threading.Thread(target=svc.serve_forever, daemon=True).start()
    deadline = time.monotonic() + 10
    while svc._httpd is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert svc._httpd is not None, "lockstep front end never bound"
    return f"http://{svc.http_addr[0]}:{svc.http_addr[1]}"


class _JaxTwin:
    """A JAX LockstepService (one rank, this process) seeded like a job of
    ``n_ranks``: the reference the port's bodies are held to."""

    def __init__(self, tmp_path, n_ranks: int, name="jax"):
        from pilosa_tpu.core.frame import FrameOptions
        from pilosa_tpu.core.holder import Holder
        from pilosa_tpu.parallel.service import LockstepService

        self.h = Holder(str(tmp_path / name))
        self.h.open()
        seed_holder(self.h, FrameOptions, job_slices(n_ranks))
        self.svc = LockstepService(self.h, control_addr=("127.0.0.1", 0),
                                   http_addr=("127.0.0.1", 0))
        self.base = _serve_in_process(self.svc)

    def raw(self, q, timeout=60, headers=None, path="/index/g/query"):
        return _post(self.base, path, q.encode() if isinstance(q, str) else q, timeout, headers)

    def close(self):
        self.svc.shutdown()
        self.h.close()


def _status(fn):
    try:
        fn()
        return 200
    except urllib.error.HTTPError as e:
        return e.code


# ---------------------------------------------------------------------------
# tests/test_multihost.py's lockstep cases
# ---------------------------------------------------------------------------

def test_lockstep_query_service(tmp_path):
    """Full lockstep SERVICE: rank 0 serves HTTP, the worker replays every
    request over the control plane, device work runs sharded over the
    2-rank job, and writes replicate to every rank's holder; every body
    equals the JAX service's byte for byte."""
    job = _LockstepJob(2)
    twin = _JaxTwin(tmp_path, 2)
    try:
        job.wait_ready()
        steps = [
            'Count(Bitmap(rowID=0, frame="f")) '
            'Count(Intersect(Bitmap(rowID=0, frame="f"), Bitmap(rowID=1, frame="f")))',
            'SetBit(rowID=0, frame="f", columnID=77) '
            'SetBit(rowID=0, frame="f", columnID=78, timestamp="2017-03-02T00:00")',
            Q_COUNT,
            'TopN(Bitmap(rowID=0, frame="f"), frame="f", n=2)',
            'Bitmap(rowID=1, frame="f")',
        ]
        bodies = [job.raw(q) for q in steps]
        assert [twin.raw(q) for q in steps] == bodies
        assert json.loads(bodies[0])["results"] == [8, 4]
        assert json.loads(bodies[1])["results"] == [True, True]
        assert json.loads(bodies[2])["results"] == [10]
        pairs = json.loads(bodies[3])["results"][0]
        assert pairs and pairs[0]["id"] == 0 and pairs[0]["count"] == 10
        # Error path: rank 0 reports, the worker stays in lockstep.
        bad = 'Bitmap(rowID=1, frame="nope")'
        assert _status(lambda: job.raw(bad)) == 400 == _status(lambda: twin.raw(bad))
        assert job.query(Q_COUNT)["results"] == [10]
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
        twin.close()
    by_pid = {o["pid"]: o for o in outs}
    assert by_pid[0]["probe"] == by_pid[1]["probe"] == 10
    assert by_pid[0]["range_probe"] == by_pid[1]["range_probe"] == 1
    assert by_pid[0]["digest"] == by_pid[1]["digest"]
    assert by_pid[0]["collectives"] == by_pid[1]["collectives"] > 0


def test_lockstep_fail_stop_on_dead_worker(tmp_path):
    """A broken control connection degrades the service: the failing
    request errors and every subsequent request is refused."""
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.parallel.service import LockstepService
    from pilosa_tpu_torch.pilosa import PilosaError

    h = Holder(str(tmp_path / "d"))
    h.open()
    idx = h.create_index("g")
    idx.create_frame("f", FrameOptions())
    idx.frame("f").set_bit("standard", 1, 3)
    svc = LockstepService(h, control_addr=("127.0.0.1", 0), device="cpu")
    assert svc.n_ranks == 1 and svc.engine.name == "mesh"
    assert svc._execute("g", 'Count(Bitmap(rowID=1, frame="f"))') == [1]
    a, b = socket.socketpair()
    b.close()
    svc._workers.append(a)
    with pytest.raises(PilosaError, match="degraded"):
        svc._execute("g", 'Count(Bitmap(rowID=1, frame="f"))')
    with pytest.raises(PilosaError, match="degraded"):
        svc._execute("g", 'Count(Bitmap(rowID=1, frame="f"))')
    a.close()
    h.close()


def test_lockstep_three_ranks():
    """Three ranks: two workers ack and replay, reads shard over 6
    slices (2 a rank), writes replicate everywhere."""
    job = _LockstepJob(3)
    try:
        job.wait_ready()
        assert job.query(Q_COUNT)["results"] == [12]
        assert job.query('SetBit(rowID=0, frame="f", columnID=321)')["results"] == [True]
        assert job.query(Q_COUNT)["results"] == [13]
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    assert {o["probe"] for o in outs} == {13}
    assert len({o["digest"] for o in outs}) == 1


def test_lockstep_pipelined_concurrent_clients():
    """Concurrent HTTP clients against the pipelined service: requests in
    flight on the control plane, execution one total order on every rank
    — results correct, replicated writes convergent."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    job = _LockstepJob(2)
    try:
        job.wait_ready()
        base = job.query(Q_COUNT)["results"][0]
        wcols = list(range(700, 720))
        jobs = [Q_COUNT] * 20 + [f'SetBit(rowID=0, frame="f", columnID={c})' for c in wcols]
        random.Random(3).shuffle(jobs)
        with ThreadPoolExecutor(6) as pool:
            outs = list(pool.map(job.query, jobs))
        for q, o in zip(jobs, outs):
            assert "results" in o, (q, o)
        after = job.query(Q_COUNT)["results"][0]
        assert after == base + len(wcols)
        outs = job.shutdown_and_collect()
        assert outs[0]["probe"] == outs[1]["probe"] == after
        assert outs[0]["digest"] == outs[1]["digest"]
    finally:
        job.cleanup()


def test_lockstep_four_ranks_replica_mesh():
    """Four ranks (8 slices, 2 a rank): reads and replicated writes
    converge, and the post-run collective probe runs a (2, 2) slice x
    replica mesh whose counts equal each rank's local numpy truth."""
    job = _LockstepJob(4)
    try:
        job.wait_ready()
        assert job.query(Q_COUNT)["results"] == [16]
        assert job.query('SetBit(rowID=0, frame="f", columnID=444)')["results"] == [True]
        assert job.query(Q_COUNT)["results"] == [17]
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    assert {o["probe"] for o in outs} == {17}
    rp = {o["replica_probe"] for o in outs}
    assert len(rp) == 1 and rp.pop() > 0
    assert len({o["digest"] for o in outs}) == 1


def test_lockstep_batch_error_isolation():
    """Coalesced batches isolate per-request errors: every bad request
    (unknown frame) gets its own 400, its siblings succeed, the ranks
    stay in lockstep."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    job = _LockstepJob(2)
    try:
        job.wait_ready()
        base = job.query(Q_COUNT)["results"][0]

        def run(q):
            try:
                return ("ok", job.query(q)["results"])
            except urllib.error.HTTPError as e:
                return ("err", e.code)

        wcols = list(range(800, 810))
        jobs = ([Q_COUNT] * 10 + ['Bitmap(rowID=1, frame="nope")'] * 10
                + [f'SetBit(rowID=0, frame="f", columnID={c})' for c in wcols])
        random.Random(7).shuffle(jobs)
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(run, jobs))
        by_q = list(zip(jobs, outs))
        assert all(o == ("err", 400) for q, o in by_q if "nope" in q)
        assert all(o[0] == "ok" for q, o in by_q if "nope" not in q), by_q
        after = job.query(Q_COUNT)["results"][0]
        assert after == base + len(wcols)
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    assert outs[0]["probe"] == outs[1]["probe"] == after


def test_lockstep_coalescing_batches_requests():
    """PILOSA_TPU_LOCKSTEP_COALESCE=1 (batches of one) behaves exactly
    like per-request replay."""
    job = _LockstepJob(2, env_extra={"PILOSA_TPU_LOCKSTEP_COALESCE": "1"})
    try:
        job.wait_ready()
        assert job.query(Q_COUNT)["results"] == [8]
        assert job.query('SetBit(rowID=0, frame="f", columnID=345)')["results"] == [True]
        assert job.query(Q_COUNT)["results"] == [9]
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    assert {o["probe"] for o in outs} == {9}
    assert outs[0]["batches"] == outs[0]["requests"] == 3


def test_lockstep_expired_deadline_dropped_identically():
    """An expired request (X-Pilosa-Deadline-Ms: 0) is dropped on every
    rank by the ship-time flag: 504 to its client, siblings unaffected,
    the expired writes land on no rank."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    job = _LockstepJob(2)
    try:
        job.wait_ready()
        base = job.query(Q_COUNT)["results"][0]

        def run(args):
            q, hdrs = args
            try:
                return ("ok", job.query(q, headers=hdrs)["results"])
            except urllib.error.HTTPError as e:
                return ("err", e.code)

        expired_hdr = {"X-Pilosa-Deadline-Ms": "0"}
        wcols = list(range(600, 610))
        jobs = ([(Q_COUNT, None)] * 10
                + [(f'SetBit(rowID=0, frame="f", columnID={c})', expired_hdr) for c in range(650, 655)]
                + [(f'SetBit(rowID=0, frame="f", columnID={c})', None) for c in wcols]
                + [(Q_COUNT, {"X-Pilosa-Deadline-Ms": "60000"})] * 5)
        random.Random(11).shuffle(jobs)
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(run, jobs))
        for (q, hdrs), o in zip(jobs, outs):
            if hdrs and hdrs.get("X-Pilosa-Deadline-Ms") == "0":
                assert o == ("err", 504), (q, o)
            else:
                assert o[0] == "ok", (q, o)
        after = job.query(Q_COUNT)["results"][0]
        assert after == base + len(wcols)
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    assert outs[0]["probe"] == outs[1]["probe"] == after
    assert outs[0]["expired"] == outs[1]["expired"] == 5


def test_lockstep_qcache_identical_hit_miss_on_all_ranks():
    """PILOSA_TPU_QCACHE=1: hit and miss decisions are identical on every
    rank (pure functions of replicated state), so a hit skips the
    executor and its collectives everywhere at once."""
    job = _LockstepJob(2, env_extra={"PILOSA_TPU_QCACHE": "1"})
    try:
        job.wait_ready()
        for want in ([8], [8], [8]):
            assert job.query(Q_COUNT)["results"] == want
        assert job.query('SetBit(rowID=0, frame="f", columnID=77)')["results"] == [True]
        assert job.query(Q_COUNT)["results"] == [9]
        assert job.query(Q_COUNT)["results"] == [9]
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    by_pid = {o["pid"]: o for o in outs}
    for k, want in (("qcache_hits", 3), ("qcache_misses", 2), ("qcache_stores", 2)):
        assert by_pid[0][k] == by_pid[1][k] == want, (k, outs)
    assert by_pid[0]["probe"] == by_pid[1]["probe"] == 9
    assert by_pid[0]["collectives"] == by_pid[1]["collectives"]


def test_lockstep_trace_sampling_decided_on_rank0():
    """PILOSA_TPU_TRACE_SAMPLE_RATE=1: the sampling decision rides the
    wire; every rank counts the same flags, only rank 0 records spans."""
    job = _LockstepJob(2, env_extra={"PILOSA_TPU_TRACE_SAMPLE_RATE": "1"})
    try:
        job.wait_ready()
        n = 6
        for _ in range(n - 1):
            assert job.query(Q_COUNT)["results"] == [8]
        assert job.query(Q_COUNT, headers={"X-Pilosa-Trace": "1"})["results"] == [8]
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    by_pid = {o["pid"]: o for o in outs}
    assert by_pid[0]["traced"] == by_pid[1]["traced"] == n
    assert by_pid[0]["trace_ring"] == n
    assert by_pid[1]["trace_ring"] == 0
    assert {"lockstep.queue", "lockstep.ship", "lockstep.execute"} <= set(by_pid[0]["trace_phases"])


def test_lockstep_tenant_resolved_on_rank0():
    """The tenant is resolved once on rank 0 at ship time and rides the
    batch entry: every rank tallies the same per-tenant counts."""
    job = _LockstepJob(2, env_extra={"PILOSA_TPU_TENANCY_MAP": "g=gold"})
    try:
        job.wait_ready()
        for _ in range(3):
            assert job.query(Q_COUNT, headers={"X-Pilosa-Tenant": "acme"})["results"] == [8]
        for _ in range(4):
            assert job.query(Q_COUNT)["results"] == [8]
        assert _status(lambda: job.query(
            Q_COUNT, headers={"X-Pilosa-Tenant": "acme", "X-Pilosa-Deadline-Ms": "0"})) == 504
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    by_pid = {o["pid"]: o for o in outs}
    assert by_pid[0]["tenants"] == by_pid[1]["tenants"], outs
    assert by_pid[0]["tenants"] == {
        "acme": {"requests": 4, "expired": 1},
        "gold": {"requests": 4, "expired": 0},
    }, outs


def test_replica_router_over_two_lockstep_groups():
    """Replica serving groups at full depth: TWO 2-rank port lockstep jobs
    (groups g0/g1, identities via PILOSA_TPU_REPLICA_GROUP) behind one
    port ReplicaRouter.  Writes through the router fan to BOTH groups
    (each group replays them on every rank); reads spread across groups
    and see every acked write; killing one group's WORKER rank degrades
    that group (its control plane fail-stops), the router fails reads
    over to the survivor and refuses writes 503 until the set is
    quorate."""
    from pilosa_tpu_torch.replica import GROUP_HEADER, ReplicaRouter
    from pilosa_tpu_torch.stats import ExpvarStatsClient

    g0 = _LockstepJob(2, env_extra={"PILOSA_TPU_REPLICA_GROUP": "g0@1"})
    g1 = _LockstepJob(2, env_extra={"PILOSA_TPU_REPLICA_GROUP": "g1@1"})
    router = None
    try:
        g0.wait_ready()
        g1.wait_ready()
        stats = ExpvarStatsClient()
        router = ReplicaRouter(
            [f"g0=127.0.0.1:{g0.http}", f"g1=127.0.0.1:{g1.http}"],
            probe_interval_s=0.2, stats=stats,
        ).serve()

        def via_router(q, timeout=60):
            req = urllib.request.Request(
                f"http://127.0.0.1:{router.port}/index/g/query",
                data=q.encode(), method="POST",
            )
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read()), resp.headers.get(GROUP_HEADER)

        # Both groups seeded alike: a read through the router agrees with
        # a direct read on either group.
        want = g0.query(Q_COUNT)["results"]
        assert g1.query(Q_COUNT)["results"] == want
        out, grp = via_router(Q_COUNT)
        assert out["results"] == want and grp in ("g0@1", "g1@1")

        # A write through the router lands on BOTH groups (and, inside
        # each group, replays on every rank over the control plane).
        out, grp = via_router('SetBit(rowID=0, frame="f", columnID=901)')
        assert out["results"] == [True] and grp == "all"
        after = want[0] + 1
        assert g0.query(Q_COUNT)["results"] == [after]
        assert g1.query(Q_COUNT)["results"] == [after]
        served = set()
        for _ in range(4):
            out, grp = via_router(Q_COUNT)
            assert out["results"] == [after]
            served.add(grp)
        assert served == {"g0@1", "g1@1"}

        # Kill g1's WORKER rank: g1's control plane fail-stops on the
        # next shipped entry, the router marks it unhealthy and keeps
        # reads serving from g0.
        g1.procs[1].kill()
        ok_reads = 0
        for _ in range(12):
            try:
                out, grp = via_router(Q_COUNT, timeout=30)
            except (urllib.error.HTTPError, urllib.error.URLError, OSError):
                continue  # the probe that tripped the degrade
            assert out["results"] == [after]
            ok_reads += 1
        assert ok_reads >= 8, "reads stopped serving after one group died"
        assert not router.groups[1].healthy
        # Writes refuse while non-quorate: g0 is not advanced past g1.
        try:
            via_router('SetBit(rowID=0, frame="f", columnID=902)', timeout=30)
            raise AssertionError("write acked against a non-quorate group set")
        except urllib.error.HTTPError as e:
            assert e.code == 503
        assert g0.query(Q_COUNT)["results"] == [after]
        assert stats.snapshot().get("replica.failover", 0) >= 1

        outs = g0.shutdown_and_collect()
        # g0's ranks converged on the routed writes.
        assert {o["probe"] for o in outs} == {after}
    finally:
        if router is not None:
            router.close()
        g0.cleanup()
        g1.cleanup()


def test_lockstep_worker_death_mid_stream():
    """A worker rank killed mid-stream: the next request errors, every
    later one is refused, and rank 0 stays alive to refuse them."""
    job = _LockstepJob(2)
    try:
        job.wait_ready()
        assert job.query(Q_COUNT)["results"][0] > 0
        job.procs[1].kill()
        failed = False
        for i in range(20):
            try:
                job.query(f'SetBit(rowID=0, frame="f", columnID={900 + i})', timeout=30)
            except (urllib.error.HTTPError, urllib.error.URLError, OSError):
                failed = True
                break
        assert failed, "service kept acking writes after a replica died"
        for _ in range(3):
            assert _status(lambda: job.query(Q_COUNT, timeout=30)) in (500, 503)
        assert job.procs[0].poll() is None, "rank 0 died with the worker"
    finally:
        job.cleanup()


def test_lockstep_mesh_check_two_ranks():
    """POST /debug/mesh-check: every rank runs the sharded compositions
    over its block of the named rows (topn_counts, gather_src_counts, the
    pair and fold entries, count_rows under each op) and rank 0 answers
    the merged results, equal to the seed's counts; a deterministic error
    is a 400 on every rank and the job keeps serving."""
    job = _LockstepJob(2)
    try:
        job.wait_ready()
        out = json.loads(job.raw(b"", path="/debug/mesh-check?index=g&frame=f&rows=0,1,2,3&src=0"))
        bad = _status(lambda: job.raw(b"", path="/debug/mesh-check?index=g&frame=nope&rows=0&src=0"))
        assert job.query(Q_COUNT)["results"] == [8]
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    n = job_slices(2)
    # Row r holds columns 10 + r and 500 in every slice; src is row 0.
    assert out["slices"] == n and out["ranks"] == 2
    assert out["topn"] == [2 * n, n, n, n]
    assert out["scorer"] == [[2, 1, 1, 1]] * n
    assert out["pairs"] == [n] * 4 and out["fold_or"] == [5 * n]
    assert out["count"] == {"and": 2 * n, "or": 2 * n, "xor": 0, "andnot": 0}
    assert bad == 400
    assert outs[0]["collectives"] == outs[1]["collectives"]


# ---------------------------------------------------------------------------
# the lockstep bulk door (tests/test_bulk.py) and the ranks' digests
# ---------------------------------------------------------------------------

def _bulk_frames():
    from pilosa_tpu_torch import ingest

    rng = np.random.default_rng(14)
    rows = rng.integers(0, 12, size=6000).astype(np.uint64)
    cols = rng.integers(0, 2 * SLICE_WIDTH, size=6000).astype(np.uint64)
    frames = [ingest.encode_packed(rows[i:i + 2048], cols[i:i + 2048])
              for i in range(0, len(rows), 2048)]
    crc = 0
    for fb in frames:
        crc = zlib.crc32(fb, crc)
    return rows, cols, frames, sum(len(f) for f in frames), crc


def _stream(post, index, frame, door, frames, total, crc):
    off, out = 0, None
    for fb in frames:
        out = json.loads(post(
            f"/index/{index}/frame/{frame}/{door}?off={off}&total={total}"
            f"&crc={crc}&ccrc={zlib.crc32(fb)}", fb))
        off += len(fb)
        assert out["staged"] == off
    assert out["done"]
    return out


def _lockstep_svc(tmp_path, frame_options, lockstep_service, **kw):
    from importlib import import_module

    holder_mod = import_module(frame_options.__module__.replace("frame", "holder"))
    h = holder_mod.Holder(str(tmp_path))
    h.open()
    idx = h.create_index("i")
    idx.create_frame("f", frame_options())
    idx.create_frame("g", frame_options())
    svc = lockstep_service(h, control_addr=("127.0.0.1", 0), http_addr=("127.0.0.1", 0), **kw)
    return h, svc, _serve_in_process(svc)


def test_lockstep_front_end_bulk(tmp_path):
    """The lockstep front end serves the bulk wire: rank 0 decodes each
    chunk once and replays the pairs through the total order, every rank
    runs the build, the completion recalc rides its own entry; reads
    right after are fresh, every fragment equals the streamed door's,
    and every body equals the JAX service's."""
    from pilosa_tpu.core.frame import FrameOptions as JFrameOptions
    from pilosa_tpu.parallel.service import LockstepService as JLockstepService
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.parallel.service import LockstepService
    from pilosa_tpu_torch.replica.digest import holder_digest

    rows, cols, frames, total, crc = _bulk_frames()
    sides = [_lockstep_svc(tmp_path / "torch", FrameOptions, LockstepService, device="cpu"),
             _lockstep_svc(tmp_path / "jax", JFrameOptions, JLockstepService)]
    try:
        bodies = []
        for h, svc, base in sides:
            post = lambda p, d, _b=base: _post(_b, p, d)  # noqa: E731
            _stream(post, "i", "f", "bulk", frames, total, crc)
            got = post("/index/i/query", b'Count(Bitmap(rowID=3, frame="f"))')
            assert json.loads(got)["results"][0] == len(np.unique(cols[rows == 3]))
            _stream(post, "i", "g", "ingest", frames, total, crc)
            tops = [post("/index/i/query", f'TopN(frame="{f}", n=3)'.encode()) for f in "fg"]
            assert json.loads(tops[0])["results"][0] == json.loads(tops[1])["results"][0]
            bodies.append([got] + tops)
            idx = h.index("i")
            for sl in sorted(idx.frame("g").view("standard").fragments):
                assert idx.frame("f").view("standard").fragment(sl).checksum() \
                    == idx.frame("g").view("standard").fragment(sl).checksum()
        assert bodies[0] == bodies[1]
        assert holder_digest(sides[0][0])["digest"] == holder_digest(sides[1][0])["digest"]
    finally:
        for h, svc, _ in sides:
            svc.shutdown()
            h.close()


def test_lockstep_front_end_bulk_arrow(tmp_path):
    """Arrow chunks through the lockstep bulk door: rank 0's decode is the
    only pyarrow touch; the replicated replay carries decoded pairs."""
    pa = pytest.importorskip("pyarrow")
    import io

    from pilosa_tpu_torch import ingest
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.parallel.service import LockstepService

    h, svc, base = _lockstep_svc(tmp_path, FrameOptions, LockstepService, device="cpu")
    try:
        t = pa.table({"row": np.array([1, 2, 2], dtype=np.uint64),
                      "col": np.array([7, 8, 9], dtype=np.uint64), "noise": [0.1, 0.2, 0.3]})
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, t.schema) as w:
            w.write_table(t)
        body = sink.getvalue()
        crc = zlib.crc32(body)
        out = json.loads(_post(base, f"/index/i/frame/f/bulk?off=0&total={len(body)}"
                               f"&crc={crc}&ccrc={crc}", body,
                               headers={"Content-Type": ingest.ARROW_CONTENT_TYPE}))
        assert out["done"]
        got = json.loads(_post(base, "/index/i/query", b'Count(Bitmap(rowID=2, frame="f"))'))
        assert got["results"][0] == 2
    finally:
        svc.shutdown()
        h.close()


def test_lockstep_bulk_two_ranks():
    """The bulk door on a 2-rank job: every rank builds the planes from
    the replicated pairs; on every rank the bulk frame's fragments equal
    the streamed door's, and the ranks' digests are equal."""
    rows, cols, frames, total, crc = _bulk_frames()
    job = _LockstepJob(2)
    try:
        job.wait_ready()
        post = lambda p, d: job.raw(d, path=p)  # noqa: E731
        _stream(post, "g", "b", "bulk", frames, total, crc)
        _stream(post, "g", "s", "ingest", frames, total, crc)
        got = job.query('Count(Bitmap(rowID=3, frame="b")) Count(Bitmap(rowID=3, frame="s"))')
        assert got["results"] == [len(np.unique(cols[rows == 3]))] * 2
        outs = job.shutdown_and_collect()
    finally:
        job.cleanup()
    for o in outs:
        assert o["checksums"]["b"] == o["checksums"]["s"] and o["checksums"]["b"]
    assert outs[0]["digest"] == outs[1]["digest"]
    assert outs[0]["checksums"] == outs[1]["checksums"]


def test_cli_lockstep_two_ranks(tmp_path):
    """``python -m pilosa_tpu_torch.cli lockstep`` on two ranks of the CPU
    (gloo, ``PILOSA_ENGINE=torch:cpu``), each over its own copy of the
    data directory: rank 0 serves, SIGINT shuts the job down, every rank
    prints its summary line, and the two data directories digest alike."""
    import shutil
    import signal

    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.replica.digest import holder_digest

    h = Holder(str(tmp_path / "d0"))
    h.open()
    seed_holder(h, FrameOptions, 4)
    h.close()
    shutil.copytree(tmp_path / "d0", tmp_path / "d1")
    http, control, coord = _free_port(), _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, PILOSA_ENGINE="torch:cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "lockstep", "--data-dir", str(tmp_path / f"d{r}"),
         "--host", f"127.0.0.1:{http}", "--control", f"127.0.0.1:{control}",
         "--coordinator", f"127.0.0.1:{coord}", "--num-processes", "2", "--process-id", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env, text=True)
        for r in range(2)]
    try:
        base = f"http://127.0.0.1:{http}"
        deadline = time.monotonic() + JOB_TIMEOUT_S
        while True:
            try:
                out = json.loads(_post(base, "/index/g/query", Q_COUNT.encode(), timeout=10))
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "lockstep rank 0 never served"
                assert all(p.poll() is None for p in procs), procs[0].stderr.read()[-2000:]
                time.sleep(0.2)
        assert out["results"] == [8]
        assert json.loads(_post(base, "/index/g/query",
                                b'SetBit(rowID=0, frame="f", columnID=31)'))["results"] == [True]
        assert json.loads(_post(base, "/index/g/query", Q_COUNT.encode()))["results"] == [9]
        procs[0].send_signal(signal.SIGINT)
        lines = []
        for p in procs:
            out, err = p.communicate(timeout=JOB_TIMEOUT_S)
            assert p.returncode == 0, err[-2000:]
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [ln["lockstep_rank"] for ln in lines] == [0, 1]
    assert {ln["ranks"] for ln in lines} == {2} and {ln["device"] for ln in lines} == {"cpu"}
    assert lines[0]["requests"] == 3 and lines[0]["collectives"] == lines[1]["collectives"] > 0
    digests = []
    for r in range(2):
        h = Holder(str(tmp_path / f"d{r}"))
        h.open()
        digests.append(holder_digest(h)["digest"])
        h.close()
    assert digests[0] == digests[1] == lines[0]["digest"] == lines[1]["digest"]


# ---------------------------------------------------------------------------
# in-process single-rank cases (tests/test_replica.py, test_replica_recovery.py)
# ---------------------------------------------------------------------------

def _one_rank(tmp_path, **kw):
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.parallel.service import LockstepService

    h = Holder(str(tmp_path / "d"))
    h.open()
    idx = h.create_index("g")
    idx.create_frame("f", FrameOptions())
    idx.frame("f").set_bit("standard", 1, 3)
    return h, LockstepService(h, control_addr=("127.0.0.1", 0), device="cpu", **kw)


def test_lockstep_group_epoch_guard(tmp_path):
    h, svc = _one_rank(tmp_path, group="g0", group_epoch=2)
    assert svc.group == "g0" and svc.group_epoch == 2
    assert svc._execute("g", 'Count(Bitmap(rowID=1, frame="f"))') == [1]
    assert svc._epoch_ok({"op": "batch"})
    assert svc._epoch_ok({"op": "batch", "group": "g0", "gepoch": 2})
    assert not svc._epoch_ok({"op": "batch", "group": "g0", "gepoch": 1})
    assert not svc._epoch_ok({"op": "batch", "group": "g9", "gepoch": 2})
    h.close()


def test_lockstep_front_end_serves_admin_gets(tmp_path):
    """The admin GETs the router forwards (/schema, /status, /slices/max,
    /version, /debug/vars, /debug/traces, /replica/health, /replica/digest)
    answer on the port's lockstep front end; the deterministic ones equal
    the JAX front end's bodies byte for byte."""
    from pilosa_tpu.core.frame import FrameOptions as JFrameOptions
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu.parallel.service import LockstepService as JLockstepService
    from pilosa_tpu_torch.replica import GROUP_HEADER
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.parallel.service import LockstepService

    bases, svcs, holders = [], [], []
    for name, hmod, fo, cls, kw in (("t", Holder, FrameOptions, LockstepService, {"device": "cpu"}),
                                    ("j", JHolder, JFrameOptions, JLockstepService, {})):
        h = hmod(str(tmp_path / name))
        h.open()
        idx = h.create_index("g")
        idx.create_frame("f", fo())
        idx.frame("f").set_bit("standard", 1, 3)
        svc = cls(h, control_addr=("127.0.0.1", 0), http_addr=("127.0.0.1", 0),
                  group="g0", group_epoch=1, **kw)
        bases.append(_serve_in_process(svc))
        svcs.append(svc)
        holders.append(h)

    def get(base, path):
        try:
            with urllib.request.urlopen(base + path, timeout=10) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, b"", dict(e.headers)

    try:
        t = bases[0]
        st, schema, hdrs = get(t, "/schema")
        assert st == 200 and [x["name"] for x in json.loads(schema)["indexes"]] == ["g"]
        assert hdrs.get(GROUP_HEADER) == "g0@1"
        st, status, _ = get(t, "/status")
        assert st == 200 and json.loads(status)["status"]["state"] == "UP"
        assert get(t, "/debug/vars")[0] == 200
        st, tr, _ = get(t, "/debug/traces")
        assert st == 200 and json.loads(tr)["traces"] == []
        st, dig, _ = get(t, "/replica/digest")
        d = json.loads(dig)
        assert st == 200 and "g/f/standard/0" in d["fragments"]
        assert d["appliedSeq"] == 0 and d["digest"]
        for path in ("/schema", "/status", "/slices/max", "/version", "/replica/health",
                     "/replica/digest"):
            assert get(bases[0], path)[:2] == get(bases[1], path)[:2], path
        assert get(t, "/nope")[0] == 404
    finally:
        for svc, h in zip(svcs, holders):
            svc.shutdown()
            h.close()


def test_lockstep_group_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_REPLICA_GROUP", "g7@4")
    h, svc = _one_rank(tmp_path)
    assert svc.group == "g7" and svc.group_epoch == 4
    h.close()


def test_replica_mesh_single_rank():
    """A job of one: the (slice x replica) mesh builds flat (hybrid asked
    for, no second host), and a 2-replica split needs 2 ranks."""
    from pilosa_tpu_torch.parallel import ReplicaMesh, replica_gather_count

    mesh = ReplicaMesh(n_replicas=1, device="cpu", hybrid=True)
    assert mesh.hybrid is False and mesh.n_devices == 1 and mesh.n_replicas == 1
    rng = np.random.default_rng(42)
    rm = rng.integers(0, 1 << 32, size=(4, 8, 256), dtype=np.uint32)
    pairs = rng.integers(0, 8, size=(6, 2), dtype=np.int32)
    got = replica_gather_count(mesh, "and", mesh.shard_stack(rm), pairs).tolist()
    from pilosa_tpu_torch.ops.bitwise import np_popcount

    assert got == [int(np_popcount(rm[:, a] & rm[:, b]).sum()) for a, b in pairs]
    with pytest.raises(ValueError, match="replica groups"):
        ReplicaMesh(n_replicas=2, device="cpu")


def test_build_group_mesh_single_process():
    from pilosa_tpu_torch.parallel.sharded import ReplicaMesh
    from pilosa_tpu_torch.replica import build_group_mesh

    mesh = build_group_mesh(n_replicas=1, device="cpu")
    assert isinstance(mesh, ReplicaMesh)
    assert mesh.hybrid is False and mesh.n_replicas == 1


def test_lockstep_front_end_reports_applied_seq(tmp_path):
    from pilosa_tpu_torch.replica import APPLIED_SEQ_HEADER
    from pilosa_tpu_torch.replica.catchup import AppliedSeq

    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.parallel.service import LockstepService

    h = Holder(str(tmp_path / "d"))
    h.open()
    h.create_index("g").create_frame("f", FrameOptions())
    svc = LockstepService(h, control_addr=("127.0.0.1", 0), http_addr=("127.0.0.1", 0),
                          group="g0", group_epoch=1, device="cpu")
    base = _serve_in_process(svc)
    try:
        rq = urllib.request.Request(base + "/index/g/query",
                                    data=b'SetBit(rowID=1, frame="f", columnID=1)', method="POST")
        rq.add_header("X-Pilosa-Write-Seq", "11")
        with urllib.request.urlopen(rq, timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers.get(APPLIED_SEQ_HEADER) == "11"
        with urllib.request.urlopen(base + "/replica/health", timeout=10) as resp:
            assert json.loads(resp.read())["appliedSeq"] == 11
        assert AppliedSeq(os.path.join(h.path, "applied_seq")).value == 11
        rq = urllib.request.Request(base + "/index/g/query",
                                    data=b'SetBit(rowID=1, frame="nope", columnID=1)', method="POST")
        rq.add_header("X-Pilosa-Write-Seq", "12")
        assert _status(lambda: urllib.request.urlopen(rq, timeout=10)) == 400
        assert svc.applied_seq.value == 12
    finally:
        svc.shutdown()
        h.close()


# ---------------------------------------------------------------------------
# replica/digest.py
# ---------------------------------------------------------------------------

def _digest_writes(holder, frame_options):
    idx = holder.create_index("i")
    idx.create_frame("f", frame_options(inverse_enabled=True))
    idx.create_frame("t", frame_options(time_quantum="YM"))
    rng = np.random.default_rng(5)
    for r, c in rng.integers(0, 3 * SLICE_WIDTH, size=(300, 2)):
        idx.frame("f").set_bit("standard", int(r) % 9, int(c))
    idx.frame("f").clear_bit("standard", 1, 5)
    idx.create_frame("e", frame_options())
    idx.frame("e").set_bit("standard", 2, 9)
    idx.frame("e").clear_bit("standard", 2, 9)  # cleared to empty: omitted


def test_holder_digest_equals_jax(tmp_path):
    """A port holder and a JAX holder fed the same writes digest alike,
    key for key, and the digest helpers agree."""
    from pilosa_tpu.core.frame import FrameOptions as JFrameOptions
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu.replica import digest as jdigest
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.replica import digest

    h, jh = Holder(str(tmp_path / "t")), JHolder(str(tmp_path / "j"))
    h.open()
    jh.open()
    _digest_writes(h, FrameOptions)
    _digest_writes(jh, JFrameOptions)
    d, jd = digest.holder_digest(h), jdigest.holder_digest(jh)
    assert d == jd and d["fragments"]
    assert not any(p.startswith("i/e/") for p in d["fragments"])
    other = dict(jd, fragments=dict(list(jd["fragments"].items())[1:]))
    assert digest.diff_digests(d, other) == jdigest.diff_digests(jd, other)
    plan = {"a": d, "b": d, "c": other}
    assert digest.majority_plan(plan) == jdigest.majority_plan(plan)
    h.close()
    jh.close()


def test_server_replica_digest_route(tmp_path):
    """GET /replica/digest on the port's server (handler.py) answers the
    JAX server's body byte for byte on the same writes."""
    from pilosa_tpu.config import Config as JConfig
    from pilosa_tpu.server.server import Server as JServer
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.server.server import Server

    bodies = []
    for srv in (Server(Config(data_dir=str(tmp_path / "t"), host="127.0.0.1:0", engine="torch:cpu")),
                JServer(JConfig(data_dir=str(tmp_path / "j"), host="127.0.0.1:0", engine="numpy"))):
        srv.open()
        try:
            base = f"http://{srv.host}"
            _post(base, "/index/i", b"")
            _post(base, "/index/i/frame/f", b"")
            _post(base, "/index/i/query",
                  b'SetBit(rowID=1, frame="f", columnID=3) SetBit(rowID=2, frame="f", columnID=1048580)')
            with urllib.request.urlopen(base + "/replica/digest", timeout=10) as resp:
                bodies.append(resp.read())
        finally:
            srv.close()
    assert bodies[0] == bodies[1]
    assert set(json.loads(bodies[0])["fragments"]) == {"i/f/standard/0", "i/f/standard/1"}


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        a = sys.argv[2:]
        sys.exit(rank_main(a[0], int(a[1]), int(a[2]), int(a[3]), int(a[4])))
    sys.exit(f"usage: {sys.argv[0]} rank <coordinator> <n> <rank> <control_port> <http_port>")
