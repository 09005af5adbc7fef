"""One run of one cell: set-up, the window, the check, the result line.

The harness process hosts the port's ``Server`` on a free localhost port;
the cell's clients run in processes of their own.  The stages:

1. set-up: the configuration's data is made on the device from the seed
   and loaded through the port's in-process bulk path
   (``bulk.ingress.apply_bulk`` with the server's engine); then requests
   of the mix's shape that name every row fill the row pool, and each
   client sends its warm-up requests;
2. the window: every client runs its closed loop for ``--seconds``; with
   ``--trace 1`` under ``torch.profiler``, with the port's request spans
   forced on and the harness's host spans around the calls into each
   layer;
3. the check, once the window has closed, the peak memory has been read
   and the program's device state has been let go: a sample of the
   window's requests, drawn from the seed, against the plain reference;
4. the line: the cell's metrics (``metrics/<name>.py``), the device, the
   check's numbers beside their limits.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

from benchport import schema
from benchport.traffic_gen import STREAMS, rng_for, shape

FORBIDDEN = ("jax", "jaxlib", "flax", "pilosa_tpu")
# Limits of the check's numbers: exact counts, every request answered.
LIMITS = {"wrong_counts": 0, "unanswered_requests": 0}


class Fail(Exception):
    """A run that cannot give a result: printed to stderr, exit code 1."""


def root_of() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Bench:
    """``BENCHMARK.json`` and the files it names, found by name under
    ``<root>/benchport``."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.exists(path):
            raise Fail(f"no BENCHMARK.json at {root}")
        with open(path) as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise Fail(f"no workload {name!r} in BENCHMARK.json")

    def data(self, kind: str, name: str) -> dict:
        path = os.path.join(self.root, "benchport", kind, f"{name}.json")
        if not os.path.exists(path):
            raise Fail(f"no {kind} file for {name!r}: {path}")
        with open(path) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise Fail(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        without the trace, the per-layer ones with it; a metric with a
        ``workloads`` list only in those cells."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """``metrics/<name>.py``'s ``read(ctx)``."""
        try:
            return schema.plugin(self.root, "metrics", name).read
        except FileNotFoundError as e:
            raise Fail(str(e)) from None


class Request:
    """One request of the window, as its client recorded it; ``calls``:
    its call trees, made again from the seed."""

    __slots__ = ("client", "i", "due", "done", "answer", "calls")

    def __init__(self, client, i, due, done, answer):
        self.client, self.i, self.due, self.done, self.answer = client, i, due, done, answer
        self.calls = None

    @property
    def ok(self) -> bool:
        return self.answer is not None

    @property
    def rows(self) -> list[list[tuple[str, int]]]:
        """Each call's (frame, row) leaves."""
        return [schema.leaves(c) for c in self.calls]


class Ctx:
    """What a metric's reader reads: the run's cell, configuration and
    mix, the window's requests, set-up seconds and, in a traced run, the
    counters' deltas, the port's spans and the device summary."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def calls_answered(self) -> int:
        """Calls of the requests answered inside the window."""
        return sum(len(r.answer) for r in self.requests if r.ok and r.done <= self.t_end)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def host_span_targets():
    """The port's layer boundaries that the traced run times.  Two are
    private names of the program; a boundary that a later change renames
    is left out (``HostSpans.install`` skips it), and its idle gaps go to
    the span around it."""
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import dispatch, kernels
    from pilosa_tpu_torch.pql import parser
    from pilosa_tpu_torch.rowpool import DeviceRowPool
    from pilosa_tpu_torch.server.handler import Handler

    out = [
        (Handler, "dispatch", "server: dispatch"),
        (getattr(parser, "_Parser", None), "parse_query", "pql: parse"),
        (Executor, "execute", "executor: execute"),
        (Executor, "_fused_local_counts", "executor: fused lane"),
        (DeviceRowPool, "acquire", "rowpool: acquire"),
    ]
    for name in ("gather_count_multi", "gather_count_multi_rowmajor", "gather_count",
                 "gather_count_rowmajor", "gather_count_tree", "count",
                 "batch_intersection_count"):
        out.append((dispatch, name, f"dispatch: {name}"))
    for name in kernels.KERNELS:
        out.append((kernels, name, f"kernels: {name}"))
    return out


def start_clients(cfg, mix, seed, seconds, trace, root):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    from benchport import client

    n = int(mix["clients"])
    n_max = int(mix["requests_per_client_s"] * seconds) + 16
    procs, pipes = [], []
    for c in range(n):
        here, there = ctx.Pipe()
        pr = ctx.Process(target=client.run, name=f"benchport-client-{c}",
                         args=(there, c, mix, cfg, seed, n_max, int(mix["warm_requests"]), trace,
                               root))
        pr.start()
        there.close()
        procs.append(pr)
        pipes.append(here)
    return procs, pipes


def expect(pipe, kind, timeout):
    if not pipe.poll(timeout):
        raise Fail(f"a client sent no {kind!r} within {timeout:.0f} s")
    msg = pipe.recv()
    if msg[0] != kind:
        raise Fail(f"a client sent {msg[0]!r} ({msg[1:]!r}), not {kind!r}")
    return msg


def stop_clients(procs, pipes):
    for pr in procs:
        pr.join(timeout=30)
        if pr.is_alive():
            pr.terminate()
            pr.join(timeout=10)
        if pr.is_alive():
            pr.kill()
            pr.join()
    for p in pipes:
        p.close()


def open_server(cfg, data_dir, engine, trace):
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.index import IndexOptions
    from pilosa_tpu_torch.server.server import Server

    dep = cfg.get("deployment", {})
    conf = Config.from_dict(dep.get("server", {}))
    conf.engine = "auto" if engine == "cuda" else f"torch:{engine}"
    conf.host = "127.0.0.1:0"
    conf.data_dir = data_dir
    if trace:
        conf.trace_ring = 1 << 20
    server = Server(conf)
    server.open()
    idx = server.holder.create_index(cfg["index"], IndexOptions(column_label=cfg.get("column_label", "")))
    for f in schema.frames(cfg):
        idx.create_frame(f["name"], FrameOptions(row_label=f["row_label"]))
    return server


def load(server, cfg, seed, device, root) -> int:
    """The configuration's pairs into their frames through the bulk path."""
    import numpy as np

    from benchport import datagen
    from pilosa_tpu_torch.bulk.ingress import apply_bulk

    idx = server.holder.index(cfg["index"])
    engine = server.executor.engine
    n = 0
    for frame, rows, cols in datagen.chunks(cfg, seed, device, root=root):
        r = rows.cpu().numpy().astype(np.uint64)
        c = cols.cpu().numpy().astype(np.uint64)
        del rows, cols
        n += apply_bulk(idx.frame(frame), r, c, engine=engine, executor=server.executor,
                        index=cfg["index"])
    return n


def post(conn, path, body):
    conn.request("POST", path, body=body, headers={"Content-Type": "text/plain"})
    resp = conn.getresponse()
    payload = resp.read()
    if resp.status != 200:
        raise Fail(f"set-up request failed: {resp.status} {payload[:200]!r}")
    return json.loads(payload)["results"]


def release(server, index: str) -> None:
    """Let go of the program's device state for ``index`` (its row pools,
    matrices and cached answers) through the executor's public hook, so
    that the reference has the card.  The server is not closed: closing
    the holder would materialize the lazy bulk overlay into roaring
    storage, the shutdown cost of a lazy backfill (minutes at these
    sizes), which no request of the window pays.  Its door and loops run
    on daemon threads and end with the process."""
    server.executor.drop_index_state(index)


def sample(requests, seed, n_check):
    """The check's requests: the answered request that names the most
    distinct (frame, row) leaves, and others drawn from the seed."""
    answered = [r for r in requests if r.ok]
    if not answered:
        return []
    longest = max(answered, key=lambda r: len({x for call in r.rows for x in call}))
    rest = [r for r in answered if r is not longest]
    rng = rng_for(seed, STREAMS["sample"])
    pick = rng.choice(len(rest), size=min(len(rest), max(0, n_check - 1)), replace=False)
    return [longest] + [rest[int(j)] for j in sorted(pick)]


def judge(cfg, seed, checked, device, control=False, root=None):
    """Compare the answers of ``checked`` with the reference; returns the
    number of wrong counts and the number of counts compared.  With
    ``control`` the reference in its broken precision stands in for
    the program's answers."""
    from benchport import reference

    counts = reference.per_slice(cfg, seed, device, [c for r in checked for c in r.calls],
                                 root=root)
    want = reference.totals(counts)
    got = reference.totals(counts, control=True) if control else None
    wrong = compared = j = 0
    for r in checked:
        n = len(r.calls)
        answer = got[j:j + n] if control else r.answer
        wrong += sum(int(a != b) for a, b in zip(answer, want[j:j + n]))
        compared += n
        j += n
    return wrong, compared


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(argv=None, root=None, engine="cuda", t_proc0=None, out=None) -> int:
    """One run; prints the result line on ``out`` (stdout) and returns
    the exit code."""
    t_proc0 = time.perf_counter() if t_proc0 is None else t_proc0
    out = out if out is not None else sys.stdout
    args = parse_args(argv)
    try:
        return _run(args, root or root_of(), engine, t_proc0, out)
    except Fail as e:
        print(f"benchport: {e}", file=sys.stderr)
        return 1


class HostLoad:
    """The server process's load over the window: seconds paused in
    Python's garbage collector (and its full collections) and CPU
    seconds, for the run's diagnostic line on standard error."""

    def __init__(self):
        self.gc_s, self.gc_full, self._t = 0.0, 0, None
        self.cpu0 = time.process_time()
        gc.callbacks.append(self._watch)

    def _watch(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_full += info.get("generation", 0) == 2

    def stop(self):
        gc.callbacks.remove(self._watch)
        self.cpu_s = time.process_time() - self.cpu0
        return self


def _set_up(server, cfg, mix, seed, device, pipes, t_proc0, root):
    """Load the data, fill the pool, warm every client; returns the
    pairs loaded and the stages' end times (s from process start)."""
    import http.client

    stages = {"start": time.perf_counter() - t_proc0}
    loaded = load(server, cfg, seed, device, root)
    stages["load"] = time.perf_counter() - t_proc0
    traffic = shape(mix, cfg, seed, root)
    host, port = server.host.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    for request in traffic.cover():
        post(conn, f"/index/{cfg['index']}/query", traffic.body(request))
    conn.close()
    stages["fill"] = time.perf_counter() - t_proc0
    for p in pipes:
        expect(p, "ready", 300)
    for p in pipes:
        p.send(("warm", host, int(port)))
    warm_bad = sum(expect(p, "warmed", 600)[2] for p in pipes)
    if warm_bad:
        raise Fail(f"{warm_bad} warm-up requests got no full answer")
    stages["warm"] = time.perf_counter() - t_proc0
    return loaded, stages


def _threads() -> list[int]:
    return [int(t) for t in os.listdir("/proc/self/task")]


def _set_cpus(tid: int, cpus) -> None:
    try:
        os.sched_setaffinity(tid, cpus)
    except OSError:  # the thread has ended
        pass


class Pinning:
    """For the window: the server's threads on the upper half of the CPUs
    this process may use, the clients on the lower half (the first CPU
    takes the machine's housekeeping), so that no client takes a core
    from the server and the server's threads move over fewer cores.
    Threads the server starts in the window inherit its CPUs.  ``undo``
    gives this process its CPUs back."""

    def __init__(self, client_pids):
        self.cpus = sorted(os.sched_getaffinity(0))
        if len(self.cpus) < 2:
            return
        half = len(self.cpus) // 2
        for pid in client_pids:
            os.sched_setaffinity(pid, self.cpus[:half])
        for tid in _threads():
            _set_cpus(tid, self.cpus[half:])

    def undo(self) -> None:
        for tid in _threads():
            _set_cpus(tid, self.cpus)


def _window(server, procs, pipes, seconds, trace, engine, t_proc0) -> Ctx:
    """The measured window: every client's closed loop, the counters'
    deltas and, traced, the device's and the port's spans."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    dtrace = spans = None
    if trace and engine == "cuda":
        from benchport.devtrace import CLOSE_MARK, OPEN_MARK, DeviceTrace, HostSpans

        spans = HostSpans()
        spans.install(host_span_targets())
        dtrace = DeviceTrace()
        dtrace.start()
    traces0 = len(server.tracer)
    if engine == "cuda":
        torch.cuda.synchronize()
    pinning = Pinning([pr.pid for pr in procs])
    t_start = time.perf_counter() + 0.25
    t_end = t_start + seconds
    for p in pipes:
        p.send(("go", t_start, t_end))
    # One sleep to each edge: this thread shares the server's interpreter,
    # and each wake-up inside the window would take the GIL from the
    # thread that serves the request.
    time.sleep(max(0.0, t_start - time.perf_counter()))
    load_ = HostLoad()
    launches0 = dict(kernels.LAUNCHES)
    upload0 = server.executor.engine.stat_upload_bytes
    if dtrace:
        dtrace.mark(OPEN_MARK)
    time.sleep(max(0.0, t_end - time.perf_counter()))
    if dtrace:
        dtrace.mark(CLOSE_MARK)
    load_.stop()
    pinning.undo()
    launches = {k: v - launches0.get(k, 0) for k, v in kernels.LAUNCHES.items()}
    upload = server.executor.engine.stat_upload_bytes - upload0
    requests = []
    for p in pipes:
        _, c, dues, dones, answers = expect(p, "done", seconds + 120)
        requests += [Request(c, i, dues[i], dones[i], answers[i]) for i in range(len(dues))]
    device_summary = None
    if dtrace:
        dtrace.stop()
        spans.remove()
        device_summary = dtrace.summary(spans.spans)
    return Ctx(t_start=t_start, t_end=t_end, setup_s=t_start - t_proc0, seconds=seconds,
               trace=trace, requests=requests, launches=launches, upload_bytes=upload,
               port_spans=server.tracer.traces_json(limit=len(server.tracer) - traces0),
               device=device_summary, host_load=load_)


def _run(args, root, engine, t_proc0, out) -> int:
    bench = Bench(root)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    mix = bench.data("traffic", cell["traffic"])
    chips = int(cell["chips"])

    import numpy as np
    import torch

    # The program first: a checkout without it fails here, before any
    # client starts.
    from pilosa_tpu_torch.server.server import Server  # noqa: F401

    if engine == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise Fail(f"the cell needs {chips} CUDA device(s); torch sees "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    for k, v in cfg.get("deployment", {}).get("env", {}).items():
        os.environ[k] = str(v)
    device = torch.device(engine)
    if engine == "cuda":
        torch.cuda.reset_peak_memory_stats()

    procs, pipes = start_clients(cfg, mix, args.seed, args.seconds, bool(args.trace), root)
    data_dir = tempfile.mkdtemp(prefix="benchport-")
    try:
        server = open_server(cfg, data_dir, engine, bool(args.trace))
        loaded, stages = _set_up(server, cfg, mix, args.seed, device, pipes, t_proc0, root)
        ctx = _window(server, procs, pipes, args.seconds, bool(args.trace), engine, t_proc0)
        if engine == "cuda":
            torch.cuda.synchronize()
            peak, kind = torch.cuda.max_memory_allocated(), torch.cuda.get_device_name(0)
        else:
            peak, kind = 0, f"cpu ({engine})"
        release(server, cfg["index"])
        gc.collect()
        if engine == "cuda":
            torch.cuda.empty_cache()
        bad = forbidden_modules()
        if bad:
            raise Fail(f"modules of {', '.join(bad)} were loaded in this process")

        traffic = shape(mix, cfg, args.seed, root)
        for r in ctx.requests:
            r.calls = traffic.request("window", r.client, r.i)
        ctx.requests = [r for r in ctx.requests if ctx.t_start <= r.due < ctx.t_end]
        ctx.cell, ctx.cfg, ctx.mix = cell, cfg, mix
        checked = sample(ctx.requests, args.seed, int(mix["check_requests"]))
        t_check = time.perf_counter()
        if engine == "cuda":
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        wrong, compared = judge(cfg, args.seed, checked, device, root=root)
        check_s = time.perf_counter() - t_check
        if engine == "cuda":
            peak_check = torch.cuda.max_memory_allocated() - held
            print(f"benchport: the check's peak allocation {peak_check} bytes over the {held} "
                  f"held when it began", file=sys.stderr)
        unanswered = sum(1 for r in ctx.requests if not r.ok)

        metrics = {}
        for m in bench.metrics(cell["name"], ctx.trace):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        numbers = {"wrong_counts": wrong, "unanswered_requests": unanswered}
        dev = {"platform": "gpu" if engine == "cuda" else "cpu", "kind": kind,
               "count": chips, "memory_peak_bytes": int(peak)}
        result = {"correct": compared > 0 and all(numbers[k] <= LIMITS[k] for k in LIMITS),
                  "attempted": len(ctx.requests), "failed": unanswered,
                  "metrics": metrics, "device": dev}
        if ctx.device:
            dev["busy_s"] = ctx.device["busy_s"]
            dev["window_s"] = ctx.device["window_s"]
            result["breakdown"] = {"device_ops": ctx.device["device_ops"],
                                   "idle_gaps": ctx.device["idle_gaps"]}
        result["checks"] = {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}

        hl = ctx.host_load
        lat = np.array([(r.done - r.due) * 1e3 for r in ctx.requests])
        print("benchport: set-up stages end at (s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in stages.items()) + f", window {ctx.setup_s:.2f}",
            file=sys.stderr)
        print("benchport: latency ms p50 %.1f p90 %.1f p99 %.1f max %.1f; gc %.3f s (%d full); "
              "server cpu %.1f s" % (np.percentile(lat, 50), np.percentile(lat, 90),
                                     np.percentile(lat, 99), lat.max(), hl.gc_s, hl.gc_full,
                                     hl.cpu_s), file=sys.stderr)
        # Calls answered in each 5 s of the window: whether a slow run was
        # slow throughout or for a stretch of it.
        ans = [r for r in ctx.requests if r.ok and r.done <= ctx.t_end]
        per = np.bincount(np.array([(r.done - ctx.t_start) // 5 for r in ans], dtype=np.int64),
                          weights=[len(r.answer) for r in ans], minlength=1)
        print("benchport: calls/s in each 5 s: " + " ".join(
            f"{n / 5:.0f}" for n in per[:max(1, int(ctx.seconds // 5))]), file=sys.stderr)
        print(f"benchport: {args.workload} seed {args.seed}: {len(ctx.requests)} requests due, "
              f"{loaded} pairs loaded, {compared} counts of {len(checked)} requests checked "
              f"in {check_s:.1f} s", file=sys.stderr)
        for k in LIMITS:
            print(f"check {k} {numbers[k]} limit {LIMITS[k]}", file=sys.stderr)
        out.write(json.dumps(result) + "\n")
        out.flush()
        return 0
    finally:
        stop_clients(procs, pipes)
        shutil.rmtree(data_dir, ignore_errors=True)
