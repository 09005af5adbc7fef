"""A closed-loop client, run in a process of its own.

It makes its requests from the seed before the window opens, warms its
connection, then sends the next request only after the reply to the last
one, from the window's opening until its close, and records for every
request the time it was due (sent) and done (answered), and its answer.
Imports the standard library, the traffic generator and the mix's shape
only: nothing of the program and no torch.
"""

from __future__ import annotations

import http.client
import json
import time

from benchport.traffic_gen import shape

TRACE_HEADER = "X-Pilosa-Trace"


def _post(conn, path: str, body: bytes, headers: dict) -> tuple[int, bytes]:
    conn.request("POST", path, body=body, headers=headers)
    resp = conn.getresponse()
    return resp.status, resp.read()


def _answer(status: int, payload: bytes, n_calls: int):
    """The request's counts, or None where the reply is not a full answer."""
    if status != 200:
        return None
    try:
        results = json.loads(payload)["results"]
    except (ValueError, KeyError, TypeError):
        return None
    if not isinstance(results, list) or len(results) != n_calls:
        return None
    return [int(r) for r in results]


def run(pipe, client: int, mix: dict, cfg: dict, seed: int, n_max: int, n_warm: int,
        trace: bool, root: str) -> None:
    """The client's life: ``ready`` -> (``warm`` host port) -> ``warmed``
    -> (``go`` t_start t_end) -> ``done`` with its records.  The mix's
    shape is found under ``root``."""
    traffic = shape(mix, cfg, seed, root)
    window = [traffic.body(traffic.request("window", client, i)) for i in range(n_max)]
    warm = [traffic.body(traffic.request("warm", client, i)) for i in range(n_warm)]
    pipe.send(("ready", client))
    _, host, port = pipe.recv()
    path = f"/index/{cfg['index']}/query"
    conn = http.client.HTTPConnection(host, port, timeout=600)
    headers = {"Content-Type": "text/plain"}
    warm_bad = 0
    for body in warm:
        status, payload = _post(conn, path, body, headers)
        warm_bad += _answer(status, payload, traffic.calls) is None
    pipe.send(("warmed", client, warm_bad))
    _, t_start, t_end = pipe.recv()
    if trace:
        headers = dict(headers, **{TRACE_HEADER: "1"})
    due, done, answers = [], [], []
    while time.perf_counter() < t_start:
        time.sleep(min(0.01, max(0.0, t_start - time.perf_counter())))
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        if i >= n_max:
            pipe.send(("exhausted", client, n_max))
            conn.close()
            return
        try:
            status, payload = _post(conn, path, window[i], headers)
            ans = _answer(status, payload, traffic.calls)
        except (OSError, http.client.HTTPException):
            conn.close()
            conn = http.client.HTTPConnection(host, port, timeout=600)
            ans = None
        due.append(t0)
        done.append(time.perf_counter())
        answers.append(ans)
        i += 1
    conn.close()
    pipe.send(("done", client, due, done, answers))
