"""HTTP client mirroring the full API (reference analog: client.go, 1053 LoC).

Used by: remote query execution (executor mapReduce), write forwarding,
bulk import (grouping bits by slice and POSTing protobuf to every owner
node, client.go:304-390), backup/restore streaming, fragment block sync,
attr-diff sync, and the ctl tools.
"""

from __future__ import annotations

import json
import os
import random
import time
import urllib.error
import urllib.request
from typing import Any, Optional, Sequence

import numpy as np

from pilosa_tpu_torch import pql, wire
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.executor import QueryBitmap
from pilosa_tpu_torch.ops.bitwise import pack_positions
from pilosa_tpu_torch.pilosa import SLICE_WIDTH, PilosaError
from pilosa_tpu_torch.qcache import NO_CACHE_HEADER
from pilosa_tpu_torch.qos import DEADLINE_HEADER
from pilosa_tpu_torch.replica import GROUP_HEADER
from pilosa_tpu_torch.trace import TRACE_HEADER, TRACE_SPANS_HEADER

PROTOBUF = "application/x-protobuf"

# Backoff cap when honoring a peer's Retry-After on 429/503 in the
# cluster fan-out: a peer advertising a long recovery must not stall a
# forwarded sub-request longer than this per attempt.
RETRY_AFTER_CAP_S = 2.0

# Decorrelated-jitter backoff floor between retry attempts (AWS
# architecture-blog discipline: each wait draws uniform(base, 3x the
# previous wait), so a retrying fleet spreads out instead of thundering
# back in lockstep).
RETRY_BASE_S = 0.05

# Default retry budget ([client] retry-budget): total EXTRA attempts a
# single logical request may spend across its lifetime.
DEFAULT_RETRY_BUDGET = 2


class ClientError(PilosaError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class Client:
    def __init__(self, host: str, timeout: float = 30.0,
                 retry_budget: Optional[int] = None, stats=None):
        if "://" not in host:
            host = "http://" + host
        self.base = host.rstrip("/")
        self.timeout = timeout
        # Retry budget (ctor arg — the Server passes [client]
        # retry-budget — > env > default).  Budgeted retries fire ONLY
        # on 429/503 answers: both are door sheds in this stack
        # (admission/quorum refusal BEFORE execution), so retrying a
        # write is safe — a request that reached execution answers with
        # some other status and is never retried past its first byte of
        # effect.
        if retry_budget is None:
            retry_budget = int(
                os.environ.get(  # analysis-ok: env-knob-outside-config: client-side fallback for directly-constructed clients; the Server passes [client] config
                    "PILOSA_TPU_CLIENT_RETRY_BUDGET", str(DEFAULT_RETRY_BUDGET)
                )
            )
        self.retry_budget = max(0, retry_budget)
        self.stats = stats
        self._rng = random.Random()

    # -- low level -------------------------------------------------------

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        content_type: str = "application/json",
        accept: str = "application/json",
        headers: Optional[dict] = None,
        timeout: Optional[float] = None,
        retries: Optional[int] = None,
        deadline=None,
        capture: Optional[dict] = None,
    ) -> tuple[int, bytes]:
        """One HTTP exchange; ``timeout`` overrides the constructor-wide
        default per request.

        RETRY BUDGET: a 429/503 answer — a door shed, issued BEFORE any
        execution, so safe to retry even for writes; a request that
        reached execution never answers 429/503 and is never retried
        past its first byte of effect — is retried up to ``retries``
        times (default: the client's ``retry_budget``; 0 disables).
        Each wait uses DECORRELATED JITTER (uniform between the base
        and 3x the previous wait, so a shedding server sees retries
        spread out, not a thundering herd), floored by the peer's
        ``Retry-After`` hint and capped at RETRY_AFTER_CAP_S.  The loop
        is DEADLINE-AWARE: a wait that could not finish inside the
        remaining budget returns the shed answer instead of sleeping
        through it.  Each retry counts ``client.retries``.

        ``capture`` (a dict) receives the final response's headers under
        ``"headers"`` — the trace hop reads X-Pilosa-Trace-Spans from
        it.  The SAME Request object serves every retry attempt, so a
        retried request keeps its identity (deadline budget and trace
        id headers included): the peer sees one request retried, never
        two distinct root spans."""
        if retries is None:
            retries = self.retry_budget
        req = urllib.request.Request(self.base + path, data=body, method=method)
        if body is not None:
            req.add_header("Content-Type", content_type)
        req.add_header("Accept", accept)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        attempt = 0
        prev_wait = RETRY_BASE_S
        while True:
            try:
                with urllib.request.urlopen(
                    req, timeout=timeout if timeout is not None else self.timeout
                ) as resp:
                    if capture is not None:
                        capture["headers"] = resp.headers
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                status, payload, resp_headers = e.code, e.read(), e.headers
                if capture is not None:
                    capture["headers"] = resp_headers
            if status not in (429, 503) or attempt >= retries:
                return status, payload
            attempt += 1
            wait = self._rng.uniform(RETRY_BASE_S, prev_wait * 3.0)
            try:
                hint = float(resp_headers.get("Retry-After", "0"))
            except (TypeError, ValueError):
                hint = 0.0
            wait = min(max(wait, hint, 0.0), RETRY_AFTER_CAP_S)
            prev_wait = wait
            if deadline is not None:
                left = deadline.remaining_ms() / 1000.0
                if left <= wait:
                    return status, payload  # a retry could not finish in budget
            if self.stats is not None:
                self.stats.count("client.retries")
            time.sleep(wait)

    def _json(self, method: str, path: str, obj: Any = None) -> dict:
        body = json.dumps(obj).encode() if obj is not None else None
        status, payload = self._request(method, path, body)
        if status >= 400:
            msg = payload.decode(errors="replace")
            try:
                msg = json.loads(msg).get("error", msg)
            # analysis-ok: exception-hygiene: best-effort decode of an error payload; the real error raises on the next line
            except Exception:
                pass
            raise ClientError(status, msg)
        return json.loads(payload) if payload else {}

    # -- queries (client.go:38-120) ---------------------------------------

    def execute_query(
        self,
        index: str,
        query: str,
        slices: Optional[Sequence[int]] = None,
        column_attrs: bool = False,
        remote: bool = False,
        deadline=None,
        timeout: Optional[float] = None,
        no_cache: bool = False,
        trace_span=None,
    ) -> dict:
        """Execute PQL; returns the decoded QueryResponse dict.

        ``deadline`` (qos.Deadline) forwards the REMAINING budget to the
        peer as the X-Pilosa-Deadline-Ms hop header and tightens the
        socket timeout to match; a shed (429) or unavailable (503) peer
        is retried within the client's deadline-aware retry budget
        (decorrelated jitter, floored by Retry-After).  ``no_cache`` sets
        X-Pilosa-No-Cache so the peer's query result cache neither
        serves nor stores this request (A/B measurement, stale-read
        debugging).  ``trace_span`` (trace.Span) propagates the request
        trace across the hop: the trace id goes out in X-Pilosa-Trace
        (forcing the peer to trace), and the peer's span tree from the
        X-Pilosa-Trace-Spans response header is grafted under it.  The
        retry reuses the same Request object, so a retried hop keeps
        ONE trace identity — no duplicate root spans on the peer.
        """
        body = wire.encode_query_request(
            query, slices=list(slices or []), column_attrs=column_attrs, remote=remote
        )
        headers = {}
        if no_cache:
            headers[NO_CACHE_HEADER] = "1"
        if trace_span is not None:
            headers[TRACE_HEADER] = getattr(trace_span, "trace_id", "") or "1"
        if deadline is not None:
            headers[DEADLINE_HEADER] = deadline.header_value()
            if timeout is None:
                # Socket bound tracks the budget (+ slack for the 504
                # answer itself to travel back).
                timeout = min(self.timeout, deadline.remaining_ms() / 1000.0 + 1.0)
        capture: dict = {}
        status, payload = self._request(
            "POST", f"/index/{index}/query", body, content_type=PROTOBUF, accept=PROTOBUF,
            headers=headers, timeout=timeout, deadline=deadline,
            capture=capture,
        )
        if trace_span is not None and capture.get("headers") is not None:
            raw = capture["headers"].get(TRACE_SPANS_HEADER)
            if raw:
                try:
                    trace_span.graft(json.loads(raw))
                except ValueError:
                    pass  # a malformed header never fails the query
        if status >= 400:
            msg = payload.decode(errors="replace")
            try:
                msg = wire.decode_query_response(payload).get("err") or msg
            except ValueError:
                try:
                    msg = json.loads(msg).get("error", msg)
                # analysis-ok: exception-hygiene: best-effort decode of an error payload; the real error raises below
                except Exception:
                    pass
            raise ClientError(status, msg)
        resp = wire.decode_query_response(payload)
        if resp.get("err"):
            raise ClientError(status, resp["err"])
        # Replica attribution: which serving group (or "all", for a
        # router write fan-out) answered — absent off group-less hosts.
        if capture.get("headers") is not None:
            grp = capture["headers"].get(GROUP_HEADER)
            if grp:
                resp["group"] = grp
        return resp

    def execute_remote(
        self,
        index: str,
        query: "pql.Query",
        slices: Optional[Sequence[int]] = None,
        deadline=None,
        no_cache: bool = False,
        trace_span=None,
    ) -> list:
        """Forward a parsed query for remote execution; returns typed results
        (the client half of executor.go:1009-1091).  proto3 omits
        zero-valued fields, so each QueryResult is interpreted against its
        call's expected type, as the reference does (executor.go:1068-1085).
        """
        resp = self.execute_query(
            index, str(query), slices=slices, remote=True, deadline=deadline,
            no_cache=no_cache, trace_span=trace_span,
        )
        return [
            _result_from_wire(r, expect=c.name)
            for r, c in zip(resp["results"], query.calls)
        ]

    def execute_remote_call(
        self, index: str, call: "pql.Call", slices: Sequence[int], deadline=None,
        no_cache: bool = False, trace_span=None,
    ):
        results = self.execute_remote(
            index, pql.Query(calls=[call]), slices=slices, deadline=deadline,
            no_cache=no_cache, trace_span=trace_span,
        )
        return results[0]

    # -- schema (client.go:392-460) ----------------------------------------

    def schema(self) -> list[dict]:
        return self._json("GET", "/schema")["indexes"]

    def create_index(self, index: str, options: Optional[dict] = None) -> None:
        self._json("POST", f"/index/{index}", {"options": options or {}})

    def delete_index(self, index: str) -> None:
        self._json("DELETE", f"/index/{index}")

    def create_frame(self, index: str, frame: str, options: Optional[dict] = None) -> None:
        self._json("POST", f"/index/{index}/frame/{frame}", {"options": options or {}})

    def delete_frame(self, index: str, frame: str) -> None:
        self._json("DELETE", f"/index/{index}/frame/{frame}")

    def frame_views(self, index: str, frame: str) -> list[str]:
        return self._json("GET", f"/index/{index}/frame/{frame}/views")["views"]

    def max_slices(self, inverse: bool = False) -> dict[str, int]:
        suffix = "?inverse=true" if inverse else ""
        return self._json("GET", f"/slices/max{suffix}")["maxSlices"]

    def hosts(self) -> list[dict]:
        return self._json("GET", "/hosts")

    def status(self) -> dict:
        return self._json("GET", "/status")["status"]

    def replica_status(self) -> dict:
        """The replica router's live group table (/replica/status):
        per-group health/inflight/epoch plus the quorum flag."""
        return self._json("GET", "/replica/status")

    def version(self) -> str:
        return self._json("GET", "/version")["version"]

    # -- import (client.go:304-390) ----------------------------------------

    def import_bits(
        self,
        index: str,
        frame: str,
        bits: Sequence[tuple],
        fragment_nodes=None,
    ) -> None:
        """Group (row, col[, timestamp]) bits by slice and POST each group to
        every owner node (client.go:304-331)."""
        groups: dict[int, list[tuple]] = {}
        for bit in bits:
            slice_i = int(bit[1]) // SLICE_WIDTH
            groups.setdefault(slice_i, []).append(bit)
        for slice_i, group in sorted(groups.items()):
            rows = [int(b[0]) for b in group]
            cols = [int(b[1]) for b in group]
            ts = [int(b[2]) if len(b) > 2 and b[2] else 0 for b in group]
            payload = wire.encode_import_request(
                index, frame, slice_i, rows, cols, ts if any(ts) else None
            )
            hosts = [self.base]
            if fragment_nodes is not None:
                hosts = [n.host for n in fragment_nodes(index, slice_i)]
            for host in hosts:
                client = self if host == self.base else Client(host, self.timeout)
                status, resp = client._request(
                    "POST", "/import", payload, content_type=PROTOBUF, accept=PROTOBUF
                )
                if status >= 400:
                    raise ClientError(status, resp.decode(errors="replace"))

    # -- export / backup / restore (client.go:463-676) ----------------------

    # -- streaming columnar ingest (POST .../ingest) ------------------------

    def ingest_chunk(self, index: str, frame: str, off: int, total: int,
                     crc: int, body: bytes, ccrc: Optional[int] = None,
                     probe: bool = False, deadline=None,
                     door: str = "ingest", arrow: bool = False):
        """One chunk of a streaming ingest transfer; returns
        ``(status, parsed-json)`` — 409 answers (offset gaps / resume
        hints) come back as data, not exceptions, so the streamer can
        adopt the server's ``staged`` frontier.  ``door`` selects the
        endpoint (``ingest`` = streamed set_bits, ``bulk`` = device
        build); ``arrow`` marks the chunk as an Arrow IPC stream."""
        from pilosa_tpu_torch.ingest import ARROW_CONTENT_TYPE

        q = f"/index/{index}/frame/{frame}/{door}?off={off}&total={total}&crc={crc}"
        if ccrc is not None:
            q += f"&ccrc={ccrc}"
        if probe:
            q += "&probe=1"
        status, payload = self._request(
            "POST", q, body=body,
            content_type=(
                ARROW_CONTENT_TYPE if arrow else "application/octet-stream"
            ),
            deadline=deadline,
        )
        try:
            out = json.loads(payload) if payload else {}
        except ValueError:
            out = {}
        if status >= 400 and status != 409:
            raise ClientError(status, out.get("error", payload.decode(errors="replace")))
        return status, out

    def ingest_stream(self, index: str, frame: str, rows, cols,
                      chunk_pairs: int = 65536, deadline=None,
                      door: str = "ingest", arrow: bool = False) -> dict:
        """Stream (row, col) columns through a columnar ingest door as
        packed-uint64 (or, with ``arrow``, Arrow IPC) chunks, resuming
        at the server's staged frontier on offset gaps (a restarted
        transfer probes first).  Chunk boundaries are a pure function
        of (rows, cols, chunk_pairs), so a resumed stream re-frames
        identically."""
        import zlib as _zlib

        from pilosa_tpu_torch.ingest import encode_packed

        if arrow:
            from pilosa_tpu_torch.bulk.egress import encode_arrow_pairs

            def _enc(r, c):
                return encode_arrow_pairs(r, c)
        else:
            _enc = encode_packed
        frames = [
            _enc(rows[i : i + chunk_pairs], cols[i : i + chunk_pairs])
            for i in range(0, len(rows), chunk_pairs)
        ] or [_enc([], [])]
        total = sum(len(f) for f in frames)
        crc = 0
        for f in frames:
            crc = _zlib.crc32(f, crc)
        _, out = self.ingest_chunk(index, frame, 0, total, crc, b"", probe=True,
                                   deadline=deadline, door=door, arrow=arrow)
        staged = int(out.get("staged", 0))
        cur = 0
        result: dict = {"staged": staged, "done": False}
        for fb in frames:
            if cur + len(fb) <= staged:
                cur += len(fb)  # already applied before a restart
                continue
            status, result = self.ingest_chunk(
                index, frame, cur, total, crc, fb,
                ccrc=_zlib.crc32(fb), deadline=deadline, door=door,
                arrow=arrow,
            )
            if status == 409:
                # Adopt the server's frontier once; anything else
                # (shrinking frontier, repeat gap) is a real error.
                srv = int(result.get("staged", -1))
                if srv <= cur:
                    raise ClientError(409, result.get("error", "ingest gap"))
                staged = srv
                if cur + len(fb) <= staged:
                    cur += len(fb)
                    continue
                raise ClientError(409, result.get("error", "ingest gap"))
            cur += len(fb)
        return result

    def bulk_stream(self, index: str, frame: str, rows, cols,
                    chunk_pairs: int = 65536, deadline=None,
                    arrow: bool = False) -> dict:
        """Stream (row, col) columns through the device-first bulk
        build door (``POST .../bulk``): same wire and resume semantics
        as :meth:`ingest_stream`, but the server packs the bits into
        fragment word planes with its engine's sort/segment/scatter
        kernel and leaves roaring materialization lazy."""
        return self.ingest_stream(
            index, frame, rows, cols, chunk_pairs=chunk_pairs,
            deadline=deadline, door="bulk", arrow=arrow,
        )

    def export_arrow(self, index: str, frame: str, view: str,
                     slice_i: int) -> bytes:
        """One fragment as an Arrow IPC stream of uint64 row/col
        columns — the exact schema the ingest doors accept."""
        status, payload = self._request(
            "GET",
            f"/export?index={index}&frame={frame}&view={view}"
            f"&slice={slice_i}&format=arrow",
        )
        if status >= 400:
            raise ClientError(status, payload.decode(errors="replace"))
        return payload

    def export_csv(self, index: str, frame: str, view: str, slice_i: int) -> str:
        status, payload = self._request(
            "GET", f"/export?index={index}&frame={frame}&view={view}&slice={slice_i}"
        )
        if status >= 400:
            raise ClientError(status, payload.decode(errors="replace"))
        return payload.decode()

    def fragment_data(self, index: str, frame: str, view: str, slice_i: int) -> Optional[bytes]:
        status, payload = self._request(
            "GET", f"/fragment/data?index={index}&frame={frame}&view={view}&slice={slice_i}"
        )
        if status == 404:
            return None
        if status >= 400:
            raise ClientError(status, payload.decode(errors="replace"))
        return payload

    def restore_fragment(self, index: str, frame: str, view: str, slice_i: int, data: bytes) -> None:
        status, payload = self._request(
            "POST",
            f"/fragment/data?index={index}&frame={frame}&view={view}&slice={slice_i}",
            data,
            content_type="application/octet-stream",
        )
        if status >= 400:
            raise ClientError(status, payload.decode(errors="replace"))

    def restore_frame(self, index: str, frame: str, host: str) -> None:
        self._json("POST", f"/index/{index}/frame/{frame}/restore?host={host}")

    # -- block sync (client.go:700-860) --------------------------------------

    def fragment_blocks(self, index: str, frame: str, view: str, slice_i: int) -> list[tuple[int, bytes]]:
        resp = self._json(
            "GET", f"/fragment/blocks?index={index}&frame={frame}&view={view}&slice={slice_i}"
        )
        return [(b["id"], bytes.fromhex(b["checksum"])) for b in resp["blocks"]]

    def block_data(self, index: str, frame: str, view: str, slice_i: int, block: int):
        status, payload = self._request(
            "GET",
            f"/fragment/block/data?index={index}&frame={frame}&view={view}&slice={slice_i}&block={block}",
            accept=PROTOBUF,
        )
        if status >= 400:
            raise ClientError(status, payload.decode(errors="replace"))
        rows, cols = wire.decode_block_data_response(payload)
        return np.array(rows, dtype=np.uint64), np.array(cols, dtype=np.uint64)

    def post_block_diff(
        self,
        index: str,
        frame: str,
        view: str,
        slice_i: int,
        set_bits: tuple[list[int], list[int]],
        clear_bits: tuple[list[int], list[int]],
    ) -> None:
        payload = wire.encode_block_diff(set_bits[0], set_bits[1], clear_bits[0], clear_bits[1])
        status, resp = self._request(
            "POST",
            f"/fragment/block/diff?index={index}&frame={frame}&view={view}&slice={slice_i}",
            payload,
            content_type=PROTOBUF,
        )
        if status >= 400:
            raise ClientError(status, resp.decode(errors="replace"))

    def column_attr_diff(self, index: str, blocks: list[tuple[int, bytes]]) -> dict[int, dict]:
        resp = self._json(
            "POST",
            f"/index/{index}/attr/diff",
            {"blocks": [{"id": b, "checksum": c.hex()} for b, c in blocks]},
        )
        return {int(k): v for k, v in resp["attrs"].items()}

    def row_attr_diff(self, index: str, frame: str, blocks: list[tuple[int, bytes]]) -> dict[int, dict]:
        resp = self._json(
            "POST",
            f"/index/{index}/frame/{frame}/attr/diff",
            {"blocks": [{"id": b, "checksum": c.hex()} for b, c in blocks]},
        )
        return {int(k): v for k, v in resp["attrs"].items()}


def _result_from_wire(r: dict, expect: str = ""):
    """Decode one wire QueryResult into executor-level result types."""
    if expect == "Count":
        return int(r.get("n", 0))
    if expect == "TopN":
        return [Pair(id=p["id"], count=p["count"]) for p in r.get("pairs", [])]
    if expect in ("SetBit", "ClearBit"):
        return bool(r.get("changed", False))
    if expect in ("SetRowAttrs", "SetColumnAttrs", "SetProfileAttrs"):
        return None
    if expect in ("Bitmap", "Intersect", "Union", "Difference", "Xor", "Range") and "bitmap" not in r:
        return QueryBitmap({}, {})
    if "bitmap" in r:
        bits = np.array(r["bitmap"]["bits"], dtype=np.uint64)
        segments: dict[int, np.ndarray] = {}
        if len(bits):
            slices = bits // np.uint64(SLICE_WIDTH)
            for s in np.unique(slices):
                local = bits[slices == s] % np.uint64(SLICE_WIDTH)
                segments[int(s)] = pack_positions(local)
        return QueryBitmap(segments, r["bitmap"].get("attrs") or {})
    if "pairs" in r:
        return [Pair(id=p["id"], count=p["count"]) for p in r["pairs"]]
    if "changed" in r:
        return r["changed"]
    if "n" in r:
        return r["n"]
    return None


def bits_group_by_slice(bits: Sequence[tuple]) -> dict[int, list[tuple]]:
    """client.go:1027-1043 Bits.GroupBySlice."""
    groups: dict[int, list[tuple]] = {}
    for bit in bits:
        groups.setdefault(int(bit[1]) // SLICE_WIDTH, []).append(bit)
    return groups
