"""HTTP API handler: the reference's full route table on stdlib http.server.

Reference analog: handler.go (1429 LoC; route table handler.go:82-120).
Routes:

    GET    /                                        welcome (API) / WebUI (browser)
    GET    /assets/{file}                           WebUI assets
    GET    /index                                   list indexes
    GET    /index/{index}                           index info
    POST   /index/{index}                           create index
    DELETE /index/{index}                           delete index
    POST   /index/{index}/attr/diff                 column attr-diff (sync)
    POST   /index/{index}/frame/{frame}             create frame
    DELETE /index/{index}/frame/{frame}             delete frame
    POST   /index/{index}/query                     PQL query (JSON or protobuf)
    POST   /index/{index}/frame/{frame}/attr/diff   row attr-diff (sync)
    POST   /index/{index}/frame/{frame}/restore     restore frame from peers
    PATCH  /index/{index}/frame/{frame}/time-quantum
    GET    /index/{index}/frame/{frame}/views
    PATCH  /index/{index}/time-quantum
    GET    /debug/vars                              expvar-style stats
    GET    /debug/pprof/...                         thread/profile dump
    GET    /export                                  CSV export
    GET    /fragment/block/data                     block bit data (protobuf)
    GET    /fragment/blocks                         block checksums
    GET    /fragment/data                           raw fragment snapshot
    POST   /fragment/data                           replace fragment (restore)
    GET    /fragment/nodes                          owner nodes for a slice
    POST   /import                                  bulk import (protobuf)
    GET    /hosts                                   cluster hosts
    GET    /schema                                  full schema
    GET    /slices/max                              per-index max slice
    GET    /status                                  cluster status
    GET    /version

Content negotiation mirrors handler.go:816-898: requests/responses use
``application/x-protobuf`` when the Content-Type/Accept headers ask for
it, JSON otherwise.
"""

from __future__ import annotations

import io
import json
import os
import queue
import re
import socket
import threading
import time
import traceback
import zlib
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from pilosa_tpu_torch import pilosa as errors
from pilosa_tpu_torch.analysis import lockcheck
from pilosa_tpu_torch import pql, qcache as qcache_mod, qos, trace as trace_mod, wire
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.core.frame import FrameOptions
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.executor import ExecOptions, QueryBitmap
from pilosa_tpu_torch.pilosa import SLICE_WIDTH, PilosaError

# The reference server's version string: both packages serve one HTTP
# API, and clients read the same /version body from either.
VERSION = "0.1.0-tpu"

PROTOBUF = "application/x-protobuf"

# Tenant attribution goes through the single tenancy.resolve seam
# (header > [tenancy] map > index name): trace tags, slow-query log
# lines, the cost ledger, and the admission doors can never disagree
# on a request's tenant.  See _resolve_tenant.
from pilosa_tpu_torch import tenancy as tenancy_mod


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def result_to_json(result):
    if isinstance(result, QueryBitmap):
        return result.to_json()
    if isinstance(result, list) and (not result or isinstance(result[0], Pair)):
        return [p.to_json() for p in result]
    return result


class Handler:
    """Routes requests to the holder/executor; transport-agnostic core."""

    def __init__(self, holder, executor, cluster=None, host="", broadcaster=None, stats=None, client_factory=None,
                 admission=None, default_deadline_ms: float = 0.0, tracer=None,
                 group: str = "", applied_seq=None,
                 ingest_chunk_bytes: int = 4 << 20, costs=None,
                 planner=None,
                 bulk_batch_slices: int = 8,
                 bulk_materialize_budget_ms: float = 0.0,
                 tenancy=None):
        self.holder = holder
        self.executor = executor
        self.cluster = cluster
        self.host = host
        self.broadcaster = broadcaster  # schema-mutation broadcast hook
        self.stats = stats
        self._profiling = None  # (trace dir, torch profiler) while one runs
        self.client_factory = client_factory
        # Request-lifecycle QoS: the per-class admission gate (None =
        # unbounded, the pre-QoS behavior) and the server's default
        # deadline for requests that carry no X-Pilosa-Deadline-Ms.
        self.admission = admission
        self.default_deadline_ms = default_deadline_ms
        # Request-scoped span tracer (trace.Tracer); None = no tracing
        # at all (embedders) — the server always passes one so the
        # X-Pilosa-Trace force override works without a restart.
        self.tracer = tracer
        # Per-fingerprint cost ledger (costs.CostLedger), served at
        # /debug/costs; None = ledger disabled (endpoint answers empty).
        self.costs = costs
        # Cost-based planner (planner.Planner): this handler is the
        # CONSULTATION point — post_query fingerprints the body and
        # attaches the plan to ExecOptions; the executor only applies.
        # None = static strategy ladder everywhere (the default).
        self.planner = planner
        # Multi-tenant isolation (tenancy.TenancyState): the resolution
        # seam + fair-share/quota/pacer state.  None = isolation off —
        # attribution falls back to the index name and no door enforces.
        self.tenancy = tenancy
        # Replica serving-group identity ("name" or "name@epoch",
        # [replica] group): stamped on every response as X-Pilosa-Group
        # so the router can record which group answered and detect
        # epoch bumps across restarts.
        self.group = group
        # Last-applied router write sequence (replica durability): the
        # router tags every sequenced write with X-Pilosa-Write-Seq;
        # the handler notes it once the route answers deterministically
        # and reports it back (X-Pilosa-Applied-Seq + /replica/health)
        # so the router can stream exactly the missed WAL suffix to a
        # restarted group.  The Server passes a disk-backed AppliedSeq;
        # group-tagged embedders get an in-memory one.
        if applied_seq is None and group:
            from pilosa_tpu_torch.replica.catchup import AppliedSeq

            applied_seq = AppliedSeq()
        self.applied_seq = applied_seq
        # Resync chunk staging (POST /fragment/import-roaring): one
        # in-progress transfer buffer per fragment path, keyed with the
        # whole payload's (total, crc) so a resumed transfer continues
        # and a different payload restarts cleanly.  Memory only — a
        # crashed group simply restarts the transfer.
        self._resync_mu = lockcheck.named_lock("server.handler._resync_mu")
        self._resync_staging: dict[tuple, dict] = {}
        # Streaming columnar bulk-ingest door (POST .../ingest): chunks
        # apply as they arrive through the batched set_bits path; the
        # stager holds offsets + running CRC only, never payloads.
        from pilosa_tpu_torch import ingest as ingest_mod

        self._ingestor = ingest_mod.StreamIngestor(
            self._ingest_apply,
            complete=self._ingest_complete,
            stats=stats,
            max_chunk_bytes=ingest_chunk_bytes,
        )
        # Device-first bulk build door (POST .../bulk): same chunk wire
        # as the streamed door, but chunks run the engine's
        # sort/segment/scatter build and commit word planes as pending
        # fragment overlays — roaring stays lazy (pilosa_tpu_torch/bulk).
        self.bulk_batch_slices = bulk_batch_slices
        self.bulk_materialize_budget_ms = bulk_materialize_budget_ms
        self._bulk_ingestor = ingest_mod.StreamIngestor(
            self._bulk_apply,
            complete=self._bulk_complete,
            stats=stats,
            max_chunk_bytes=ingest_chunk_bytes,
        )
        self.version = VERSION
        self._routes = self._build_routes()

    # -- routing -------------------------------------------------------

    def _build_routes(self):
        return [
            ("GET", re.compile(r"^/$"), self.get_root),
            ("GET", re.compile(r"^/assets/(?P<file>[^/]+)$"), self.get_webui_asset),
            ("GET", re.compile(r"^/index$"), self.get_indexes),
            ("GET", re.compile(r"^/index/(?P<index>[^/]+)$"), self.get_index),
            ("POST", re.compile(r"^/index/(?P<index>[^/]+)$"), self.post_index),
            ("DELETE", re.compile(r"^/index/(?P<index>[^/]+)$"), self.delete_index),
            ("POST", re.compile(r"^/index/(?P<index>[^/]+)/attr/diff$"), self.post_index_attr_diff),
            ("POST", re.compile(r"^/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)$"), self.post_frame),
            ("DELETE", re.compile(r"^/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)$"), self.delete_frame),
            ("POST", re.compile(r"^/index/(?P<index>[^/]+)/query$"), self.post_query),
            ("POST", re.compile(r"^/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/ingest$"), self.post_frame_ingest),
            ("POST", re.compile(r"^/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/bulk$"), self.post_frame_bulk),
            ("POST", re.compile(r"^/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/attr/diff$"), self.post_frame_attr_diff),
            ("POST", re.compile(r"^/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/restore$"), self.post_frame_restore),
            ("PATCH", re.compile(r"^/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/time-quantum$"), self.patch_frame_time_quantum),
            ("GET", re.compile(r"^/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/views$"), self.get_frame_views),
            ("PATCH", re.compile(r"^/index/(?P<index>[^/]+)/time-quantum$"), self.patch_index_time_quantum),
            ("GET", re.compile(r"^/replica/health$"), self.get_replica_health),
            ("GET", re.compile(r"^/replica/digest$"), self.get_replica_digest),
            ("POST", re.compile(r"^/replica/seed-seq$"), self.post_replica_seed_seq),
            ("POST", re.compile(r"^/fragment/import-roaring$"), self.post_fragment_import_roaring),
            ("GET", re.compile(r"^/debug/vars$"), self.get_expvar),
            ("GET", re.compile(r"^/debug/traces$"), self.get_debug_traces),
            ("GET", re.compile(r"^/debug/costs$"), self.get_debug_costs),
            ("GET", re.compile(r"^/debug/planner$"), self.get_debug_planner),
            ("GET", re.compile(r"^/debug/tenants$"), self.get_debug_tenants),
            ("GET", re.compile(r"^/metrics$"), self.get_metrics),
            ("GET", re.compile(r"^/debug/pprof(?:/(?P<path>.*))?$"), self.get_pprof),
            ("POST", re.compile(r"^/debug/profile/start$"), self.post_profile_start),
            ("POST", re.compile(r"^/debug/profile/stop$"), self.post_profile_stop),
            ("GET", re.compile(r"^/export$"), self.get_export),
            ("GET", re.compile(r"^/fragment/block/data$"), self.get_fragment_block_data),
            ("POST", re.compile(r"^/fragment/block/diff$"), self.post_fragment_block_diff),
            ("GET", re.compile(r"^/fragment/blocks$"), self.get_fragment_blocks),
            ("GET", re.compile(r"^/fragment/data$"), self.get_fragment_data),
            ("POST", re.compile(r"^/fragment/data$"), self.post_fragment_data),
            ("GET", re.compile(r"^/fragment/nodes$"), self.get_fragment_nodes),
            ("POST", re.compile(r"^/import$"), self.post_import),
            ("GET", re.compile(r"^/hosts$"), self.get_hosts),
            ("GET", re.compile(r"^/schema$"), self.get_schema),
            ("GET", re.compile(r"^/slices/max$"), self.get_slices_max),
            ("GET", re.compile(r"^/status$"), self.get_status),
            ("GET", re.compile(r"^/version$"), self.get_version),
        ]

    def dispatch(self, method: str, path: str, params: dict, body: bytes, headers: dict):
        """Returns (status, content_type, payload bytes[, extra headers]).

        The TRACE door wraps the QoS door: the head-sampling decision is
        made once here (``X-Pilosa-Trace`` forces it — the client
        override and the cross-node hop), the root span rides down into
        the route (post_query threads it through ExecOptions into the
        executor), and at completion the tracer records the ring entry,
        emits the slow-query log line for any request past ``slow-ms``
        (sampled or not), and — for propagated traces — returns the
        serialized span tree in the ``X-Pilosa-Trace-Spans`` response
        header so the coordinator grafts the peer's sub-spans.  With no
        tracer (embedders) this wrapper is a single branch.
        """
        tracer = self.tracer
        if tracer is None:
            out = self._dispatch_qos(method, path, params, body, headers, None)
            self._note_applied(headers, out)
            return self._with_group(out)
        trace = tracer.begin(headers, name=f"{method} {path}")
        if trace is not None and headers.get("x-pilosa-replay"):
            # Catch-up replays are router-originated re-deliveries, not
            # client traffic: tag the root so /debug/traces (and the
            # slow-query log) can split replay load from live load.
            trace.root.tags["replay"] = True
        t0 = time.perf_counter()
        try:
            out = self._dispatch_qos(
                method, path, params, body, headers, trace.root if trace else None
            )
        finally:
            if trace is not None:
                tracer.release(trace)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._note_applied(headers, out)
        # An UNSAMPLED request crossing slow-ms synthesizes a root-only
        # trace inside finish_request; hand it the QoS class + tenant
        # tags it never got from _dispatch_qos (computed only on the
        # slow path — the fast path stays one comparison).
        tags = None
        if trace is None and tracer.slow_ms > 0.0 and dt_ms >= tracer.slow_ms:
            tags = {"qos_class": qos.classify_request(method, path, body)}
            tenant, index = self._resolve_tenant(path, headers)
            if tenant:
                tags["tenant"] = tenant
            if index:
                tags["index"] = index
        extra = tracer.finish_request(
            trace, name=f"{method} {path}", dt_ms=dt_ms, body=body,
            status=out[0], tags=tags,
        )
        if extra:
            merged = dict(out[3]) if len(out) > 3 else {}
            merged.update(extra)
            out = (out[0], out[1], out[2], merged)
        return self._with_group(out)

    def _note_applied(self, headers: dict, out) -> None:
        """Advance the applied-sequence mark when this request carried
        the router's write sequence and answered deterministically.
        The whole response tuple rides in so the shared not-applied
        predicate sees a shed's Retry-After even on a <500 status."""
        if self.applied_seq is None:
            return
        from pilosa_tpu_torch.replica.catchup import note_applied_from_headers

        extra = out[3] if len(out) > 3 else {}
        note_applied_from_headers(self.applied_seq, headers, out[0],
                                  retry_after=extra.get("Retry-After"))

    def _with_group(self, out):
        """Stamp the serving group's identity (and its applied-sequence
        high-water mark — the router's passive lag tracking) on every
        response — per-read attribution plus the epoch-bump signal."""
        if not self.group:
            return out
        from pilosa_tpu_torch.replica import APPLIED_SEQ_HEADER, GROUP_HEADER

        merged = dict(out[3]) if len(out) > 3 else {}
        merged.setdefault(GROUP_HEADER, self.group)
        if self.applied_seq is not None:
            merged.setdefault(APPLIED_SEQ_HEADER, str(self.applied_seq.value))
        return (out[0], out[1], out[2], merged)

    def _dispatch_qos(self, method: str, path: str, params: dict, body: bytes,
                      headers: dict, span=None):
        """The QoS door wraps every route: the request's deadline is built
        once (header > configured default), the request is classified
        (read / write / admin) and admitted through the per-class
        bounded gate — a full door answers 429 + Retry-After
        immediately, an expired deadline answers 504 BEFORE the route
        executes, and per-class latency lands in the stats histograms
        that /debug/vars serves.
        """
        deadline = qos.deadline_from_headers(headers, self.default_deadline_ms)
        cls = qos.classify_request(method, path, body)
        tenant, index = self._resolve_tenant(path, headers)
        if span is not None:
            # QoS class + tenant tag (the shared tenancy.resolve seam):
            # every trace (and slow-query log line, which surfaces root
            # tags flat) attributes to its tenant.
            span.tags["qos_class"] = cls
            if tenant:
                span.tags["tenant"] = tenant
            if index:
                span.tags["index"] = index
        # Fair-share enforcement engages only with tenancy ON; off, the
        # door sees tenant=None and behaves byte-identically to today.
        door_tenant = tenant if self.tenancy is not None else None
        t0 = time.perf_counter()
        try:
            if self.admission is not None:
                asp = span.child("qos.admit") if span is not None else None
                with self.admission.admit(cls, deadline, tenant=door_tenant):
                    if asp is not None:
                        asp.finish()
                    if deadline is not None:
                        deadline.check("admission")
                    return self._dispatch_route(method, path, params, body, headers,
                                                deadline, span)
            if deadline is not None and deadline.expired():
                raise qos.DeadlineExceeded("admission")
            return self._dispatch_route(method, path, params, body, headers,
                                        deadline, span)
        except qos.ShedError as e:
            if span is not None:
                span.tags["qos"] = "shed"
            return (
                e.status,
                "application/json",
                json.dumps({"error": str(e)}).encode(),
                {"Retry-After": f"{e.retry_after:.3f}"},
            )
        except qos.DeadlineExceeded as e:
            if span is not None:
                span.tags["qos"] = "expired"
            if self.stats is not None:
                self.stats.count("qos.expired")
            return 504, "application/json", json.dumps({"error": str(e)}).encode()
        finally:
            if self.stats is not None:
                dt_ms = (time.perf_counter() - t0) * 1e3
                self.stats.histogram(f"qos.latency_ms.{cls}", dt_ms)
                if door_tenant is not None:
                    # Per-tenant latency rides next to the per-class
                    # series (the hostile-neighbor bench's probe).
                    self.stats.histogram(
                        f"tenancy.latency_ms.{door_tenant}", dt_ms
                    )

    def _resolve_tenant(self, path: str, headers):
        """(tenant, index-tag): the deduped tenant extraction.  With
        isolation OFF this reproduces the pre-tenancy tagging exactly —
        tenant = the index name on /index/ paths, nothing otherwise,
        and no separate index tag.  With isolation ON it resolves
        through tenancy.resolve (header > [tenancy] map > index name >
        "default") and tags the index separately so the cost ledger
        keeps both dimensions."""
        index = tenancy_mod.index_of(path)
        if self.tenancy is None:
            return (index or None), None
        return self.tenancy.resolve(path, headers), (index or None)

    def _dispatch_route(self, method: str, path: str, params: dict, body: bytes,
                        headers: dict, deadline=None, span=None):
        matched_path = False
        for m, pattern, fn in self._routes:
            match = pattern.match(path)
            if match is None:
                continue
            matched_path = True
            if m != method:
                continue
            try:
                return fn(params=params, body=body, headers=headers,
                          deadline=deadline, span=span, **match.groupdict())
            except (qos.ShedError, qos.DeadlineExceeded):
                raise  # QoS outcomes map to 429/504 in dispatch()
            except HTTPError as e:
                return e.status, "application/json", json.dumps({"error": e.message}).encode()
            except errors.ErrIndexNotFound as e:
                return 404, "application/json", json.dumps({"error": str(e)}).encode()
            except errors.ErrFrameNotFound as e:
                return 404, "application/json", json.dumps({"error": str(e)}).encode()
            except (errors.ErrIndexExists, errors.ErrFrameExists) as e:
                return 409, "application/json", json.dumps({"error": str(e)}).encode()
            except (PilosaError, pql.ParseError, ValueError, TypeError) as e:
                return 400, "application/json", json.dumps({"error": str(e)}).encode()
            except Exception as e:  # internal error
                traceback.print_exc()
                return 500, "application/json", json.dumps({"error": str(e)}).encode()
        if matched_path:
            return 405, "text/plain", b"method not allowed"
        return 404, "text/plain", b"not found"

    # -- helpers --------------------------------------------------------

    @staticmethod
    def _json(obj, status=200):
        return status, "application/json", (json.dumps(obj) + "\n").encode()

    @staticmethod
    def _wants_protobuf(headers) -> bool:
        return PROTOBUF in headers.get("accept", "")

    @staticmethod
    def _sends_protobuf(headers) -> bool:
        return PROTOBUF in headers.get("content-type", "")

    @staticmethod
    def _param(params, name, default=None):
        v = params.get(name)
        return v[0] if v else default

    def _frag(self, params):
        index = self._param(params, "index")
        frame = self._param(params, "frame")
        view = self._param(params, "view", VIEW_STANDARD)
        slice_i = int(self._param(params, "slice", 0))
        frag = self.holder.fragment(index, frame, view, slice_i)
        if frag is None:
            raise HTTPError(404, "fragment not found")
        return frag

    # -- root / misc -----------------------------------------------------

    # WebUI embed (reference: webui/ served via statik, handler.go:132-145).
    _WEBUI_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "webui")
    _WEBUI_TYPES = {".html": "text/html", ".js": "application/javascript", ".css": "text/css",
                    ".svg": "image/svg+xml", ".png": "image/png"}

    def get_root(self, headers=None, **kw):
        # Browsers get the console; API clients keep the plain-text banner.
        if headers and "text/html" in (headers.get("accept") or ""):
            try:
                return self._webui_file("index.html")
            except HTTPError:
                pass  # bundle missing: the banner is a safer answer than 404
        return (
            200,
            "text/plain",
            b"Welcome. pilosa-tpu is running. POST PQL to /index/{index}/query.\n",
        )

    def get_webui_asset(self, file=None, **kw):
        if not file or "/" in file or file.startswith("."):
            raise HTTPError(404, "not found")
        return self._webui_file(os.path.join("assets", file))

    def _webui_file(self, rel: str):
        path = os.path.join(self._WEBUI_DIR, rel)
        try:
            with open(path, "rb") as f:
                body = f.read()
        except OSError:
            raise HTTPError(404, "not found")
        ctype = self._WEBUI_TYPES.get(os.path.splitext(rel)[1], "application/octet-stream")
        return 200, ctype, body

    def get_version(self, **kw):
        return self._json({"version": self.version})

    def get_hosts(self, **kw):
        nodes = self.cluster.nodes if self.cluster else []
        return self._json([n.to_json() for n in nodes])

    def get_schema(self, **kw):
        return self._json({"indexes": self.holder.schema()})

    def get_status(self, **kw):
        status = {
            "host": self.host,
            "state": "UP",
            "cluster": self.cluster.status_json() if self.cluster else {"nodes": []},
            "indexes": self.holder.schema(),
        }
        return self._json({"status": status})

    def get_slices_max(self, params=None, headers=None, **kw):
        m = self.holder.max_slices()
        if headers and self._wants_protobuf(headers):
            return 200, PROTOBUF, wire.encode_max_slices_response(m)
        inverse = self._param(params or {}, "inverse") == "true"
        if inverse:
            m = self.holder.max_inverse_slices()
        return self._json({"maxSlices": m})

    def get_replica_health(self, **kw):
        """Replica-router health probe: a 200 here restores an
        unhealthy group in the router's table (the lockstep front end
        serves the same route, answering 503 while degraded).  The
        reported ``appliedSeq`` is the catch-up trigger: a live group
        behind the router's WAL head gets the missed suffix replayed
        before it rejoins the read rotation."""
        out = {"group": self.group, "state": "UP"}
        if self.applied_seq is not None:
            out["appliedSeq"] = self.applied_seq.value
        return self._json(out)

    def get_replica_digest(self, **kw):
        """The group's content digest (replica/digest.py): schema plus a
        per-(index, frame, view, slice) fragment-checksum tree — what
        the router's resync diff and the anti-entropy sweep compare.
        Pure function of (schema, logical bits), so two groups that
        applied the same writes answer byte-identically."""
        from pilosa_tpu_torch.replica.digest import holder_digest

        out = holder_digest(self.holder)
        if self.applied_seq is not None:
            out["appliedSeq"] = self.applied_seq.value
        return self._json(out)

    def post_replica_seed_seq(self, body=b"", **kw):
        """Resync handoff: adopt the donor's applied sequence after a
        fragment-level resync made this group's bytes match the donor's
        as of that sequence.  Monotonic (AppliedSeq.note never
        regresses), so a stray replayed seed is harmless."""
        try:
            seq = int((json.loads(body or b"{}") or {}).get("seq", 0))
        except (ValueError, TypeError):
            raise HTTPError(400, "bad seq")
        if seq <= 0:
            raise HTTPError(400, "seq must be positive")
        if self.applied_seq is None:
            raise HTTPError(409, "group has no applied-sequence tracking")
        self.applied_seq.note(seq)
        return self._json({"appliedSeq": self.applied_seq.value})

    def post_fragment_import_roaring(self, params=None, body=b"", **kw):
        """Receiving half of the resync fragment stream: replace one
        fragment wholesale from a serialized roaring payload, delivered
        in CRC-framed chunks so a killed transfer RESUMES instead of
        restarting.

        Protocol (query params): ``index/frame/view/slice`` name the
        fragment, ``total`` and ``crc`` (crc32 of the complete payload)
        identify the transfer, ``off`` is this chunk's byte offset.  A
        chunk whose ``off`` does not match the staged size answers 409
        with ``{"staged": n}`` so the sender resumes from ``n`` (an
        idempotent re-send of an already-staged chunk included);
        ``probe=1`` asks where the transfer stands without sending
        bytes.  A different (total, crc) for the same fragment restarts
        the transfer.  Once the staged bytes reach ``total`` and the
        CRC matches, the fragment (created along with its index, frame,
        and view when missing — the blank-group path) is replaced via
        ``read_from``, which bumps its generation so qcache entries and
        warm serve state invalidate exactly like any other write.
        ``total=0`` clears the fragment (the donor no longer holds it).
        Applying the same payload twice converges to the same bytes —
        the whole stream is idempotent."""
        params = params or {}
        index = self._param(params, "index")
        frame_name = self._param(params, "frame")
        view_name = self._param(params, "view", VIEW_STANDARD)
        slice_i = int(self._param(params, "slice", 0))
        off = int(self._param(params, "off", 0))
        total = int(self._param(params, "total", 0))
        crc = int(self._param(params, "crc", 0))
        probe = self._param(params, "probe") == "1"
        if not index or not frame_name:
            raise HTTPError(400, "index and frame required")
        if total < 0 or off < 0:
            raise HTTPError(400, "bad off/total")
        key = (index, frame_name, view_name, slice_i)
        with self._resync_mu:
            st = self._resync_staging.get(key)
            if st is not None and (st["total"] != total or st["crc"] != crc):
                # A different payload for this fragment: the previous
                # transfer is dead — restart.
                self._resync_staging.pop(key, None)
                st = None
            if probe:
                return self._json({"staged": len(st["buf"]) if st else 0})
            if st is None:
                if off != 0:
                    return self._json({"staged": 0}, status=409)
                st = {"total": total, "crc": crc, "buf": bytearray()}
                self._resync_staging[key] = st
            buf = st["buf"]
            if off != len(buf):
                return self._json({"staged": len(buf)}, status=409)
            buf += body
            if len(buf) > total:
                self._resync_staging.pop(key, None)
                raise HTTPError(409, "chunk overruns declared total")
            if len(buf) < total:
                return self._json({"staged": len(buf)})
            self._resync_staging.pop(key, None)
            data = bytes(buf)
        if zlib.crc32(data) != crc:
            raise HTTPError(409, "payload crc mismatch; transfer restarted")
        idx = self.holder.create_index_if_not_exists(index)
        frame = idx.create_frame_if_not_exists(frame_name)
        view = frame.create_view_if_not_exists(view_name)
        frag = view.create_fragment_if_not_exists(slice_i)
        if total == 0:
            # Clear: replace with an empty bitmap's serialized form.
            from pilosa_tpu_torch import roaring

            empty = io.BytesIO()
            roaring.Bitmap().write_to(empty)
            data = empty.getvalue()
        frag.read_from(data)
        if self.executor is not None:
            # Warm device state for the frame predates the restore.
            self.executor.drop_frame_state(index, frame_name)
        if self.stats is not None:
            self.stats.count("replica.fragment_restores")
        return self._json({"applied": True, "checksum": frag.checksum().hex()})

    def get_expvar(self, **kw):
        stats = {}
        if self.stats is not None and hasattr(self.stats, "snapshot"):
            self._publish_shard_gauge()
            # One consistent snapshot under one short lock hold (the
            # striped client drains every write shard in the same hold).
            stats = self.stats.snapshot()
        return self._json(stats)

    def _publish_shard_gauge(self) -> None:
        """Pull-model gauge: live stats write shards at scrape time."""
        shard_count = getattr(self.stats, "shard_count", None)
        if shard_count is not None:
            self.stats.gauge("stats.shards", float(shard_count()))

    def get_debug_traces(self, params=None, **kw):
        """Finished request traces, newest-first (bounded ring).
        ``?min-ms=`` filters by total duration, ``?limit=`` caps the
        page (default 64).  Malformed or out-of-range filter values
        clamp to their defaults instead of 400ing — a debug endpoint a
        dashboard polls must never fail on a mistyped filter."""
        if self.tracer is None:
            return self._json({"traces": []})
        params = params or {}
        from pilosa_tpu_torch import metrics as metrics_mod

        min_ms = metrics_mod.clamp_float(self._param(params, "min-ms"), 0.0)
        limit = metrics_mod.clamp_int(self._param(params, "limit"), 64, lo=0)
        return self._json(
            {"traces": self.tracer.traces_json(min_ms=min_ms, limit=limit)}
        )

    def get_debug_costs(self, params=None, **kw):
        """The per-fingerprint cost ledger (costs.CostLedger snapshot):
        EWMA cost/bandwidth per (index, frame, fingerprint, lane),
        highest cost first.  ``?limit=`` caps the page."""
        from pilosa_tpu_torch import metrics as metrics_mod

        limit = metrics_mod.clamp_int(
            self._param(params or {}, "limit"), 0, lo=0
        )
        if self.costs is None:
            return self._json({"cap": 0, "alpha": 0.0, "entries": []})
        return self._json(self.costs.snapshot(limit=limit))

    def get_debug_planner(self, params=None, **kw):
        """The planner's decision state (planner.Planner snapshot):
        per-(index, fingerprint) chosen lane, confidence, consult/decided
        counts, and win/loss tallies joined with the per-lane ledger
        estimates, most-consulted first.  ``?limit=`` caps the page."""
        from pilosa_tpu_torch import metrics as metrics_mod

        limit = metrics_mod.clamp_int(
            self._param(params or {}, "limit"), 0, lo=0
        )
        if self.planner is None:
            return self._json({"lanes": [], "keys": []})
        return self._json(self.planner.snapshot(limit=limit))

    def get_debug_tenants(self, **kw):
        """Per-tenant isolation state: fair-share door accounting
        (inflight / share / debt / admitted / shed per QoS class),
        qcache resident bytes + quota, ingest pacer buckets, and the
        cost-ledger billing aggregate.  ``enabled: false`` with no rows
        when isolation is off."""
        if self.tenancy is None:
            return self._json({"enabled": False, "tenants": {}})
        tenants: dict = {}
        if self.admission is not None:
            for t, row in self.admission.tenants_snapshot().items():
                tenants.setdefault(t, {}).update(row)
        qc = getattr(self.executor, "qcache", None)
        if qc is not None:
            for t, nbytes in qc.tenant_bytes_snapshot().items():
                row = tenants.setdefault(t, {})
                row["qcacheBytes"] = nbytes
                row["qcacheQuota"] = self.tenancy.qcache_quota(t, qc.max_bytes)
        if self.costs is not None:
            for t, agg in self.costs.by_tenant().items():
                tenants.setdefault(t, {})["ledger"] = agg
        if self.tenancy.pacer is not None:
            for t, row in self.tenancy.pacer.snapshot().items():
                tenants.setdefault(t, {})["ingest"] = row
        return self._json({
            "enabled": True,
            "defaultWeight": self.tenancy.default_weight,
            "tenants": tenants,
        })

    def get_metrics(self, **kw):
        """Prometheus text exposition of the whole stats registry
        (metrics.render): every counter/gauge/histogram the expvar
        client holds, names mapped mechanically from the COUNTERS.md
        registry (the stats-registry analysis rule gates the mapping)."""
        from pilosa_tpu_torch import metrics as metrics_mod
        from pilosa_tpu_torch.analysis import lockcheck

        if self.stats is not None:
            # Refresh the named-global gauges (parse memo & friends) at
            # scrape time — they are pull-model state, not event counters.
            lockcheck.publish_global_stats(self.stats)
            self._publish_shard_gauge()
        # render() reads one snapshot_typed() — the striped client
        # drains and renders under a single lock hold, so a scrape is
        # consistent against concurrent mutation by construction.
        text = metrics_mod.render(self.stats) if self.stats is not None else ""
        return 200, metrics_mod.CONTENT_TYPE, text.encode("utf-8")

    def get_pprof(self, path="", params=None, **kw):
        """/debug/pprof with net/http/pprof semantics (handler.go:99):
        the default payload is a gzipped pprof protobuf Profile that
        ``go tool pprof`` consumes; ``?debug=1`` returns the text form.

        Routes: /debug/pprof/goroutine (thread profile — one sample per
        live thread), /debug/pprof/profile?seconds=N (sampling CPU
        profile), bare /debug/pprof (thread profile)."""
        from pilosa_tpu_torch import pprof as pprof_mod

        params = params or {}
        kind = (path or "").rsplit("/", 1)[-1]
        if self._param(params, "debug"):
            return 200, "text/plain", pprof_mod.text_threads().encode()
        if kind == "profile":
            try:
                seconds = float(self._param(params, "seconds") or "5")
            except ValueError:
                raise HTTPError(400, "bad seconds")
            seconds = min(seconds, 120.0)
            body = pprof_mod.cpu_profile(seconds)
        else:  # goroutine analog (and the index default)
            body = pprof_mod.thread_profile()
        return 200, "application/octet-stream", body

    def post_profile_start(self, params=None, **kw):
        """Start a torch.profiler trace of the host and, when a card is
        present, the CUDA device (the device analog of the reference's
        CPU-profile flags, cmd/server.go:47-62).  On stop a Chrome trace
        lands in ``dir`` (default <data>/profiles).

        The profile runs on a thread of its own, started and stopped
        there: requests land on pool threads, and torch's profiler must
        not be started on one thread and stopped on another."""
        import torch

        trace_dir = self._param(params or {}, "dir") or os.path.join(
            self.holder.path, "profiles"
        )
        if self._profiling:
            raise HTTPError(409, "profile already running")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        path = os.path.join(
            trace_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
        )
        started, stop, errors = threading.Event(), threading.Event(), []

        def run():
            try:
                os.makedirs(trace_dir, exist_ok=True)
                with torch.profiler.profile(activities=activities) as prof:
                    started.set()
                    stop.wait()
                prof.export_chrome_trace(path)
            except Exception as e:  # reported by the start or stop request
                errors.append(e)
            finally:
                started.set()

        t = threading.Thread(target=run, name="pilosa-profiler", daemon=True)
        t.start()
        started.wait()
        if errors:
            t.join()
            raise HTTPError(500, f"profiler: {errors[0]}")
        self._profiling = (trace_dir, stop, t, errors)
        return self._json({"tracing": trace_dir})

    def post_profile_stop(self, **kw):
        if not self._profiling:
            raise HTTPError(409, "no profile running")
        (trace_dir, stop, t, errors), self._profiling = self._profiling, None
        stop.set()
        t.join()
        if errors:
            raise HTTPError(500, f"profiler: {errors[0]}")
        return self._json({"written": trace_dir})

    # -- index lifecycle --------------------------------------------------

    def get_indexes(self, **kw):
        return self._json({"indexes": self.holder.schema()})

    def get_index(self, index=None, **kw):
        idx = self.holder.index(index)
        if idx is None:
            raise errors.ErrIndexNotFound(index)
        return self._json({"index": idx.schema_json()})

    def post_index(self, index=None, body=b"", **kw):
        opts = {}
        if body:
            opts = (json.loads(body) or {}).get("options", {})
        self.holder.create_index(
            index,
            IndexOptions(
                column_label=opts.get("columnLabel", ""),
                time_quantum=opts.get("timeQuantum", ""),
            ),
        )
        if self.broadcaster is not None:
            self.broadcaster.create_index(index, opts)
        return self._json({})

    def delete_index(self, index=None, **kw):
        self.holder.delete_index(index)
        if self.executor is not None:
            # Reclaim warm device state eagerly (serve states, row pools,
            # Grams): validity tokens already prevent stale serving for a
            # recreated namesake, but the old state would otherwise pin
            # HBM until LRU churn evicts it.
            self.executor.drop_index_state(index)
        if self.broadcaster is not None:
            self.broadcaster.delete_index(index)
        return self._json({})

    def patch_index_time_quantum(self, index=None, body=b"", **kw):
        idx = self.holder.index(index)
        if idx is None:
            raise errors.ErrIndexNotFound(index)
        q = (json.loads(body) or {}).get("timeQuantum", "")
        idx.set_time_quantum(q)
        return self._json({})

    # -- frame lifecycle --------------------------------------------------

    def post_frame(self, index=None, frame=None, body=b"", **kw):
        idx = self.holder.index(index)
        if idx is None:
            raise errors.ErrIndexNotFound(index)
        opts = {}
        if body:
            opts = (json.loads(body) or {}).get("options", {})
        idx.create_frame(
            frame,
            FrameOptions(
                row_label=opts.get("rowLabel", ""),
                inverse_enabled=opts.get("inverseEnabled", False),
                cache_type=opts.get("cacheType", ""),
                cache_size=opts.get("cacheSize", 0),
                time_quantum=opts.get("timeQuantum", ""),
            ),
        )
        if self.broadcaster is not None:
            self.broadcaster.create_frame(index, frame, opts)
        return self._json({})

    def delete_frame(self, index=None, frame=None, **kw):
        idx = self.holder.index(index)
        if idx is None:
            raise errors.ErrIndexNotFound(index)
        idx.delete_frame(frame)
        if self.executor is not None:
            self.executor.drop_frame_state(index, frame)
        if self.broadcaster is not None:
            self.broadcaster.delete_frame(index, frame)
        return self._json({})

    def patch_frame_time_quantum(self, index=None, frame=None, body=b"", **kw):
        f = self.holder.frame(index, frame)
        if f is None:
            raise errors.ErrFrameNotFound(frame)
        q = (json.loads(body) or {}).get("timeQuantum", "")
        f.set_time_quantum(q)
        return self._json({})

    def get_frame_views(self, index=None, frame=None, **kw):
        f = self.holder.frame(index, frame)
        if f is None:
            raise errors.ErrFrameNotFound(frame)
        return self._json({"views": sorted(f.views.keys())})

    # -- query (handler.go:179-243) ----------------------------------------

    def post_query(self, index=None, params=None, body=b"", headers=None, deadline=None, span=None, **kw):
        headers = headers or {}
        params = params or {}
        if self._sends_protobuf(headers):
            req = wire.decode_query_request(body)
            query_str = req["query"]
            slices = req["slices"] or None
            column_attrs = req["column_attrs"]
            remote = req["remote"]
        else:
            query_str = body.decode()
            slices_param = self._param(params, "slices")
            slices = [int(s) for s in slices_param.split(",")] if slices_param else None
            column_attrs = self._param(params, "columnAttrs") == "true"
            remote = self._param(params, "remote") == "true"

        # Per-request qcache bypass (A/B measurement, stale-read
        # debugging): the request neither reads nor stores an entry.
        no_cache = (headers.get(qcache_mod.NO_CACHE_HEADER.lower(), "") or "").strip().lower() in (
            "1", "true", "yes"
        )
        opt = ExecOptions(remote=remote, deadline=deadline, no_cache=no_cache,
                          span=span)
        if self.planner is not None and not remote:
            # Front-door planner consultation (remote hops carry no plan:
            # the originating door already decided for the whole query).
            # Keyed on the decoded query text so protobuf and JSON
            # transports share one fingerprint.
            opt.plan = self.planner.plan_for(index, query_str.encode())
        try:
            results = self.executor.execute(index, query_str, slices=slices, opt=opt)
        except qos.DeadlineExceeded:
            raise  # 504, not the 400 a PilosaError would map to
        except (PilosaError, pql.ParseError) as e:
            if self._wants_protobuf(headers):
                return 400, PROTOBUF, wire.encode_query_response(err=str(e))
            return 400, "application/json", json.dumps({"error": str(e)}).encode()

        column_attr_sets = []
        if column_attrs:
            idx = self.holder.index(index)
            seen = set()
            for r in results:
                if isinstance(r, QueryBitmap):
                    for col in r.bits():
                        if col in seen:
                            continue
                        seen.add(col)
                        attrs = idx.column_attr_store.attrs(col)
                        if attrs:
                            column_attr_sets.append((col, attrs))

        if self._wants_protobuf(headers):
            return 200, PROTOBUF, wire.encode_query_response(
                results=results, column_attr_sets=column_attr_sets
            )
        out = {"results": [result_to_json(r) for r in results]}
        if column_attr_sets:
            out["columnAttrSets"] = [
                {"id": id, "attrs": attrs} for id, attrs in column_attr_sets
            ]
        return self._json(out)

    # -- streaming columnar ingest (the bulk-write front door) --------------

    def _ingest_apply(self, key, rows, cols, deadline):
        """One decoded chunk -> the batched set_bits path (+ executor
        dirty-row notes so warm serve state patches, not rebuilds)."""
        from pilosa_tpu_torch import ingest as ingest_mod

        index, fname = key
        frame = self.holder.frame(index, fname)
        if frame is None:
            # Deleted mid-transfer: deterministic 404 for this chunk.
            raise errors.ErrFrameNotFound(fname)
        return ingest_mod.apply_columnar(
            frame, rows, cols, executor=self.executor, index=index,
            deadline=deadline,
        )

    def _ingest_complete(self, key) -> None:
        """Import-parity hook: transfer done -> rank caches fresh NOW."""
        from pilosa_tpu_torch import ingest as ingest_mod

        index, fname = key
        frame = self.holder.frame(index, fname)
        if frame is not None:
            ingest_mod.recalc_frame_caches(frame)

    def _bulk_apply(self, key, rows, cols, deadline):
        """One decoded bulk chunk -> device build + overlay commit
        (pilosa_tpu_torch/bulk): the chunk's columns sort/segment/scatter into
        word planes on the executor's engine and land as pending dense
        overlays — no roaring container churn on the ingest path."""
        from pilosa_tpu_torch.bulk import ingress

        index, fname = key
        frame = self.holder.frame(index, fname)
        if frame is None:
            raise errors.ErrFrameNotFound(fname)
        engine = getattr(self.executor, "engine", None)
        return ingress.apply_bulk(
            frame, rows, cols, engine=engine, executor=self.executor,
            index=index, deadline=deadline,
            batch_slices=self.bulk_batch_slices, stats=self.stats,
        )

    def _bulk_complete(self, key) -> None:
        """Bulk transfer done: rankings fresh (import parity), then the
        opportunistic overlay drain under the configured budget."""
        from pilosa_tpu_torch.bulk import ingress

        index, fname = key
        frame = self.holder.frame(index, fname)
        if frame is not None:
            ingress.complete_bulk(frame, self.bulk_materialize_budget_ms)

    def post_frame_ingest(self, index=None, frame=None, params=None, body=b"",
                          headers=None, deadline=None, **kw):
        """Streaming columnar bulk ingest: ``(row, col)`` column chunks
        applied straight into the batched write path.

        Wire: each POST carries one chunk of a transfer identified by
        query params ``total`` (whole payload bytes) + ``crc`` (crc32
        of the whole payload); ``off`` is this chunk's byte offset and
        must equal the applied frontier (a re-send below it acks
        idempotently, a gap answers 409 + ``{"staged": n}`` so the
        sender resumes); ``ccrc`` is the chunk's own crc32, verified
        before any bit is touched; ``probe=1`` asks where the transfer
        stands.  Chunk payloads are packed-uint64 frames
        (``PI64 | u32 n | rows | cols``) or — with an Arrow content
        type and pyarrow importable — Arrow IPC record batches with
        uint64 ``row``/``col`` columns.  QoS classifies the route as a
        write, so each chunk passes the write-class admission door
        (ingest bursts backpressure instead of starving reads) and the
        replica router sequences + WAL-logs chunks like any other
        write — replay is idempotent.  On completion the frame's rank
        caches recalculate immediately (import parity)."""
        return self._stream_door(
            self._ingestor, index, frame, params, body, headers, deadline
        )

    def post_frame_bulk(self, index=None, frame=None, params=None, body=b"",
                        headers=None, deadline=None, **kw):
        """Device-first bulk build door: the SAME chunk/resume/CRC wire
        as ``POST .../ingest`` (probe, offsets, 409 + staged, per-chunk
        ccrc, PI64 or Arrow IPC payloads), but each chunk's columns run
        the engine's jitted sort/segment/scatter build and commit
        packed word planes as pending fragment overlays — roaring
        containers and rank caches materialize lazily on first
        snapshot/sync/digest touch, or under the
        ``[bulk] materialize-budget-ms`` drain at completion.  QoS
        classifies the route as a write; the replica router sequences
        and WAL-logs chunks like any other write (replay idempotent —
        the overlay OR converges)."""
        return self._stream_door(
            self._bulk_ingestor, index, frame, params, body, headers, deadline
        )

    def _stream_door(self, ingestor, index, frame, params, body, headers,
                     deadline):
        """Shared chunk-wire plumbing for the streamed and bulk doors:
        parse the transfer params, answer probes, push the chunk."""
        headers = headers or {}
        params = params or {}
        idx = self.holder.index(index)
        if idx is None:
            raise errors.ErrIndexNotFound(index)
        f = idx.frame(frame)
        if f is None:
            raise errors.ErrFrameNotFound(frame)
        try:
            off = int(self._param(params, "off", 0))
            total = int(self._param(params, "total", 0))
            crc = int(self._param(params, "crc", 0))
            ccrc_s = self._param(params, "ccrc")
            ccrc = int(ccrc_s) if ccrc_s is not None else None
        except (TypeError, ValueError):
            raise HTTPError(400, "bad off/total/crc/ccrc")
        from pilosa_tpu_torch import ingest as ingest_mod

        key = (index, frame)
        if self._param(params, "probe") == "1":
            return self._json(ingestor.probe(key, total, crc))
        # Per-tenant bandwidth pacing ([tenancy] ingest-bytes-per-s):
        # a chunk past the tenant's token-bucket share answers 429 +
        # Retry-After BEFORE it stages — a hostile backfill backs off
        # while other tenants' chunks keep clearing at their share.
        if (
            self.tenancy is not None
            and self.tenancy.pacer is not None
            and body
        ):
            tenant = self.tenancy.resolve_for_index(index, headers)
            wait = self.tenancy.pacer.admit(tenant, len(body))
            if wait > 0.0:
                if self.stats is not None:
                    self.stats.count(f"tenancy.ingest_shed.{tenant}")
                raise qos.ShedError(
                    f"tenant {tenant!r} over its ingest bandwidth share;"
                    f" retry after {wait:.3f}s",
                    retry_after=wait,
                )
            if self.stats is not None:
                self.stats.count(f"tenancy.ingest_bytes.{tenant}", len(body))
        arrow = "arrow" in (headers.get("content-type") or "")
        try:
            out = ingestor.chunk(
                key, off, total, crc, body, chunk_crc=ccrc, arrow=arrow,
                deadline=deadline,
            )
        except ingest_mod.IngestError as e:
            return self._json(
                {"error": str(e), "staged": e.staged}, status=e.status
            )
        return self._json(out)

    # -- import (handler.go:900-978) ---------------------------------------

    def post_import(self, body=b"", headers=None, **kw):
        req = wire.decode_import_request(body)
        index_name, frame_name = req["index"], req["frame"]
        slice_i = req["slice"]
        idx = self.holder.index(index_name)
        if idx is None:
            raise errors.ErrIndexNotFound(index_name)
        frame = idx.frame(frame_name)
        if frame is None:
            raise errors.ErrFrameNotFound(frame_name)
        # Reject imports for slices this node doesn't own (412, handler.go:936).
        if self.cluster is not None and self.host:
            if not self.cluster.owns_fragment(self.host, index_name, slice_i):
                raise HTTPError(412, f"host does not own slice {slice_i}")
        timestamps = [
            datetime.utcfromtimestamp(t) if t else None for t in req["timestamps"]
        ] or None
        frame.import_bits(req["rowIDs"], req["columnIDs"], timestamps)
        return self._json({})

    # -- export (handler.go:990-1030) --------------------------------------

    def get_export(self, params=None, headers=None, **kw):
        """Fragment contents as CSV (default) or, with ``format=arrow``,
        as an Arrow IPC stream of uint64 ``row``/``col`` columns — the
        exact schema the bulk/ingest doors accept, so an export can be
        re-ingested byte-identically.  Both formats read the fragment's
        merged dense view (``export_pairs``): a pending bulk overlay is
        visible without materializing roaring containers."""
        params = params or {}
        index = self._param(params, "index")
        frame = self._param(params, "frame")
        view = self._param(params, "view", VIEW_STANDARD)
        slice_i = int(self._param(params, "slice", 0))
        frag = self.holder.fragment(index, frame, view, slice_i)
        if frag is None:
            raise HTTPError(404, "fragment not found")
        fmt = self._param(params, "format", "csv")
        if fmt == "arrow":
            from pilosa_tpu_torch import ingest as ingest_mod
            from pilosa_tpu_torch.bulk import egress

            try:
                payload = egress.export_fragment_arrow(frag, stats=self.stats)
            except ingest_mod.IngestError as e:
                return self._json({"error": str(e)}, status=e.status)
            return 200, ingest_mod.ARROW_CONTENT_TYPE, payload
        if fmt != "csv":
            raise HTTPError(400, f"unknown export format {fmt!r}")
        out = io.StringIO()
        rows, cols = frag.export_pairs()
        for r, c in zip(rows.tolist(), cols.tolist()):
            out.write(f"{r},{c}\n")
        return 200, "text/csv", out.getvalue().encode()

    # -- fragment data / sync (handler.go:1053-1178) ------------------------

    def get_fragment_data(self, params=None, **kw):
        frag = self._frag(params or {})
        buf = io.BytesIO()
        frag.write_to(buf)
        return 200, "application/octet-stream", buf.getvalue()

    def post_fragment_data(self, params=None, body=b"", **kw):
        params = params or {}
        index = self._param(params, "index")
        frame_name = self._param(params, "frame")
        view_name = self._param(params, "view", VIEW_STANDARD)
        slice_i = int(self._param(params, "slice", 0))
        frame = self.holder.frame(index, frame_name)
        if frame is None:
            raise HTTPError(404, "frame not found")
        view = frame.create_view_if_not_exists(view_name)
        frag = view.create_fragment_if_not_exists(slice_i)
        frag.read_from(body)
        return self._json({})

    def get_fragment_blocks(self, params=None, **kw):
        frag = self._frag(params or {})
        return self._json(
            {"blocks": [{"id": bid, "checksum": chk.hex()} for bid, chk in frag.blocks()]}
        )

    def get_fragment_block_data(self, params=None, body=b"", headers=None, **kw):
        headers = headers or {}
        if body and self._sends_protobuf(headers):
            req = wire.decode_block_data_request(body)
            index, frame = req["index"], req["frame"]
            view, slice_i, block = req["view"], req["slice"], req["block"]
        else:
            params = params or {}
            index = self._param(params, "index")
            frame = self._param(params, "frame")
            view = self._param(params, "view", VIEW_STANDARD)
            slice_i = int(self._param(params, "slice", 0))
            block = int(self._param(params, "block", 0))
        frag = self.holder.fragment(index, frame, view, slice_i)
        if frag is None:
            raise HTTPError(404, "fragment not found")
        rows, cols = frag.block_data(block)
        payload = wire.encode_block_data_response(rows.tolist(), cols.tolist())
        return 200, PROTOBUF, payload

    def post_fragment_block_diff(self, params=None, body=b"", **kw):
        """Apply a sync diff directly to a fragment (any view) — the
        receiving half of the anti-entropy push."""
        frag = self._frag(params or {})
        set_rows, set_cols, clear_rows, clear_cols = wire.decode_block_diff(body)
        for r, c in zip(set_rows, set_cols):
            frag.set_bit(r, c)
        for r, c in zip(clear_rows, clear_cols):
            frag.clear_bit(r, c)
        return self._json({})

    def get_fragment_nodes(self, params=None, **kw):
        params = params or {}
        index = self._param(params, "index")
        slice_i = int(self._param(params, "slice", 0))
        if self.cluster is None:
            return self._json([{"host": self.host, "internalHost": "", "state": "UP"}])
        nodes = self.cluster.fragment_nodes(index, slice_i)
        return self._json([n.to_json() for n in nodes])

    # -- attr diff (handler.go:472-518, 735-782) -----------------------------

    def post_index_attr_diff(self, index=None, body=b"", **kw):
        idx = self.holder.index(index)
        if idx is None:
            raise errors.ErrIndexNotFound(index)
        return self._attr_diff(idx.column_attr_store, body)

    def post_frame_attr_diff(self, index=None, frame=None, body=b"", **kw):
        f = self.holder.frame(index, frame)
        if f is None:
            raise errors.ErrFrameNotFound(frame)
        return self._attr_diff(f.row_attr_store, body)

    def _attr_diff(self, store, body: bytes):
        # Requester posts its block checksums; we reply with our attrs for
        # every block where our data differs (or they lack the block), and
        # the requester merges what it's missing (attr.go:394-428).
        req = json.loads(body or b"{}")
        remote = {b["id"]: bytes.fromhex(b["checksum"]) for b in req.get("blocks", [])}
        ids = [bid for bid, chk in store.blocks() if remote.get(bid) != chk]
        attrs = {}
        for bid in sorted(ids):
            for id, a in store.block_data(bid).items():
                attrs[str(id)] = a
        return self._json({"attrs": attrs})

    # -- frame restore (handler.go:1184-1271) --------------------------------

    def post_frame_restore(self, index=None, frame=None, params=None, **kw):
        params = params or {}
        src_host = self._param(params, "host")
        if not src_host:
            raise HTTPError(400, "host required")
        if self.client_factory is None:
            raise HTTPError(500, "no client factory configured")
        client = self.client_factory(src_host)
        f = self.holder.frame(index, frame)
        if f is None:
            raise errors.ErrFrameNotFound(frame)
        max_slices = client.max_slices()
        max_slice = max_slices.get(index, 0)
        for view_name in client.frame_views(index, frame):
            view = f.create_view_if_not_exists(view_name)
            for slice_i in range(max_slice + 1):
                data = client.fragment_data(index, frame, view_name, slice_i)
                if data is None:
                    continue
                frag = view.create_fragment_if_not_exists(slice_i)
                frag.read_from(data)
        return self._json({})


class _HTTPRequestHandler(BaseHTTPRequestHandler):
    handler: Handler = None  # set by serve()
    protocol_version = "HTTP/1.1"

    def _run(self, method: str):
        parsed = urlparse(self.path)
        params = parse_qs(parsed.query)
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        headers = {k.lower(): v for k, v in self.headers.items()}
        out = self.handler.dispatch(method, parsed.path, params, body, headers)
        status, ctype, payload = out[:3]
        extra = out[3] if len(out) > 3 else {}
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in extra.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        self._run("GET")

    def do_POST(self):
        self._run("POST")

    def do_DELETE(self):
        self._run("DELETE")

    def do_PATCH(self):
        self._run("PATCH")

    def log_message(self, fmt, *args):  # quiet by default
        pass


# Default connection-worker pool size: enough for every in-tree client
# rig (benches cap at 16 client threads) with headroom for keep-alive
# connections that pin a worker between requests.
DEFAULT_MAX_THREADS = 32

_POOL_STOP = object()


class PooledHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a BOUNDED connection worker pool.

    Accepted connections are queued to ``max_threads`` pre-spawned
    workers instead of spawning one thread per connection; a full queue
    waits ``overflow_wait_s`` then sheds the connection with a raw
    503 + Retry-After (the same contract the QoS door gives an admitted
    request, issued before a worker is ever consumed, so clients retry
    through the normal budget).  ``reuse_port=True`` sets SO_REUSEPORT
    before bind — the multi-process worker mode on GIL builds runs N
    such servers on one port and lets the kernel spread accepts.
    """

    def __init__(self, addr, cls, max_threads: int = DEFAULT_MAX_THREADS,
                 overflow_wait_s: float = 0.05, retry_after_s: float = 0.25,
                 reuse_port: bool = False, stats=None):
        self._reuse_port = reuse_port
        self.pool_stats = stats
        self._overflow_wait_s = overflow_wait_s
        self._retry_after = max(1, int(retry_after_s + 0.999))
        self._max_threads = max(1, int(max_threads))
        self._conn_q: "queue.Queue" = queue.Queue(maxsize=self._max_threads * 2)
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"http-pool-{i}")
            for i in range(self._max_threads)
        ]
        super().__init__(addr, cls)
        for t in self._workers:
            t.start()
        stats = self.pool_stats
        if stats is not None:
            stats.gauge("server.pool.workers", float(self._max_threads))

    def server_bind(self):
        if self._reuse_port:
            if not hasattr(socket, "SO_REUSEPORT"):
                raise OSError("SO_REUSEPORT unsupported on this platform")
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()

    def _worker(self) -> None:
        while True:
            item = self._conn_q.get()
            if item is _POOL_STOP:
                return
            request, client_address = item
            # The mixin's per-connection body: finish_request +
            # handle_error + shutdown_request, minus the thread spawn.
            self.process_request_thread(request, client_address)

    def process_request(self, request, client_address):
        try:
            self._conn_q.put((request, client_address),
                             timeout=self._overflow_wait_s)
        except queue.Full:
            self._shed(request)

    def _shed(self, request) -> None:
        stats = self.pool_stats
        if stats is not None:
            stats.count("server.pool.shed")
            stats.gauge("server.pool.queue_depth", float(self._conn_q.qsize()))
        try:
            request.sendall(
                (
                    "HTTP/1.1 503 Service Unavailable\r\n"
                    f"Retry-After: {self._retry_after}\r\n"
                    "Content-Length: 0\r\nConnection: close\r\n\r\n"
                ).encode()
            )
        except OSError:
            pass
        self.shutdown_request(request)

    def server_close(self):
        super().server_close()
        # Unblock every worker, then close any connection still queued.
        for _ in self._workers:
            self._conn_q.put(_POOL_STOP)
        while True:
            try:
                item = self._conn_q.get_nowait()
            except queue.Empty:
                break
            if item is not _POOL_STOP:
                self.shutdown_request(item[0])


def serve(handler: Handler, host: str = "127.0.0.1", port: int = 0,
          max_threads: int = DEFAULT_MAX_THREADS, reuse_port: bool = False,
          retry_after_s: float = 0.25) -> ThreadingHTTPServer:
    """Start an HTTP server for the handler; returns the (running) server.

    ``max_threads`` bounds the connection worker pool (0 = the legacy
    unbounded thread-per-connection server).
    """
    cls = type("BoundHandler", (_HTTPRequestHandler,), {"handler": handler})
    if max_threads and max_threads > 0:
        httpd: ThreadingHTTPServer = PooledHTTPServer(
            (host, port), cls, max_threads=max_threads,
            retry_after_s=retry_after_s, reuse_port=reuse_port,
            stats=getattr(handler, "stats", None),
        )
    else:
        httpd = ThreadingHTTPServer((host, port), cls)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd
