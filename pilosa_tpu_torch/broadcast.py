"""Cluster broadcast: typed schema-mutation messages + transports.

Reference analog: broadcast.go (envelope: 1-byte type prefix + protobuf,
broadcast.go:110-166), httpbroadcast/ (HTTP POST to every node's internal
host), gossip/ (memberlist).  This build ships:

- the same typed envelope (type bytes 1-5, wire-compatible payloads),
- ``StaticNodeSet`` — fixed host list, no messaging (cluster type
  "static"),
- ``HTTPBroadcaster``/``HTTPBroadcastReceiver`` — sync fan-out over the
  internal HTTP port (cluster type "http").

The SWIM gossip transport (cluster type "gossip") lives in
``pilosa_tpu_torch.gossip.GossipNodeSet``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from pilosa_tpu_torch import wire
from pilosa_tpu_torch.wire import Writer, iter_fields

MESSAGE_TYPE_CREATE_SLICE = 1
MESSAGE_TYPE_CREATE_INDEX = 2
MESSAGE_TYPE_DELETE_INDEX = 3
MESSAGE_TYPE_CREATE_FRAME = 4
MESSAGE_TYPE_DELETE_FRAME = 5


# -- message payloads (private.proto) ---------------------------------------

def encode_create_slice(index: str, slice_i: int, is_inverse: bool = False) -> bytes:
    body = Writer().string(1, index).varint(2, slice_i).bool(3, is_inverse).finish()
    return bytes([MESSAGE_TYPE_CREATE_SLICE]) + body


def encode_create_index(index: str, column_label: str = "", time_quantum: str = "") -> bytes:
    meta = wire.encode_index_meta(column_label, time_quantum)
    body = Writer().string(1, index).message(2, meta).finish()
    return bytes([MESSAGE_TYPE_CREATE_INDEX]) + body


def encode_delete_index(index: str) -> bytes:
    return bytes([MESSAGE_TYPE_DELETE_INDEX]) + Writer().string(1, index).finish()


def encode_create_frame(index: str, frame: str, meta: dict) -> bytes:
    meta_raw = wire.encode_frame_meta(
        meta.get("rowLabel", ""),
        meta.get("inverseEnabled", False),
        meta.get("cacheType", ""),
        meta.get("cacheSize", 0),
        meta.get("timeQuantum", ""),
    )
    body = Writer().string(1, index).string(2, frame).message(3, meta_raw).finish()
    return bytes([MESSAGE_TYPE_CREATE_FRAME]) + body


def encode_delete_frame(index: str, frame: str) -> bytes:
    return bytes([MESSAGE_TYPE_DELETE_FRAME]) + Writer().string(1, index).string(2, frame).finish()


def decode_message(data: bytes) -> tuple[int, dict]:
    """(type, payload dict) — raises on unknown types (broadcast.go:142-166)."""
    if not data:
        raise ValueError("empty broadcast message")
    typ, body = data[0], data[1:]
    out: dict = {}
    if typ == MESSAGE_TYPE_CREATE_SLICE:
        for f, w, v in iter_fields(body):
            if f == 1:
                out["index"] = v.decode()
            elif f == 2:
                out["slice"] = v
            elif f == 3:
                out["isInverse"] = bool(v)
    elif typ in (MESSAGE_TYPE_CREATE_INDEX, MESSAGE_TYPE_DELETE_INDEX):
        for f, w, v in iter_fields(body):
            if f == 1:
                out["index"] = v.decode()
            elif f == 2 and typ == MESSAGE_TYPE_CREATE_INDEX:
                out["meta"] = wire.decode_index_meta(v)
    elif typ in (MESSAGE_TYPE_CREATE_FRAME, MESSAGE_TYPE_DELETE_FRAME):
        for f, w, v in iter_fields(body):
            if f == 1:
                out["index"] = v.decode()
            elif f == 2:
                out["frame"] = v.decode()
            elif f == 3 and typ == MESSAGE_TYPE_CREATE_FRAME:
                out["meta"] = wire.decode_frame_meta(v)
    else:
        raise ValueError(f"invalid message type: {typ}")
    return typ, out


# -- transports -------------------------------------------------------------


class NopBroadcaster:
    """broadcast.go NopBroadcaster."""

    def send_sync(self, msg: bytes) -> None:
        pass

    def send_async(self, msg: bytes) -> None:
        pass


class StaticNodeSet:
    """Fixed membership, no messaging (server/server.go 'static' type)."""

    def __init__(self, hosts: list[str]):
        self._hosts = list(hosts)

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def nodes(self) -> list[str]:
        return list(self._hosts)


class HTTPBroadcaster:
    """POST the envelope to every peer's internal endpoint
    (httpbroadcast/messenger.go:45-121)."""

    def __init__(self, internal_hosts: list[str], self_host: str = "",
                 timeout: float = 10.0, stats=None):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.internal_hosts = list(internal_hosts)
        self.self_host = self_host
        self.timeout = timeout
        self.stats = stats if stats is not None else NOP_STATS
        self.stat_send_errors = 0

    def send_sync(self, msg: bytes) -> None:
        import urllib.request

        errs = []
        for host in self.internal_hosts:
            if host == self.self_host:
                continue
            url = host if "://" in host else f"http://{host}"
            req = urllib.request.Request(
                url + "/message", data=msg, method="POST",
                headers={"Content-Type": "application/octet-stream"},
            )
            try:
                urllib.request.urlopen(req, timeout=self.timeout).read()
            except Exception as e:
                errs.append(e)
        if errs:
            raise errs[0]

    def send_async(self, msg: bytes) -> None:
        threading.Thread(target=lambda: self._quiet_sync(msg), daemon=True).start()

    def _quiet_sync(self, msg: bytes) -> None:
        try:
            self.send_sync(msg)
        except Exception:
            # Async delivery is best-effort by contract; the drop is
            # counted so a steadily failing peer shows on a dashboard.
            self.stat_send_errors += 1
            self.stats.count("broadcast.send_errors")


class HTTPBroadcastReceiver:
    """Internal-port listener feeding a handler's receive_message
    (httpbroadcast/messenger.go:139-174)."""

    def __init__(self, port: int, handler: Optional[Callable[[bytes], None]] = None):
        self.port = port
        self.handler = handler
        self._server = None

    def start(self, handler: Callable[[bytes], None]) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        receiver = self

        class _MsgHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length)
                try:
                    handler(body)
                    code, payload = 200, b"{}"
                except Exception as e:
                    # error returns to the sender as the HTTP answer
                    code, payload = 400, str(e).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, fmt, *args):
                pass

        self._server = ThreadingHTTPServer(("", self.port), _MsgHandler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None


class SchemaBroadcaster:
    """High-level schema mutation broadcaster used by the HTTP handler.

    Wraps a transport broadcaster; called on local schema changes so peers
    apply the same mutation (server.go:259-304 ReceiveMessage loop is the
    other half, in pilosa_tpu_torch.server.server).
    """

    def __init__(self, transport):
        self.transport = transport

    def create_index(self, index: str, options: dict) -> None:
        self.transport.send_sync(
            encode_create_index(index, options.get("columnLabel", ""), options.get("timeQuantum", ""))
        )

    def delete_index(self, index: str) -> None:
        self.transport.send_sync(encode_delete_index(index))

    def create_frame(self, index: str, frame: str, options: dict) -> None:
        self.transport.send_sync(encode_create_frame(index, frame, options))

    def delete_frame(self, index: str, frame: str) -> None:
        self.transport.send_sync(encode_delete_frame(index, frame))

    def create_slice(self, index: str, slice_i: int, is_inverse: bool = False) -> None:
        self.transport.send_async(encode_create_slice(index, slice_i, is_inverse))
