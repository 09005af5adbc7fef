"""SWIM-style gossip membership + broadcast transport.

Reference analog: gossip/gossip.go — ``GossipNodeSet`` wraps
hashicorp/memberlist and implements three interfaces at once: NodeSet
(membership, gossip.go:47-54), Broadcaster (SendSync = direct TCP to every
member gossip.go:124-149, SendAsync = TransmitLimitedQueue gossip
gossip.go:152-164), and memberlist.Delegate (NotifyMsg → BroadcastHandler,
LocalState/MergeRemoteState → StatusHandler, gossip.go:166-222).

This build implements the same contract natively instead of embedding a
library, with the SWIM mechanics memberlist is built on:

- **Failure detection**: periodic UDP probe of a random member; a missed
  ack marks it SUSPECT, a suspicion timeout marks it DEAD.  A suspected
  node that hears its own suspicion refutes it by re-broadcasting itself
  ALIVE with a higher incarnation number.
- **Dissemination**: membership updates and user broadcasts piggyback on
  probe/ack packets, each retransmitted ``retransmit_mult * log2(n+1)``
  times (memberlist's TransmitLimitedQueue discipline).
- **Anti-entropy**: periodic TCP push/pull exchanges the full member list
  plus the application status blob (LocalState/MergeRemoteState — the
  server's schema/maxslice sync hook, server.go:310-391).
- **Join**: TCP push/pull against the seed host (gossip.go:70-76).

Everything is plain sockets + threads; payloads use the same typed
broadcast envelope as the HTTP transport (broadcast.py).
"""

from __future__ import annotations

import json
import math
import random
import socket
import socketserver
import struct
import threading

from pilosa_tpu_torch.analysis import lockcheck
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

# Member states (cluster.go:33-36 NodeState UP/DOWN + SWIM's suspect).
STATE_ALIVE = "alive"
STATE_SUSPECT = "suspect"
STATE_DEAD = "dead"

# UDP frame types.
_PING = 1
_ACK = 2
# TCP frame types.
_USER_MSG = 3
_PUSH_PULL = 4

# Piggyback item kinds.
_PB_MEMBER = 0
_PB_USER = 1

_MAX_UDP = 1350  # stay under typical MTU like memberlist does


@dataclass
class Member:
    name: str  # the node's API host:port — what NodeSet.Nodes() reports
    addr: str  # gossip bind host:port (UDP+TCP)
    incarnation: int = 0
    state: str = STATE_ALIVE
    state_change: float = field(default_factory=time.monotonic)

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "addr": self.addr,
            "inc": self.incarnation,
            "state": self.state,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Member":
        return cls(
            name=d["name"], addr=d["addr"], incarnation=d.get("inc", 0),
            state=d.get("state", STATE_ALIVE),
        )


class _LimitedBroadcast:
    """One queued item with a remaining-transmit budget
    (memberlist TransmitLimitedQueue element)."""

    __slots__ = ("payload", "kind", "remaining")

    def __init__(self, kind: int, payload: bytes, remaining: int):
        self.kind = kind
        self.payload = payload
        self.remaining = remaining


def _pack_piggyback(items: list[tuple[int, bytes]]) -> bytes:
    out = [struct.pack("<H", len(items))]
    for kind, body in items:
        out.append(struct.pack("<BI", kind, len(body)))
        out.append(body)
    return b"".join(out)


def _unpack_piggyback(buf: bytes) -> list[tuple[int, bytes]]:
    if len(buf) < 2:
        return []
    (n,) = struct.unpack_from("<H", buf, 0)
    off = 2
    items = []
    for _ in range(n):
        kind, ln = struct.unpack_from("<BI", buf, off)
        off += 5
        items.append((kind, buf[off : off + ln]))
        off += ln
    return items


def _split_addr(addr: str) -> tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host or "127.0.0.1", int(port)


class GossipNodeSet:
    """NodeSet + Broadcaster + failure detector (gossip/gossip.go analog).

    Lifecycle: ``start(handler)`` registers the broadcast handler
    (BroadcastReceiver.Start, gossip.go:57-60), ``open()`` binds sockets,
    joins the seed, and starts the probe / push-pull loops
    (gossip.go:63-86).  For server integration ``start`` may be called
    with the handler and ``open`` afterwards, mirroring the reference's
    ordering requirement.
    """

    def __init__(
        self,
        name: str,
        bind: str = "127.0.0.1:0",
        seed: str = "",
        status_handler=None,
        probe_interval: float = 0.25,
        probe_timeout: float = 0.5,
        suspect_timeout: float = 1.5,
        push_pull_interval: float = 2.0,
        retransmit_mult: int = 3,
        stats=None,
    ):
        from pilosa_tpu_torch.stats import NOP_STATS

        self.name = name
        self.bind = bind
        self.seed = seed
        self.status_handler = status_handler
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.suspect_timeout = suspect_timeout
        self.push_pull_interval = push_pull_interval
        self.retransmit_mult = retransmit_mult
        self.stats = stats if stats is not None else NOP_STATS
        # Process-lifetime total of swallowed errors (tests, embedders
        # without an expvar sink); tagged counters live in the client.
        self.stat_swallowed = 0

        self.handler: Optional[Callable[[bytes], None]] = None
        self._lock = lockcheck.named_rlock("gossip._lock")
        self._members: dict[str, Member] = {}
        self._incarnation = 0
        self._queue: list[_LimitedBroadcast] = []
        self._acks: dict[int, threading.Event] = {}
        self._seq = 0
        self._udp: Optional[socket.socket] = None
        self._tcp: Optional[socketserver.ThreadingTCPServer] = None
        self._closing = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- BroadcastReceiver ------------------------------------------------

    def start(self, handler: Callable[[bytes], None]) -> None:
        self.handler = handler

    # -- lifecycle --------------------------------------------------------

    def open(self) -> None:
        if self.handler is None:
            raise RuntimeError(
                "opening GossipNodeSet: call start(handler) before open()"
            )  # gossip.go:64-66
        host, cfg_port = _split_addr(self.bind)

        nodeset = self

        class _TCPHandler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    hdr = self.rfile.read(5)
                    if len(hdr) < 5:
                        return
                    typ, ln = struct.unpack("<BI", hdr)
                    body = self.rfile.read(ln)
                    resp = nodeset._handle_tcp(typ, body)
                    if resp is not None:
                        self.wfile.write(struct.pack("<BI", _PUSH_PULL, len(resp)) + resp)
                except Exception:
                    # A malformed or torn inbound frame must not kill the
                    # accept loop, but it is never silent.
                    nodeset._note_swallowed("tcp_handler")

        # Gossip needs the SAME port on UDP and TCP (memberlist does too).
        # With an ephemeral bind (":0") the kernel-chosen UDP port may be
        # held by another process on TCP — rebind the pair until both work.
        socketserver.ThreadingTCPServer.allow_reuse_address = True
        last_err: Optional[OSError] = None
        for _ in range(16):
            self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._udp.bind((host, cfg_port))
            port = self._udp.getsockname()[1]
            try:
                self._tcp = socketserver.ThreadingTCPServer((host, port), _TCPHandler)
                last_err = None
                break
            except OSError as e:
                last_err = e
                self._udp.close()
                if cfg_port != 0:
                    break  # explicit port: caller asked for exactly this one
        if last_err is not None:
            raise last_err
        self.addr = f"{host}:{port}"
        self.bind = self.addr

        with self._lock:
            self._members[self.name] = Member(
                name=self.name, addr=self.addr, incarnation=self._incarnation
            )

        for target in (self._udp_loop, self._tcp.serve_forever, self._probe_loop, self._push_pull_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

        if self.seed and self.seed != self.addr:
            # Join: full state exchange with the seed (gossip.go:70-76).
            # Briefly retried — a seed that is itself just starting may
            # refuse the first connection (memberlist retries joins too).
            last: Optional[OSError] = None
            for attempt in range(3):
                try:
                    self._push_pull(self.seed)
                    last = None
                    break
                except OSError as e:
                    last = e
                    if attempt < 2:
                        time.sleep(0.2)
            if last is not None:
                raise ConnectionError(f"gossip join to seed {self.seed}: {last}") from last

    def close(self) -> None:
        self._closing.set()
        if self._tcp is not None:
            self._tcp.shutdown()
            self._tcp.server_close()
            self._tcp = None
        if self._udp is not None:
            self._udp.close()
            self._udp = None

    # -- NodeSet ----------------------------------------------------------

    def nodes(self) -> list[str]:
        """Live member names (gossip.go:47-54 — DEAD members drop out)."""
        with self._lock:
            return sorted(
                m.name for m in self._members.values() if m.state != STATE_DEAD
            )

    def member_states(self) -> dict[str, str]:
        """name → alive/suspect/dead, for /status reporting (cluster.go:33-36)."""
        with self._lock:
            return {m.name: m.state for m in self._members.values()}

    # -- Broadcaster ------------------------------------------------------

    def send_sync(self, msg: bytes) -> None:
        """Direct TCP to every live member; any failure raises
        (gossip.go:124-149)."""
        with self._lock:
            targets = [
                m for m in self._members.values()
                if m.name != self.name and m.state != STATE_DEAD
            ]
        errs: list[Exception] = []
        threads = []

        def _send(member: Member):
            try:
                self._tcp_send(member.addr, _USER_MSG, msg)
            except Exception as e:  # collected, first one re-raised
                errs.append(e)

        for m in targets:
            t = threading.Thread(target=_send, args=(m,))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=10.0)
        if errs:
            raise errs[0]

    def send_async(self, msg: bytes) -> None:
        """Queue for piggybacked gossip delivery (gossip.go:152-164).

        Messages too large for a UDP probe's piggyback budget would sit in
        the queue forever; they take the TCP direct path instead (errors
        ignored — async delivery is best-effort).
        """
        if 5 + len(msg) > _MAX_UDP - 200:
            threading.Thread(target=self._quiet_sync, args=(msg,), daemon=True).start()
            return
        self._queue_broadcast(_PB_USER, msg)

    def _note_swallowed(self, where: str) -> None:
        """One intentionally-swallowed error on a best-effort path:
        visible at /debug/vars instead of vanishing."""
        self.stat_swallowed += 1
        self.stats.count(f"gossip.swallowed.{where}")

    def _quiet_sync(self, msg: bytes) -> None:
        try:
            self.send_sync(msg)
        except Exception:
            self._note_swallowed("async_send")

    # -- internals: queue + piggyback -------------------------------------

    def _retransmit_limit(self) -> int:
        with self._lock:
            n = len(self._members)
        return self.retransmit_mult * max(1, math.ceil(math.log2(n + 1)))

    def _queue_broadcast(self, kind: int, payload: bytes) -> None:
        with self._lock:
            self._queue.append(_LimitedBroadcast(kind, payload, self._retransmit_limit()))

    def _get_broadcasts(self, limit: int) -> list[tuple[int, bytes]]:
        """Drain up to ``limit`` bytes of queued items, decrementing their
        budgets (TransmitLimitedQueue.GetBroadcasts)."""
        out: list[tuple[int, bytes]] = []
        used = 0
        with self._lock:
            for lb in list(self._queue):
                cost = 5 + len(lb.payload)
                if cost > _MAX_UDP - 200:
                    # Can never fit any packet's budget — drop instead of
                    # rescanning a dead entry forever.
                    self._queue.remove(lb)
                    continue
                if used + cost > limit:
                    continue
                out.append((lb.kind, lb.payload))
                used += cost
                lb.remaining -= 1
                if lb.remaining <= 0:
                    self._queue.remove(lb)
        return out

    def _broadcast_member(self, m: Member) -> None:
        self._queue_broadcast(_PB_MEMBER, json.dumps(m.to_wire()).encode())

    # -- internals: membership table --------------------------------------

    def _merge_member(self, update: Member) -> None:
        """SWIM update rules: higher incarnation wins; alive refutes suspect
        only with a strictly newer incarnation; self-suspicion triggers
        refutation."""
        requeue = False
        with self._lock:
            if update.name == self.name:
                if update.state in (STATE_SUSPECT, STATE_DEAD) and update.incarnation >= self._incarnation:
                    # Refute: bump incarnation, re-announce ALIVE.
                    self._incarnation = update.incarnation + 1
                    me = self._members[self.name]
                    me.incarnation = self._incarnation
                    me.state = STATE_ALIVE
                    self._broadcast_member(me)
                return
            cur = self._members.get(update.name)
            if cur is None:
                self._members[update.name] = Member(
                    name=update.name, addr=update.addr,
                    incarnation=update.incarnation, state=update.state,
                )
                requeue = True
            else:
                newer = update.incarnation > cur.incarnation
                same = update.incarnation == cur.incarnation
                worse = (
                    (cur.state == STATE_ALIVE and update.state in (STATE_SUSPECT, STATE_DEAD))
                    or (cur.state == STATE_SUSPECT and update.state == STATE_DEAD)
                )
                if newer or (same and worse):
                    cur.incarnation = update.incarnation
                    cur.state = update.state
                    cur.addr = update.addr
                    cur.state_change = time.monotonic()
                    requeue = True
        if requeue:
            self._broadcast_member(self._members[update.name])

    def _mark(self, name: str, state: str) -> None:
        with self._lock:
            m = self._members.get(name)
            if m is None or m.state == state:
                return
            m.state = state
            m.state_change = time.monotonic()
        self._broadcast_member(m)

    # -- internals: UDP probe path ----------------------------------------

    def _udp_loop(self) -> None:
        while not self._closing.is_set():
            sock = self._udp
            if sock is None:
                return
            try:
                data, src = sock.recvfrom(65536)
            except OSError:
                # Transient errors (e.g. ICMP port-unreachable surfacing as
                # ConnectionResetError) must not kill failure detection;
                # only exit once close() is underway.
                if self._closing.is_set() or self._udp is None:
                    return
                continue
            try:
                self._handle_udp(data, src)
            except Exception:
                self._note_swallowed("udp_handler")

    def _handle_udp(self, data: bytes, src) -> None:
        if len(data) < 5:
            return
        typ, seq = struct.unpack_from("<BI", data, 0)
        payload = data[5:]
        if typ == _PING:
            nlen = struct.unpack_from("<H", payload, 0)[0]
            piggy = payload[2 + nlen :]
            self._consume_piggyback(piggy)
            ack = struct.pack("<BI", _ACK, seq) + _pack_piggyback(
                self._get_broadcasts(_MAX_UDP - 5)
            )
            try:
                self._udp.sendto(ack, src)
            except OSError:
                pass
        elif typ == _ACK:
            self._consume_piggyback(payload)
            ev = self._acks.pop(seq, None)
            if ev is not None:
                ev.set()

    def _consume_piggyback(self, buf: bytes) -> None:
        for kind, body in _unpack_piggyback(buf):
            if kind == _PB_MEMBER:
                try:
                    self._merge_member(Member.from_wire(json.loads(body)))
                except (ValueError, KeyError):
                    pass
            elif kind == _PB_USER and self.handler is not None:
                try:
                    self.handler(body)
                except Exception:
                    self._note_swallowed("user_handler")

    def _probe_loop(self) -> None:
        while not self._closing.wait(self.probe_interval):
            with self._lock:
                candidates = [
                    m for m in self._members.values()
                    if m.name != self.name and m.state != STATE_DEAD
                ]
                suspects = [
                    (m.name, m.state_change) for m in self._members.values()
                    if m.state == STATE_SUSPECT
                ]
            now = time.monotonic()
            for name, since in suspects:
                if now - since > self.suspect_timeout:
                    self._mark(name, STATE_DEAD)
            if not candidates:
                continue
            target = random.choice(candidates)
            if not self._probe(target):
                self._mark(target.name, STATE_SUSPECT)

    def _probe(self, member: Member) -> bool:
        with self._lock:
            self._seq += 1
            seq = self._seq
        ev = threading.Event()
        self._acks[seq] = ev
        name_b = self.name.encode()
        pkt = (
            struct.pack("<BI", _PING, seq)
            + struct.pack("<H", len(name_b))
            + name_b
            + _pack_piggyback(
                [(_PB_MEMBER, json.dumps(self._members[self.name].to_wire()).encode())]
                + self._get_broadcasts(_MAX_UDP - 200)
            )
        )
        try:
            self._udp.sendto(pkt, _split_addr(member.addr))
        except OSError:
            self._acks.pop(seq, None)
            return False
        ok = ev.wait(self.probe_timeout)
        self._acks.pop(seq, None)
        return ok

    # -- internals: TCP path ----------------------------------------------

    def _tcp_send(self, addr: str, typ: int, body: bytes) -> bytes:
        with socket.create_connection(_split_addr(addr), timeout=5.0) as s:
            s.sendall(struct.pack("<BI", typ, len(body)) + body)
            if typ != _PUSH_PULL:
                return b""
            hdr = _recv_exact(s, 5)
            rtyp, ln = struct.unpack("<BI", hdr)
            return _recv_exact(s, ln)

    def _handle_tcp(self, typ: int, body: bytes) -> Optional[bytes]:
        if typ == _USER_MSG:
            if self.handler is not None:
                self.handler(body)
            return None
        if typ == _PUSH_PULL:
            self._merge_push_pull(body)
            return self._encode_push_pull()
        return None

    def _encode_push_pull(self) -> bytes:
        with self._lock:
            members = [m.to_wire() for m in self._members.values()]
        status = b""
        if self.status_handler is not None:
            try:
                status = self.status_handler.local_status() or b""
            except Exception:
                self._note_swallowed("local_status")
                status = b""
        head = json.dumps({"members": members}).encode()
        return struct.pack("<I", len(head)) + head + status

    def _merge_push_pull(self, body: bytes) -> None:
        (hlen,) = struct.unpack_from("<I", body, 0)
        head = json.loads(body[4 : 4 + hlen])
        status = body[4 + hlen :]
        for d in head.get("members", []):
            try:
                self._merge_member(Member.from_wire(d))
            except (ValueError, KeyError):
                pass
        if status and self.status_handler is not None:
            try:
                self.status_handler.handle_remote_status(status)
            except Exception:
                self._note_swallowed("remote_status")

    def _push_pull(self, addr: str) -> None:
        resp = self._tcp_send(addr, _PUSH_PULL, self._encode_push_pull())
        if resp:
            self._merge_push_pull(resp)

    def _push_pull_loop(self) -> None:
        while not self._closing.wait(self.push_pull_interval):
            with self._lock:
                candidates = [
                    m for m in self._members.values()
                    if m.name != self.name and m.state == STATE_ALIVE
                ]
            if not candidates:
                continue
            target = random.choice(candidates)
            try:
                self._push_pull(target.addr)
            except OSError:
                pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("gossip peer closed mid-frame")
        buf += chunk
    return buf
