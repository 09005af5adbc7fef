"""Router write-ahead log: the durable total order of accepted writes.

A sequencer alone gives every group the same write ORDER but keeps no
record of it — which is why its quorum rule would have to be the full group
set (a write a down group missed could never be re-delivered).  This
log is the missing record: every write the router accepts is assigned
a monotonic sequence number and appended HERE, fsync-batched, BEFORE
any group sees it.  The log is then the recovery story end to end:

- a write commits on a DEGRADED quorum (majority of groups) because
  the laggards' missed suffix is replayable from the log;
- a crashed/restarted group re-converges by replaying the suffix past
  its last-applied sequence (``replica/catchup.py``);
- a crashed ROUTER recovers its sequence space by re-opening the log
  (the tail that never reached a quorum replays to everyone — writes
  are at-least-once, the same contract the 502 "may be partially
  applied" answer always had).

On-disk format (little-endian), one frame per record::

    [u32 payload_len][u32 crc32(payload)][payload]
    payload = [u64 seq][u32 meta_len][meta JSON][body bytes]

``meta`` carries ``{"m": method, "p": path_qs, "t": content-type}`` —
everything needed to re-forward the write verbatim — or ``{"x": true}``
for an ABORT tombstone: a write that PROVABLY applied nowhere (shed or
deterministically refused before any group committed — a transport
failure proves nothing and never tombstones) is tombstoned so replay
never delivers a write no live group has.  Recovery scans the file frame by frame; the first short or
checksum-failing frame is a torn tail from a crash mid-append — the
file is truncated there (``wal.torn_tail`` counted) and appends
continue from the last good record.

FSYNC BATCHING: appenders write+flush under the lock, then join a
group commit — one leader fsyncs for every append that landed before
the syscall, so concurrent writes share one disk flush (the classic
group-commit discipline; ``fsync=False`` trades crash durability for
speed on dev rigs).

COMPACTION: ``compact(min_applied)`` rewrites the log without records
every tracked group has applied (and without tombstones at or below the
watermark), atomically (temp file + rename).  The router calls it as
the min-applied watermark advances; a laggard pinning the log past
``max_bytes`` is the router's signal to declare that group stale
rather than grow the log without bound.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading

from pilosa_tpu_torch.analysis import lockcheck
import zlib
from typing import NamedTuple, Optional

from pilosa_tpu_torch.analysis import spec
from pilosa_tpu_torch.replica.faults import NOP_FAULTS
from pilosa_tpu_torch.stats import NOP_STATS

_FRAME = struct.Struct("<II")  # payload_len, crc32(payload)
_HEAD = struct.Struct("<QI")  # seq, meta_len


class WalRecord(NamedTuple):
    seq: int
    method: str
    path: str
    body: bytes
    ctype: str


def _encode(seq: int, meta: dict, body: bytes) -> bytes:
    mb = json.dumps(meta, separators=(",", ":")).encode()
    payload = _HEAD.pack(seq, len(mb)) + mb + body
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _decode_payload(payload: bytes) -> tuple[int, dict, bytes]:
    seq, meta_len = _HEAD.unpack_from(payload)
    meta = json.loads(payload[_HEAD.size : _HEAD.size + meta_len])
    return seq, meta, payload[_HEAD.size + meta_len :]


@lockcheck.guarded_class
class WriteAheadLog:
    """Append-only, checksummed, compactable write log.

    ``path=None`` keeps the log IN MEMORY: the same sequence space,
    abort, and replay semantics with no crash durability — the default
    for routers configured without ``[replica] wal-dir`` (and the unit
    the tests exercise without touching disk).
    """

    # Lockset race detector declarations: the record index and the file
    # handle move under ``_mu`` (appenders, abort, compaction swap,
    # close); the group-commit frontier state moves under the
    # ``_sync_cv`` condition's lock (leader election, generation bumps).
    # The compaction/fsync interplay here is exactly where races hide —
    # machine-checked.
    _guarded_by_ = {
        "last_seq": "replica.wal._mu",
        "_offsets": "replica.wal._mu",
        "_aborted": "replica.wal._mu",
        "_mem_frames": "replica.wal._mu",
        "_end_off": "replica.wal._mu",
        "_f": "replica.wal._mu",
        "_synced_off": "replica.wal._sync_cv",
        "_syncing": "replica.wal._sync_cv",
        "_file_gen": "replica.wal._sync_cv",
    }

    def __init__(self, path: Optional[str] = None, fsync: bool = True,
                 max_bytes: int = 64 << 20, stats=None, faults=None):
        self.path = path
        self.fsync = fsync
        self.max_bytes = max_bytes
        self.stats = stats if stats is not None else NOP_STATS
        self.faults = faults if faults is not None else NOP_FAULTS
        self._mu = lockcheck.named_lock("replica.wal._mu")
        # seq -> (offset, frame_len) for live records; aborted seqs kept
        # separately so replay can skip them in O(1).
        self._offsets: dict[int, tuple[int, int]] = {}
        self._aborted: set[int] = set()
        self.last_seq = 0
        self._f: Optional[io.BufferedRandom] = None
        self._mem_frames: dict[int, bytes] = {}  # offset -> frame (path=None)
        self._end_off = 0
        # Group commit: _synced_off trails _end_off; one leader fsyncs
        # for every append that landed before its syscall.  _file_gen
        # counts file swaps (compaction/close): offsets from different
        # generations are not comparable, so the leader pins the
        # generation with the fd and a swap invalidates both.
        self._sync_cv = lockcheck.named_condition("replica.wal._sync_cv")
        self._synced_off = 0
        self._syncing = False
        self._file_gen = 0
        # Serializes whole compactions (the bulk copy runs outside _mu,
        # so two concurrent compact() calls would race on the tmp file).
        self._compact_mu = lockcheck.named_lock("replica.wal._compact_mu")
        if path is not None:
            self._open_and_recover(path)
        self.stats.gauge("replica.wal_bytes", self.size_bytes)

    # -- recovery ---------------------------------------------------------

    def _open_and_recover(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # a+b creates; reopen r+b for positioned reads AND appends.
        with open(path, "ab"):
            pass
        self._f = open(path, "r+b")
        off = 0
        data_end = os.fstat(self._f.fileno()).st_size
        while True:
            head = self._read_at(off, _FRAME.size)
            if len(head) < _FRAME.size:
                break  # clean EOF or torn length header
            n, crc = _FRAME.unpack(head)
            payload = self._read_at(off + _FRAME.size, n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                break  # torn tail: crash mid-append
            seq, meta, _ = _decode_payload(payload)
            if meta.get("x"):
                self._aborted.add(seq)
                self._offsets.pop(seq, None)
            else:
                self._offsets[seq] = (off, _FRAME.size + n)
            self.last_seq = max(self.last_seq, seq)
            off += _FRAME.size + n
        if off < data_end:
            # Truncate the torn tail so the next append starts on a
            # frame boundary (re-appending over garbage would corrupt
            # the NEXT recovery scan).
            self._f.truncate(off)
            self.stats.count("wal.torn_tail")
        self._end_off = off
        self._synced_off = off

    def _read_at(self, off: int, n: int) -> bytes:
        self._f.seek(off)
        return self._f.read(n)

    # -- append / abort ---------------------------------------------------

    def append(self, method: str, path_qs: str, body: bytes, ctype: str = "") -> int:
        """Assign the next sequence number and make the record durable.
        Returns the sequence number; raises OSError on a failed append
        (the caller must refuse the write — nothing was sequenced)."""
        with self._mu:
            self.faults.hit("wal.append")
            if self.path is not None and self._f is None:
                # A file-backed log that was close()d must REFUSE, not
                # silently buffer to memory: an append that returns a
                # sequence promises a durable, replayable record (the
                # interleaving explorer's append-vs-close scenario
                # found the old fall-through losing the record).
                raise OSError("write log is closed")
            seq = self.last_seq + 1
            frame = _encode(seq, {"m": method, "p": path_qs, "t": ctype}, body)
            off = self._end_off
            if self._f is not None:
                self._f.seek(off)
                self._f.write(frame)
                self._f.flush()
            else:
                self._mem_frames[off] = frame
            self._offsets[seq] = (off, len(frame))
            self._end_off = off + len(frame)
            self.last_seq = seq
            spec.emit("append", src=id(self), seq=seq)
        self._fsync_batched()
        self.stats.gauge("replica.wal_bytes", self.size_bytes)
        return seq

    def abort(self, seq: int) -> None:
        """Tombstone a sequenced write that applied NOWHERE (shed before
        any commit, or failed on every group): replay skips it, so a
        recovering group converges to exactly what the live groups hold."""
        with self._mu:
            if self.path is not None and self._f is None:
                raise OSError("write log is closed")
            frame = _encode(seq, {"x": True}, b"")
            off = self._end_off
            if self._f is not None:
                self._f.seek(off)
                self._f.write(frame)
                self._f.flush()
            else:
                self._mem_frames[off] = frame
            self._aborted.add(seq)
            self._offsets.pop(seq, None)
            self._end_off = off + len(frame)
            spec.emit("abort", src=id(self), seq=seq)
        self._fsync_batched()
        self.stats.count("wal.aborted")

    def _fsync_batched(self) -> None:
        """Group commit: block until everything written so far is on
        disk, sharing one fsync between concurrent appenders.

        Compaction swaps the backing file (close + rename), so the fd
        and the target offset are pinned together with ``_file_gen``
        under ``_sync_cv``: a generation bump while waiting means
        ``compact()`` already fsynced everything it kept — and
        everything it dropped was applied by every tracked group — so
        the caller's record is durable (or moot) either way and the
        old-file offsets must never touch ``_synced_off``."""
        if self._f is None or not self.fsync:
            return
        with self._sync_cv:
            target = self._end_off
            gen = self._file_gen
        while True:
            with self._sync_cv:
                if self._file_gen != gen or self._synced_off >= target:
                    return
                if self._syncing:
                    self._sync_cv.wait(0.05)
                    continue
                self._syncing = True
                # Leader: pin the fd and capture the frontier BEFORE
                # the syscall — appends landing during the fsync need
                # the next round, and compact() blocks on _syncing so
                # the fd cannot be closed under the syscall.
                f = self._f
                covered = self._end_off
            try:
                if f is not None:
                    os.fsync(f.fileno())
            finally:
                with self._sync_cv:
                    if self._file_gen == gen:
                        self._synced_off = max(self._synced_off, covered)
                    self._syncing = False
                    self._sync_cv.notify_all()

    # -- read / replay ----------------------------------------------------

    @property
    def first_seq(self) -> int:
        """Lowest LIVE sequence still in the log (0 = empty)."""
        with self._mu:
            return min(self._offsets) if self._offsets else 0

    @property
    def size_bytes(self) -> int:
        return self._end_off

    def records(self, from_seq: int) -> list[WalRecord]:
        """Live records with seq >= from_seq, in sequence order (aborted
        tombstones skipped) — the catch-up suffix."""
        with self._mu:
            seqs = sorted(s for s in self._offsets if s >= from_seq)
            out = []
            for s in seqs:
                off, n = self._offsets[s]
                frame = self._frame_at(off, n)
                payload = frame[_FRAME.size :]
                seq, meta, body = _decode_payload(payload)
                out.append(WalRecord(seq, meta.get("m", ""), meta.get("p", ""),
                                     body, meta.get("t", "")))
            return out

    def _frame_at(self, off: int, n: int) -> bytes:
        if self._f is not None:
            return self._read_at(off, n)
        return self._mem_frames[off]

    # -- compaction -------------------------------------------------------

    def compact(self, min_applied: int) -> int:
        """Drop records (and tombstones) with seq <= ``min_applied`` —
        every tracked group has applied them, so no replay can need
        them.  Atomic for the file-backed log (temp + rename).  Returns
        bytes reclaimed.

        The BULK of the work — copying every kept frame into the temp
        file and fsyncing it — happens OUTSIDE ``_mu``, so appends keep
        flowing to the old file during a large compaction instead of
        stalling behind its disk I/O (the lock checker flags fsync under
        a lock for exactly this reason).  The swap then re-takes ``_mu``,
        appends the DELTA that landed meanwhile (records/tombstones past
        the snapshot), fsyncs that bounded tail, and renames — so the
        new file is durable end to end before the generation bump, which
        preserves the group-commit contract: a bump observed by a
        waiting appender means its record is durable (in bulk or delta)
        or moot (compacted away because every group applied it)."""
        if self._f is None:
            with self._mu:
                keep = sorted(s for s in self._offsets if s > min_applied)
                keep_aborted = {s for s in self._aborted if s > min_applied}
                before = self._end_off
                mem = {}
                offsets = {}
                pos = 0
                for s in keep:
                    off, n = self._offsets[s]
                    fr = self._frame_at(off, n)
                    offsets[s] = (pos, len(fr))
                    mem[pos] = fr
                    pos += len(fr)
                for s in sorted(keep_aborted):
                    fr = _encode(s, {"x": True}, b"")
                    mem[pos] = fr
                    pos += len(fr)
                self._mem_frames = mem
                self._offsets = offsets
                self._end_off = pos
                self._aborted = keep_aborted
                freed = before - self._end_off
                spec.emit("wal_compact", src=id(self), floor=min_applied)
            self.stats.gauge("replica.wal_bytes", self.size_bytes)
            if freed:
                self.stats.count("wal.compactions")
            return freed

        with self._compact_mu:
            # Phase 1 (under _mu): snapshot the kept frames.
            with self._mu:
                if self._f is None:  # closed mid-wait
                    return 0
                snap_last = self.last_seq
                snap_aborted = {s for s in self._aborted if s > min_applied}
                before = self._end_off
                frames = []
                for s in sorted(x for x in self._offsets if x > min_applied):
                    off, n = self._offsets[s]
                    frames.append((s, self._frame_at(off, n)))
            # Phase 2 (no locks): bulk copy + fsync.  Appends land in
            # the old file meanwhile and are carried over as the delta.
            tmp = self.path + ".compact"
            out = open(tmp, "wb")
            offsets = {}
            pos = 0
            for s, fr in frames:
                offsets[s] = (pos, len(fr))
                out.write(fr)
                pos += len(fr)
            for s in sorted(snap_aborted):
                fr = _encode(s, {"x": True}, b"")
                out.write(fr)
                pos += len(fr)
            out.flush()
            if self.fsync:
                os.fsync(out.fileno())
            # Phase 3 (under _mu): append the delta, make it durable,
            # swap.  The delta is bounded by what arrived during phase
            # 2, so this fsync never covers the whole log again.
            with self._mu:
                if self._f is None:  # closed mid-compaction: abandon
                    out.close()
                    os.unlink(tmp)
                    return 0
                for s in sorted(x for x in self._offsets if x > snap_last):
                    off, n = self._offsets[s]
                    fr = self._frame_at(off, n)
                    offsets[s] = (pos, len(fr))
                    out.write(fr)
                    pos += len(fr)
                new_aborts = {s for s in self._aborted if s > min_applied} - snap_aborted
                for s in sorted(new_aborts):
                    fr = _encode(s, {"x": True}, b"")
                    out.write(fr)
                    pos += len(fr)
                    offsets.pop(s, None)  # aborted during phase 2
                out.flush()
                if self.fsync:
                    # analysis-ok's runtime twin: bounded delta fsync
                    # before the rename keeps "gen bump => durable or
                    # moot" true for every waiting appender.
                    with lockcheck.allowed("fsync"):
                        os.fsync(out.fileno())
                out.close()
                # Exclude the group-commit leader for the swap: an
                # in-flight fsync must finish on the OLD fd before it
                # closes, and no new leader may pin the fd mid-swap.
                with self._sync_cv:
                    while self._syncing:
                        self._sync_cv.wait()
                    self._syncing = True
                try:
                    self._f.close()
                    os.replace(tmp, self.path)
                    self._f = open(self.path, "r+b")
                    self._offsets = offsets
                    self._end_off = pos
                finally:
                    with self._sync_cv:
                        # The new file was fsynced end to end (bulk in
                        # phase 2, delta above) before the rename, so
                        # the synced frontier is exactly its end —
                        # never the old file's (larger) offsets, which
                        # would make later appends skip their fsync.
                        self._file_gen += 1
                        self._synced_off = pos
                        self._syncing = False
                        self._sync_cv.notify_all()
                self._aborted = {s for s in self._aborted if s > min_applied}
                freed = before - self._end_off
                spec.emit("wal_compact", src=id(self), floor=min_applied)
        self.stats.gauge("replica.wal_bytes", self.size_bytes)
        if freed:
            self.stats.count("wal.compactions")
        return freed

    def close(self) -> None:
        with self._mu:
            if self._f is None:
                return
            # Same swap discipline as compact(): wait out an in-flight
            # group-commit fsync, then bump the generation so waiting
            # followers return instead of spinning on a dead frontier.
            with self._sync_cv:
                while self._syncing:
                    self._sync_cv.wait()
                self._syncing = True
            try:
                self._f.close()
                self._f = None
            finally:
                with self._sync_cv:
                    self._file_gen += 1
                    self._syncing = False
                    self._sync_cv.notify_all()
