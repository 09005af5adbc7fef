"""Roaring bitmap engine, numpy-native.

Host-side compressed bitmap used at the storage/serialization boundary
(snapshot files, WAL, wire format).  On device everything is dense packed
uint32 (see pilosa_tpu_torch.ops); this module is what feeds it.

Reference analog: roaring/roaring.go (1856 LoC Go).  Semantics match —
64-bit value space split into 2^16-bit containers keyed by ``value >> 16``,
each container either a sorted array (≤ 4096 values) or a dense bitmap
(1024 × u64 words) — but the implementation is vectorized numpy rather than
a translation: container kernels are numpy set ops / bitwise ops, batch
adds group by key with one sort, and dense-row extraction emits the packed
uint32 arrays the device kernels consume.

Serialization is byte-compatible with the reference file format
(roaring.go:475-533 WriteTo / 536-614 UnmarshalBinary):

    cookie u32le = 12346 | containerCount u32le
    per container: key u64le, (n-1) u32le          (12-byte headers)
    per container: absolute file offset u32le
    payloads: array = n × u32le, bitmap = 1024 × u64le
    trailing op log: records of [typ u8 | value u64le | fnv1a32 u32le]
                     (checksum over the first 9 bytes; roaring.go:1586-1623)
"""

from __future__ import annotations

import io
import struct
import sys
from typing import Iterable, Iterator, Optional

import numpy as np

from pilosa_tpu_torch import native

COOKIE = 12346
HEADER_SIZE = 8
ARRAY_MAX_SIZE = 4096
BITMAP_N = (1 << 16) // 64  # 1024 u64 words per container
CONTAINER_BITS = 1 << 16
OP_SIZE = 13

OP_ADD = 0
OP_REMOVE = 1

# Snapshot payload chunk size: one write syscall per ~8 MB of payloads.
_SNAP_CHUNK = 8 << 20


def _snap_release(handle: int) -> None:
    """GC finalizer for a Bitmap's native snapshot mirror (safe at
    interpreter shutdown: the lib may already be unloaded)."""
    try:
        lib = native.load()
        if lib is not None:
            lib.pn_snap_free(handle)
    # analysis-ok: exception-hygiene: finalizer during interpreter shutdown; nothing to report to
    except Exception:
        pass

# Byte-popcount lookup table; np_count(words) = LUT[words.view(u8)].sum().
_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint32)


_NATIVE_LE = sys.byteorder == "little"


def _popcount_words(words: np.ndarray) -> int:
    return int(_POPCNT8[words.view(np.uint8)].sum())


def fnv1a32(data: bytes) -> int:
    """FNV-1a 32-bit hash (op-log checksums; hash/fnv analog)."""
    h = 2166136261
    for b in data:
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def highbits(v: int) -> int:
    return v >> 16


def lowbits(v: int) -> int:
    return v & 0xFFFF


class Container:
    """One 2^16-bit container: sorted uint32 array or dense u64 bitmap.

    ``array`` holds sorted unique lowbits values as uint32 (the file format
    stores them as u32le).  ``bitmap`` is uint64[1024].  Exactly one is
    non-None.  Conversion threshold matches the reference: arrays hold at
    most ARRAY_MAX_SIZE=4096 values (roaring.go:833, 951-953).
    """

    __slots__ = ("array", "bitmap", "_n", "_ser", "_buf", "_buf_addr")

    def __init__(self, array: Optional[np.ndarray] = None, bitmap: Optional[np.ndarray] = None):
        if array is None and bitmap is None:
            array = np.empty(0, dtype=np.uint32)
        self.array = array
        self.bitmap = bitmap
        # Cached bitmap-container cardinality (the reference stores n as a
        # field, roaring.go:42); add/remove adjust it so snapshots and
        # counts skip a popcount per container.  None = unknown.
        self._n: Optional[int] = None
        # Cached (n, payload bytes) for serialization: snapshots only
        # re-encode containers that changed since the last one (the
        # per-container-dirty incremental snapshot; cleared on mutation).
        self._ser: Optional[tuple[int, bytes]] = None
        # Capacity-slack backing buffer for the native in-place insert:
        # when set, ``array`` is ``_buf[:n]`` and single adds memmove
        # inside the buffer (no per-op allocation).  Any bulk mutation or
        # representation change drops it (array becomes standalone again).
        # _buf_addr caches buf.ctypes.data: the .ctypes property
        # materializes a wrapper object per access (~2us on the hot path).
        self._buf: Optional[np.ndarray] = None
        self._buf_addr = 0

    # -- constructors -------------------------------------------------

    @classmethod
    def from_values(cls, values: np.ndarray) -> "Container":
        """Build from sorted unique lowbits values, picking representation."""
        values = np.asarray(values, dtype=np.uint32)
        if len(values) > ARRAY_MAX_SIZE:
            return cls(bitmap=_values_to_bitmap(values))
        return cls(array=values)

    # -- basics -------------------------------------------------------

    @property
    def is_array(self) -> bool:
        return self.array is not None

    @property
    def n(self) -> int:
        if self.array is not None:
            return len(self.array)
        if self._n is None:
            self._n = _popcount_words(self.bitmap)
        return self._n

    def values(self) -> np.ndarray:
        """Sorted lowbits values as uint32.

        The returned array is safe to retain across later mutations: when
        the container is backed by the capacity-slack insert buffer (whose
        contents single adds memmove in place), it is detached here —
        published as a standalone array once — so no caller ever holds a
        live view of mutating storage.  The next native add re-creates the
        slack buffer.
        """
        if self.array is not None:
            if self._buf is not None:
                self.array = self.array.copy()
                self._buf = None
            return self.array
        return _bitmap_to_values(self.bitmap)

    def contains(self, v: int) -> bool:
        if self.array is not None:
            i = np.searchsorted(self.array, v)
            return i < len(self.array) and self.array[i] == v
        return bool((int(self.bitmap[v >> 6]) >> (v & 63)) & 1)

    def contains_many(self, lows: np.ndarray) -> np.ndarray:
        """Vectorized membership mask for uint32 lowbits values."""
        lows = np.asarray(lows, dtype=np.uint32)
        if self.array is not None:
            if len(self.array) == 0:
                return np.zeros(len(lows), dtype=bool)
            i = np.searchsorted(self.array, lows)
            mask = i < len(self.array)
            return mask & (self.array[np.minimum(i, len(self.array) - 1)] == lows)
        words = self.bitmap[(lows >> np.uint32(6)).astype(np.int64)]
        return ((words >> (lows & np.uint32(63)).astype(np.uint64)) & np.uint64(1)).astype(bool)

    def _writable_bitmap(self) -> np.ndarray:
        """Copy-on-write gate for in-place bitmap-container mutation.

        mmap-attached containers (zero-copy snapshot views,
        Bitmap.from_bytes(..., zero_copy=True)) hold READ-ONLY views into
        the mapped file; the first mutation promotes the container to a
        private heap copy — the reference's equivalent is the op log
        keeping mutations out of the mmap entirely (roaring.go:84-103 adds
        go to the WAL; the mmap stays immutable until snapshot)."""
        bm = self.bitmap
        if not bm.flags.writeable:
            bm = self.bitmap = bm.copy()
        return bm

    def _ensure_slack(self, n: int) -> np.ndarray:
        """The capacity-slack insert buffer, (re)built so capacity > n.

        Invariant shared by every native insert path: ``array`` is
        ``_buf[:n]`` and ``_buf_addr`` caches the buffer's base address.
        """
        buf = self._buf
        if buf is None or n >= len(buf):
            buf = np.empty(max(8, 2 * n), dtype=np.uint32)
            buf[:n] = self.array
            self._buf = buf
            self._buf_addr = buf.ctypes.data
        return buf

    def add(self, v: int) -> bool:
        """Insert lowbits value; True if it was newly added."""
        arr = self.array
        if arr is not None:
            n = len(arr)
            if n < ARRAY_MAX_SIZE:
                lib = native.load()
                if lib is not None:
                    # Native in-place insert over a capacity-slack buffer:
                    # one C call does the binary search, duplicate check,
                    # and memmove — no per-op numpy dispatch or allocation.
                    buf = self._ensure_slack(n)
                    newn = lib.pn_array_insert_u32(self._buf_addr, n, v)
                    if newn < 0:
                        return False
                    self._ser = None
                    self.array = buf[:newn]
                    return True
            # Direct ndarray method: the np.searchsorted module wrapper pays
            # ~3µs of dispatch machinery per call on this hot path.
            i = int(arr.searchsorted(v))
            if i < len(arr) and arr[i] == v:
                return False
            self._ser = None
            if len(arr) >= ARRAY_MAX_SIZE:
                self._buf = None
                self.bitmap = _values_to_bitmap(arr)
                self._n = len(arr) + 1
                self.array = None
                self.bitmap[v >> 6] |= np.uint64(1 << (v & 63))
                return True
            # np.insert pays axis-normalization machinery per call; a plain
            # split copy is ~3x faster on the SetBit hot path.
            new = np.empty(len(arr) + 1, dtype=np.uint32)
            new[:i] = arr[:i]
            new[i] = v
            new[i + 1:] = arr[i:]
            self._buf = None
            self.array = new
            return True
        w, b = v >> 6, v & 63
        if (int(self.bitmap[w]) >> b) & 1:
            return False
        self._ser = None
        self._writable_bitmap()[w] |= np.uint64(1 << b)
        if self._n is not None:
            self._n += 1
        return True

    def remove(self, v: int) -> bool:
        if self.array is not None:
            i = int(self.array.searchsorted(v))
            if i >= len(self.array) or self.array[i] != v:
                return False
            self._ser = None
            self._buf = None
            self.array = np.delete(self.array, i)
            return True
        w, b = v >> 6, v & 63
        if not (int(self.bitmap[w]) >> b) & 1:
            return False
        self._ser = None
        self._writable_bitmap()[w] &= np.uint64(~(1 << b) & 0xFFFFFFFFFFFFFFFF)
        if self._n is not None:
            self._n -= 1
        # Convert back to array when small enough (roaring.go remove path).
        if self.n <= ARRAY_MAX_SIZE:
            self._buf = None
            self.array = _bitmap_to_values(self.bitmap)
            self.bitmap = None
            self._n = None  # array form owns the count now
        return True

    def add_many(self, values: np.ndarray) -> int:
        """Bulk insert of sorted-or-not lowbits values; returns newly-added count."""
        values = np.asarray(values, dtype=np.uint32)
        if len(values) == 0:
            return 0
        self._ser = None
        self._buf = None
        before = self.n
        if self.bitmap is not None:
            # Dense stays dense: OR the bits in directly, O(len + 1024)
            # instead of a full unpack + union sort.
            np.bitwise_or.at(
                self._writable_bitmap(),
                (values >> np.uint32(6)).astype(np.int64),
                np.uint64(1) << (values & np.uint32(63)).astype(np.uint64),
            )
            self._n = None  # bulk OR: recount (and re-cache) below
            return self.n - before
        merged = np.union1d(self.array, values)
        if len(merged) > ARRAY_MAX_SIZE:
            self.bitmap = _values_to_bitmap(merged)
            self._n = len(merged)
            self.array = None
        else:
            self.array = merged.astype(np.uint32)
            self.bitmap = None
        return len(merged) - before

    # -- range --------------------------------------------------------

    def count_range(self, start: int, end: int) -> int:
        """Count values in [start, end) within this container's lowbits space."""
        if self.array is not None:
            return int(np.searchsorted(self.array, end) - np.searchsorted(self.array, start))
        vals = _bitmap_to_values(self.bitmap)
        return int(np.searchsorted(vals, end) - np.searchsorted(vals, start))

    # -- serialization ------------------------------------------------

    def payload(self) -> bytes:
        if self.array is not None:
            if _NATIVE_LE:
                return self.array.tobytes()
            return self.array.astype("<u4").tobytes()
        if _NATIVE_LE:
            return self.bitmap.tobytes()
        return self.bitmap.astype("<u8").tobytes()

    def payload_size(self) -> int:
        if self.array is not None:
            return 4 * len(self.array)
        return 8 * BITMAP_N

    def ser(self) -> tuple[int, bytes]:
        """(n, payload bytes), cached until the next mutation — snapshots
        re-encode only the containers that changed (incremental snapshot;
        fragment.go rewrites every container each time)."""
        s = self._ser
        if s is None:
            s = (self.n, self.payload())
            if self.array is not None and len(self.array) <= 512:
                # Only small array containers cache their payload: the win
                # is the per-container Python overhead on snapshot (small
                # containers dominate sparse fragments), while pinning
                # multi-KB copies (dense 8 KB, near-full arrays 16 KB)
                # would meaningfully grow host memory on large fragments.
                self._ser = s
        return s

    def check(self) -> None:
        if self.array is not None:
            if len(self.array) > ARRAY_MAX_SIZE:
                raise ValueError("array container too large")
            if len(self.array) > 1 and not (np.diff(self.array.astype(np.int64)) > 0).all():
                raise ValueError("array container not sorted/unique")
            if len(self.array) and int(self.array[-1]) >= CONTAINER_BITS:
                raise ValueError("array value out of range")


def _values_to_bitmap(values: np.ndarray) -> np.ndarray:
    bm = np.zeros(BITMAP_N, dtype=np.uint64)
    v = values.astype(np.uint64)
    np.bitwise_or.at(bm, (v >> np.uint64(6)).astype(np.int64), np.uint64(1) << (v & np.uint64(63)))
    return bm


def _bitmap_to_values(bitmap: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(bitmap.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint32)


class Bitmap:
    """Sparse 64-bit-keyed roaring bitmap (reference roaring.go:42 Bitmap).

    ``containers`` maps container key (value >> 16) -> Container.  A dict is
    the Python-native replacement for the reference's parallel sorted
    keys/containers slices; sorted key order is materialized on demand
    (iteration/serialization) and set ops intersect key sets directly.

    ``op_writer`` is the WAL hook (roaring.go:51 OpWriter): when set, every
    successful add/remove appends a checksummed 13-byte op record.
    """

    def __init__(self, values: Optional[Iterable[int]] = None):
        self.containers: dict[int, Container] = {}
        self._op_writer = None  # file-like; WAL hook
        # Raw fd of the WAL writer for the fused native add (insert + WAL
        # record + write(2) in one C call): >= 0 usable, -1 unresolved,
        # -2 writer has no fileno (BytesIO tests — python write path).
        self._op_fd = -1
        self.op_n = 0
        # C++ incremental-snapshot mirror (see write_to): handle into the
        # native encoder + the container keys mutated since the last sync.
        # None until the first native write_to; every Bitmap mutation
        # method records dirty keys once tracking is live.
        self._snap_handle = None
        self._snap_dirty: "Optional[set[int]]" = None
        if values is not None:
            self.add_many(np.fromiter(values, dtype=np.uint64))

    @property
    def op_writer(self):
        return self._op_writer

    @op_writer.setter
    def op_writer(self, w) -> None:
        self._op_writer = w
        self._op_fd = -1  # re-resolve on next fused add

    def _wal_fd(self) -> int:
        """fd of the WAL writer, or -2 when the fused C write(2) path may
        not use it.  Only UNBUFFERED raw writers qualify: a buffered
        writer's fileno() is real, but bypassing its userspace buffer
        would let a fused ADD hit disk ahead of an unflushed earlier
        record — out-of-order replay after a crash."""
        fd = self._op_fd
        if fd == -1:
            w = self._op_writer
            if isinstance(w, io.RawIOBase):
                try:
                    fd = w.fileno()
                except (OSError, ValueError):
                    fd = -2
            else:
                fd = -2
            self._op_fd = fd
        return fd

    # -- mutation -----------------------------------------------------

    def add(self, v: int) -> bool:
        v = int(v)
        # Fused native lane (the reference's compiled SetBit chain,
        # fragment.go:371-459): container search + duplicate check +
        # memmove insert + WAL record + write(2) in ONE ctypes call.
        # Declines to the general path on any structural case: new or
        # bitmap container, no capacity slack, array at the conversion
        # threshold, or a WAL writer without a real fd.
        key = v >> 16
        c = self.containers.get(key)
        if c is None or (c.array is not None and len(c.array) < ARRAY_MAX_SIZE):
            lib = native.load()
            if lib is not None:
                if self._op_writer is None:
                    fd = -1
                else:
                    fd = self._wal_fd()
                if fd != -2:
                    if c is None:  # first touch: container + slack buffer
                        c = Container()
                        self.containers[key] = c
                        n = 0
                    else:
                        n = len(c.array)
                    buf = c._ensure_slack(n)
                    r = lib.pn_array_add_logged(c._buf_addr, n, v & 0xFFFF, v, fd)
                    if r == -2:
                        return False
                    if r == -3:
                        if n == 0:  # don't leave an empty first-touch shell
                            del self.containers[key]
                        raise OSError("WAL write failed")
                    c._ser = None
                    c.array = buf[:r]
                    d = self._snap_dirty
                    if d is not None:
                        d.add(key)
                    if fd >= 0:
                        self.op_n += 1
                    return True
        changed = self._container_for(v).add(lowbits(v))
        if changed:
            d = self._snap_dirty
            if d is not None:
                d.add(highbits(v))
            self._write_op(OP_ADD, v)
        return changed

    def remove(self, v: int) -> bool:
        v = int(v)
        c = self.containers.get(highbits(v))
        if c is None:
            return False
        changed = c.remove(lowbits(v))
        if changed:
            if c.n == 0:
                del self.containers[highbits(v)]
            d = self._snap_dirty
            if d is not None:
                d.add(highbits(v))
            self._write_op(OP_REMOVE, v)
        return changed

    def add_unlogged(self, v: int) -> bool:
        """Scalar add WITHOUT the WAL — the tiny-batch ingest fast path
        (fragment.set_bits): callers apply a handful of scalar adds and
        then append ONE combined op-log record batch via log_add_ops."""
        v = int(v)
        changed = self._container_for(v).add(lowbits(v))
        if changed and self._snap_dirty is not None:
            self._snap_dirty.add(highbits(v))
        return changed

    def _bulk_add(self, values: np.ndarray) -> np.ndarray:
        """Shared bulk-add core: apply sorted-unique uint64 values and
        return the (sorted) subset that was newly added.  No WAL."""
        keys = (values >> np.uint64(16)).astype(np.int64)
        # values is sorted, so per-key groups are contiguous: one pass.
        uniq_keys, starts = np.unique(keys, return_index=True)
        groups = np.split(values, starts[1:])
        added_groups = []
        for key, group in zip(uniq_keys.tolist(), groups):
            lows = (group & np.uint64(0xFFFF)).astype(np.uint32)
            # analysis-ok: check-then-act: Bitmap is externally synchronized (Roaring-library contract): every mutating call site holds the owning fragment's _mu
            c = self.containers.get(key)
            if c is None:
                self.containers[key] = Container.from_values(lows)
                new_lows = lows
            elif len(lows) <= 8 and c.array is not None and len(c.array) + len(lows) <= ARRAY_MAX_SIZE:
                # Scattered-batch fast path: a handful of inserts into an
                # array container goes through the native in-place insert
                # (a few us total) instead of the vectorized
                # contains_many + union1d machinery (~30us of numpy
                # dispatch per container, the set_bits hot cost).
                new = [int(v) for v in lows.tolist() if c.add(int(v))]
                new_lows = np.asarray(new, dtype=np.uint32)
            else:
                new_lows = lows[~c.contains_many(lows)]
                if len(new_lows):
                    c.add_many(new_lows)
            if len(new_lows):
                if self._snap_dirty is not None:
                    self._snap_dirty.add(key)
                added_groups.append(new_lows.astype(np.uint64) | np.uint64(key << 16))
        if not added_groups:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(added_groups)

    def add_many(self, values: np.ndarray) -> int:
        """Vectorized bulk add (no WAL; callers snapshot after, like Import)."""
        return len(self.add_many_unlogged(values))

    def add_many_unlogged(self, values: np.ndarray) -> np.ndarray:
        """Apply a batch WITHOUT touching the WAL; returns the sorted
        uint64 array of newly-added values.  Callers own durability:
        either snapshot afterwards (import path) or pass the result to
        ``log_add_ops`` (small-batch path)."""
        values = np.asarray(values, dtype=np.uint64)
        if len(values) == 0:
            return values
        return self._bulk_add(np.unique(values))

    def add_many_logged(self, values: np.ndarray) -> np.ndarray:
        """Vectorized add WITH WAL: applies the batch and appends one op
        record per newly-set value (a durable bulk SetBit, unlike
        ``add_many`` which callers must follow with a snapshot).

        Returns the sorted uint64 array of values that were newly added.
        """
        added = self.add_many_unlogged(values)
        self.log_add_ops(added)
        return added

    def log_add_ops(self, added: np.ndarray) -> None:
        """Append one OP_ADD record per value to the WAL (no-op when
        detached).  For callers that apply a batch first and decide on
        durability strategy after seeing what was actually new."""
        if len(added) == 0 or self.op_writer is None:
            return
        if len(added) <= 8:
            # The native encoder costs ~40 us of ctypes marshalling per
            # call; a handful of records pack faster in pure python.
            self.op_writer.write(
                b"".join(encode_op(OP_ADD, int(v)) for v in added)
            )
            # analysis-ok: check-then-act: Bitmap is externally synchronized (Roaring-library contract): every mutating call site holds the owning fragment's _mu
            self.op_n += len(added)
            return
        types = np.zeros(len(added), dtype=np.uint8)  # OP_ADD
        self.op_writer.write(native.oplog_encode(types, added))
        # analysis-ok: check-then-act: Bitmap is externally synchronized (Roaring-library contract): every mutating call site holds the owning fragment's _mu
        self.op_n += len(added)

    def _container_for(self, v: int) -> Container:
        key = highbits(v)
        # analysis-ok: check-then-act: Bitmap is externally synchronized (Roaring-library contract): every mutating call site holds the owning fragment's _mu
        c = self.containers.get(key)
        if c is None:
            c = Container()
            self.containers[key] = c
        return c

    def _write_op(self, typ: int, value: int) -> None:
        if self.op_writer is None:
            return
        self.op_writer.write(native.op_encode1(typ, value))
        self.op_n += 1

    # -- queries ------------------------------------------------------

    def contains(self, v: int) -> bool:
        v = int(v)
        c = self.containers.get(highbits(v))
        return c is not None and c.contains(lowbits(v))

    def count(self) -> int:
        return sum(c.n for c in self.containers.values())

    def _keys_in_range(self, hk: int, he: int):
        """Container keys present in [hk, he], UNSORTED.  Iterates whichever
        side is smaller — the key range (a row spans ≤16 consecutive keys,
        the SetBit hot path) or the container dict."""
        if he - hk + 1 <= len(self.containers):
            return [k for k in range(hk, he + 1) if k in self.containers]
        return [k for k in self.containers if hk <= k <= he]

    def count_range(self, start: int, end: int) -> int:
        """Count values in [start, end)."""
        if end <= start:
            return 0
        total = 0
        hk, he = highbits(start), highbits(end - 1)
        for key in self._keys_in_range(hk, he):  # counting needs no order
            c = self.containers[key]
            lo = lowbits(start) if key == hk else 0
            hi = lowbits(end - 1) + 1 if key == he else CONTAINER_BITS
            if lo == 0 and hi == CONTAINER_BITS:
                total += c.n
            else:
                total += c.count_range(lo, hi)
        return total

    def slice_values(self, start: int, end: int) -> np.ndarray:
        """All values in [start, end) as sorted uint64 (OffsetRange core)."""
        out = []
        hk, he = highbits(start), highbits(max(end - 1, 0))
        for key in sorted(self._keys_in_range(hk, he)):
            vals = self.containers[key].values().astype(np.uint64) | np.uint64(key << 16)
            if key == hk or key == he:
                vals = vals[(vals >= start) & (vals < end)]
            out.append(vals)
        if not out:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(out)

    def offset_range(self, offset: int, start: int, end: int) -> "Bitmap":
        """New bitmap holding values in [start, end) rebased to ``offset``.

        Reference roaring.go:253-285: container keys are shifted whole —
        offset/start/end must be container-aligned multiples of 2^16.
        """
        for name, v in (("offset", offset), ("start", start), ("end", end)):
            if v & 0xFFFF:
                raise ValueError(f"{name} must be a multiple of 2^16")
        other = Bitmap()
        off_key, hi0, hi1 = highbits(offset), highbits(start), highbits(end)
        for key, c in self.containers.items():
            if hi0 <= key < hi1:
                other.containers[off_key + (key - hi0)] = Container(
                    array=None if c.array is None else c.array.copy(),
                    bitmap=None if c.bitmap is None else c.bitmap.copy(),
                )
        return other

    def sorted_keys(self) -> list[int]:
        return sorted(self.containers.keys())

    def max(self) -> int:
        """Largest value present (0 when empty; roaring.go Max analog)."""
        if not self.containers:
            return 0
        key = max(self.containers)
        vals = self.containers[key].values()
        return (key << 16) | int(vals[-1]) if len(vals) else 0

    # -- set algebra --------------------------------------------------

    def intersect(self, other: "Bitmap") -> "Bitmap":
        out = Bitmap()
        for key in self.containers.keys() & other.containers.keys():
            c = _c_intersect(self.containers[key], other.containers[key])
            if c.n:
                out.containers[key] = c
        return out

    def union(self, other: "Bitmap") -> "Bitmap":
        out = Bitmap()
        for key in self.containers.keys() | other.containers.keys():
            a, b = self.containers.get(key), other.containers.get(key)
            if a is None:
                out.containers[key] = _c_copy(b)
            elif b is None:
                out.containers[key] = _c_copy(a)
            else:
                out.containers[key] = _c_union(a, b)
        return out

    def difference(self, other: "Bitmap") -> "Bitmap":
        out = Bitmap()
        for key, a in self.containers.items():
            b = other.containers.get(key)
            c = _c_copy(a) if b is None else _c_difference(a, b)
            if c.n:
                out.containers[key] = c
        return out

    def intersection_count(self, other: "Bitmap") -> int:
        """|self ∩ other| without materializing (the popcntAndSlice host path)."""
        total = 0
        for key in self.containers.keys() & other.containers.keys():
            total += _c_intersection_count(self.containers[key], other.containers[key])
        return total

    def xor(self, other: "Bitmap") -> "Bitmap":
        out = Bitmap()
        for key in self.containers.keys() | other.containers.keys():
            a, b = self.containers.get(key), other.containers.get(key)
            if a is None:
                out.containers[key] = _c_copy(b)
            elif b is None:
                out.containers[key] = _c_copy(a)
            else:
                c = Container.from_values(np.setxor1d(a.values(), b.values()))
                if c.n:
                    out.containers[key] = c
        return out

    # -- iteration ----------------------------------------------------

    def __iter__(self) -> Iterator[int]:
        for key in self.sorted_keys():
            base = key << 16
            for v in self.containers[key].values():
                yield base | int(v)

    def to_array(self) -> np.ndarray:
        """All values as a sorted uint64 array."""
        keys = self.sorted_keys()
        if not keys:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(
            [self.containers[k].values().astype(np.uint64) | np.uint64(k << 16) for k in keys]
        )

    # -- dense bridge (device boundary) --------------------------------

    def to_dense_words(self, start: int, n_bits: int) -> np.ndarray:
        """Pack values in [start, start+n_bits) into uint32 words.

        The bridge to the device side: a fragment row becomes
        to_dense_words(row*SLICE_WIDTH, SLICE_WIDTH) → uint32[32768].
        Requires container-aligned start and n_bits (multiples of 2^16).
        """
        if start & 0xFFFF:
            raise ValueError("start must be container-aligned")
        if n_bits <= 0 or n_bits & 0xFFFF:
            raise ValueError("n_bits must be a positive multiple of 2^16")
        n_words = n_bits // 32
        out = np.zeros(n_words, dtype=np.uint32)
        k0, k1 = highbits(start), highbits(start + n_bits - 1)
        for key in self.containers.keys():
            if not (k0 <= key <= k1):
                continue
            c = self.containers[key]
            word_off = ((key - k0) << 16) // 32
            if c.bitmap is not None:
                out[word_off : word_off + 2048] = c.bitmap.view(np.uint32)[: 2 * BITMAP_N]
            elif len(c.array):
                v = c.array.astype(np.int64)
                np.bitwise_or.at(
                    out, word_off + (v >> 5), (np.uint32(1) << (v & 31).astype(np.uint32))
                )
        return out

    @classmethod
    def from_dense_words(cls, words: np.ndarray, start: int = 0) -> "Bitmap":
        """Inverse of to_dense_words (start container-aligned)."""
        if start & 0xFFFF:
            raise ValueError("start must be container-aligned")
        bm = cls()
        words = np.ascontiguousarray(words, dtype=np.uint32)
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        positions = np.nonzero(bits)[0].astype(np.uint64) + np.uint64(start)
        bm.add_many(positions)
        return bm

    # -- consistency ---------------------------------------------------

    def check(self) -> None:
        """Invariant check (roaring.go:653-674 Bitmap.Check analog)."""
        for key, c in self.containers.items():
            if key < 0 or key > (1 << 48):
                raise ValueError(f"container key out of range: {key}")
            c.check()

    # -- serialization -------------------------------------------------

    def write_to(self, w) -> int:
        """Serialize in the reference's cookie-12346 format.

        With the native library, snapshots are INCREMENTAL: a C++-side
        mirror keeps every container's encoded payload, Python pushes only
        the keys dirtied since the last write_to, and the full image is
        emitted by one C call — the per-container Python loop (which
        dominated SetBit's amortized cost on sparse fragments) runs only
        over the dirty set.  Fallback: vectorized numpy header building.
        """
        lib = native.load()
        if lib is not None and _NATIVE_LE and self._snap_profitable():
            return self._write_to_native(lib, w)
        if self._snap_handle is not None:
            # Shape drifted out of the profitable regime (e.g. ingest
            # densified the containers): drop the mirror and its memory.
            _snap_release(self._snap_handle)
            self._snap_handle = None
            self._snap_dirty = None
        return self._write_to_python(w)

    def _snap_profitable(self) -> bool:
        """Whether the C++ incremental-snapshot mirror pays for itself.

        The mirror pins an encoded copy of every container in C++ heap,
        and its win is amortizing the per-container Python loop — so it
        pays exactly when containers are MANY and SMALL (sparse
        fragments, the SetBit-hot shape).  Dense shapes (few, 8 KB
        containers) keep the vectorized Python writer: the loop is short
        there and the pinned copies would roughly double resident
        memory.  Sampled, not exact: O(64) per call.
        """
        n = len(self.containers)
        if n < 512:
            return False
        import itertools

        sample = list(itertools.islice(self.containers.values(), 64))
        avg = sum(c.payload_size() for c in sample) / len(sample)
        return avg <= 256.0

    def _write_to_python(self, w) -> int:
        # One pass over sorted keys reading the _ser slot directly: for a
        # mostly-clean bitmap (the steady SetBit state) each container
        # costs one attribute read, not repeated n-property calls.
        keys: list[int] = []
        ns_list: list[int] = []
        conts: list[Container] = []
        for k in self.sorted_keys():
            c = self.containers[k]
            s = c._ser
            cn = s[0] if s is not None else c.n
            if cn > 0:
                keys.append(k)
                ns_list.append(cn)
                conts.append(c)
        n = len(keys)
        written = w.write(np.array([COOKIE, n], dtype="<u4").tobytes())
        if n:
            ns = np.asarray(ns_list, dtype=np.int64)
            meta = np.zeros(n, dtype=[("key", "<u8"), ("n1", "<u4")])
            meta["key"] = np.asarray(keys, dtype=np.uint64)
            meta["n1"] = (ns - 1).astype(np.uint32)
            written += w.write(meta.tobytes())
            sizes = np.where(ns <= ARRAY_MAX_SIZE, ns * 4, BITMAP_N * 8)
            offsets = HEADER_SIZE + n * 16 + np.concatenate(([0], np.cumsum(sizes[:-1])))
            written += w.write(offsets.astype("<u4").tobytes())
            # Payloads are produced lazily (cached for small dirty-tracked
            # arrays, fresh for dense containers) and written in ~8 MB
            # joined chunks: few syscalls, and peak extra memory stays one
            # chunk — never the whole serialized image.
            chunk: list[bytes] = []
            chunk_bytes = 0
            for c in conts:
                s = c._ser
                p = s[1] if s is not None else c.ser()[1]
                chunk.append(p)
                chunk_bytes += len(p)
                if chunk_bytes >= _SNAP_CHUNK:
                    written += w.write(b"".join(chunk))
                    chunk, chunk_bytes = [], 0
            if chunk:
                written += w.write(b"".join(chunk))
        return written

    def _write_to_native(self, lib, w) -> int:
        """Incremental snapshot emit via the C++ mirror (pn_snap_*)."""
        h = self._snap_handle
        if h is None:
            h = lib.pn_snap_new()
            self._snap_handle = h
            import weakref

            weakref.finalize(self, _snap_release, h)
            dirty = list(self.containers.keys())  # first sync: everything
        else:
            dirty = self._snap_dirty
        self._snap_dirty = set()  # tracking live from now on
        containers = self.containers
        snap_set, snap_del = lib.pn_snap_set, lib.pn_snap_del
        for k in dirty:
            c = containers.get(k)
            if c is None:
                snap_del(h, k)
                continue
            n, payload = c.ser()
            if n == 0:
                snap_del(h, k)
            else:
                snap_set(h, k, n, payload, len(payload))
        size = lib.pn_snap_image_size(h)
        buf = np.empty(size, dtype=np.uint8)
        got = lib.pn_snap_emit(h, buf.ctypes.data, size)
        if got != size:  # registry raced a free: fall back, stay correct
            self._snap_handle, self._snap_dirty = None, None
            return self._write_to_python(w)
        w.write(memoryview(buf))
        return size

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write_to(buf)
        return buf.getvalue()

    @classmethod
    def _parse_snapshot(cls, data, zero_copy: bool = False) -> tuple["Bitmap", int]:
        """Strict snapshot-body decode; returns (bitmap, op-log offset).

        ``zero_copy=True`` (little-endian hosts): container payloads become
        READ-ONLY numpy views into ``data`` — pass an ``mmap.mmap`` and the
        open is O(headers); payload bytes page in on first touch and the
        index can exceed host RAM (the reference's mmap attach,
        roaring.go:536-614 + fragment.go:179-234).  Mutations
        copy-on-write per container (Container._writable_bitmap /
        the array insert paths, which already allocate fresh arrays).
        """
        if len(data) < HEADER_SIZE:
            raise ValueError("data too small")
        raw = np.frombuffer(data, dtype=np.uint8)
        zero_copy = zero_copy and _NATIVE_LE
        head = raw[:8].view("<u4")
        if int(head[0]) != COOKIE:
            raise ValueError("invalid roaring file")
        n = int(head[1])
        bm = cls()
        hdr = raw[8 : 8 + n * 12]
        keys = hdr.reshape(n, 12)[:, :8].copy().view("<u8").ravel() if n else np.empty(0, "<u8")
        counts = (hdr.reshape(n, 12)[:, 8:12].copy().view("<u4").ravel() + 1) if n else []
        offsets = raw[8 + n * 12 : 8 + n * 16].view("<u4")
        ops_offset = HEADER_SIZE + n * 16
        for i in range(n):
            key, cnt, off = int(keys[i]), int(counts[i]), int(offsets[i])
            payload = cnt * 4 if cnt <= ARRAY_MAX_SIZE else BITMAP_N * 8
            if off >= len(data) or off + payload > len(data):
                raise ValueError(
                    f"container payload out of bounds: off={off}, need={payload}, len={len(data)}"
                )
            view = raw[off : off + payload]
            if cnt <= ARRAY_MAX_SIZE:
                arr = view.view("<u4") if zero_copy else view.view("<u4").astype(np.uint32)
                c = bm.containers[key] = Container(array=arr)
            else:
                words = view.view("<u8") if zero_copy else view.view("<u8").astype(np.uint64)
                c = bm.containers[key] = Container(bitmap=words)
                c._n = cnt  # header carries the exact cardinality
            ops_offset = off + payload
        return bm, ops_offset

    def _apply_ops(self, types: np.ndarray, values: np.ndarray) -> None:
        for typ, value in zip(types.tolist(), values.tolist()):
            value = int(value)
            if typ == OP_ADD:
                self._container_for(value).add(lowbits(value))
            else:
                c = self.containers.get(highbits(value))
                if c is not None and c.remove(lowbits(value)) and c.n == 0:
                    del self.containers[highbits(value)]
            # analysis-ok: check-then-act: Bitmap is externally synchronized (Roaring-library contract): every mutating call site holds the owning fragment's _mu
            self.op_n += 1

    @classmethod
    def from_bytes(cls, data, zero_copy: bool = False) -> "Bitmap":
        """Decode the reference format, applying any trailing op log.

        Strict: any invalid op record raises (the reference's open
        behavior, roaring.go:590-611).  Crash recovery is the caller's
        policy — see :meth:`from_bytes_recover`.  ``zero_copy``: see
        :meth:`_parse_snapshot` (pass an mmap; containers view it).
        """
        bm, ops_offset = cls._parse_snapshot(data, zero_copy=zero_copy)
        # Trailing op log (roaring.go:590-611); decoded+verified in one
        # native pass when the C++ kernels are available.
        buf = data[ops_offset:]
        if buf:
            types, values = native.oplog_decode(bytes(buf))
            bm._apply_ops(types, values)
        return bm

    @classmethod
    def from_bytes_recover(cls, data, zero_copy: bool = False) -> tuple["Bitmap", int]:
        """Crash-recovery decode: snapshot body strictly, op log leniently.

        A torn tail — the partial or checksum-corrupt record a crash
        mid-append leaves behind — stops the op replay at the last valid
        record instead of failing the open (the reference errors there and
        leaves trimming to hand repair; roaring.go:599-601 FIXME).  The
        snapshot body itself is still parsed strictly: container damage is
        real corruption, not an interrupted append, and must surface.

        Returns ``(bitmap, valid_len)`` where ``valid_len`` is the byte
        length of the recoverable file prefix (snapshot + valid ops); the
        caller truncates the file there to discard the torn tail.
        """
        bm, ops_offset = cls._parse_snapshot(data, zero_copy=zero_copy)
        buf = bytes(data[ops_offset:])
        valid_len = ops_offset
        if buf:
            types, values, valid_bytes = native.oplog_decode_prefix(buf)
            # Tear vs corruption: a crash tears only the TAIL of the log (a
            # partial final append, possibly a lost page of trailing
            # records) — it can never leave VALID records after the bad
            # one.  If any later record still checksums, record boundaries
            # are intact and a mid-log byte flipped: that destroyed acked
            # ops and must surface, not be silently truncated away.
            rest = buf[valid_bytes:]
            for i in range(13, len(rest) - 12, 13):
                try:
                    decode_op(rest[i : i + 13])
                except ValueError:
                    continue
                raise ValueError(
                    f"op log corrupt mid-stream at byte {valid_bytes} "
                    "(valid records follow the damage; refusing to truncate)"
                )
            bm._apply_ops(types, values)
            valid_len += valid_bytes
        return bm, valid_len


def _c_copy(c: Container) -> Container:
    return Container(
        array=None if c.array is None else c.array.copy(),
        bitmap=None if c.bitmap is None else c.bitmap.copy(),
    )


def _c_from_words(words: np.ndarray) -> Container:
    """Wrap a computed dense word array, demoting to an array container only
    when small (no unpack/repack round trip for dense results)."""
    n = _popcount_words(words)
    if n > ARRAY_MAX_SIZE:
        return Container(bitmap=words)
    return Container(array=_bitmap_to_values(words))


def _c_intersect(a: Container, b: Container) -> Container:
    if a.bitmap is not None and b.bitmap is not None:
        return _c_from_words(a.bitmap & b.bitmap)
    if a.is_array and b.is_array:
        return Container(array=np.intersect1d(a.array, b.array).astype(np.uint32))
    arr, bmp = (a, b) if a.is_array else (b, a)
    v = arr.array.astype(np.int64)
    mask = ((bmp.bitmap[v >> 6] >> (v & 63).astype(np.uint64)) & np.uint64(1)).astype(bool)
    return Container(array=arr.array[mask])


def _c_intersection_count(a: Container, b: Container) -> int:
    if a.bitmap is not None and b.bitmap is not None:
        return _popcount_words(a.bitmap & b.bitmap)
    if a.is_array and b.is_array:
        return len(np.intersect1d(a.array, b.array))
    arr, bmp = (a, b) if a.is_array else (b, a)
    v = arr.array.astype(np.int64)
    return int(((bmp.bitmap[v >> 6] >> (v & 63).astype(np.uint64)) & np.uint64(1)).sum())


def _c_union(a: Container, b: Container) -> Container:
    if a.bitmap is not None and b.bitmap is not None:
        return Container(bitmap=a.bitmap | b.bitmap)
    return Container.from_values(np.union1d(a.values(), b.values()))


def _c_difference(a: Container, b: Container) -> Container:
    if a.bitmap is not None and b.bitmap is not None:
        return _c_from_words(a.bitmap & ~b.bitmap)
    if a.is_array:
        if b.is_array:
            return Container(array=np.setdiff1d(a.array, b.array).astype(np.uint32))
        v = a.array.astype(np.int64)
        mask = ((b.bitmap[v >> 6] >> (v & 63).astype(np.uint64)) & np.uint64(1)).astype(bool)
        return Container(array=a.array[~mask])
    # a bitmap, b array
    out = a.bitmap.copy()
    v = b.array.astype(np.int64)
    np.bitwise_and.at(out, v >> 6, ~(np.uint64(1) << (v & 63).astype(np.uint64)))
    return _c_from_words(out)


# ---------------------------------------------------------------------------
# Op-log records (roaring.go:1560-1626)
# ---------------------------------------------------------------------------

_OP_BODY = struct.Struct("<BQ")
_OP_CHK = struct.Struct("<I")


def encode_op(typ: int, value: int) -> bytes:
    body = _OP_BODY.pack(typ, value)
    return body + _OP_CHK.pack(fnv1a32(body))


def decode_op(data: bytes) -> tuple[int, int]:
    if len(data) < OP_SIZE:
        raise ValueError(f"op data out of bounds: len={len(data)}")
    body, chk = data[:9], int(np.frombuffer(data[9:13], dtype="<u4")[0])
    if fnv1a32(body) != chk:
        raise ValueError(f"checksum mismatch: exp={fnv1a32(body):08x}, got={chk:08x}")
    typ = data[0]
    if typ not in (OP_ADD, OP_REMOVE):
        raise ValueError(f"invalid op type: {typ}")
    value = int(np.frombuffer(data[1:9], dtype="<u8")[0])
    return typ, value
