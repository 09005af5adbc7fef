"""(row, column) iterators over bitmap data.

Reference analog: iterator.go — the ``Iterator`` interface (iterator.go:24-27)
with ``Seek``/``Next``, plus the concrete kinds: ``BufIterator`` (unread
support, iterator.go:30-79), ``LimitIterator`` (iterator.go:82-119),
``SliceIterator`` over materialized pairs (iterator.go:122-172), and
``RoaringIterator`` mapping linear bit positions to (row, col) via
SliceWidth (iterator.go:175-194).

The hot paths here are vectorized (fragment.merge_block and import work on
whole numpy position arrays at once), so these iterators serve the same
role as the reference's: a small composable streaming layer for
host-side consumers (k-way merges, paging, export) where materializing is
wasteful.  ``next()`` returns ``(row, col)`` or ``None`` at exhaustion
instead of Go's ``(row, col, eof)`` triple.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pilosa_tpu_torch.pilosa import SLICE_WIDTH

Pair = Tuple[int, int]


class SliceIterator:
    """Iterate a materialized (rows, cols) pair of arrays in order
    (iterator.go:122-172)."""

    def __init__(self, rows, cols):
        rows = np.asarray(rows, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.uint64)
        if rows.shape != cols.shape:
            raise ValueError("rows/cols length mismatch")
        # Keep (row, col) lexicographic order — the merge invariant.
        order = np.lexsort((cols, rows))
        self._rows = rows[order]
        self._cols = cols[order]
        self._i = 0

    def seek(self, row: int, col: int) -> None:
        """Position at the first pair >= (row, col) (iterator.go:137-151)."""
        key = int(row) * SLICE_WIDTH + int(col)
        keys = self._rows * np.uint64(SLICE_WIDTH) + self._cols
        self._i = int(np.searchsorted(keys, np.uint64(key), side="left"))

    def next(self) -> Optional[Pair]:
        if self._i >= len(self._rows):
            return None
        p = (int(self._rows[self._i]), int(self._cols[self._i]))
        # analysis-ok: check-then-act: iterators are per-execution objects, owned by one thread
        self._i += 1
        return p


class RoaringIterator:
    """Iterate a roaring bitmap of linear positions as (row, col) pairs
    (iterator.go:175-194: pos = row*SliceWidth + col)."""

    def __init__(self, bitmap):
        self._positions = bitmap.to_array()
        self._i = 0

    def seek(self, row: int, col: int) -> None:
        key = np.uint64(int(row) * SLICE_WIDTH + int(col))
        self._i = int(np.searchsorted(self._positions, key, side="left"))

    def next(self) -> Optional[Pair]:
        if self._i >= len(self._positions):
            return None
        pos = int(self._positions[self._i])
        # analysis-ok: check-then-act: iterators are per-execution objects, owned by one thread
        self._i += 1
        return pos // SLICE_WIDTH, pos % SLICE_WIDTH


class BufIterator:
    """Wraps an iterator with a one-element pushback buffer
    (iterator.go:30-79) — the k-way merge primitive."""

    def __init__(self, it):
        self._it = it
        self._buf: Optional[Pair] = None

    def seek(self, row: int, col: int) -> None:
        self._buf = None
        self._it.seek(row, col)

    def next(self) -> Optional[Pair]:
        if self._buf is not None:
            p, self._buf = self._buf, None
            return p
        return self._it.next()

    def peek(self) -> Optional[Pair]:
        if self._buf is None:
            self._buf = self._it.next()
        return self._buf

    def unread(self, pair: Pair) -> None:
        if self._buf is not None:
            raise RuntimeError("unread buffer full")
        self._buf = pair


class LimitIterator:
    """Stops after yielding pairs at or past a row limit
    (iterator.go:82-119)."""

    def __init__(self, it, max_row: int):
        self._it = it
        self._max_row = max_row
        self._eof = False

    def seek(self, row: int, col: int) -> None:
        self._eof = False
        self._it.seek(row, col)

    def next(self) -> Optional[Pair]:
        if self._eof:
            return None
        p = self._it.next()
        if p is None:
            self._eof = True
            return None
        if p[0] > self._max_row:
            # Push the boundary pair back (iterator.go:103-108) so a shared
            # underlying iterator (k-way merge composition) doesn't lose it.
            if hasattr(self._it, "unread"):
                self._it.unread(p)
            self._eof = True
            return None
        return p


def merge_iterators(iterators) -> "SliceIterator":
    """K-way merge of (row, col) iterators into one deduplicated stream —
    the shape fragment.go:812-828 builds for MergeBlock, vectorized."""
    rows, cols = [], []
    for it in iterators:
        while True:
            p = it.next()
            if p is None:
                break
            rows.append(p[0])
            cols.append(p[1])
    if not rows:
        return SliceIterator([], [])
    keys = np.unique(
        np.asarray(rows, dtype=np.uint64) * np.uint64(SLICE_WIDTH)
        + np.asarray(cols, dtype=np.uint64)
    )
    return SliceIterator(keys // np.uint64(SLICE_WIDTH), keys % np.uint64(SLICE_WIDTH))
