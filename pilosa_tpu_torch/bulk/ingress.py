"""Bulk build commit lane: decoded columns -> fragment word planes.

This is the apply half of the device-first bulk door
(``POST /index/<i>/frame/<f>/bulk``).  One chunk's (row, col) columns
run through the engine's sort/segment/scatter build (bulk/build.py) —
on the torch engine the bits pack on the card (csrc/build_planes.cu) —
and the resulting planes commit into fragments per (view, slice) as a
pending dense overlay (``Fragment.bulk_set_planes``).  No roaring
container is touched here: containers and rank caches materialize
lazily (bulk/lazy.py) on the first snapshot/sync/digest/mutation
touch, or opportunistically at transfer completion under the
``[bulk] materialize-budget-ms`` budget.

The HTTP handler drives these functions.
"""

from __future__ import annotations

import time

import numpy as np

from pilosa_tpu_torch.bulk.build import build_words_numpy
from pilosa_tpu_torch.stats import NOP_STATS


def _commit_view(view, rows, cols, engine=None, batch_slices: int = 8,
                 deadline=None) -> int:
    """Build one view's orientation and commit it per slice.
    ``batch_slices`` bounds how many slice fragments commit between
    deadline checks (and how much transient build memory one iteration
    pins).  Returns the number of (slice, row) planes committed.

    Two commit lanes, same semantics: engines exposing ``build_words``
    (host/numpy) commit sparse — only each plane's touched words
    scatter into the overlay; engines whose scatter output is born
    dense on device (``build_planes``, the torch engine) commit whole
    planes."""
    build_words = (
        getattr(engine, "build_words", None)
        if engine is not None else build_words_numpy
    )
    if build_words is not None:
        slice_ids, row_ids, counts, widx, wvals = build_words(rows, cols)
        offs = np.concatenate(
            [np.zeros(1, dtype=np.int64), np.cumsum(counts)]
        )
    else:
        slice_ids, row_ids, planes = engine.build_planes(rows, cols)
    if len(slice_ids) == 0:
        return 0
    # group_pairs orders groups by (slice, row): one boundary scan
    # yields each slice's contiguous plane block.
    uniq, starts = np.unique(slice_ids, return_index=True)
    bounds = list(starts.tolist()) + [len(slice_ids)]
    batch_slices = max(1, int(batch_slices))
    committed = 0
    for i, s in enumerate(uniq.tolist()):
        if deadline is not None and i % batch_slices == 0 and i:
            deadline.check("bulk commit")
        lo, hi = bounds[i], bounds[i + 1]
        frag = view.create_fragment_if_not_exists(int(s))
        if build_words is not None:
            committed += frag.bulk_or_words(
                row_ids[lo:hi], counts[lo:hi],
                widx[offs[lo]:offs[hi]], wvals[offs[lo]:offs[hi]],
            )
        else:
            committed += frag.bulk_set_planes(row_ids[lo:hi], planes[lo:hi])
    return committed


def apply_bulk(frame, rows, cols, engine=None, executor=None, index: str = "",
               deadline=None, batch_slices: int = 8, stats=None) -> int:
    """Apply one decoded bulk chunk: device build + overlay commit for
    the standard view (and the inverse view with the columns swapped,
    mirroring the streamed door's fan-out), executor dirty-row notes so
    warm serve state patches instead of rebuilding.  Returns the pair
    count applied (the overlay OR cannot know which bits were new — the
    changed count the streamed door reports — without a dense read per
    row, which would defeat the device-first build)."""
    stats = stats if stats is not None else NOP_STATS
    t0 = time.perf_counter()
    rows = np.asarray(rows, dtype=np.uint64)
    cols = np.asarray(cols, dtype=np.uint64)
    from pilosa_tpu_torch.core.view import VIEW_INVERSE, VIEW_STANDARD

    std = frame.create_view_if_not_exists(VIEW_STANDARD)
    _commit_view(std, rows, cols, engine=engine, batch_slices=batch_slices,
                 deadline=deadline)
    if deadline is not None:
        deadline.check("bulk apply")
    if frame.inverse_enabled:
        inv = frame.create_view_if_not_exists(VIEW_INVERSE)
        _commit_view(inv, cols, rows, engine=engine,
                     batch_slices=batch_slices, deadline=deadline)
    if executor is not None and len(rows):
        executor.note_external_write(
            index, frame.name, np.unique(rows).tolist()
        )
    stats.count("bulk.pairs", int(len(rows)))
    stats.timing("bulk.build", time.perf_counter() - t0)
    return int(len(rows))


def complete_bulk(frame, budget_ms: float = 0.0) -> None:
    """Transfer-completion hook: rank caches fresh NOW (import parity —
    the rankings seed from merged overlay counts, still lazily), then
    an opportunistic overlay->roaring drain under ``budget_ms`` (0 =
    stay fully lazy)."""
    from pilosa_tpu_torch.bulk.lazy import LEDGER
    from pilosa_tpu_torch.ingest import recalc_frame_caches

    recalc_frame_caches(frame)
    LEDGER.materialize_some(budget_ms)
