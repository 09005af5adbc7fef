"""Sort/segment/scatter bulk build.

A bulk chunk is two uint64 columns (row ids, global column ids).  The
build turns them into packed-uint32 word planes — one ``uint32[W]``
plane per touched (slice, row), ``W = SLICE_WIDTH // 32`` — which is
EXACTLY the engine's device row layout, so a committed plane needs no
further transformation to serve.

Three stages:

1. **sort** — order pairs by (slice, row, local column);
2. **segment** — find the (slice, row) group boundaries (the group
   table is what the fragment commit keys on) and drop duplicate
   positions;
3. **scatter** — OR each position's bit into its group's word plane.

:func:`build_planes_numpy` is the host twin (vectorized sort +
``bitwise_or.reduceat``); :func:`build_planes_torch` is the device lane:
the group table on the host, then one hand-written CUDA kernel
(``kernels.build_planes``) writes every word of the arena on the card
once from the sorted keys.  Both return identical planes for identical
input, as the reference's two lanes do.  :func:`plane_positions` is the fragment's
overlay materialization bridge.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pilosa import SLICE_WIDTH

# Words per (slice, row) plane: the packed-uint32 device row layout.
WORDS_PER_PLANE = SLICE_WIDTH // 32


def group_pairs(rows, cols):
    """Sort + segment: order (row, col) pairs by (slice, row, local) and
    return the group table.

    Returns ``(slice_ids i64[G], row_ids i64[G], gid_sorted i64[N],
    local_sorted i64[N])`` where ``gid_sorted`` maps each sorted pair to
    its dense (slice, row) group and ``local_sorted`` is its in-slice
    column.  The sorted order makes every downstream flat index
    nondecreasing, which is what both scatter lanes lean on.
    """
    rows = np.asarray(rows, dtype=np.uint64)
    cols = np.asarray(cols, dtype=np.uint64)
    if len(rows) != len(cols):
        raise ValueError("row/col length mismatch")
    if len(rows) == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z, z, z
    slices = (cols // np.uint64(SLICE_WIDTH)).astype(np.int64)
    local = (cols % np.uint64(SLICE_WIDTH)).astype(np.int64)
    r = rows.astype(np.int64)
    # The sort is the whole kernel's hot spot.  When (slice, row) fit
    # beside the 20 local bits in one uint64 — every realistic shape;
    # slice and row ids past 2^22 apiece do not — pack the three keys
    # into ONE composite word and radix the VALUES (np.sort, no argsort,
    # no gather): ~20x over the three-pass lexsort on million-pair
    # chunks.  The decomposed fields are exactly the sorted columns.
    sb = int(slices.max()).bit_length()
    rb = int(r.max()).bit_length()
    if sb + rb <= 44:
        key = np.sort(
            (slices.astype(np.uint64) << np.uint64(rb + 20))
            | (r.astype(np.uint64) << np.uint64(20))
            | local.astype(np.uint64)
        )
        ll = (key & np.uint64(SLICE_WIDTH - 1)).astype(np.int64)
        rr = ((key >> np.uint64(20)) & np.uint64((1 << rb) - 1)).astype(
            np.int64
        )
        ss = (key >> np.uint64(rb + 20)).astype(np.int64)
    else:
        order = np.lexsort((local, r, slices))
        ss, rr, ll = slices[order], r[order], local[order]
    newgrp = np.empty(len(ss), dtype=bool)
    newgrp[0] = True
    newgrp[1:] = (ss[1:] != ss[:-1]) | (rr[1:] != rr[:-1])
    gid = np.cumsum(newgrp) - 1
    firsts = np.flatnonzero(newgrp)
    return ss[firsts], rr[firsts], gid, ll


def _nonzero_words(gid, local):
    """Segment+scatter core shared by both host lanes: the UNIQUE flat
    word indices (``gid * W + word``, ascending) and each word's OR'd
    bit value, from the sorted group/local columns."""
    flat = gid * WORDS_PER_PLANE + (local >> 5)
    val = (np.uint32(1) << (local & 31).astype(np.uint32)).astype(np.uint32)
    # ``flat`` is already nondecreasing (sorted by (slice, row, local)),
    # so the word boundaries are plain diffs — no np.unique re-sort.
    start = np.flatnonzero(
        np.concatenate([np.ones(1, dtype=bool), flat[1:] != flat[:-1]])
    )
    return flat[start], np.bitwise_or.reduceat(val, start)


def build_planes_numpy(rows, cols):
    """Host build twin: ``(slice_ids, row_ids, planes uint32[G, W])``.

    ``bitwise_or.reduceat`` over the sorted flat word index does the
    segment+scatter in two vectorized passes (duplicate positions OR
    harmlessly, so no explicit dedup pass is needed on host).
    """
    slice_ids, row_ids, gid, local = group_pairs(rows, cols)
    g = len(slice_ids)
    planes = np.zeros((g, WORDS_PER_PLANE), dtype=np.uint32)
    if g == 0:
        return slice_ids, row_ids, planes
    uf, orv = _nonzero_words(gid, local)
    planes[uf // WORDS_PER_PLANE, uf % WORDS_PER_PLANE] = orv
    return slice_ids, row_ids, planes


def build_words_numpy(rows, cols):
    """Sparse host lane: ``(slice_ids, row_ids, counts, word_idx,
    word_vals)`` — the SAME planes as :func:`build_planes_numpy`, in
    CSR form over their nonzero words (``counts[i]`` words belong to
    group ``i``; ``word_idx`` is each word's in-plane index, unique and
    ascending within a group; ``word_vals`` its OR'd uint32 value).

    This is what the commit path wants on host: a chunk's pairs touch
    a few hundred words per plane, so materializing (and then OR-ing)
    full 32768-word planes per chunk is almost all page traffic for
    zeros.  ``Fragment.bulk_or_words`` scatters exactly these words
    into the persistent overlay instead.
    """
    slice_ids, row_ids, gid, local = group_pairs(rows, cols)
    if len(slice_ids) == 0:
        z = np.empty(0, dtype=np.int64)
        return slice_ids, row_ids, z, z, np.empty(0, dtype=np.uint32)
    uf, orv = _nonzero_words(gid, local)
    counts = np.bincount(uf // WORDS_PER_PLANE, minlength=len(slice_ids))
    return (slice_ids, row_ids, counts.astype(np.int64),
            uf % WORDS_PER_PLANE, orv)


def build_planes_torch(rows, cols, device="cuda"):
    """Device build lane: same contract as :func:`build_planes_numpy`.
    The group table is computed on the host (the fragment commit needs
    host ids regardless); each sorted pair's key ``gid * SLICE_WIDTH +
    local`` (ascending: ``group_pairs``' order) is uploaded and
    ``kernels.build_planes`` builds the ``[G, W]`` arena on ``device``
    (its plain version on the CPU), which is copied back.  The kernel's
    order check costs no launch and no wait: its descent flags come back
    in the same copy as the planes and raise here.  Exact shapes: no
    padding, since eager torch keeps no compile cache to keep stable."""
    slice_ids, row_ids, gid, local = group_pairs(rows, cols)
    g = len(slice_ids)
    if g == 0:
        return slice_ids, row_ids, np.zeros((0, WORDS_PER_PLANE), np.uint32)
    keys = torch.from_numpy(gid * SLICE_WIDTH + local).to(device)
    planes, descents = kernels.build_planes(keys, g)
    if planes.is_cuda:
        # The planes come back through pinned memory: 33.5 MB of planes
        # took 0.64 ms so and 14.5 ms by a pageable copy from an H100
        # (chip_smoke.py's build_times).
        whole = kernels.planes_and_descents(planes, descents)
        host = torch.empty(whole.shape, dtype=whole.dtype, pin_memory=True)
        host.copy_(whole)
        n = planes.numel()
        kernels.raise_on_descent(host[n:].numpy())
        host = host[:n].view(planes.shape)
    else:
        kernels.raise_on_descent(descents.numpy())
        host = planes
    # The words' bits, not their values: int32 read back as uint32.
    return slice_ids, row_ids, host.numpy().view(np.uint32)


def plane_positions(words: np.ndarray, base: int = 0) -> np.ndarray:
    """Set-bit positions of a packed-uint32 plane (uint64, ascending),
    offset by ``base`` — the dense→roaring bridge used by overlay
    materialization and the Arrow egress (matches
    ``roaring.Bitmap.from_dense_words`` bit order).
    """
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint64) + np.uint64(base)
