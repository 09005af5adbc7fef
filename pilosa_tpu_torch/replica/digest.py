"""Replica digest protocol: a compact content fingerprint of one group.

The replica tier's convergence story (PRs 6-7) is ORDER-based: every
group applies the same total order of writes, so equal applied
sequences should mean equal bytes.  "Should" is not a verification —
an ambiguous 502 partial write replayed differently, a data dir
restored from an old backup, or a plain bug diverges a group silently,
and nothing notices until two replicas answer the same read
differently.  This module is the CONTENT half of convergence: each
group can be asked (``GET /replica/digest``, served by the HTTP
handler and the lockstep front end — rank 0 computes over replicated
state, so every rank agrees by construction) for a per-(index, frame,
view, slice) tree of fragment checksums plus the schema header, and
two groups holding identical logical bits produce byte-identical
digests regardless of the write path that built them (the reference's
holder syncer makes the same promise per fragment with its block
checksums, fragment.go:681-920 — this promotes it to whole groups).

Digest shape (JSON)::

    {
      "digest":    "<sha1 hex over schema + every fragment entry>",
      "schema":    [<holder.schema() — the index/frame option tree>],
      "fragments": {"<index>/<frame>/<view>/<slice>": "<sha1 hex>", ...}
    }

- The flat ``fragments`` map keys sort lexically and diff trivially;
  EMPTY fragments are omitted, so "fragment never created" and
  "fragment cleared to zero bits" — which serve identical answers —
  digest identically (anti-entropy repair relies on this: clearing a
  divergent extra fragment converges the digests).
- The top-level ``digest`` makes the common all-equal sweep one string
  compare; the map is only walked when it differs.
- Determinism: iteration is sorted at every level and
  ``Fragment.checksum()`` is a pure function of the logical bit set
  (position-bound block hashes, write-order independent — the property
  tests/test_fragment_stateful.py pins), so the digest is a pure
  function of (schema, bits).
"""

from __future__ import annotations

import hashlib
import json
from typing import NamedTuple, Optional

#: Checksum of a fragment with no bits (sha1 over zero blocks) — such
#: fragments are omitted from the digest (see module docstring).
EMPTY_FRAGMENT_CHECKSUM = hashlib.sha1().digest()


def fragment_path(index: str, frame: str, view: str, slice_i: int) -> str:
    """Digest-map key for one fragment (names never contain ``/``)."""
    return f"{index}/{frame}/{view}/{slice_i}"


def parse_fragment_path(path: str) -> tuple[str, str, str, int]:
    index, frame, view, slice_s = path.split("/")
    return index, frame, view, int(slice_s)


def fragment_query(path: str) -> str:
    """The ``?index=..&frame=..&view=..&slice=..`` query string for the
    fragment-data / import-roaring endpoints."""
    index, frame, view, slice_i = parse_fragment_path(path)
    return f"index={index}&frame={frame}&view={view}&slice={slice_i}"


def holder_digest(holder) -> dict:
    """Compute one group's digest over its live holder (see module
    docstring for the shape).  Sorted at every level; empty fragments
    omitted."""
    fragments: dict[str, str] = {}
    for idx_name, idx in sorted(holder.indexes.items()):
        for f_name, frame in sorted(idx.frames.items()):
            for v_name, view in sorted(frame.views.items()):
                for slice_i, frag in sorted(view.fragments.items()):
                    chk = frag.checksum()
                    if chk == EMPTY_FRAGMENT_CHECKSUM:
                        continue
                    fragments[fragment_path(idx_name, f_name, v_name, slice_i)] = (
                        chk.hex()
                    )
    schema = holder.schema()
    h = hashlib.sha1()
    h.update(json.dumps(schema, sort_keys=True, separators=(",", ":")).encode())
    for path in sorted(fragments):
        h.update(path.encode())
        h.update(fragments[path].encode())
    return {"digest": h.hexdigest(), "schema": schema, "fragments": fragments}


class DigestDiff(NamedTuple):
    """Donor-vs-laggard fragment plan (resync direction: make the
    laggard's bytes the donor's)."""

    #: Fragment paths to stream donor -> laggard: present on the donor
    #: but missing or differing on the laggard, plus laggard extras
    #: whose (index, frame) still exists on the donor (the donor's 404
    #: streams as a clear).
    stream: list[str]
    #: Index names the laggard holds that the donor does not (delete).
    drop_indexes: list[str]
    #: (index, frame) pairs the laggard holds inside donor indexes that
    #: the donor does not (delete).
    drop_frames: list[tuple[str, str]]


def _schema_tree(schema: list) -> dict[str, set[str]]:
    return {
        i.get("name", ""): {f.get("name", "") for f in i.get("frames", [])}
        for i in (schema or [])
    }


def diff_digests(donor: dict, laggard: dict) -> DigestDiff:
    """The resync plan that converges ``laggard`` onto ``donor``."""
    d_frags = donor.get("fragments") or {}
    l_frags = laggard.get("fragments") or {}
    d_tree = _schema_tree(donor.get("schema"))
    l_tree = _schema_tree(laggard.get("schema"))
    stream = [p for p in sorted(d_frags) if l_frags.get(p) != d_frags[p]]
    drop_indexes = sorted(set(l_tree) - set(d_tree))
    drop_frames = sorted(
        (i, f)
        for i, frames in l_tree.items()
        if i in d_tree
        for f in frames - d_tree[i]
    )
    # Laggard extras inside surviving (index, frame) pairs: the donor
    # answers 404 for them and the stream path clears them.
    dropped = set(drop_indexes)
    dropped_frames = set(drop_frames)
    for p in sorted(set(l_frags) - set(d_frags)):
        index, frame, _view, _s = parse_fragment_path(p)
        if index in dropped or (index, frame) in dropped_frames:
            continue
        stream.append(p)
    return DigestDiff(stream, drop_indexes, drop_frames)


class RepairPlan(NamedTuple):
    """Anti-entropy repair plan across N healthy groups."""

    #: group name -> sorted fragment paths to repair on it.
    divergent: dict[str, list[str]]
    #: fragment path -> donor group name holding the winning copy.
    donor: dict[str, str]
    #: First differing path (lexically) — the structured divergence
    #: log's pointer at WHERE the groups disagree.
    first_path: Optional[str]


def majority_plan(digests: dict[str, dict]) -> RepairPlan:
    """Compare the healthy groups' digests; for every divergent
    fragment path the MAJORITY copy wins (ties break to the copy held
    by the lexically smallest group name, so every router instance
    derives the same plan) and minority holders are scheduled for
    repair.  A majority that LACKS the fragment wins too: the plan
    streams a clear (the donor's 404) to the holders."""
    names = sorted(digests)
    all_paths = sorted({p for d in digests.values() for p in (d.get("fragments") or {})})
    divergent: dict[str, list[str]] = {}
    donor: dict[str, str] = {}
    first_path: Optional[str] = None
    for path in all_paths:
        held = {n: (digests[n].get("fragments") or {}).get(path) for n in names}
        values = set(held.values())
        if len(values) == 1:
            continue
        if first_path is None:
            first_path = path
        counts: dict[Optional[str], int] = {}
        for v in held.values():
            counts[v] = counts.get(v, 0) + 1
        # Majority copy; ties -> the copy held by the smallest group
        # name (deterministic across routers and runs).
        winner = min(
            counts,
            key=lambda v: (
                -counts[v],
                min(n for n in names if held[n] == v),
            ),
        )
        donor_name = min(n for n in names if held[n] == winner)
        for n in names:
            if held[n] != winner:
                divergent.setdefault(n, []).append(path)
                donor.setdefault(path, donor_name)
    return RepairPlan(divergent, donor, first_path)
