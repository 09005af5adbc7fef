"""Automated group resync: stale and blank replica groups self-heal.

Catch-up alone leaves exactly one manual step in the failure-recovery story: a
group that lagged past ``wal-max-bytes`` was marked STALE and parked
for "operator resync", and a group started on a blank data dir could
only converge by replaying the entire write history bit by bit — if
the WAL even still held it.  This module closes both doors without a
human in the loop:

- DIGEST DIFF: the laggard's content digest (``GET /replica/digest``,
  replica/digest.py) is compared against a healthy caught-up DONOR
  group's; only the differing fragments move.
- FRAGMENT STREAM: each differing fragment ships as its serialized
  roaring payload (``GET /fragment/data`` off the donor, ``POST
  /fragment/import-roaring`` onto the laggard) — compressed container
  form, not bit-by-bit writes — in CRC-framed chunks.  A killed
  transfer RESUMES: the next round probes the laggard's staged offset
  and continues from there, and applying a payload twice is
  idempotent.
- SEED + HANDOFF: once the laggard's bytes match the donor's as of
  ``seed_seq`` (the donor's applied sequence captured BEFORE the
  digest fetch — writes landing during the stream may already be in
  the fetched bytes, and replaying them is the idempotent-re-apply
  contract), the laggard's ``AppliedSeq`` is seeded to ``seed_seq``
  under the router's sequencer lock (a bounded hold, like catch-up's
  locked drain) and the existing WAL catch-up replays the short
  remainder and flips the group back into rotation.  Rejoin therefore
  means *byte-identical + caught up*.  While a round runs, the
  router's WAL compaction is FLOORED at ``seed_seq`` so the handoff
  suffix stays replayable even for a stale group compaction would
  otherwise skip.

Failure is always safe: any aborted round (donor death mid-stream,
torn transfer, epoch bump on the laggard, seed refusal) leaves the
laggard out of rotation with whatever fragments already applied —
strictly closer to the donor — and the next probe retries.  A group
that does not speak the resync protocol (legacy build, lockstep front
end without the import lane) falls back to plain WAL replay when the
log still covers its gap.

The same fragment-stream path repairs DIVERGENCE found by the router's
anti-entropy sweep (router._anti_entropy_once): healthy groups' digests
are compared under the sequencer lock (a consistent cut — no write can
land between the fetches) and any mismatched fragment is repaired from
the majority copy (replica.digest.majority_plan).

Fault sites (replica/faults.py): ``resync.digest`` (digest fetch, key =
group), ``resync.fetch`` (donor fragment fetch, key = donor),
``resync.chunk`` (each chunk push, key = laggard), ``resync.seed``
(the seed-seq exchange, key = laggard) — so torn-transfer,
donor-death-mid-stream, and crash-before-seed orderings replay
deterministically in tier-1.
"""

from __future__ import annotations

import json
import time
import zlib
from typing import Optional

from pilosa_tpu_torch.replica.digest import (
    diff_digests,
    fragment_query,
    parse_fragment_path,
)
from pilosa_tpu_torch.stats import NOP_STATS


class ResyncAbort(Exception):
    """This resync round cannot finish (donor/laggard failure, epoch
    bump, refused chunk); the group stays out of rotation and the next
    probe retries."""


class ResyncUnsupported(ResyncAbort):
    """The laggard does not implement the resync wire protocol (404/405
    on the digest or import endpoints) — fall back to WAL replay when
    the log still covers its gap."""


class ResyncManager:
    """Drives fragment-level resync rounds for the router (probe thread)."""

    def __init__(self, router, wal, stats=None, chunk_bytes: int = 256 << 10,
                 locked_seed_s: float = 5.0, columnar: bool = False,
                 budgets=None):
        self.router = router
        self.wal = wal
        self.stats = stats if stats is not None else NOP_STATS
        # Chunk size of the fragment stream: small enough that a torn
        # transfer loses little, large enough that the per-chunk HTTP
        # round trip amortizes.
        self.chunk_bytes = max(1, chunk_bytes)
        # Adaptive chunk sizing (planner.AdaptiveBudgets): when the
        # router wires one, each push reads the chunk size from the
        # MEASURED stream bandwidth (fed back below) — fast links get
        # larger chunks, slow links keep resume granularity fine.  The
        # configured chunk_bytes stays the static fallback and anchor.
        self.budgets = budgets
        # Bound on the seed-seq exchange under the sequencer lock —
        # same rationale as CatchupManager.locked_drain_s: a laggard
        # that hangs mid-handoff must not stall every write.
        self.locked_seed_s = locked_seed_s
        # Columnar negotiation (PR-18 bulk wire): fragments the laggard
        # lacks ENTIRELY may move as Arrow record batches through its
        # device-build /bulk door — the bulk OR equals replacement only
        # over an empty target, so non-empty targets always take the
        # roaring byte stream.
        self.columnar = columnar

    # -- triggers ---------------------------------------------------------

    def covered(self, g) -> bool:
        """True when the WAL alone can converge ``g``: every live
        record in (applied, head] is still present (nothing it needs
        was compacted away)."""
        if self.wal.last_seq == 0 or g.applied_seq >= self.wal.last_seq:
            return True
        first = self.wal.first_seq
        return first != 0 and g.applied_seq + 1 >= first

    def needed(self, g) -> bool:
        """A probe answer that calls for a RESYNC round instead of
        plain catch-up: the group is stale (the WAL compacted past its
        lag), it reports ``applied_seq == 0`` over a non-empty sequence
        space (a blank data dir — streaming compressed fragments beats
        replaying the whole history write by write), or its gap is no
        longer covered by the log."""
        if g.stale:
            return True
        if self.wal.last_seq == 0:
            return False
        return g.applied_seq == 0 or not self.covered(g)

    # -- wire helpers -----------------------------------------------------

    def _check_epoch(self, g, start_epoch: Optional[str]) -> None:
        """Abort the round if the laggard restarted mid-round (its
        epoch header changed): a fresh incarnation must report its own
        state before absorbing a stream paced against its predecessor —
        the same guard catch-up applies per replayed record."""
        if (start_epoch is not None and g.epoch is not None
                and g.epoch != start_epoch):
            raise ResyncAbort(f"{g.name} restarted mid-resync ({g.epoch})")

    def _digest(self, g, site: str = "resync.digest") -> dict:
        self.router.faults.hit(site, key=g.name)
        status, _ct, payload, _h = self.router._forward(
            g, "GET", "/replica/digest", b"", {}, timeout_s=30.0
        )
        if status in (404, 405, 501):
            raise ResyncUnsupported(f"{g.name} serves no digest (HTTP {status})")
        if status != 200:
            raise ResyncAbort(f"digest fetch from {g.name}: HTTP {status}")
        try:
            return json.loads(payload)
        except ValueError:
            raise ResyncAbort(f"digest fetch from {g.name}: bad payload")

    def _pick_donor(self, exclude):
        """A healthy, caught-up, non-stale group to copy from: highest
        applied sequence wins, ties break to the smallest name (every
        round derives the same donor from the same table)."""
        live = [g for g in self.router._ready_groups() if g is not exclude]
        if not live:
            return None
        return min(live, key=lambda g: (-g.applied_seq, g.name))

    def _push_schema(self, donor_digest: dict, laggard_digest: dict, g,
                     start_epoch) -> None:
        """Create the indexes/frames the laggard is missing, with the
        donor's options (the import lane would create them with
        defaults — option parity matters for time quantum and cache
        shape).  Existing objects answer 409, which is fine."""
        have = {
            i.get("name"): {f.get("name") for f in i.get("frames", [])}
            for i in (laggard_digest.get("schema") or [])
        }
        for idx in donor_digest.get("schema") or []:
            name = idx.get("name")
            if name not in have:
                body = json.dumps({"options": {
                    "columnLabel": idx.get("columnLabel", ""),
                    "timeQuantum": idx.get("timeQuantum", ""),
                }}).encode()
                self._push(g, "POST", f"/index/{name}", body, start_epoch)
            frames_have = have.get(name, set())
            for fr in idx.get("frames", []):
                if fr.get("name") in frames_have:
                    continue
                body = json.dumps({"options": {
                    "rowLabel": fr.get("rowLabel", ""),
                    "inverseEnabled": fr.get("inverseEnabled", False),
                    "cacheType": fr.get("cacheType", ""),
                    "cacheSize": fr.get("cacheSize", 0),
                    "timeQuantum": fr.get("timeQuantum", ""),
                }}).encode()
                self._push(
                    g, "POST", f"/index/{name}/frame/{fr.get('name')}",
                    body, start_epoch,
                )

    def _push(self, g, method: str, path: str, body: bytes, start_epoch,
              ctype: str = "application/json",
              timeout_s: float = 30.0) -> tuple[int, bytes]:
        """One laggard exchange with the epoch guard applied."""
        headers = {"content-type": ctype} if body else {}
        status, _ct, payload, _rh = self.router._forward(
            g, method, path, body, headers, timeout_s=timeout_s
        )
        self._check_epoch(g, start_epoch)
        if status == 409:
            return status, payload  # caller-meaningful (resume / exists)
        if status in (404, 405, 501):
            raise ResyncUnsupported(f"{g.name} {method} {path}: HTTP {status}")
        if status >= 400:
            raise ResyncAbort(f"{g.name} {method} {path}: HTTP {status}")
        return status, payload

    # -- the fragment stream ----------------------------------------------

    def _stream_fragment_columnar(self, donor, g, path_key: str,
                                  start_epoch) -> Optional[int]:
        """Try the negotiated columnar move: fetch the donor fragment
        as Arrow record batches (``/export?format=arrow``) and push the
        stream through the laggard's device-build ``/bulk`` door in ONE
        CRC-framed chunk.  Returns bytes moved, or ``None`` when either
        side declines (no Arrow egress on the donor, no bulk door or
        chunk ceiling on the laggard) — the caller degrades to the
        roaring byte stream.  Only standard-view fragments the laggard
        LACKS are eligible: the bulk door ORs pairs in, which equals
        replacement only over an empty target (and feeds the inverse
        view itself, so inverse fragments never move columnar)."""
        index, frame, view, _slice_i = parse_fragment_path(path_key)
        if view != "standard":
            return None
        qs = fragment_query(path_key)
        self.router.faults.hit("resync.fetch", key=donor.name)
        status, _ct, data, _h = self.router._forward(
            donor, "GET", f"/export?{qs}&format=arrow", b"", {}, timeout_s=60.0
        )
        if status != 200 or not data:
            return None  # no Arrow egress (or empty): roaring path
        total, crc = len(data), zlib.crc32(data)
        base = (f"/index/{index}/frame/{frame}/bulk"
                f"?total={total}&crc={crc}&ccrc={crc}&off=0")
        self.router.faults.hit("resync.chunk", key=g.name)
        try:
            status, payload = self._push(
                g, "POST", base, data, start_epoch,
                ctype="application/vnd.apache.arrow.stream",
                timeout_s=120.0,
            )
        except ResyncAbort:
            # 404/405 (no bulk door), 413 (chunk ceiling), 415 (no
            # pyarrow on the laggard), ...: negotiate down, never
            # abort the round over the optional fast path.
            return None
        try:
            done = bool(json.loads(payload).get("done"))
        except (ValueError, TypeError):
            done = False
        if not done:
            return None
        self.stats.count("replica.resync_fragments")
        self.stats.count("replica.resync_columnar")
        return total

    def _stream_fragment(self, donor, g, path_key: str, start_epoch,
                         laggard_empty: bool = False) -> int:
        """Replace one fragment on ``g`` with the donor's serialized
        roaring payload — chunked, CRC-framed, resumable.  Returns the
        bytes actually pushed (a resumed transfer skips the staged
        prefix).  A donor 404 streams as a CLEAR (total=0): the donor
        no longer holds the fragment, so the laggard's copy empties.

        With columnar negotiation on and an empty target
        (``laggard_empty``), the Arrow fast path is tried first and any
        refusal degrades here."""
        if self.columnar and laggard_empty:
            moved = self._stream_fragment_columnar(
                donor, g, path_key, start_epoch
            )
            if moved is not None:
                return moved
            self.stats.count("replica.resync_columnar_fallback")
        qs = fragment_query(path_key)
        self.router.faults.hit("resync.fetch", key=donor.name)
        status, _ct, data, _h = self.router._forward(
            donor, "GET", f"/fragment/data?{qs}", b"", {}, timeout_s=60.0
        )
        if status == 404:
            data = b""
        elif status != 200:
            raise ResyncAbort(f"fragment fetch {path_key} from {donor.name}: "
                              f"HTTP {status}")
        total, crc = len(data), zlib.crc32(data)
        base = f"/fragment/import-roaring?{qs}&total={total}&crc={crc}"
        # Resume point: where does a previous (killed) transfer stand?
        self.router.faults.hit("resync.chunk", key=g.name)
        _st, payload = self._push(g, "POST", base + "&probe=1", b"", start_epoch)
        off = 0
        try:
            off = int(json.loads(payload).get("staged", 0))
        except (ValueError, TypeError):
            off = 0
        if not (0 <= off <= total):
            off = 0
        sent = 0
        while True:
            step = (
                self.budgets.resync_chunk_bytes()
                if self.budgets is not None
                else self.chunk_bytes
            )
            chunk = bytes(data[off : off + step])
            self.router.faults.hit("resync.chunk", key=g.name)
            t_push = time.perf_counter()
            status, payload = self._push(
                g, "POST", f"{base}&off={off}", chunk, start_epoch,
                ctype="application/octet-stream",
            )
            if self.budgets is not None and chunk:
                # Measured push bandwidth feeds the next chunk's sizing
                # (the "resync" budget lane).
                self.budgets.observe_transfer(
                    "resync", (time.perf_counter() - t_push) * 1e3, len(chunk)
                )
            if status == 409:
                # Offset disagreement: adopt the group's staged size
                # and resume (covers an idempotent re-send after a lost
                # response as well as a restarted transfer).
                try:
                    staged = int(json.loads(payload).get("staged", -1))
                except (ValueError, TypeError):
                    staged = -1
                if 0 <= staged <= total and staged != off:
                    off = staged
                    continue
                raise ResyncAbort(f"chunk at {off} refused by {g.name}: "
                                  f"{payload[:120]!r}")
            sent += len(chunk)
            off += len(chunk)
            try:
                applied = bool(json.loads(payload).get("applied"))
            except (ValueError, TypeError):
                applied = False
            if applied:
                self.stats.count("replica.resync_fragments")
                return sent
            if off >= total:
                raise ResyncAbort(
                    f"transfer of {path_key} to {g.name} completed without apply"
                )

    # -- suspect verification ---------------------------------------------

    def verify(self, g) -> bool:
        """Digest-check a SUSPECT group (it answered a write with a 4xx
        a sibling 2xx'd) against a healthy donor: equal digests clear
        the flag (a retried create legitimately 409s on the groups that
        already applied it); a mismatch drives a full resync round.
        Returns False when the check could not run — the next probe
        retries."""
        donor = self._pick_donor(g)
        if donor is None:
            return False
        try:
            equal = (
                self._digest(donor).get("digest")
                == self._digest(g).get("digest")
            )
        except (OSError, ResyncAbort):
            return False
        if equal:
            with self.router._mu:
                g.suspect = False
            self.stats.count("replica.suspect_cleared")
            return True
        self.stats.count(f"replica.divergence.{g.name}")
        if not self.resync(g):
            return False
        with self.router._mu:
            g.suspect = False
        return True

    # -- the resync round -------------------------------------------------

    def resync(self, g) -> bool:
        """One automated resync round for ``g`` (probe thread).  On
        success the group is byte-identical to the donor as of the seed
        sequence, fully caught up via WAL replay, and back in rotation;
        on any failure it stays out and the next probe retries."""
        router = self.router
        self.stats.count("replica.resync_rounds")
        t0 = time.perf_counter()
        start_epoch = g.epoch
        donor = self._pick_donor(g)
        if donor is None:
            # No healthy caught-up sibling to copy from; plain replay
            # can still finish a covered, non-stale gap.
            if not g.stale and self.covered(g):
                return router.catchup.catch_up(g)
            self.stats.count("replica.resync_abort")
            self.stats.set(
                "replica.last_failure", f"{g.name}: resync needs a donor group"
            )
            return False
        # Every write <= seed_seq is in the bytes we are about to copy
        # (captured BEFORE the digest); later writes may be too —
        # replaying them is the idempotent re-apply contract.
        seed_seq = donor.applied_seq
        # Floor compaction at the seed: the handoff suffix (seed_seq,
        # head] must stay replayable even though a stale g is excluded
        # from the usual min-applied watermark.
        with router._mu:
            router._resync_floor[g.name] = seed_seq
        try:
            donor_digest = self._digest(donor)
            laggard_digest = self._digest(g)
            self._check_epoch(g, start_epoch)
            plan = diff_digests(donor_digest, laggard_digest)
            self._push_schema(donor_digest, laggard_digest, g, start_epoch)
            for name in plan.drop_indexes:
                self._push(g, "DELETE", f"/index/{name}", b"", start_epoch)
            for index, frame in plan.drop_frames:
                self._push(
                    g, "DELETE", f"/index/{index}/frame/{frame}", b"", start_epoch
                )
            sent = 0
            l_frags = laggard_digest.get("fragments") or {}
            for path_key in plan.stream:
                sent += self._stream_fragment(
                    donor, g, path_key, start_epoch,
                    laggard_empty=path_key not in l_frags,
                )
            # SEED under the sequencer lock: no write can be sequenced
            # between "the bytes match seed_seq" and "the applied mark
            # says so", so catch-up's arithmetic is exact.  Bounded
            # hold (locked_seed_s) — a hanging laggard aborts the round
            # instead of stalling every write.
            with router._seq_mu:
                self.router.faults.hit("resync.seed", key=g.name)
                self._push(
                    g, "POST", "/replica/seed-seq",
                    json.dumps({"seq": seed_seq}).encode(), start_epoch,
                    timeout_s=self.locked_seed_s,
                )
                # The sequencer lock serializes the seed against new
                # writes, but applied_seq is TABLE state read by handler
                # threads — the mark itself moves under router._mu.
                from pilosa_tpu_torch.analysis import spec

                with router._mu:
                    g.applied_seq = max(g.applied_seq, seed_seq)
                    spec.emit("seed", src=id(router.wal), group=g.name,
                              epoch=g.epoch, value=g.applied_seq)
            with router._mu:
                g.stale = False
            self.stats.count(f"replica.resync.{g.name}")
            if sent:
                self.stats.count("replica.resync_bytes", sent)
            self.stats.timing(
                "replica.resync_ms", (time.perf_counter() - t0) * 1e3
            )
        except ResyncUnsupported as e:
            # The group has no resync lane (legacy build / lockstep
            # front end): WAL replay still converges a covered gap.
            if not g.stale and self.covered(g):
                with router._mu:
                    router._resync_floor.pop(g.name, None)
                return router.catchup.catch_up(g)
            self.stats.count("replica.resync_abort")
            self.stats.set("replica.last_failure", f"{g.name}: {e}")
            return False
        except (OSError, ResyncAbort) as e:
            # Partial progress is safe progress: any fragment already
            # applied moved the laggard closer to the donor, its
            # applied mark did not move, and the next probe retries
            # (resuming mid-fragment from the staged offset).
            self.stats.count("replica.resync_abort")
            self.stats.set("replica.last_failure",
                           f"{g.name}: resync aborted: {e}")
            return False
        finally:
            with router._mu:
                router._resync_floor.pop(g.name, None)
        # Handoff: replay the (short) missed tail past seed_seq through
        # the normal catch-up, whose phase-2 locked drain flips the
        # group back into rotation.  g is no longer stale, so the
        # compaction watermark now includes it — the tail cannot vanish
        # between here and the drain.
        return router.catchup.catch_up(g)
