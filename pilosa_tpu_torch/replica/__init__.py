"""Replicated serving groups: read fan-out over a 2-D (slice x replica) mesh.

No single reference analog — the reference's ReplicaN (cluster.go:220-240)
replicates FRAGMENTS across ring nodes inside one cluster and lets the
executor pick any owner at query time (executor.go:1147-1159).  Here the
unit of replication is a whole SERVING GROUP: each group is a full
LockstepService-style unit (or a plain Server on dev rigs) owning a
complete copy of every slice, and a front-end ROUTER fans reads across
groups — read QPS grows with group count while one lockstep group's
semantics stay exactly what the stack already proved.

Pieces:

- :mod:`pilosa_tpu_torch.replica.router` — :class:`ReplicaRouter`, the HTTP
  front door: classifies requests with the QoS classifier, routes READS
  to the least-inflight healthy group (one-shot failover to a sibling
  on connect/5xx failure), and ships WRITES total-ordered to ALL groups
  through one sequencer so every group's fragment generation vectors
  advance identically — which is what keeps each group's qcache and
  serve-state machinery read-your-writes correct with zero new
  invalidation traffic.
- :mod:`pilosa_tpu_torch.replica.mesh` — device-mesh construction for the
  group's device plane: 2-D ``(slice, replica)`` over the ranks of a
  ``torch.distributed`` job, one replica group per host when the job
  spans hosts, with a flat layout for a job on one host, so CPU/test
  environments run the same code.

GROUP IDENTITY: every serving group carries a ``group`` name and an
integer ``group epoch`` (bumped on each job restart).  The identity
rides every HTTP response as the ``X-Pilosa-Group: <name>@<epoch>``
header (the router records it and counts epoch bumps) and every
lockstep control-plane batch entry as a ``gepoch`` field (workers
fail-stop on a mismatch — a stale rank 0 from a previous incarnation
can never feed entries to restarted workers).  An epoch bump tells the
router the group's IN-MEMORY state (generation vectors, qcache) was
rebuilt from disk; nothing cross-group needs invalidating because no
cache entry ever crosses a group boundary.

DURABILITY & RECOVERY: the router sequences every accepted
write into a WRITE-AHEAD LOG (:mod:`pilosa_tpu_torch.replica.wal`) before
fan-out, commits on a DEGRADED QUORUM (majority of groups), and
re-converges down/lagging groups by streaming them the missed WAL
suffix (:mod:`pilosa_tpu_torch.replica.catchup`) — a single dead group no
longer halts ingest cluster-wide.  Each group tracks and reports its
last-applied write sequence (``X-Pilosa-Applied-Seq`` beside
``X-Pilosa-Group``, plus the ``/replica/health`` JSON); only a fully
caught-up group serves reads.  Partial-failure orderings are
reproducible through the deterministic fault seam
(:mod:`pilosa_tpu_torch.replica.faults`, ``PILOSA_TPU_FAULT_SPEC``).

RESYNC & ANTI-ENTROPY: stale and blank groups SELF-HEAL — the
probe keeps visiting stale groups (at ``probe-max-interval``) and
drives an automated resync round (:mod:`pilosa_tpu_torch.replica.resync`):
content-digest diff (:mod:`pilosa_tpu_torch.replica.digest`, ``GET
/replica/digest``) against a healthy donor, differing fragments
streamed as serialized roaring payloads (chunked, CRC-framed,
resumable), applied-sequence seeded under the sequencer lock, WAL
catch-up for the final locked drain.  A background anti-entropy sweep
(``[replica] anti-entropy-interval``, off by default) compares healthy
groups' digests and repairs silent divergence from the majority copy
(``replica.divergence.<g>``).

Config: ``[replica] group / groups / router-port / failover /
probe-interval / probe-max-interval / wal-dir / wal-max-bytes /
anti-entropy-interval / resync-chunk-bytes`` TOML keys with
``PILOSA_TPU_REPLICA_*`` env overrides, wired through ``pilosa-tpu
replica-router`` and the lockstep CLI.
"""

from __future__ import annotations

# Response header carrying the serving group's identity ("name@epoch"):
# set by every group front door, read back by the router (epoch-bump
# detection) and by clients that want to know which replica answered.
GROUP_HEADER = "X-Pilosa-Group"

# Request header carrying the router-assigned WAL sequence number of a
# write (fan-out and catch-up replays alike); the group notes it as its
# applied high-water mark once the route answers deterministically.
WRITE_SEQ_HEADER = "X-Pilosa-Write-Seq"

# Response header: the group's last-applied write sequence, stamped
# beside X-Pilosa-Group on every response — the router's passive lag
# tracking (the /replica/health JSON carries the same number for the
# probe).
APPLIED_SEQ_HEADER = "X-Pilosa-Applied-Seq"

# Request header marking a catch-up replay (vs a live client write):
# groups tag sampled trace roots ``replay=true`` so replayed traffic is
# distinguishable at /debug/traces.
REPLAY_HEADER = "X-Pilosa-Replay"


def write_not_applied(status: int, retry_after=None) -> bool:
    """THE one predicate for "did this sequenced write LAND on the
    group?", shared by the router's write fan-out, the catch-up
    replay, and the group-side applied-mark bookkeeping so no path can
    disagree with another about a write's fate.  NOT applied: a 429,
    any 5xx, or any other answer carrying Retry-After (the admission
    door's shed shape even when the status is not 429) — all
    load/fault-dependent, so the write must stay replayable.  Applied:
    2xx, and deterministic 4xx (parse/schema errors answer identically
    on every group — replaying them only re-answers the same error)."""
    return status == 429 or status >= 500 or bool(retry_after)


def parse_group(spec: str) -> tuple[str, int]:
    """Split a ``name[@epoch]`` group identity; epoch defaults to 0."""
    spec = (spec or "").strip()
    name, _, epoch = spec.partition("@")
    try:
        return name, int(epoch or 0)
    except ValueError:
        return name, 0


def format_group(name: str, epoch: int = 0) -> str:
    return f"{name}@{int(epoch)}" if name else ""


def __getattr__(name):
    # PEP 562 lazy export: keep this package importable from the handler
    # and client modules without pulling the router's qos/trace imports
    # at module-import time (same contract as pilosa_tpu_torch/parallel).
    if name in ("ReplicaRouter", "GroupState", "router_from_config"):
        from pilosa_tpu_torch.replica import router as _router

        return getattr(_router, name)
    if name in ("WriteAheadLog", "WalRecord"):
        from pilosa_tpu_torch.replica import wal as _wal

        return getattr(_wal, name)
    if name in ("AppliedSeq", "CatchupManager", "note_applied_from_headers"):
        from pilosa_tpu_torch.replica import catchup as _catchup

        return getattr(_catchup, name)
    if name in ("FaultInjector", "FaultError", "InjectedStatus", "NOP_FAULTS"):
        from pilosa_tpu_torch.replica import faults as _faults

        return getattr(_faults, name)
    if name in ("ResyncManager", "ResyncAbort", "ResyncUnsupported"):
        from pilosa_tpu_torch.replica import resync as _resync

        return getattr(_resync, name)
    if name in ("holder_digest", "diff_digests", "majority_plan",
                "fragment_path", "parse_fragment_path"):
        from pilosa_tpu_torch.replica import digest as _digest

        return getattr(_digest, name)
    if name == "build_group_mesh":
        from pilosa_tpu_torch.replica.mesh import build_group_mesh

        return build_group_mesh
    if name in ("Shard", "ShardMap", "ShardMapError", "parse_shard_map",
                "single_shard_map", "uniform_shard_map"):
        from pilosa_tpu_torch.replica import shards as _shards

        return getattr(_shards, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
