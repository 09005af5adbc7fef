"""The replica shard map: contiguous slice ranges x replica sets.

A plain replica tier scales READ QPS — every group holds a full copy
of every slice, so capacity and write throughput stay flat as groups
are added.  The shard map is the 2-D upgrade: the slice space is
partitioned into contiguous ranges (shards), each shard owns its own
replica set and its own write sequence space, and the router fans a
query out by SLICE COVER exactly like the executor's cluster fan-out
(``cluster.slices_by_node``) — each slice belongs to exactly one
owner, the union over owners is exactly the query's slice set, and a
query touching K shards costs K forwards.

Why contiguous ranges rather than the executor's hash ring: the
router's unit of REBALANCING is a range split (stream the upper half's
fragments, flip ownership behind an epoch fence — ``/replica/reshard``),
and a contiguous range moves as one fragment interval instead of a
scatter of ring partitions.  The COVER semantics are identical either
way (exact, minimal, one owner per slice); the property tests pin the
agreement against ``cluster.slices_by_node``.

Map shapes:

- **single shard** (the default, and exactly the unpartitioned behavior): one
  shard named ``s0`` covering ``[0, inf)`` with every group.
- **uniform auto-split** (``[replica] shards = N`` +
  ``shard-span = W``): N shards, shard i covering
  ``[i*W, (i+1)*W)`` (the last open-ended), the flat group list split
  into N consecutive chunks.
- **explicit map** (``[replica] shard-map``)::

      s0=0-3:g0=h:p,g1=h:p;s1=4-:g2=h:p,g3=h:p

  ``;`` separates shards, each ``name=lo-hi:groups`` with ``hi``
  omitted for open-ended and groups comma-separated (each group spec
  is the router's usual ``name=host:port`` / ``host:port``).

Validation (the config satellite's contract): ranges sorted, first at
slice 0, contiguous with no gaps or overlaps, exactly one open-ended
tail — every slice covered exactly once — and every shard holding at
least one group, with shard and group names unique across the map.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Optional

#: Default width (in slices) of each shard under uniform auto-split.
DEFAULT_SHARD_SPAN = 256


class ShardMapError(ValueError):
    """An invalid shard map (gap, overlap, empty shard, bad spec)."""


class Shard:
    """One shard: a contiguous slice range and its replica set."""

    __slots__ = ("name", "lo", "hi", "group_specs")

    def __init__(self, name: str, lo: int, hi: Optional[int],
                 group_specs: list):
        self.name = name
        self.lo = lo
        self.hi = hi  # exclusive; None = open-ended
        self.group_specs = list(group_specs)

    def owns(self, slice_i: int) -> bool:
        return slice_i >= self.lo and (self.hi is None or slice_i < self.hi)

    def range_json(self) -> dict:
        return {"lo": self.lo, "hi": self.hi}

    def __repr__(self) -> str:
        hi = "" if self.hi is None else self.hi
        return f"Shard({self.name}, [{self.lo},{hi}), {self.group_specs})"


def _parse_group_name(i: int, spec: str) -> str:
    spec = spec.strip()
    if "=" in spec and "://" not in spec.split("=", 1)[0]:
        return spec.split("=", 1)[0].strip()
    return f"g{i}"


class ShardMap:
    """The validated shard table: every slice covered exactly once."""

    def __init__(self, shards: list):
        if not shards:
            raise ShardMapError("shard map needs at least one shard")
        shards = sorted(shards, key=lambda s: s.lo)
        names = [s.name for s in shards]
        if len(set(names)) != len(names):
            raise ShardMapError(f"duplicate shard names in {names}")
        if shards[0].lo != 0:
            raise ShardMapError(
                f"shard map must start at slice 0 (first shard "
                f"{shards[0].name} starts at {shards[0].lo})"
            )
        for a, b in zip(shards, shards[1:]):
            if a.hi is None:
                raise ShardMapError(
                    f"open-ended shard {a.name} is not last in the map"
                )
            if a.hi != b.lo:
                kind = "gap" if a.hi < b.lo else "overlap"
                raise ShardMapError(
                    f"{kind} between shard {a.name} [{a.lo},{a.hi}) and "
                    f"{b.name} starting at {b.lo} — every slice must be "
                    "covered exactly once"
                )
        if shards[-1].hi is not None:
            raise ShardMapError(
                f"last shard {shards[-1].name} must be open-ended "
                "(hi omitted) so every slice has an owner"
            )
        gnames: list[str] = []
        for s in shards:
            if not s.group_specs:
                raise ShardMapError(f"shard {s.name} has no groups")
            for spec in s.group_specs:
                gnames.append(_parse_group_name(len(gnames), spec))
        if len(set(gnames)) != len(gnames):
            raise ShardMapError(f"duplicate group names in shard map: {gnames}")
        self.shards = shards
        self._los = [s.lo for s in shards]

    def __len__(self) -> int:
        return len(self.shards)

    def __iter__(self):
        return iter(self.shards)

    def shard_of(self, slice_i: int) -> Shard:
        """The unique owner of ``slice_i`` (bisect over range starts)."""
        if slice_i < 0:
            raise ShardMapError(f"negative slice {slice_i}")
        return self.shards[bisect_right(self._los, slice_i) - 1]

    def cover(self, slices) -> dict:
        """Group a query's slice list by owning shard — the router
        analog of ``cluster.slices_by_node``: exact (the union over
        shards is exactly the input set) and minimal (only shards
        owning at least one requested slice appear; each slice appears
        exactly once, under its one owner)."""
        out: dict[str, list[int]] = {}
        for s in sorted(set(slices)):
            out.setdefault(self.shard_of(s).name, []).append(s)
        return out

    def to_json(self) -> list:
        return [
            {
                "name": s.name,
                "slices": s.range_json(),
                "groups": [
                    _parse_group_name(i, spec)
                    for i, spec in enumerate(s.group_specs)
                ],
            }
            for s in self.shards
        ]


def single_shard_map(group_specs) -> ShardMap:
    """The degenerate (and default) map: one shard, every slice, every
    group — exactly the pre-shard router."""
    return ShardMap([Shard("s0", 0, None, list(group_specs))])


def uniform_shard_map(group_specs, n_shards: int,
                      span: int = DEFAULT_SHARD_SPAN) -> ShardMap:
    """``[replica] shards = N``: split the flat group list into N
    consecutive chunks, shard i covering ``[i*span, (i+1)*span)`` with
    the last shard open-ended.  The group count must divide evenly —
    an uneven split silently giving one shard a thinner quorum is a
    config mistake, not a layout choice."""
    groups = list(group_specs)
    if n_shards < 1:
        raise ShardMapError(f"shards must be >= 1 (got {n_shards})")
    if span < 1:
        raise ShardMapError(f"shard-span must be >= 1 (got {span})")
    if not groups or len(groups) % n_shards != 0:
        raise ShardMapError(
            f"cannot split {len(groups)} group(s) evenly across "
            f"{n_shards} shard(s)"
        )
    per = len(groups) // n_shards
    shards = []
    for i in range(n_shards):
        hi = None if i == n_shards - 1 else (i + 1) * span
        shards.append(
            Shard(f"s{i}", i * span, hi, groups[i * per:(i + 1) * per])
        )
    return ShardMap(shards)


def parse_shard_map(spec: str) -> ShardMap:
    """Parse the explicit ``shard-map`` string (see module docstring).
    Raises :class:`ShardMapError` with the offending fragment."""
    shards = []
    for i, part in enumerate(p for p in spec.split(";") if p.strip()):
        part = part.strip()
        head, _, groups_s = part.partition(":")
        name = f"s{i}"
        if "=" in head:
            name, _, head = head.partition("=")
            name = name.strip()
        head = head.strip()
        lo_s, dash, hi_s = head.partition("-")
        if not dash:
            raise ShardMapError(
                f"shard {name!r}: range {head!r} must be lo-hi or lo- "
                "(hi omitted for open-ended)"
            )
        try:
            lo = int(lo_s)
            hi = int(hi_s) if hi_s.strip() else None
        except ValueError:
            raise ShardMapError(f"shard {name!r}: bad range {head!r}")
        group_specs = [g.strip() for g in groups_s.split(",") if g.strip()]
        shards.append(Shard(name, lo, hi, group_specs))
    return ShardMap(shards)
