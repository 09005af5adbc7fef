"""Row-rank caches and Pair merge for TopN.

Reference analog: cache.go — the Cache interface (cache.go:35-52), LRUCache
(cache.go:55-123), RankCache with threshold trimming + 10s invalidation
debounce (cache.go:126-275), SimpleCache (cache.go:438-462), and the
Pairs.Add distributed-TopN merge (cache.go:343-361).

Observable semantics preserved (SURVEY.md §7 hard part (c)): ThresholdFactor
1.1 buffer, threshold = count of the (maxEntries+1)-th ranked entry, 10s
debounce on invalidate, trim of entries at-or-below threshold when the map
outgrows the buffer.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable

THRESHOLD_FACTOR = 1.1

# RankCache invalidation debounce (cache.go:219-226's hard-coded 10 s,
# promoted to config).  The configured value ([cache] ranking-debounce-s,
# env-resolved once in Config._apply_env) threads through Holder ->
# Index -> Frame -> View -> Fragment construction; an absent ctor arg
# falls back to this module default — no module-global mutation, so two
# servers in one process never leak each other's setting.
DEFAULT_RANKING_DEBOUNCE_S = 10.0

# Cache type names (frame.go:33-40).
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_RANKED = "ranked"
DEFAULT_CACHE_TYPE = CACHE_TYPE_LRU


@dataclass(frozen=True)
class Pair:
    """(row id, count) result pair (cache.go:291-294)."""

    id: int
    count: int

    def to_json(self) -> dict:
        return {"id": self.id, "count": self.count}


def pairs_add(a: Iterable[Pair], b: Iterable[Pair]) -> list[Pair]:
    """Merge counts by id (distributed TopN reduce; cache.go:343-361)."""
    m: dict[int, int] = {}
    for p in a:
        m[p.id] = m.get(p.id, 0) + p.count
    for p in b:
        m[p.id] = m.get(p.id, 0) + p.count
    return [Pair(id=k, count=v) for k, v in m.items()]


def pairs_sorted(pairs: Iterable[Pair]) -> list[Pair]:
    """Descending by count, then ascending id for determinism."""
    return sorted(pairs, key=lambda p: (-p.count, p.id))


class LRUCache:
    """LRU row-count cache (cache.go:55-123)."""

    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self._od: OrderedDict[int, int] = OrderedDict()

    def add(self, id: int, n: int) -> None:
        self._od[id] = n
        self._od.move_to_end(id)
        while len(self._od) > self.max_entries:
            self._od.popitem(last=False)

    bulk_add = add

    def get(self, id: int) -> int:
        n = self._od.get(id, 0)
        if id in self._od:
            self._od.move_to_end(id)
        return n

    def __len__(self) -> int:
        return len(self._od)

    def ids(self) -> list[int]:
        return sorted(self._od.keys())

    def invalidate(self) -> None:
        pass

    def recalculate(self) -> None:
        pass

    def top(self) -> list[Pair]:
        return pairs_sorted(Pair(id=k, count=v) for k, v in self._od.items() if v > 0)


class RankCache:
    """Ranked row cache with entry threshold (cache.go:126-275).

    Keeps up to ``max_entries`` top rows by count plus a slop buffer;
    ``threshold_value`` is the count of the first evicted rank, and adds
    below it are ignored.  ``invalidate`` is debounced to once per
    ``debounce_s`` (default 10 s, cache.go:219-226; config
    ``[cache] ranking-debounce-s`` / PILOSA_TPU_RANKING_DEBOUNCE_S,
    resolved in Config and threaded through holder construction);
    ``recalculate`` forces it.
    """

    def __init__(self, max_entries: int, _now=time.monotonic, debounce_s=None):
        self.max_entries = max_entries
        self.threshold_buffer = int(THRESHOLD_FACTOR * max_entries)
        self.threshold_value = 0
        self.entries: dict[int, int] = {}
        self.rankings: list[Pair] = []
        if debounce_s is None:
            debounce_s = DEFAULT_RANKING_DEBOUNCE_S
        self.debounce_s = float(debounce_s)
        self._now = _now
        self._update_time = _now() - 1e9

    def add(self, id: int, n: int) -> None:
        if n < self.threshold_value:
            return
        self.entries[id] = n
        self.invalidate()

    def bulk_add(self, id: int, n: int) -> None:
        """Unsorted add; caller should invalidate()/recalculate() after."""
        if n < self.threshold_value:
            return
        self.entries[id] = n

    def get(self, id: int) -> int:
        return self.entries.get(id, 0)

    def __len__(self) -> int:
        return len(self.entries)

    def ids(self) -> list[int]:
        return sorted(self.entries.keys())

    def invalidate(self) -> None:
        if self._now() - self._update_time < self.debounce_s:
            return
        self.recalculate()

    def recalculate(self) -> None:
        rankings = pairs_sorted(Pair(id=k, count=v) for k, v in self.entries.items())
        if len(rankings) > self.max_entries:
            self.threshold_value = rankings[self.max_entries].count
            rankings = rankings[: self.max_entries]
        else:
            self.threshold_value = 1
        self.rankings = rankings
        self._update_time = self._now()
        if len(self.entries) > self.threshold_buffer:
            self.entries = {
                k: v for k, v in self.entries.items() if v > self.threshold_value
            }

    def top(self) -> list[Pair]:
        return self.rankings


class SimpleCache:
    """Unbounded id->count map (cache.go:438-462 BitmapCache/SimpleCache)."""

    def __init__(self):
        self.entries: dict[int, int] = {}

    def add(self, id: int, n: int) -> None:
        self.entries[id] = n

    bulk_add = add

    def get(self, id: int) -> int:
        return self.entries.get(id, 0)

    def __len__(self) -> int:
        return len(self.entries)

    def ids(self) -> list[int]:
        return sorted(self.entries.keys())

    def invalidate(self) -> None:
        pass

    def recalculate(self) -> None:
        pass

    def top(self) -> list[Pair]:
        return pairs_sorted(Pair(id=k, count=v) for k, v in self.entries.items() if v > 0)


def new_cache(cache_type: str, size: int, ranking_debounce_s=None):
    if cache_type == CACHE_TYPE_RANKED:
        return RankCache(size, debounce_s=ranking_debounce_s)
    if cache_type == CACHE_TYPE_LRU:
        return LRUCache(size)
    if cache_type in ("", "simple", "none"):
        return SimpleCache()
    from pilosa_tpu_torch.pilosa import ErrInvalidCacheType

    raise ErrInvalidCacheType(f"invalid cache type: {cache_type}")
