"""Holder: the root of the data hierarchy, owning all indexes on disk.

Reference analog: holder.go — opens the data directory, discovers indexes
from subdirectories (holder.go:73-121), exposes Schema() (holder.go:154),
accessor chain Holder → Index → Frame → View → Fragment
(holder.go:298-322), and the periodic rank-cache flush (holder.go:324-358,
driven by the server loop here).

Path layout matches the reference
(<data>/<index>/<frame>/views/<view>/fragments/<slice>; holder.go:174).
"""

from __future__ import annotations

import os
import shutil
import threading

from pilosa_tpu_torch.analysis import lockcheck
from typing import Optional

from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.frame import Frame
from pilosa_tpu_torch.core.index import Index, IndexOptions
from pilosa_tpu_torch.core.view import View
from pilosa_tpu_torch.pilosa import ErrIndexExists, ErrIndexNotFound, validate_name

CACHE_FLUSH_INTERVAL = 60.0  # seconds (holder.go:30-31)


class Holder:
    def __init__(self, path: str, stats=None, ranking_debounce_s=None):
        from pilosa_tpu_torch.stats import NopStatsClient

        self.path = path
        self.stats = stats if stats is not None else NopStatsClient()
        # [cache] ranking-debounce-s, threaded down through Index ->
        # Frame -> View -> Fragment -> RankCache; None = module default.
        self.ranking_debounce_s = ranking_debounce_s
        # Guards index create/delete against concurrent schema merges
        # (gossip push/pull runs from two threads; holder.go:35 mu analog).
        self._mu = lockcheck.named_rlock("core.holder._mu")
        self.indexes: dict[str, Index] = {}
        # Hook invoked as (index, frame, view, slice) when a fragment for a
        # new max slice is created locally — the server broadcasts a
        # CreateSliceMessage from it (view.go:219-254).
        self.on_new_fragment = None

    # -- lifecycle ------------------------------------------------------

    def open(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        for entry in sorted(os.listdir(self.path)):
            full = os.path.join(self.path, entry)
            if not os.path.isdir(full) or entry.startswith("."):
                continue
            idx = Index(
                full,
                entry,
                stats=self.stats.with_tags(f"index:{entry}"),
                on_new_fragment=self._fragment_hook,
                ranking_debounce_s=self.ranking_debounce_s,
            )
            idx.open()
            self.indexes[entry] = idx
            self.stats.count("indexN", 1)  # holder.go:113

    def close(self) -> None:
        for idx in list(self.indexes.values()):
            idx.close()
        self.indexes.clear()

    def _fragment_hook(self, index: str, frame: str, view: str, slice_i: int) -> None:
        if self.on_new_fragment is not None:
            self.on_new_fragment(index, frame, view, slice_i)

    def flush_caches(self) -> None:
        # list() snapshots: schema merges may insert concurrently
        for idx in list(self.indexes.values()):
            idx.flush_caches()

    # -- indexes ---------------------------------------------------------

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(self, name: str, opt: Optional[IndexOptions] = None) -> Index:
        with self._mu:
            if name in self.indexes:
                raise ErrIndexExists(name)
            return self._create_index(name, opt or IndexOptions())

    def create_index_if_not_exists(self, name: str, opt: Optional[IndexOptions] = None) -> Index:
        with self._mu:
            idx = self.indexes.get(name)
            if idx is not None:
                return idx
            return self._create_index(name, opt or IndexOptions())

    def _create_index(self, name: str, opt: IndexOptions) -> Index:
        validate_name(name)
        # Validate options BEFORE any directory exists (no ghost indexes).
        opt.validate()
        idx = Index(
            os.path.join(self.path, name),
            name,
            stats=self.stats.with_tags(f"index:{name}"),
            on_new_fragment=self._fragment_hook,
            ranking_debounce_s=self.ranking_debounce_s,
        )
        idx.open()
        idx.apply_options(opt)
        self.indexes[name] = idx
        self.stats.count("indexN", 1)  # holder.go:252
        return idx

    def delete_index(self, name: str) -> None:
        # close + rmtree stay under the lock so a concurrent create of the
        # same name can't have its fresh directory deleted out from under it.
        with self._mu:
            idx = self.indexes.pop(name, None)
            if idx is None:
                raise ErrIndexNotFound(name)
            idx.close()
            shutil.rmtree(idx.path, ignore_errors=True)
            self.stats.count("indexN", -1)  # holder.go:292

    # -- accessors (holder.go:298-322) ------------------------------------

    def frame(self, index: str, frame: str) -> Optional[Frame]:
        idx = self.index(index)
        return idx.frame(frame) if idx else None

    def view(self, index: str, frame: str, view: str) -> Optional[View]:
        f = self.frame(index, frame)
        return f.view(view) if f else None

    def fragment(self, index: str, frame: str, view: str, slice_i: int) -> Optional[Fragment]:
        v = self.view(index, frame, view)
        return v.fragment(slice_i) if v else None

    # -- schema (holder.go:154-171) ---------------------------------------

    def schema(self) -> list[dict]:
        return [idx.schema_json() for _, idx in sorted(list(self.indexes.items()))]

    def max_slices(self) -> dict[str, int]:
        return {name: idx.max_slice() for name, idx in list(self.indexes.items())}

    def max_inverse_slices(self) -> dict[str, int]:
        return {name: idx.max_inverse_slice() for name, idx in list(self.indexes.items())}
