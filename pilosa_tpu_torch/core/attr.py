"""Attribute storage: id -> typed attribute maps.

Reference analog: attr.go — a BoltDB-backed KV store of protobuf attr maps
with an in-memory cache (attr.go:43-178), typed values
string/int/bool/float (attr.go:35-40), and anti-entropy via SHA1 checksums
over blocks of 100 ids (attr.go:181-241, AttrBlocks.Diff attr.go:394-428).

This build uses sqlite3 (stdlib, durable, transactional) as the KV engine
and JSON for the typed value encoding; block checksums hash the canonical
JSON so replicas agree byte-for-byte.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading

from pilosa_tpu_torch.analysis import lockcheck
from typing import Optional

ATTR_BLOCK_SIZE = 100


def _canonical(attrs: dict) -> bytes:
    return json.dumps(attrs, sort_keys=True, separators=(",", ":")).encode()


def _validate_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if not isinstance(k, str):
            raise TypeError(f"attribute key must be str: {k!r}")
        if v is None or isinstance(v, (str, bool, int, float)):
            out[k] = v
        else:
            raise TypeError(f"unsupported attribute value type: {k}={v!r}")
    return out


class AttrStore:
    """Durable id->attrs store with in-memory cache (attr.go:43)."""

    def __init__(self, path: str):
        self.path = path
        self._cache: dict[int, dict] = {}
        self._lock = lockcheck.named_rlock("core.attrstore._lock")
        self._db: Optional[sqlite3.Connection] = None

    def open(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS attrs (id INTEGER PRIMARY KEY, data TEXT NOT NULL)"
        )
        self._db.commit()

    def close(self) -> None:
        if self._db is not None:
            self._db.close()
            self._db = None
        self._cache.clear()

    def attrs(self, id: int) -> Optional[dict]:
        with self._lock:
            if id in self._cache:
                return self._cache[id]
            row = self._db.execute("SELECT data FROM attrs WHERE id=?", (int(id),)).fetchone()
            attrs = json.loads(row[0]) if row else None
            if attrs is not None:
                self._cache[id] = attrs
            return attrs

    def set_attrs(self, id: int, attrs: dict) -> dict:
        """Merge attrs into the stored map; None values delete keys
        (attr.go SetAttrs merge semantics)."""
        attrs = _validate_attrs(attrs)
        with self._lock:
            cur = self.attrs(id) or {}
            merged = dict(cur)
            for k, v in attrs.items():
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
            self._db.execute(
                "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)",
                (int(id), _canonical(merged).decode()),
            )
            self._db.commit()
            self._cache[id] = merged
            return merged

    def set_bulk_attrs(self, items: dict[int, dict]) -> None:
        with self._lock:
            for id, attrs in items.items():
                self.set_attrs(id, attrs)

    def ids(self) -> list[int]:
        rows = self._db.execute("SELECT id FROM attrs ORDER BY id").fetchall()
        return [r[0] for r in rows]

    # -- anti-entropy blocks (attr.go:181-241) --------------------------

    def blocks(self) -> list[tuple[int, bytes]]:
        """(block id, sha1) over blocks of ATTR_BLOCK_SIZE ids."""
        rows = self._db.execute("SELECT id, data FROM attrs ORDER BY id").fetchall()
        out: list[tuple[int, bytes]] = []
        h = None
        cur_block = None
        for id, data in rows:
            bid = id // ATTR_BLOCK_SIZE
            if bid != cur_block:
                if h is not None:
                    out.append((cur_block, h.digest()))
                cur_block, h = bid, hashlib.sha1()
            h.update(str(id).encode())
            h.update(data.encode())
        if h is not None:
            out.append((cur_block, h.digest()))
        return out

    def block_data(self, block_id: int) -> dict[int, dict]:
        rows = self._db.execute(
            "SELECT id, data FROM attrs WHERE id >= ? AND id < ? ORDER BY id",
            (block_id * ATTR_BLOCK_SIZE, (block_id + 1) * ATTR_BLOCK_SIZE),
        ).fetchall()
        return {id: json.loads(data) for id, data in rows}


def blocks_diff(local: list[tuple[int, bytes]], remote: list[tuple[int, bytes]]) -> list[int]:
    """Block ids present/differing in remote vs local (attr.go:394-428)."""
    lm = dict(local)
    out = []
    for bid, chk in remote:
        if lm.get(bid) != chk:
            out.append(bid)
    return sorted(out)
