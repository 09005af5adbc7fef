"""Cluster topology and deterministic slice placement.

Reference analog: cluster.go.  Placement is kept bit-for-bit compatible
(SURVEY.md §7.5) so a mixed rollout agrees on ownership:

- slice → partition: FNV-1a 64 over (index name bytes + slice as 8-byte
  big-endian), mod PartitionN=256 (cluster.go:198-207),
- partition → nodes: jump consistent hash picks the primary, ReplicaN
  consecutive ring nodes replicate it (cluster.go:220-240, 266-277).

This layer routes *across hosts*; within one job the slice batch is one
device dispatch per rank (parallel/: a torch.distributed job shards the
slice axis over its GPUs) instead of hash-routed.
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_PARTITION_N = 256
DEFAULT_REPLICA_N = 1

NODE_STATE_UP = "UP"
NODE_STATE_DOWN = "DOWN"


def fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def jump_hash(key: int, n: int) -> int:
    """Jump consistent hash (Lamping & Veach) — key to bucket in [0, n)."""
    key &= 0xFFFFFFFFFFFFFFFF
    b, j = -1, 0
    while j < n:
        b = j
        key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
        j = int((b + 1) * ((1 << 31) / ((key >> 33) + 1)))
    return b


@dataclass(eq=False)  # identity hash: nodes are shared per-cluster instances
class Node:
    host: str
    internal_host: str = ""
    state: str = NODE_STATE_UP

    def to_json(self) -> dict:
        return {"host": self.host, "internalHost": self.internal_host, "state": self.state}


class Cluster:
    def __init__(
        self,
        nodes: list[Node] | None = None,
        replica_n: int = DEFAULT_REPLICA_N,
        partition_n: int = DEFAULT_PARTITION_N,
    ):
        self.nodes: list[Node] = nodes or []
        self.replica_n = replica_n
        self.partition_n = partition_n

    # -- membership ------------------------------------------------------

    def node_by_host(self, host: str):
        for n in self.nodes:
            if n.host == host:
                return n
        return None

    def node_set_hosts(self) -> list[str]:
        return [n.host for n in self.nodes]

    def up_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.state == NODE_STATE_UP]

    # -- placement (cluster.go:198-254) ----------------------------------

    def partition(self, index: str, slice_i: int) -> int:
        data = index.encode() + slice_i.to_bytes(8, "big")
        return fnv1a64(data) % self.partition_n

    def partition_nodes(self, partition_id: int) -> list[Node]:
        if not self.nodes:
            return []
        replica_n = min(self.replica_n, len(self.nodes)) or 1
        primary = jump_hash(partition_id, len(self.nodes))
        return [self.nodes[(primary + i) % len(self.nodes)] for i in range(replica_n)]

    def fragment_nodes(self, index: str, slice_i: int) -> list[Node]:
        return self.partition_nodes(self.partition(index, slice_i))

    def owns_fragment(self, host: str, index: str, slice_i: int) -> bool:
        return any(n.host == host for n in self.fragment_nodes(index, slice_i))

    def owns_slices(self, index: str, max_slice: int, host: str) -> list[int]:
        """Slices whose PRIMARY owner is host (cluster.go:243-254)."""
        out = []
        for i in range(max_slice + 1):
            p = self.partition(index, i)
            if self.nodes[jump_hash(p, len(self.nodes))].host == host:
                out.append(i)
        return out

    def slices_by_node(
        self,
        index: str,
        slices: list[int],
        exclude_down: bool = False,
        exclude_hosts: set | None = None,
    ) -> dict[Node, list[int]]:
        """Group slices by an owning node (executor.go:1095-1109).

        Each slice goes to its first eligible owner; with replicas, a down
        (or ``exclude_hosts``-listed, i.e. failed mid-query) primary falls
        through to the next replica — the placement half of the retry
        semantics of executor.go:1147-1159.
        """
        out: dict[Node, list[int]] = {}
        for s in slices:
            owners = self.fragment_nodes(index, s)
            chosen = None
            for node in owners:
                if exclude_down and node.state != NODE_STATE_UP:
                    continue
                if exclude_hosts and node.host in exclude_hosts:
                    continue
                chosen = node
                break
            if chosen is None:
                detail = "down or unreachable" if exclude_hosts else "down"
                raise RuntimeError(f"slice {s} unavailable: all owners {detail}")
            out.setdefault(chosen, []).append(s)
        return out

    def status_json(self) -> dict:
        return {
            "replicaN": self.replica_n,
            "partitionN": self.partition_n,
            "nodes": [n.to_json() for n in self.nodes],
        }
