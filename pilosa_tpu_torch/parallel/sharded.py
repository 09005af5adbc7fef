"""Slice-axis sharding over a torch.distributed process group.

The reference fans a query out with a goroutine per slice and reduces
through channels (executor.go:1115-1244).  Here one process drives one
GPU: a job of N ranks splits the slice axis of every stack into N
contiguous blocks, rank k holding slices ``[k*S/N, (k+1)*S/N)`` on its
own device, and a ``torch.distributed`` collective merges what each rank
computed on its block:

- elementwise set ops stay local to each block (no communication),
- ``Count`` reduces with ``all_reduce(SUM)`` over the group (the analog
  of the coordinator summing per-node counts),
- bitmap materialization and per-slice results gather the blocks
  (``all_gather``, the analog of streaming per-node segment lists back).

Every composition below is the port's own single-GPU entry (``ops.kernels``
/ ``ops.dispatch``) on the rank's block followed by one collective, so
the hand-written kernels run per shard and their gates (resident or
gather, staged or gather fold) are decided at the shard's own shape.
The functions take LOCAL blocks (``SliceMesh.shard_stack``) and return
global results on every rank.

Collectives run where the backend takes them: NCCL on the card, gloo on
the host.  Under gloo the small count vectors cross to the host and back
explicitly (``SliceMesh.collective_device``).  Every rank must reach
every collective in the same order: nothing here decides a path from a
rank-local measurement.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pilosa_tpu_torch.ops import bitwise, dispatch, kernels


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device() -> torch.device:
    """The device a mesh uses when none is given: the current CUDA device
    (``init_multihost`` sets each rank's).  There is no fallback to the
    CPU: a rank that finds no CUDA raises; the CPU is asked for with
    ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "SliceMesh: torch.cuda.is_available() is False; pass device='cpu' "
            "to run the mesh on the host (gloo)"
        )
    return torch.device("cuda", torch.cuda.current_device())


class SliceMesh:
    """One rank's view of a 1-D ``slice`` mesh over a process group.

    ``group`` is a ``torch.distributed`` process group (None: the default
    group once one is initialized; without one the mesh is a job of one
    rank whose collectives are the identity).  ``n_devices`` is the
    number of slice shards, one per rank; ownership is contiguous and
    deterministic, the mesh's replacement for the reference's hash-ring
    placement (cluster.go:198-240).

    ``timing=True`` synchronizes the device around every collective and
    adds its wall time to ``stat_collective_s`` (telemetry only, never
    read back into a decision).
    """

    AXIS = "slice"

    def __init__(self, group=None, device=None, timing: bool = False):
        self.group = group
        self.device = torch.device(device) if device is not None else rank_device()
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SliceMesh(device='cuda'): torch.cuda.is_available() is False")
        if _initialized() and (group is None or group != dist.GroupMember.NON_GROUP_MEMBER):
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        else:
            self.rank, self.world_size, self.backend = 0, 1, None
        self.n_devices = self.world_size
        self.timing = timing
        self.stat_collectives = 0
        self.stat_collective_s = 0.0

    @property
    def collective_device(self) -> torch.device:
        """Where a collective's tensor must lie: the card under NCCL, the
        host under gloo (and for a job of one)."""
        if self.backend == "nccl":
            return self.device
        return torch.device("cpu")

    # -- ownership -------------------------------------------------------

    def owned_range(self, n_slices: int) -> range:
        """Global slice indices this rank holds (contiguous)."""
        _require_divisible(n_slices, self.n_devices)
        per = n_slices // self.n_devices
        return range(self.rank * per, (self.rank + 1) * per)

    def shard_stack(self, x: np.ndarray) -> torch.Tensor:
        """Upload this rank's block of a host ``[n_slices, ...]`` stack
        (uint32 or int32 words) to the rank's device; only the block
        crosses."""
        r = self.owned_range(x.shape[0])
        return bitwise.to_words(np.ascontiguousarray(x[r.start:r.stop]), self.device)

    def replicate(self, x: np.ndarray) -> torch.Tensor:
        """Upload the whole stack to the rank's device."""
        return bitwise.to_words(np.ascontiguousarray(x), self.device)

    # -- collectives -----------------------------------------------------

    def _sync(self) -> None:
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group; the result lies on ``t``'s device."""
        if self.world_size == 1 and self.backend is None:
            return t
        self._sync()
        t0 = time.perf_counter()
        buf = t.to(self.collective_device).contiguous()
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        out = buf.to(t.device)
        self._sync()
        self.stat_collectives += 1
        self.stat_collective_s += time.perf_counter() - t0
        return out

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along axis 0 in rank order (the
        blocks of a slice-sharded result -> the whole); on ``t``'s device."""
        if self.world_size == 1 and self.backend is None:
            return t
        self._sync()
        t0 = time.perf_counter()
        buf = t.to(self.collective_device).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.world_size)]
        dist.all_gather(parts, buf, group=self.group)
        out = torch.cat(parts, dim=0).to(t.device)
        self._sync()
        self.stat_collectives += 1
        self.stat_collective_s += time.perf_counter() - t0
        return out


def _require_divisible(n_slices: int, n_devices: int) -> None:
    if n_slices % n_devices:
        raise ValueError(
            f"slice count {n_slices} must be a multiple of mesh size {n_devices}; "
            "pad the stack with zero slices"
        )


def _local(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor over the same storage (drops a subclass such as the
    engine's SliceShard, whose type would otherwise ride every op)."""
    return t.as_subclass(torch.Tensor) if type(t) is not torch.Tensor else t


def sharded_count_and(mesh: SliceMesh, a, b) -> torch.Tensor:
    """Global ``|a & b|`` over slice-sharded ``[S, W]`` stacks (local
    blocks): the count kernel on each block, a local sum, then
    all_reduce.  Returns an int64 scalar tensor."""
    return sharded_count_call(mesh, "and", a, b)


def sharded_union_reduce(mesh: SliceMesh, stacks):
    """OR together several slice-sharded stacks; the result stays
    sharded (each rank ORs its own block: no communication, as in the
    reference, where a bitmap result is slice-partitioned)."""
    out = _local(stacks[0])
    for x in stacks[1:]:
        out = torch.bitwise_or(out, _local(x))
    return out


def sharded_count_call(mesh: SliceMesh, op: str, a, b) -> torch.Tensor:
    """Fused count of a pairwise set op (and/or/xor/andnot) over
    slice-sharded ``[S, W]`` stacks: ``count_rows`` with ``op`` on each
    block, a local sum, then all_reduce -> int64 scalar."""
    if op not in ("and", "or", "xor", "andnot"):
        raise ValueError(op)
    local = kernels.count_rows(_local(a).contiguous(), _local(b).contiguous(), op)
    return mesh.all_reduce_sum(local.sum(dtype=torch.int64))


def sharded_gather_count(mesh: SliceMesh, op: str, row_matrix, pairs) -> torch.Tensor:
    """Batched pair counts over a slice-sharded ``[S, R, W]`` matrix:
    ``dispatch.gather_count`` on the rank's block (resident or gather
    kernel, picked by the SHARD's shape), then all_reduce -> int64[B].
    The kernels read their ids from global memory, so no batch is cut
    into chunks."""
    local = dispatch.gather_count(op, _local(row_matrix).contiguous(), pairs)
    return mesh.all_reduce_sum(local.long())


def sharded_gather_count_multi(mesh: SliceMesh, op: str, row_matrix, idx) -> torch.Tensor:
    """Multi-operand fold counts (N-ary Intersect/Union/Difference, Range
    covers): ``dispatch.gather_count_multi`` on the block (the staged
    fold where its gate admits the batch at the shard's shape), then
    all_reduce -> int64[B]."""
    local = dispatch.gather_count_multi(op, _local(row_matrix).contiguous(), idx)
    return mesh.all_reduce_sum(local.long())


def sharded_gather_count_tree(mesh: SliceMesh, row_matrix, leaves, opc) -> torch.Tensor:
    """Nested tree counts: ``dispatch.gather_count_tree`` on the block,
    then all_reduce -> int64[B]."""
    local = dispatch.gather_count_tree(_local(row_matrix).contiguous(), leaves, opc)
    return mesh.all_reduce_sum(local.long())


def sharded_scorer_counts(mesh: SliceMesh, rows, ids, src) -> torch.Tensor:
    """Per-(slice, candidate) intersection counts for TopN scoring:
    ``gather_src_counts`` on the block ``rows`` [S/n, R, W] against the
    block ``src`` [S/n, W], then all_gather -> int32[S, K] on every rank."""
    local = kernels.gather_src_counts(_local(rows).contiguous(), ids, _local(src).contiguous())
    return mesh.all_gather_cat(local)


def sharded_topn_counts(mesh: SliceMesh, rows, src) -> torch.Tensor:
    """Each row's intersection count with ``src`` summed over every
    slice: ``topn_counts`` on the block, then all_reduce -> int64[R]."""
    local = kernels.topn_counts(_local(rows).contiguous(), _local(src).contiguous())
    return mesh.all_reduce_sum(local.long())


# ---------------------------------------------------------------------------
# Replica groups: 2-D (slice x replica) mesh
# ---------------------------------------------------------------------------

def _host_blocks(world: int, n_replicas: int, group=None) -> Optional[list]:
    """Ranks by host, when the job's hosts split it into ``n_replicas``
    equal blocks (each host one replica group), else None.  Every rank
    takes part in the one object gather."""
    import socket

    names = [None] * world
    dist.all_gather_object(names, socket.gethostname(), group=group)
    by_host: dict = {}
    for r, h in enumerate(names):
        by_host.setdefault(h, []).append(r)
    blocks = list(by_host.values())
    if len(blocks) != n_replicas or len({len(b) for b in blocks}) != 1:
        return None
    return blocks


class ReplicaMesh(SliceMesh):
    """A 2-D (slice x replica) mesh: the ReplicaN analog.

    The job's ranks split into ``n_replicas`` groups of ``n_devices``
    ranks.  Inside a group the slice axis is sharded (each rank one
    contiguous block, ``shard_stack``); every group holds a full copy.
    A read batch splits over the replica axis: each group answers its
    sub-batch with an all_reduce over ITS slice subgroup, and the batch
    reassembles with an all_gather over the replica subgroup.

    The flat layout puts consecutive ranks on the slice axis: rank r is
    shard ``r % n_devices`` of replica group ``r // n_devices``.
    ``hybrid=True`` asks for one replica group per host (the slice-axis
    reduce stays inside a host and only the replica gather crosses
    hosts); a job whose hosts do not split it into ``n_replicas`` equal
    blocks — every job on one host — falls back to the flat layout, and
    ``hybrid`` records what was built.
    """

    REPLICA_AXIS = "replica"

    def __init__(self, n_replicas: int = 2, device=None, hybrid: bool = False,
                 timing: bool = False):
        super().__init__(None, device, timing)
        world = self.world_size
        if world % n_replicas:
            raise ValueError(
                f"{world} devices not divisible into {n_replicas} replica groups"
            )
        n_slice = world // n_replicas
        blocks = None
        if hybrid and _initialized():
            blocks = _host_blocks(world, n_replicas)
        self.hybrid = blocks is not None  # the layout actually BUILT
        if blocks is None:
            blocks = [list(range(j * n_slice, (j + 1) * n_slice)) for j in range(n_replicas)]
        self.layout = blocks  # layout[replica][slice position] = global rank
        me = self.rank
        self.replica = next(j for j, b in enumerate(blocks) if me in b)
        self.slice_pos = blocks[self.replica].index(me)
        self.slice_group = None
        self.replica_group = None
        if _initialized() and world > 1:
            # Every rank creates every subgroup, in the same order
            # (dist.new_group is a collective over the whole job).
            for j in range(n_replicas):
                g = dist.new_group(blocks[j])
                if j == self.replica:
                    self.slice_group = g
            for i in range(n_slice):
                g = dist.new_group([blocks[j][i] for j in range(n_replicas)])
                if i == self.slice_pos:
                    self.replica_group = g
        # SliceMesh API: the slice axis is split n_slice ways, and this
        # rank's block is its position in its replica group.
        self.n_devices = n_slice
        self.n_replicas = n_replicas
        self.job_rank, self.rank = self.rank, self.slice_pos
        self._slice_mesh = _SubMesh(self, self.slice_group, n_slice, self.slice_pos)
        self._replica_mesh = _SubMesh(self, self.replica_group, n_replicas, self.replica)

    def all_reduce_sum(self, t):
        return self._slice_mesh.all_reduce_sum(t)

    def all_gather_cat(self, t):
        return self._slice_mesh.all_gather_cat(t)


class _SubMesh(SliceMesh):
    """A subgroup of a ReplicaMesh (its slice axis or its replica axis),
    sharing the parent's device, backend and collective counters."""

    def __init__(self, parent: ReplicaMesh, group, size: int, pos: int):
        self.parent = parent
        self.group = group
        self.device = parent.device
        self.backend = parent.backend if size > 1 else None
        self.world_size = self.n_devices = size
        self.rank = pos
        self.timing = parent.timing

    @property
    def stat_collectives(self):
        return self.parent.stat_collectives

    @stat_collectives.setter
    def stat_collectives(self, v):
        self.parent.stat_collectives = v

    @property
    def stat_collective_s(self):
        return self.parent.stat_collective_s

    @stat_collective_s.setter
    def stat_collective_s(self, v):
        self.parent.stat_collective_s = v


def replica_gather_count(mesh: ReplicaMesh, op: str, row_matrix, pairs) -> torch.Tensor:
    """Batched pair counts on a (slice x replica) mesh with the batch
    SPLIT over the replica axis: each replica group runs
    ``dispatch.gather_count`` on its sub-batch against its block of the
    full copy, all_reduces over its slice subgroup, and the batch
    reassembles with an all_gather over the replica subgroup.

    pairs: int[B, 2] with B divisible by n_replicas.  Returns int64[B]."""
    pairs = np.asarray(pairs)
    b = pairs.shape[0]
    if b % mesh.n_replicas:
        raise ValueError(f"batch {b} not divisible by {mesh.n_replicas} replicas")
    per = b // mesh.n_replicas
    mine = pairs[mesh.replica * per:(mesh.replica + 1) * per]
    local = dispatch.gather_count(op, _local(row_matrix).contiguous(), mine)
    part = mesh._slice_mesh.all_reduce_sum(local.long())
    return mesh._replica_mesh.all_gather_cat(part)
