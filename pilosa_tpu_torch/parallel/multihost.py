"""Multi-process slice meshes: one ``torch.distributed`` job of ranks.

The reference scales past one node with an HTTP+protobuf data plane and a
hash ring (cluster.go, executor.go:1009-1091).  That path survives for
heterogeneous clusters (pilosa_tpu_torch/cluster.py); a homogeneous GPU
job takes the alternative here: one process per GPU, every process joins
one ``torch.distributed`` process group, the slice axis shards over the
ranks, and collectives (NCCL between cards, gloo on the host) do the
reduce that protobuf responses did in the reference.  The coordinator
address, the job size and the rank are given explicitly, like the
reference's cluster config (a coordinator address + a static host list,
config.go:37-64); nothing is discovered.

What this module adds to sharded.py is the process boundary: joining the
group (with the backend chosen by rule before init), and building a
rank's block from process-LOCAL slice data (each rank densifies only the
fragments it owns — the analog of per-node fragment ownership,
cluster.go:243-254).
"""

from __future__ import annotations

import os
import sys
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pilosa_tpu_torch.ops import bitwise
from pilosa_tpu_torch.parallel.sharded import ReplicaMesh, SliceMesh, _local, _require_divisible

# A rank that diverges (or dies) fails a collective after this long
# instead of hanging for the library's default half hour.
DEFAULT_TIMEOUT_S = 120.0


def choose_backend(device: torch.device, local_ranks: int, n_cards: int) -> str:
    """The backend rule, decided before init from this host's facts:

    - gloo for ranks on the CPU;
    - NCCL when every rank of the host has a card of its own
      (``local_ranks <= n_cards``);
    - gloo when ranks share a card: NCCL refuses two ranks on one
      device.  Collectives then cross the host (sharded.SliceMesh moves
      the small count vectors explicitly).

    There is no retry: a failing NCCL init fails the job."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_ranks <= n_cards else "gloo"


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
    device: str = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join this process to a job: ``dist.init_process_group`` at
    ``tcp://<coordinator>`` with ``num_processes`` ranks, this one
    ``process_id``.  Returns the device the rank runs on (for a card,
    also the current CUDA device, which a mesh built without a device
    takes).

    ``device="cuda"`` (the default) puts rank k on card ``k %
    local_device_count`` (default: every card the host has) and calls
    ``torch.cuda.set_device`` before anything is allocated; without CUDA
    it raises.  ``device="cpu"`` runs the rank on the host over gloo.
    The ranks of one host count as ``LOCAL_WORLD_SIZE`` when the launcher
    sets it, else the whole job (one host)."""
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_multihost: give coordinator (host:port), num_processes and process_id"
        )
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_multihost(device='cuda'): torch.cuda.is_available() is False; "
                "pass device='cpu' to run the ranks on the host"
            )
        n_cards = local_device_count or torch.cuda.device_count()
        dev = torch.device("cuda", process_id % n_cards)
        torch.cuda.set_device(dev)
    else:
        n_cards = 0
    local_ranks = int(
        os.environ.get("LOCAL_WORLD_SIZE", num_processes)
    )
    backend = choose_backend(dev, local_ranks, n_cards)
    if process_id == 0:
        print(
            f"init_multihost: {num_processes} ranks, {local_ranks} on this host, "
            f"device {dev.type} ({n_cards} cards) -> backend {backend}",
            file=sys.stderr, flush=True,
        )
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=timeout_s),
    )
    return dev


class MultiHostSliceMesh(SliceMesh):
    """SliceMesh over the job's ranks, with the process-boundary helpers:
    which global slices this rank owns, building its block from local
    data, and fetching a sharded result to every rank."""

    def __init__(self, group=None, device=None, timing: bool = False):
        super().__init__(group, device, timing)
        self.process_index = self.rank
        self.process_count = self.world_size

    def owned_slices(self, n_slices: int) -> list[int]:
        """Global slice indices whose block lives on THIS rank."""
        return list(self.owned_range(n_slices))

    def shard_stack_local(
        self,
        local_data: dict,
        n_slices: int,
        row_shape: tuple,
        dtype=np.uint32,
    ) -> torch.Tensor:
        """This rank's block of a global ``[n_slices, *row_shape]`` stack
        built from its own slices only (missing owned slices are zero).

        ``local_data`` maps global slice index -> np.ndarray of
        ``row_shape``; only slices this rank owns are consulted, and no
        rank materializes the whole stack.  ``dtype`` is explicit (not
        inferred from ``local_data``): a rank owning only empty slices
        must still agree with its peers on the block's type, or the
        collectives over it fail."""
        for v in local_data.values():
            if v.dtype != dtype:
                raise TypeError(f"local slice dtype {v.dtype} != declared {np.dtype(dtype)}")
        owned = self.owned_slices(n_slices)
        block = np.zeros((len(owned), *row_shape), dtype=dtype)
        for j, s in enumerate(owned):
            if s in local_data:
                block[j] = local_data[s]
        return bitwise.to_words(block, self.device)

    def fetch_global(self, block: torch.Tensor) -> np.ndarray:
        """Gather a slice-sharded result to every rank as a host array
        (int32 words come back as uint32 words)."""
        out = self.all_gather_cat(_local(block)).cpu().numpy()
        return out.view(np.uint32) if out.dtype == np.int32 else out


class MultiHostReplicaMesh(ReplicaMesh):
    """2-D (slice x replica) mesh over the job's ranks — the device plane
    of one replicated serving group.  ``hybrid`` defaults to True (one
    replica group per host, so every slice-axis reduce stays inside a
    host); ReplicaMesh's fallback keeps construction working on one
    host, and ``hybrid`` records what was built."""

    def __init__(self, n_replicas: int = 2, device=None, hybrid: bool = True,
                 timing: bool = False):
        super().__init__(n_replicas=n_replicas, device=device, hybrid=hybrid, timing=timing)
        self.process_index = self.job_rank
        self.process_count = self.n_devices * self.n_replicas

    def local_replica_groups(self) -> list[int]:
        """Replica groups this rank takes part in: one, its own."""
        return [self.replica]

    def owned_slices(self, n_slices: int) -> list[int]:
        """Global slice indices whose block lives on THIS rank (within its
        replica group, which holds a full copy)."""
        _require_divisible(n_slices, self.n_devices)
        return list(self.owned_range(n_slices))
