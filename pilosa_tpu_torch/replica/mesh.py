"""Device-mesh construction for one replica serving group.

One group's device plane is the 2-D ``(slice, replica)`` mesh
(parallel/sharded.py ReplicaMesh): the ``slice`` axis shards the bitmap
stacks over ranks, the ``replica`` axis holds full copies that split
read batches.  What this module decides is the layout:

- MULTI-PROCESS (a joined ``torch.distributed`` job): the hybrid layout,
  one replica group per host, so every slice-axis reduce stays inside a
  host and only the replica gather crosses hosts
  (MultiHostReplicaMesh, with its slice-ownership helpers).
- SINGLE PROCESS (a job of one rank): the flat layout; there is no
  second host to lay a replica group on.
"""

from __future__ import annotations

from typing import Optional


def build_group_mesh(n_replicas: int = 2, device=None, hybrid: Optional[bool] = None):
    """Build the (slice x replica) mesh for one serving group.

    ``hybrid=None`` (the default) decides from the job shape: hybrid when
    this process is one rank of a multi-process job, flat otherwise.
    Returns a :class:`~pilosa_tpu_torch.parallel.multihost.MultiHostReplicaMesh`
    in the multi-process case and a plain
    :class:`~pilosa_tpu_torch.parallel.sharded.ReplicaMesh` otherwise."""
    import torch.distributed as dist

    multihost = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if hybrid is None:
        hybrid = multihost
    if multihost:
        from pilosa_tpu_torch.parallel.multihost import MultiHostReplicaMesh

        return MultiHostReplicaMesh(n_replicas=n_replicas, device=device, hybrid=hybrid)
    from pilosa_tpu_torch.parallel.sharded import ReplicaMesh

    return ReplicaMesh(n_replicas=n_replicas, device=device, hybrid=hybrid)
