"""Distribution: slice-axis sharding over a job of ranks + cluster placement.

Reference analog: the scatter-gather half of executor.go (mapReduce,
executor.go:1115-1244) and cluster.go.  Inside one job, the
goroutine-per-slice fan-out becomes one process per GPU: bitmap stacks
are split along the slice axis, each rank runs the port's kernels on its
block, and a ``torch.distributed`` collective merges (all_reduce for
Count, all_gather for bitmap materialization and TopN candidate counts).
Across heterogeneous nodes the hash ring + HTTP-forwarded remote
execution of the reference's data plane stays (pilosa_tpu_torch.cluster).
"""

from pilosa_tpu_torch.parallel.multihost import (  # noqa: F401
    MultiHostReplicaMesh,
    MultiHostSliceMesh,
    init_multihost,
)
from pilosa_tpu_torch.parallel.sharded import (  # noqa: F401
    ReplicaMesh,
    SliceMesh,
    replica_gather_count,
    sharded_count_and,
    sharded_count_call,
    sharded_union_reduce,
)


def __getattr__(name):
    # PEP 562 lazy export: service.py pulls in the executor and the whole
    # server stack; importing the meshes must not.
    if name == "LockstepService":
        from pilosa_tpu_torch.parallel.service import LockstepService

        return LockstepService
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
