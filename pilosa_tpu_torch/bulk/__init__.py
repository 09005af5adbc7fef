"""Device-first bulk index construction + Arrow-native egress.

The write-path twin of the device-first read path: columnar (row, col)
batches arriving through the streaming chunk wire (``POST
/index/<i>/frame/<f>/bulk``) are bit-packed into packed-uint32 word
planes by a sort/segment/scatter build (:mod:`bulk.build`; on the
torch engine a hand-written CUDA kernel, ``TorchEngine.build_planes``;
numpy twin for parity) and committed into
each fragment's pending dense overlay — roaring containers and rank
caches materialize lazily on the first snapshot/sync/egress touch
(:mod:`bulk.lazy` tracks the debt).  The symmetric egress door
(``GET /export?format=arrow``, :mod:`bulk.egress`) streams fragment
contents as Arrow IPC record batches built zero-copy from the same
column layout the ingress accepts, so an export→re-ingest round trip
is byte-identical.
"""

from pilosa_tpu_torch.bulk.build import (  # noqa: F401
    WORDS_PER_PLANE,
    build_planes_numpy,
    group_pairs,
    plane_positions,
)
from pilosa_tpu_torch.bulk.ingress import apply_bulk, complete_bulk  # noqa: F401
from pilosa_tpu_torch.bulk.lazy import LEDGER, MaterializationLedger  # noqa: F401
