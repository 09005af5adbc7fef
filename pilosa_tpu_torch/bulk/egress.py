"""Arrow-native egress: fragment contents as IPC record batches.

The symmetric door to the bulk ingress: ``GET /export?format=arrow``
streams a fragment's (row, col) pairs as an Arrow IPC stream whose
schema is EXACTLY what the ingress accepts (uint64 ``row``/``col``
columns), so an export→re-ingest round trip converges byte-identically
— positions come out sorted, the encoder is deterministic, and the
bulk build packs the same planes back.

The column arrays are built zero-copy where pyarrow allows it
(``pa.array`` adopts the numpy buffers); the positions themselves come
straight off the fragment's merged dense view — roaring containers are
NOT materialized for an egress read (``Fragment.export_pairs`` merges
the pending overlay planes in word space).
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.ingest import ARROW_CONTENT_TYPE, IngestError, arrow_available  # noqa: F401
from pilosa_tpu_torch.pilosa import SLICE_WIDTH

# Rows per emitted record batch: bounds the peak batch allocation while
# keeping per-batch framing overhead negligible at export bandwidth.
EXPORT_BATCH_PAIRS = 1 << 18


def encode_arrow_pairs(rows: np.ndarray, cols: np.ndarray,
                       batch_pairs: int = EXPORT_BATCH_PAIRS) -> bytes:
    """Encode (row, col) uint64 columns as an Arrow IPC stream.

    Deterministic: fixed schema, fixed batch split, no metadata that
    varies per process — equal inputs encode to equal bytes (the
    round-trip property the bench asserts).  Raises
    :class:`IngestError` 415 when pyarrow is unavailable.
    """
    try:
        import pyarrow as pa
    except ImportError:
        raise IngestError(
            415, "arrow egress unavailable: pyarrow not importable on this server"
        )
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    cols = np.ascontiguousarray(cols, dtype=np.uint64)
    schema = pa.schema([("row", pa.uint64()), ("col", pa.uint64())])
    import io

    buf = io.BytesIO()
    with pa.ipc.new_stream(buf, schema) as writer:
        n = len(rows)
        for i in range(0, max(n, 1), batch_pairs):
            writer.write_batch(
                pa.record_batch(
                    [pa.array(rows[i : i + batch_pairs], type=pa.uint64()),
                     pa.array(cols[i : i + batch_pairs], type=pa.uint64())],
                    schema=schema,
                )
            )
            if n == 0:
                break
    return buf.getvalue()


def export_fragment_arrow(frag, stats=None) -> bytes:
    """One fragment as an Arrow IPC stream of global (row, col) pairs.

    Pairs come from the fragment's merged dense view (storage +
    pending bulk overlay) — an egress touch does NOT materialize
    roaring containers; that is the point of the columnar door.
    """
    rows, cols = frag.export_pairs()
    out = encode_arrow_pairs(rows, cols)
    if stats is not None:
        stats.count("bulk.export_pairs", int(len(rows)))
        stats.count("bulk.export_bytes", len(out))
    return out


def positions_to_pairs(positions: np.ndarray, slice_i: int):
    """Fragment-linear positions -> global (row, col) uint64 columns."""
    positions = np.asarray(positions, dtype=np.uint64)
    rows = positions // np.uint64(SLICE_WIDTH)
    cols = positions % np.uint64(SLICE_WIDTH) + np.uint64(slice_i * SLICE_WIDTH)
    return rows, cols
