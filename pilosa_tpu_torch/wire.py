"""Protobuf wire codec + message types for the HTTP data plane.

Wire-compatible with the reference's protobuf schema (internal/public.proto
and internal/private.proto): field numbers, types, and the proto3 encoding
rules below are interface facts taken from those definitions; the runtime
is written from scratch (a ~200-line varint/length-delimited codec) rather
than generated, so this build carries no protobuf library dependency.

proto3 rules implemented: varint (wire type 0) for ints/bools with zero
values omitted, 64-bit (wire type 1) for double, length-delimited (wire
type 2) for strings/bytes/sub-messages/packed repeated scalars; unpacked
repeated scalar fields are also accepted on decode for compatibility.
"""

from __future__ import annotations

import struct
from typing import Any, Iterable

# Attr.Type enum (reference attr.go:36-39).
ATTR_TYPE_STRING = 1
ATTR_TYPE_INT = 2
ATTR_TYPE_BOOL = 3
ATTR_TYPE_FLOAT = 4


# ---------------------------------------------------------------------------
# Primitive codec
# ---------------------------------------------------------------------------

def encode_varint(v: int) -> bytes:
    if v < 0:
        v &= (1 << 64) - 1  # two's-complement for int64 fields
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def varint(self, field: int, v: int, *, force: bool = False) -> "Writer":
        if v or force:
            self.parts.append(_tag(field, 0))
            self.parts.append(encode_varint(int(v)))
        return self

    def bool(self, field: int, v: bool) -> "Writer":
        return self.varint(field, 1 if v else 0)

    def double(self, field: int, v: float) -> "Writer":
        if v != 0.0:
            self.parts.append(_tag(field, 1))
            self.parts.append(struct.pack("<d", v))
        return self

    def string(self, field: int, v: str) -> "Writer":
        if v:
            raw = v.encode()
            self.parts.append(_tag(field, 2))
            self.parts.append(encode_varint(len(raw)))
            self.parts.append(raw)
        return self

    def bytes_field(self, field: int, raw: bytes, *, force: bool = False) -> "Writer":
        if raw or force:
            self.parts.append(_tag(field, 2))
            self.parts.append(encode_varint(len(raw)))
            self.parts.append(raw)
        return self

    def message(self, field: int, msg: bytes) -> "Writer":
        return self.bytes_field(field, msg, force=True)

    def packed(self, field: int, values: Iterable[int]) -> "Writer":
        values = list(values)
        if values:
            from pilosa_tpu_torch import native

            self.bytes_field(field, native.varint_encode(values), force=True)
        return self

    def finish(self) -> bytes:
        return b"".join(self.parts)


def iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) triples."""
    i = 0
    n = len(data)
    while i < n:
        key, i = decode_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = decode_varint(data, i)
            yield field, wire, v
        elif wire == 1:
            if i + 8 > n:
                raise ValueError("truncated fixed64")
            yield field, wire, struct.unpack_from("<d", data, i)[0]
            i += 8
        elif wire == 2:
            ln, i = decode_varint(data, i)
            if i + ln > n:
                raise ValueError("truncated length-delimited field")
            yield field, wire, data[i : i + ln]
            i += ln
        elif wire == 5:
            if i + 4 > n:
                raise ValueError("truncated fixed32")
            yield field, wire, struct.unpack_from("<f", data, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def decode_packed_uint64(raw) -> list[int]:
    if isinstance(raw, int):  # unpacked single value
        return [raw]
    from pilosa_tpu_torch import native

    return [int(v) for v in native.varint_decode(bytes(raw))]


# ---------------------------------------------------------------------------
# Attr maps (public.proto Attr/AttrMap; encode rules attr.go:303-363)
# ---------------------------------------------------------------------------

def encode_attr(key: str, value: Any) -> bytes:
    w = Writer().string(1, key)
    if isinstance(value, bool):
        w.varint(2, ATTR_TYPE_BOOL).bool(5, value)
    elif isinstance(value, str):
        w.varint(2, ATTR_TYPE_STRING).string(3, value)
    elif isinstance(value, int):
        w.varint(2, ATTR_TYPE_INT).varint(4, value)
    elif isinstance(value, float):
        w.varint(2, ATTR_TYPE_FLOAT).double(6, value)
    else:
        raise TypeError(f"unsupported attr type: {key}={value!r}")
    return w.finish()


def decode_attr(data: bytes) -> tuple[str, Any]:
    key, typ = "", 0
    sval, ival, bval, fval = "", 0, False, 0.0
    for field, wire, v in iter_fields(data):
        if field == 1:
            key = v.decode()
        elif field == 2:
            typ = v
        elif field == 3:
            sval = v.decode()
        elif field == 4:
            ival = _signed64(v)
        elif field == 5:
            bval = bool(v)
        elif field == 6:
            fval = v
    if typ == ATTR_TYPE_STRING:
        return key, sval
    if typ == ATTR_TYPE_INT:
        return key, ival
    if typ == ATTR_TYPE_BOOL:
        return key, bval
    if typ == ATTR_TYPE_FLOAT:
        return key, fval
    return key, None


def encode_attrs(attrs: dict) -> list[bytes]:
    return [encode_attr(k, attrs[k]) for k in sorted(attrs)]


def decode_attrs(raws: list[bytes]) -> dict:
    out = {}
    for raw in raws:
        k, v = decode_attr(raw)
        if k and v is not None:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Public messages (public.proto)
# ---------------------------------------------------------------------------

def encode_bitmap(bits: list[int], attrs: dict | None = None) -> bytes:
    w = Writer().packed(1, bits)
    for a in encode_attrs(attrs or {}):
        w.message(2, a)
    return w.finish()


def decode_bitmap(data: bytes) -> tuple[list[int], dict]:
    bits: list[int] = []
    attrs: list[bytes] = []
    for field, wire, v in iter_fields(data):
        if field == 1:
            bits.extend(decode_packed_uint64(v))
        elif field == 2:
            attrs.append(v)
    return bits, decode_attrs(attrs)


def encode_pair(id: int, count: int) -> bytes:
    return Writer().varint(1, id).varint(2, count).finish()


def decode_pair(data: bytes) -> tuple[int, int]:
    key = count = 0
    for field, wire, v in iter_fields(data):
        if field == 1:
            key = v
        elif field == 2:
            count = v
    return key, count


def encode_query_request(
    query: str,
    slices: list[int] | None = None,
    column_attrs: bool = False,
    quantum: str = "",
    remote: bool = False,
) -> bytes:
    return (
        Writer()
        .string(1, query)
        .packed(2, slices or [])
        .bool(3, column_attrs)
        .string(4, quantum)
        .bool(5, remote)
        .finish()
    )


def decode_query_request(data: bytes) -> dict:
    out = {"query": "", "slices": [], "column_attrs": False, "quantum": "", "remote": False}
    for field, wire, v in iter_fields(data):
        if field == 1:
            out["query"] = v.decode()
        elif field == 2:
            out["slices"].extend(decode_packed_uint64(v))
        elif field == 3:
            out["column_attrs"] = bool(v)
        elif field == 4:
            out["quantum"] = v.decode()
        elif field == 5:
            out["remote"] = bool(v)
    return out


def encode_query_result(result: Any) -> bytes:
    """Encode one executor result into a QueryResult message."""
    from pilosa_tpu_torch.core.cache import Pair
    from pilosa_tpu_torch.executor import QueryBitmap

    w = Writer()
    if isinstance(result, QueryBitmap):
        w.message(1, encode_bitmap(result.bits(), result.attrs))
    elif isinstance(result, bool):
        w.bool(4, result)
    elif isinstance(result, int):
        w.varint(2, result)
    elif isinstance(result, list):  # TopN pairs
        for p in result:
            if isinstance(p, Pair):
                w.message(3, encode_pair(p.id, p.count))
            else:
                w.message(3, encode_pair(p["id"], p["count"]))
    elif result is None:
        pass
    else:
        raise TypeError(f"cannot encode query result: {result!r}")
    return w.finish()


def decode_query_result(data: bytes) -> dict:
    out: dict[str, Any] = {}
    pairs = []
    for field, wire, v in iter_fields(data):
        if field == 1:
            bits, attrs = decode_bitmap(v)
            out["bitmap"] = {"bits": bits, "attrs": attrs}
        elif field == 2:
            out["n"] = v
        elif field == 3:
            pairs.append(decode_pair(v))
        elif field == 4:
            out["changed"] = bool(v)
    if pairs:
        out["pairs"] = [{"id": k, "count": c} for k, c in pairs]
    return out


def encode_column_attr_set(id: int, attrs: dict) -> bytes:
    w = Writer().varint(1, id)
    for a in encode_attrs(attrs):
        w.message(2, a)
    return w.finish()


def decode_column_attr_set(data: bytes) -> tuple[int, dict]:
    id = 0
    attrs: list[bytes] = []
    for field, wire, v in iter_fields(data):
        if field == 1:
            id = v
        elif field == 2:
            attrs.append(v)
    return id, decode_attrs(attrs)


def encode_query_response(
    results: list[Any] | None = None,
    err: str = "",
    column_attr_sets: list[tuple[int, dict]] | None = None,
) -> bytes:
    w = Writer().string(1, err)
    for r in results or []:
        w.message(2, encode_query_result(r))
    for id, attrs in column_attr_sets or []:
        w.message(3, encode_column_attr_set(id, attrs))
    return w.finish()


def decode_query_response(data: bytes) -> dict:
    out: dict[str, Any] = {"err": "", "results": [], "columnAttrSets": []}
    for field, wire, v in iter_fields(data):
        if field == 1:
            out["err"] = v.decode()
        elif field == 2:
            out["results"].append(decode_query_result(v))
        elif field == 3:
            id, attrs = decode_column_attr_set(v)
            out["columnAttrSets"].append({"id": id, "attrs": attrs})
    return out


def encode_import_request(
    index: str,
    frame: str,
    slice_i: int,
    row_ids: list[int],
    column_ids: list[int],
    timestamps: list[int] | None = None,
) -> bytes:
    return (
        Writer()
        .string(1, index)
        .string(2, frame)
        .varint(3, slice_i)
        .packed(4, row_ids)
        .packed(5, column_ids)
        .packed(6, timestamps or [])
        .finish()
    )


def decode_import_request(data: bytes) -> dict:
    out = {"index": "", "frame": "", "slice": 0, "rowIDs": [], "columnIDs": [], "timestamps": []}
    for field, wire, v in iter_fields(data):
        if field == 1:
            out["index"] = v.decode()
        elif field == 2:
            out["frame"] = v.decode()
        elif field == 3:
            out["slice"] = v
        elif field == 4:
            out["rowIDs"].extend(decode_packed_uint64(v))
        elif field == 5:
            out["columnIDs"].extend(decode_packed_uint64(v))
        elif field == 6:
            out["timestamps"].extend(_signed64(x) for x in decode_packed_uint64(v))
    return out


# ---------------------------------------------------------------------------
# Private messages (private.proto) — block sync, schema/broadcast, status
# ---------------------------------------------------------------------------

def encode_bit(row_id: int, column_id: int, timestamp: int = 0) -> bytes:
    """internal.Bit (public.proto:17-21)."""
    return Writer().varint(1, row_id).varint(2, column_id).varint(3, timestamp).finish()


def decode_bit(data: bytes) -> dict:
    out = {"rowID": 0, "columnID": 0, "timestamp": 0}
    for field, wire, v in iter_fields(data):
        if field == 1:
            out["rowID"] = v
        elif field == 2:
            out["columnID"] = v
        elif field == 3:
            out["timestamp"] = _signed64(v)
    return out


def encode_attr_map(attrs: dict) -> bytes:
    """internal.AttrMap (public.proto:34-36; the reference's attr-store
    value encoding, attr.go:303-363)."""
    w = Writer()
    for a in encode_attrs(attrs):
        w.message(1, a)
    return w.finish()


def decode_attr_map(data: bytes) -> dict:
    raws = [v for field, wire, v in iter_fields(data) if field == 1]
    return decode_attrs(raws)


def encode_import_response(err: str = "") -> bytes:
    """internal.ImportResponse (private.proto:17-19)."""
    return Writer().string(1, err).finish()


def decode_import_response(data: bytes) -> str:
    for field, wire, v in iter_fields(data):
        if field == 1:
            return v.decode()
    return ""


def encode_index_meta(column_label: str, time_quantum: str) -> bytes:
    return Writer().string(1, column_label).string(2, time_quantum).finish()


def decode_index_meta(data: bytes) -> dict:
    out = {"columnLabel": "", "timeQuantum": ""}
    for field, wire, v in iter_fields(data):
        if field == 1:
            out["columnLabel"] = v.decode()
        elif field == 2:
            out["timeQuantum"] = v.decode()
    return out


def encode_frame_meta(
    row_label: str, inverse_enabled: bool, cache_type: str, cache_size: int, time_quantum: str
) -> bytes:
    return (
        Writer()
        .string(1, row_label)
        .bool(2, inverse_enabled)
        .string(3, cache_type)
        .varint(4, cache_size)
        .string(5, time_quantum)
        .finish()
    )


def decode_frame_meta(data: bytes) -> dict:
    out = {"rowLabel": "", "inverseEnabled": False, "cacheType": "", "cacheSize": 0, "timeQuantum": ""}
    for field, wire, v in iter_fields(data):
        if field == 1:
            out["rowLabel"] = v.decode()
        elif field == 2:
            out["inverseEnabled"] = bool(v)
        elif field == 3:
            out["cacheType"] = v.decode()
        elif field == 4:
            out["cacheSize"] = v
        elif field == 5:
            out["timeQuantum"] = v.decode()
    return out


def encode_block_data_request(index: str, frame: str, view: str, slice_i: int, block: int) -> bytes:
    return (
        Writer()
        .string(1, index)
        .string(2, frame)
        .varint(3, block)
        .varint(4, slice_i)
        .string(5, view)
        .finish()
    )


def decode_block_data_request(data: bytes) -> dict:
    out = {"index": "", "frame": "", "view": "", "slice": 0, "block": 0}
    for field, wire, v in iter_fields(data):
        if field == 1:
            out["index"] = v.decode()
        elif field == 2:
            out["frame"] = v.decode()
        elif field == 3:
            out["block"] = v
        elif field == 4:
            out["slice"] = v
        elif field == 5:
            out["view"] = v.decode()
    return out


def encode_block_data_response(row_ids: list[int], column_ids: list[int]) -> bytes:
    return Writer().packed(1, row_ids).packed(2, column_ids).finish()


def decode_block_data_response(data: bytes) -> tuple[list[int], list[int]]:
    rows: list[int] = []
    cols: list[int] = []
    for field, wire, v in iter_fields(data):
        if field == 1:
            rows.extend(decode_packed_uint64(v))
        elif field == 2:
            cols.extend(decode_packed_uint64(v))
    return rows, cols


def encode_block_diff(
    set_rows: list[int], set_cols: list[int], clear_rows: list[int], clear_cols: list[int]
) -> bytes:
    """Internal sync message: bit diffs to apply to one fragment block.

    Not part of the reference wire surface — the reference pushes merge
    diffs as SetBit/ClearBit PQL (fragment.go:1403-1481), which re-derives
    view routing and labels on the peer; this message applies the diff to
    the exact (index, frame, view, slice) fragment instead, which is
    correct for inverse and time views too.
    """
    return (
        Writer()
        .packed(1, set_rows)
        .packed(2, set_cols)
        .packed(3, clear_rows)
        .packed(4, clear_cols)
        .finish()
    )


def decode_block_diff(data: bytes) -> tuple[list[int], list[int], list[int], list[int]]:
    out: list[list[int]] = [[], [], [], []]
    for field, wire_t, v in iter_fields(data):
        if 1 <= field <= 4:
            out[field - 1].extend(decode_packed_uint64(v))
    return out[0], out[1], out[2], out[3]


def encode_cache(ids: list[int]) -> bytes:
    return Writer().packed(1, ids).finish()


def decode_cache(data: bytes) -> list[int]:
    ids: list[int] = []
    for field, wire, v in iter_fields(data):
        if field == 1:
            ids.extend(decode_packed_uint64(v))
    return ids


def encode_max_slices_response(max_slices: dict[str, int]) -> bytes:
    w = Writer()
    # proto3 map entries: sorted by key (both gogo and google.protobuf
    # deterministic order), value field emitted even when 0.
    for k in sorted(max_slices):
        entry = Writer().string(1, k).varint(2, max_slices[k], force=True).finish()
        w.message(1, entry)
    return w.finish()


def decode_max_slices_response(data: bytes) -> dict[str, int]:
    out: dict[str, int] = {}
    for field, wire, v in iter_fields(data):
        if field == 1:
            key, val = "", 0
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1:
                    key = v2.decode()
                elif f2 == 2:
                    val = v2
            out[key] = val
    return out


# -- node status (internal/private.proto:69-90 Frame/Index/NodeStatus) -------


def encode_node_status(host: str, state: str, indexes: list[dict]) -> bytes:
    """internal.NodeStatus: the gossip/status payload (private.proto:82-86).

    ``indexes`` items: {"name", "meta": index-meta dict, "maxSlice",
    "frames": [{"name", "meta": frame-meta dict}], "slices": [int]}.
    """
    w = Writer().string(1, host).string(2, state)
    for idx in indexes:
        iw = Writer().string(1, idx.get("name", ""))
        meta = idx.get("meta")
        if meta is not None:  # unset submessage is omitted (proto3 presence)
            iw.message(
                2, encode_index_meta(meta.get("columnLabel", ""), meta.get("timeQuantum", ""))
            )
        iw.varint(3, idx.get("maxSlice", 0))
        for fr in idx.get("frames", []):
            fmeta = fr.get("meta")
            fw = Writer().string(1, fr.get("name", ""))
            if fmeta is not None:
                fw.message(
                    2,
                    encode_frame_meta(
                        fmeta.get("rowLabel", ""),
                        fmeta.get("inverseEnabled", False),
                        fmeta.get("cacheType", ""),
                        fmeta.get("cacheSize", 0),
                        fmeta.get("timeQuantum", ""),
                    ),
                )
            iw.message(4, fw.finish())
        # repeated scalar -> packed in proto3 (zero entries survive the
        # length-prefixed encoding; matches the reference encoder's bytes).
        iw.packed(5, idx.get("slices", []))
        w.message(3, iw.finish())
    return w.finish()


def decode_node_status(data: bytes) -> dict:
    out: dict = {"host": "", "state": "", "indexes": []}
    for field, wire, v in iter_fields(data):
        if field == 1:
            out["host"] = v.decode()
        elif field == 2:
            out["state"] = v.decode()
        elif field == 3:
            out["indexes"].append(_decode_index_msg(v))
    return out


def _decode_index_msg(v: bytes) -> dict:
    """internal.Index (private.proto Frame/Index); ``meta`` keys appear
    only when the submessage was present on the wire (re-encode parity)."""
    idx: dict = {"name": "", "maxSlice": 0, "frames": [], "slices": []}
    for f2, w2, v2 in iter_fields(v):
        if f2 == 1:
            idx["name"] = v2.decode()
        elif f2 == 2:
            idx["meta"] = decode_index_meta(v2)
        elif f2 == 3:
            idx["maxSlice"] = v2
        elif f2 == 4:
            fr: dict = {"name": ""}
            for f3, w3, v3 in iter_fields(v2):
                if f3 == 1:
                    fr["name"] = v3.decode()
                elif f3 == 2:
                    fr["meta"] = decode_frame_meta(v3)
            idx["frames"].append(fr)
        elif f2 == 5:
            # packed (reference encoding) or unpacked (also legal proto3)
            idx["slices"].extend(decode_packed_uint64(v2))
    return idx


def encode_cluster_status(nodes: list[dict]) -> bytes:
    """internal.ClusterStatus (private.proto:88-90): the gossip
    LocalState/MergeRemoteState payload.  ``nodes`` items use the
    encode_node_status dict shape."""
    w = Writer()
    for n in nodes:
        w.message(
            1, encode_node_status(n.get("host", ""), n.get("state", ""), n.get("indexes", []))
        )
    return w.finish()


def decode_cluster_status(data: bytes) -> list[dict]:
    return [decode_node_status(v) for field, wire, v in iter_fields(data) if field == 1]
