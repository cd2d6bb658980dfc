"""Minimal Thrift compact-protocol reader/writer for Parquet footer surgery.

The in-place index append (component #8 in SURVEY.md §2,
pq-vector src/ivf/parquet.rs:536-611) must rewrite the Parquet footer's
Thrift-serialized ``FileMetaData`` with updated key-value pairs while leaving
every other field byte-identical. The reference leans on parquet-rs's
``ParquetMetaDataWriter``; we instead perform a *surgical splice*: parse the
top-level compact-protocol field stream, re-emit every field verbatim (with
recomputed field-id deltas), and replace/insert field 5
(``key_value_metadata: list<KeyValue>``).

This keeps row-group byte ranges, schema, column orders, bloom-filter offsets,
etc. untouched — strictly more faithful than a decode/re-encode round trip.

parquet.thrift layout relied upon::

    struct FileMetaData {
      1: i32 version; 2: list<SchemaElement> schema; 3: i64 num_rows;
      4: list<RowGroup> row_groups; 5: optional list<KeyValue> key_value_metadata;
      6: optional string created_by; 7: optional list<ColumnOrder> column_orders;
      8: optional EncryptionAlgorithm; 9: optional binary footer_signing_key;
    }
    struct KeyValue { 1: string key; 2: optional string value }

A mirrored C++ implementation lives in ``native/``; this module is the
portable fallback and the test oracle.
"""

from __future__ import annotations

from ..errors import FormatError

# Compact-protocol type ids.
CT_STOP = 0x0
CT_BOOL_TRUE = 0x1
CT_BOOL_FALSE = 0x2
CT_BYTE = 0x3
CT_I16 = 0x4
CT_I32 = 0x5
CT_I64 = 0x6
CT_DOUBLE = 0x7
CT_BINARY = 0x8
CT_LIST = 0x9
CT_SET = 0xA
CT_MAP = 0xB
CT_STRUCT = 0xC

KV_FIELD_ID = 5  # FileMetaData.key_value_metadata


# ----------------------------------------------------------------------
# Primitive readers
# ----------------------------------------------------------------------


def read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise FormatError("Thrift varint extends past end of buffer")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise FormatError("Thrift varint too long")


def write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag_decode(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def zigzag_encode(value: int) -> int:
    return (value << 1) ^ (value >> 63) if value < 0 else value << 1


def _skip_value(buf: memoryview, pos: int, ctype: int) -> int:
    """Advance past one value of compact type ``ctype``."""
    if ctype in (CT_BOOL_TRUE, CT_BOOL_FALSE):
        return pos  # value lives in the field header
    if ctype == CT_BYTE:
        return pos + 1
    if ctype in (CT_I16, CT_I32, CT_I64):
        _, pos = read_varint(buf, pos)
        return pos
    if ctype == CT_DOUBLE:
        return pos + 8
    if ctype == CT_BINARY:
        length, pos = read_varint(buf, pos)
        end = pos + length
        if end > len(buf):
            raise FormatError("Thrift binary extends past end of buffer")
        return end
    if ctype in (CT_LIST, CT_SET):
        header = buf[pos]
        pos += 1
        elem_type = header & 0x0F
        size = header >> 4
        if size == 15:
            size, pos = read_varint(buf, pos)
        return _skip_list_elems(buf, pos, elem_type, size)
    if ctype == CT_MAP:
        size, pos = read_varint(buf, pos)
        if size == 0:
            return pos
        kv_types = buf[pos]
        pos += 1
        key_type = kv_types >> 4
        val_type = kv_types & 0x0F
        for _ in range(size):
            pos = _skip_value(buf, pos, key_type)
            pos = _skip_value(buf, pos, val_type)
        return pos
    if ctype == CT_STRUCT:
        return _skip_struct(buf, pos)
    raise FormatError(f"Unknown thrift compact type {ctype}")


def _skip_list_elems(buf: memoryview, pos: int, elem_type: int, size: int) -> int:
    if elem_type in (CT_BOOL_TRUE, CT_BOOL_FALSE):
        return pos + size  # bool list elems are one byte each
    for _ in range(size):
        pos = _skip_value(buf, pos, elem_type)
    return pos


def _skip_struct(buf: memoryview, pos: int) -> int:
    last_id = 0
    while True:
        if pos >= len(buf):
            raise FormatError("Thrift struct missing STOP")
        header = buf[pos]
        pos += 1
        if header == CT_STOP:
            return pos
        ctype = header & 0x0F
        delta = header >> 4
        if delta:
            last_id += delta
        else:
            fid, pos = read_varint(buf, pos)
            last_id = zigzag_decode(fid)
        pos = _skip_value(buf, pos, ctype)


# ----------------------------------------------------------------------
# Top-level struct field stream
# ----------------------------------------------------------------------


class StructField:
    """One field of a top-level struct: id, type, and raw body byte range."""

    __slots__ = ("field_id", "ctype", "body_start", "body_end")

    def __init__(self, field_id: int, ctype: int, body_start: int, body_end: int):
        self.field_id = field_id
        self.ctype = ctype
        self.body_start = body_start
        self.body_end = body_end


def parse_struct_fields(buf: memoryview) -> tuple[list[StructField], int]:
    """Parse the top-level field stream; returns (fields, pos after STOP)."""
    fields: list[StructField] = []
    pos = 0
    last_id = 0
    while True:
        if pos >= len(buf):
            raise FormatError("Thrift struct missing STOP")
        header = buf[pos]
        pos += 1
        if header == CT_STOP:
            return fields, pos
        ctype = header & 0x0F
        delta = header >> 4
        if delta:
            last_id += delta
        else:
            fid, pos = read_varint(buf, pos)
            last_id = zigzag_decode(fid)
        body_start = pos
        pos = _skip_value(buf, pos, ctype)
        fields.append(StructField(last_id, ctype, body_start, pos))


def write_field_header(prev_id: int, field_id: int, ctype: int) -> bytes:
    delta = field_id - prev_id
    if 1 <= delta <= 15:
        return bytes([(delta << 4) | ctype])
    return bytes([ctype]) + write_varint(zigzag_encode(field_id))


# ----------------------------------------------------------------------
# KeyValue list codec
# ----------------------------------------------------------------------


def _read_binary(buf: memoryview, pos: int) -> tuple[bytes, int]:
    length, pos = read_varint(buf, pos)
    end = pos + length
    if end > len(buf):
        raise FormatError("Thrift binary extends past end of buffer")
    return bytes(buf[pos:end]), end


def decode_key_value_list(buf: memoryview, pos: int) -> list[tuple[str, str | None]]:
    """Decode ``list<KeyValue>`` starting at ``pos`` (the list header)."""
    header = buf[pos]
    pos += 1
    elem_type = header & 0x0F
    size = header >> 4
    if size == 15:
        size, pos = read_varint(buf, pos)
    if elem_type != CT_STRUCT:
        raise FormatError("key_value_metadata list must contain structs")
    out: list[tuple[str, str | None]] = []
    for _ in range(size):
        key: bytes | None = None
        value: bytes | None = None
        last_id = 0
        while True:
            hdr = buf[pos]
            pos += 1
            if hdr == CT_STOP:
                break
            ctype = hdr & 0x0F
            delta = hdr >> 4
            if delta:
                last_id += delta
            else:
                fid, pos = read_varint(buf, pos)
                last_id = zigzag_decode(fid)
            if ctype == CT_BINARY and last_id == 1:
                key, pos = _read_binary(buf, pos)
            elif ctype == CT_BINARY and last_id == 2:
                value, pos = _read_binary(buf, pos)
            else:
                pos = _skip_value(buf, pos, ctype)
        if key is None:
            raise FormatError("KeyValue entry missing key")
        out.append(
            (
                key.decode("utf-8", "replace"),
                None if value is None else value.decode("utf-8", "replace"),
            )
        )
    return out


def encode_key_value_list(pairs: list[tuple[str, str | None]]) -> bytes:
    """Encode ``list<KeyValue>`` (header included)."""
    out = bytearray()
    size = len(pairs)
    if size < 15:
        out.append((size << 4) | CT_STRUCT)
    else:
        out.append(0xF0 | CT_STRUCT)
        out += write_varint(size)
    for key, value in pairs:
        kb = key.encode("utf-8")
        out.append((1 << 4) | CT_BINARY)  # field 1, delta 1
        out += write_varint(len(kb)) + kb
        if value is not None:
            vb = value.encode("utf-8")
            out.append((1 << 4) | CT_BINARY)  # field 2, delta 1
            out += write_varint(len(vb)) + vb
        out.append(CT_STOP)
    return bytes(out)


# ----------------------------------------------------------------------
# FileMetaData KV splice
# ----------------------------------------------------------------------


def read_key_value_metadata(metadata: bytes) -> list[tuple[str, str | None]]:
    """Extract FileMetaData.key_value_metadata pairs (empty list if absent)."""
    buf = memoryview(metadata)
    fields, _ = parse_struct_fields(buf)
    for field in fields:
        if field.field_id == KV_FIELD_ID and field.ctype == CT_LIST:
            return decode_key_value_list(buf, field.body_start)
    return []


def splice_key_value_metadata(
    metadata: bytes,
    set_pairs: list[tuple[str, str]],
    drop_keys: frozenset[str] | set[str] = frozenset(),
) -> bytes:
    """Return new FileMetaData bytes with KV pairs updated.

    Existing pairs are retained minus ``drop_keys``; ``set_pairs`` are appended
    at the end — matching the reference's retain-then-push ordering
    (pq-vector src/ivf/parquet.rs:568-583). All other fields are copied
    byte-for-byte (field-id deltas recomputed as needed).
    """
    buf = memoryview(metadata)
    fields, stop_pos = parse_struct_fields(buf)

    existing: list[tuple[str, str | None]] = []
    for field in fields:
        if field.field_id == KV_FIELD_ID and field.ctype == CT_LIST:
            existing = decode_key_value_list(buf, field.body_start)
            break

    pairs = [(k, v) for (k, v) in existing if k not in drop_keys]
    pairs.extend(set_pairs)
    kv_body = encode_key_value_list(pairs)

    out = bytearray()
    prev_id = 0
    emitted_kv = False
    for field in fields:
        if field.field_id == KV_FIELD_ID:
            out += write_field_header(prev_id, KV_FIELD_ID, CT_LIST)
            out += kv_body
            prev_id = KV_FIELD_ID
            emitted_kv = True
            continue
        if field.field_id > KV_FIELD_ID and not emitted_kv:
            out += write_field_header(prev_id, KV_FIELD_ID, CT_LIST)
            out += kv_body
            prev_id = KV_FIELD_ID
            emitted_kv = True
        out += write_field_header(prev_id, field.field_id, field.ctype)
        out += bytes(buf[field.body_start : field.body_end])
        prev_id = field.field_id
    if not emitted_kv:
        out += write_field_header(prev_id, KV_FIELD_ID, CT_LIST)
        out += kv_body
    out.append(CT_STOP)
    # Preserve any trailing bytes after STOP (none expected, but harmless).
    out += bytes(buf[stop_pos:])
    return bytes(out)
