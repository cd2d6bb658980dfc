"""Horizontal Parquet merge: combine column sets of aligned files by byte
splicing (host-side format surgery, no page re-encode). A copy of
``pqvector_tpu/io/merge.py``.

Closes the round-2 "partial" on component #9 (writer property preservation,
pq-vector src/ivf/parquet.rs:316-534): pyarrow's page-size and
page-statistics knobs are file-global, so the reference's *per-column*
layout (1-row pages + no page stats on the embedding column ONLY,
parquet.rs:324-345) cannot be expressed in one pyarrow write. Instead the
rewrite path writes the embedding column and the remaining columns as
SEPARATE pyarrow files — each file's global knobs are then exactly that
column set's properties — and this module merges them byte-for-byte:

* page bytes are copied verbatim per column chunk,
* offset indexes are re-emitted with shifted page offsets (unknown thrift
  fields preserved; the port rebases the plain layout every writer emits on
  arrays, ``_shift_offset_index_plain``, to the same bytes),
* column indexes are copied verbatim (no internal file offsets),
* the footers are merged structurally: schemas concatenated under one root,
  per-row-group column chunk lists concatenated with shifted offsets,
  column_orders concatenated, key-value metadata unioned.

All parts must have identical row-group row counts (the callers write them
from the same table with the same row_group_size).
"""

from __future__ import annotations

import os

import numpy as np

from ..errors import FormatError, ValidationError
from .thrift import (
    CT_BINARY,
    CT_I32,
    CT_I64,
    CT_LIST,
    CT_STOP,
    CT_STRUCT,
    parse_struct_fields,
    read_varint,
    write_field_header,
    write_varint,
    zigzag_decode,
    zigzag_encode,
)

MAGIC = b"PAR1"


# ----------------------------------------------------------------------
# Generic compact-protocol re-emit helpers
# ----------------------------------------------------------------------


def enc_i64(value: int) -> bytes:
    return write_varint(zigzag_encode(value))


def dec_varint_body(body: bytes) -> int:
    v, _ = read_varint(memoryview(body), 0)
    return zigzag_decode(v)


def reemit_struct(buf: memoryview, transform) -> bytes:
    """Re-serialize one struct, copying every field verbatim except those
    for which ``transform(field_id, ctype, body) -> bytes | None`` returns
    replacement body bytes. Unknown fields survive untouched."""
    fields, _ = parse_struct_fields(buf)
    out = bytearray()
    prev = 0
    for f in fields:
        body = bytes(buf[f.body_start : f.body_end])
        replacement = transform(f.field_id, f.ctype, body)
        if replacement is not None:
            body = replacement
        out += write_field_header(prev, f.field_id, f.ctype)
        out += body
        prev = f.field_id
    out.append(CT_STOP)
    return bytes(out)


def parse_list_header(buf: memoryview, pos: int = 0) -> tuple[int, int, int]:
    header = buf[pos]
    pos += 1
    elem_type = header & 0x0F
    size = header >> 4
    if size == 15:
        size, pos = read_varint(buf, pos)
    return elem_type, size, pos


def emit_list_header(elem_type: int, size: int) -> bytes:
    if size < 15:
        return bytes([(size << 4) | elem_type])
    return bytes([0xF0 | elem_type]) + write_varint(size)


def split_struct_list(body: bytes) -> list[bytes]:
    """A CT_LIST-of-struct body -> raw bytes of each element struct."""
    buf = memoryview(body)
    elem_type, size, pos = parse_list_header(buf)
    if size and elem_type != CT_STRUCT:
        raise FormatError("expected a list of structs")
    items = []
    for _ in range(size):
        _, consumed = parse_struct_fields(buf[pos:])
        items.append(bytes(buf[pos : pos + consumed]))
        pos += consumed
    return items


def join_struct_list(items: list[bytes]) -> bytes:
    return emit_list_header(CT_STRUCT, len(items)) + b"".join(items)


# ----------------------------------------------------------------------
# Parquet structures (field ids from parquet.thrift)
# ----------------------------------------------------------------------

# FileMetaData
_FMD_VERSION = 1
_FMD_SCHEMA = 2
_FMD_NUM_ROWS = 3
_FMD_ROW_GROUPS = 4
_FMD_KV = 5
_FMD_CREATED_BY = 6
_FMD_COLUMN_ORDERS = 7

# RowGroup
_RG_COLUMNS = 1
_RG_TOTAL_BYTE_SIZE = 2
_RG_NUM_ROWS = 3
_RG_FILE_OFFSET = 5
_RG_TOTAL_COMPRESSED = 6
_RG_ORDINAL = 7

# ColumnChunk
_CC_FILE_OFFSET = 2
_CC_META = 3
_CC_OI_OFFSET = 4
_CC_OI_LENGTH = 5
_CC_CI_OFFSET = 6
_CC_CI_LENGTH = 7

# ColumnMetaData
_CMD_NUM_VALUES = 5
_CMD_TOTAL_UNCOMPRESSED = 6
_CMD_TOTAL_COMPRESSED = 7
_CMD_DATA_PAGE_OFFSET = 9
_CMD_INDEX_PAGE_OFFSET = 10
_CMD_DICT_PAGE_OFFSET = 11
_CMD_BLOOM_OFFSET = 14
_CMD_BLOOM_LENGTH = 15

# SchemaElement
_SE_NUM_CHILDREN = 5

# OffsetIndex / PageLocation
_OI_PAGE_LOCATIONS = 1
_PL_OFFSET = 1


class _Chunk:
    """Parsed-enough view of one ColumnChunk: raw bytes + page byte range +
    index ranges."""

    __slots__ = (
        "raw",
        "pages_start",
        "pages_len",
        "oi_off",
        "oi_len",
        "ci_off",
        "ci_len",
    )

    def __init__(self, raw: bytes):
        self.raw = raw
        self.oi_off = self.oi_len = None
        self.ci_off = self.ci_len = None
        data_off = dict_off = None
        total_comp = None
        fields, _ = parse_struct_fields(memoryview(raw))
        for f in fields:
            body = raw[f.body_start : f.body_end]
            if f.field_id == _CC_OI_OFFSET:
                self.oi_off = dec_varint_body(body)
            elif f.field_id == _CC_OI_LENGTH:
                self.oi_len = dec_varint_body(body)
            elif f.field_id == _CC_CI_OFFSET:
                self.ci_off = dec_varint_body(body)
            elif f.field_id == _CC_CI_LENGTH:
                self.ci_len = dec_varint_body(body)
            elif f.field_id == _CC_META:
                mfields, _ = parse_struct_fields(memoryview(body))
                for mf in mfields:
                    mbody = body[mf.body_start : mf.body_end]
                    if mf.field_id == _CMD_DATA_PAGE_OFFSET:
                        data_off = dec_varint_body(mbody)
                    elif mf.field_id == _CMD_DICT_PAGE_OFFSET:
                        dict_off = dec_varint_body(mbody)
                    elif mf.field_id == _CMD_TOTAL_COMPRESSED:
                        total_comp = dec_varint_body(mbody)
                    elif mf.field_id == _CMD_BLOOM_OFFSET:
                        raise ValidationError(
                            "merge does not support bloom filters"
                        )
        if data_off is None or total_comp is None:
            raise FormatError("ColumnChunk missing page offsets")
        self.pages_start = (
            dict_off if dict_off is not None and dict_off < data_off else data_off
        )
        self.pages_len = total_comp

    def reemit(
        self,
        page_shift: int,
        oi_pos: int | None,
        oi_len: int | None,
        ci_pos: int | None,
    ) -> bytes:
        """ColumnChunk bytes with page/index offsets rebased. ``oi_len`` is
        the RE-EMITTED offset index's byte length (shifted page offsets can
        change varint widths)."""

        def cmd_transform(fid, ctype, body):
            if fid in (
                _CMD_DATA_PAGE_OFFSET,
                _CMD_INDEX_PAGE_OFFSET,
                _CMD_DICT_PAGE_OFFSET,
            ):
                return enc_i64(dec_varint_body(body) + page_shift)
            return None

        def transform(fid, ctype, body):
            if fid == _CC_FILE_OFFSET:
                return enc_i64(dec_varint_body(body) + page_shift)
            if fid == _CC_META:
                return reemit_struct(memoryview(body), cmd_transform)
            if fid == _CC_OI_OFFSET and oi_pos is not None:
                return enc_i64(oi_pos)
            if fid == _CC_OI_LENGTH and oi_len is not None:
                return enc_i64(oi_len)
            if fid == _CC_CI_OFFSET and ci_pos is not None:
                return enc_i64(ci_pos)
            return None

        return reemit_struct(memoryview(self.raw), transform)


#: A PageLocation's field headers as every writer emits them: offset (1,
#: i64), compressed_page_size (2, i32), first_row_index (3, i64), each the
#: short form of a delta of 1.
_PL_HEADERS = ((1 << 4) | CT_I64, (1 << 4) | CT_I32, (1 << 4) | CT_I64)


def _shift_offset_index_plain(raw: bytes, page_shift: int) -> bytes | None:
    """``_shift_offset_index`` for an OffsetIndex of page_locations alone,
    each PageLocation of exactly the three fields in order
    (``_PL_HEADERS``); None for any other layout. The same bytes as
    re-emitting each struct, computed on arrays: a vector column written
    one row a page has a PageLocation a row, a million in a 1M-row file.

    Compact-protocol bytes below 0x80 end a token (a one-byte field header,
    a stop, or a varint's last byte), so the locations are seven tokens
    each: header, offset, header, size, header, first row, stop."""
    if len(raw) < 3 or raw[0] != (_OI_PAGE_LOCATIONS << 4) | CT_LIST or raw[-1] != CT_STOP:
        return None
    try:
        elem_type, size, pos = parse_list_header(memoryview(raw), 1)
    except (IndexError, FormatError):
        return None
    if size == 0 or elem_type != CT_STRUCT or pos >= len(raw) - 1:
        return None
    b = np.frombuffer(raw, np.uint8, count=len(raw) - 1 - pos, offset=pos)
    ends = np.flatnonzero(b < 0x80)
    if ends.size != 7 * size or ends[-1] != b.size - 1:
        return None
    starts = np.concatenate([[0], ends[:-1] + 1])
    ends, starts = ends.reshape(size, 7), starts.reshape(size, 7)
    one_byte = [0, 2, 4, 6]
    heads = np.array(list(_PL_HEADERS) + [CT_STOP], np.uint8)
    if (ends[:, one_byte] != starts[:, one_byte]).any() or (
            b[ends[:, one_byte]] != heads).any():
        return None
    lens = ends[:, 1] - starts[:, 1] + 1
    if lens.max() > 9:  # offsets stay below 2^62
        return None
    j = np.arange(int(lens.max()))
    vb = b[np.minimum(starts[:, 1, None] + j, b.size - 1)].astype(np.uint64) & 0x7F
    vb[j[None, :] >= lens[:, None]] = 0
    v = np.bitwise_or.reduce(vb << (7 * j).astype(np.uint64)[None, :], axis=1)
    n = (v >> np.uint64(1)).astype(np.int64) ^ -(v & np.uint64(1)).astype(np.int64)
    n = n + page_shift
    if n.min() < -(1 << 61) or n.max() >= 1 << 61:
        return None
    z = ((n << 1) ^ (n >> 63)).astype(np.uint64)
    nb = 1 + sum((z >> np.uint64(7 * k)) > 0 for k in range(1, 10)).astype(np.int64)
    rest = ends[:, 6] - starts[:, 2] + 1  # size and first-row fields, stop
    elem = 1 + nb + rest
    off = np.concatenate([[0], np.cumsum(elem)[:-1]])
    out = np.empty(int(elem.sum()), np.uint8)
    out[off] = _PL_HEADERS[0]
    for k in range(int(nb.max())):
        m = nb > k
        byte = ((z >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        byte[nb > k + 1] |= 0x80
        out[off[m] + 1 + k] = byte[m]
    within = np.arange(int(rest.sum())) - np.repeat(np.cumsum(rest) - rest, rest)
    out[np.repeat(off + 1 + nb, rest) + within] = b[np.repeat(starts[:, 2], rest) + within]
    return (bytes([raw[0]]) + emit_list_header(CT_STRUCT, size) + out.tobytes()
            + bytes([CT_STOP]))


def _shift_offset_index(raw: bytes, page_shift: int) -> bytes:
    """OffsetIndex bytes with every PageLocation.offset rebased; unknown
    fields (e.g. unencoded_byte_array_data_bytes) copied verbatim."""
    fast = _shift_offset_index_plain(raw, page_shift)
    if fast is not None:
        return fast

    def pl_transform(fid, ctype, body):
        if fid == _PL_OFFSET:
            return enc_i64(dec_varint_body(body) + page_shift)
        return None

    def oi_transform(fid, ctype, body):
        if fid == _OI_PAGE_LOCATIONS and ctype == CT_LIST:
            items = split_struct_list(body)
            out = [
                reemit_struct(memoryview(it), pl_transform) for it in items
            ]
            return join_struct_list(out)
        return None

    return reemit_struct(memoryview(raw), oi_transform)


class _PartMeta:
    def __init__(self, path: str):
        from .embed import read_footer_metadata

        self.path = path
        # Shared bounds-checked footer reader (magic, encryption and
        # footer-length-vs-file-size checks) — a corrupt part must raise
        # FormatError here, not a confusing negative-seek OSError that the
        # write_parquet_with_index fallback would silently swallow.
        meta = read_footer_metadata(path)
        self.fields = {}
        buf = memoryview(meta)
        fields, _ = parse_struct_fields(buf)
        for fld in fields:
            self.fields[fld.field_id] = (
                fld.ctype,
                meta[fld.body_start : fld.body_end],
            )
        if _FMD_SCHEMA not in self.fields or _FMD_ROW_GROUPS not in self.fields:
            raise FormatError(f"'{path}' footer missing schema/row groups")
        self.schema_items = split_struct_list(self.fields[_FMD_SCHEMA][1])
        self.row_groups = [
            memoryview(rg) for rg in split_struct_list(self.fields[_FMD_ROW_GROUPS][1])
        ]
        self.num_rows = dec_varint_body(self.fields[_FMD_NUM_ROWS][1])

    def root_children(self) -> int:
        fields, _ = parse_struct_fields(memoryview(self.schema_items[0]))
        for f in fields:
            if f.field_id == _SE_NUM_CHILDREN:
                return dec_varint_body(
                    self.schema_items[0][f.body_start : f.body_end]
                )
        return 0

    def rg_field(self, rg: memoryview, fid: int):
        fields, _ = parse_struct_fields(rg)
        for f in fields:
            if f.field_id == fid:
                return bytes(rg[f.body_start : f.body_end])
        return None

    def rg_chunks(self, rg: memoryview) -> list[_Chunk]:
        cols = self.rg_field(rg, _RG_COLUMNS)
        if cols is None:
            raise FormatError("RowGroup missing columns")
        return [_Chunk(item) for item in split_struct_list(cols)]

    def column_orders(self) -> list[bytes] | None:
        entry = self.fields.get(_FMD_COLUMN_ORDERS)
        if entry is None:
            return None
        return split_struct_list(entry[1])

    def kv_pairs(self):
        entry = self.fields.get(_FMD_KV)
        if entry is None:
            return []
        from .thrift import decode_key_value_list

        body = entry[1]
        # decode_key_value_list expects (buf, pos) at the list header
        return decode_key_value_list(memoryview(body), 0)


def merge_parquet_files(parts: list[str | os.PathLike], output: str | os.PathLike) -> None:
    """Merge the columns of ``parts`` (row-aligned parquet files) into
    ``output``. Column order = parts order; part 0 provides version,
    created_by, and num_rows; key-value metadata is unioned (first wins)."""
    parts = [os.fspath(p) for p in parts]
    if not parts:
        raise ValidationError("merge requires at least one part")
    metas = [_PartMeta(p) for p in parts]

    n_rows = metas[0].num_rows
    n_rgs = len(metas[0].row_groups)
    for m in metas[1:]:
        if m.num_rows != n_rows or len(m.row_groups) != n_rgs:
            raise ValidationError(
                "merge parts must have identical row counts and row groups"
            )
    for rg_idx in range(n_rgs):
        counts = {
            dec_varint_body(m.rg_field(m.row_groups[rg_idx], _RG_NUM_ROWS))
            for m in metas
        }
        if len(counts) != 1:
            raise ValidationError(
                f"row group {rg_idx} row counts differ between parts"
            )

    all_chunks = [
        [m.rg_chunks(m.row_groups[g]) for g in range(n_rgs)] for m in metas
    ]

    with open(output, "wb") as out:
        out.write(MAGIC)

        # 1. Page bytes, per row group then per part (chunk order in the
        #    output row group = part order), copied verbatim.
        shifts: dict[tuple[int, int, int], int] = {}
        handles = [open(p, "rb") for p in parts]
        try:
            for g in range(n_rgs):
                for pi, m in enumerate(metas):
                    for ci, ch in enumerate(all_chunks[pi][g]):
                        pos = out.tell()
                        shifts[(pi, g, ci)] = pos - ch.pages_start
                        h = handles[pi]
                        h.seek(ch.pages_start)
                        remaining = ch.pages_len
                        while remaining:
                            data = h.read(min(remaining, 8 << 20))
                            if not data:
                                raise FormatError(
                                    f"truncated pages in '{parts[pi]}'"
                                )
                            out.write(data)
                            remaining -= len(data)

            # 2. Column indexes (verbatim) then offset indexes (re-emitted
            #    with rebased page offsets), parquet's usual ordering.
            ci_pos: dict[tuple[int, int, int], int | None] = {}
            oi_pos: dict[tuple[int, int, int], int | None] = {}
            for g in range(n_rgs):
                for pi, m in enumerate(metas):
                    h = handles[pi]
                    for ci, ch in enumerate(all_chunks[pi][g]):
                        key = (pi, g, ci)
                        if ch.ci_off is None or ch.ci_len is None:
                            if ch.ci_off is not None:
                                raise FormatError(
                                    "ColumnChunk has column_index_offset "
                                    "without column_index_length"
                                )
                            ci_pos[key] = None
                            continue
                        h.seek(ch.ci_off)
                        ci_pos[key] = out.tell()
                        out.write(h.read(ch.ci_len))
            oi_newlen: dict[tuple[int, int, int], int | None] = {}
            for g in range(n_rgs):
                for pi, m in enumerate(metas):
                    h = handles[pi]
                    for ci, ch in enumerate(all_chunks[pi][g]):
                        key = (pi, g, ci)
                        if ch.oi_off is None or ch.oi_len is None:
                            if ch.oi_off is not None:
                                raise FormatError(
                                    "ColumnChunk has offset_index_offset "
                                    "without offset_index_length"
                                )
                            oi_pos[key] = None
                            oi_newlen[key] = None
                            continue
                        h.seek(ch.oi_off)
                        raw = h.read(ch.oi_len)
                        data = _shift_offset_index(raw, shifts[key])
                        oi_pos[key] = out.tell()
                        oi_newlen[key] = len(data)
                        out.write(data)
        finally:
            for h in handles:
                h.close()

        # 3. Merged footer.
        meta_bytes = _merged_metadata(
            metas, all_chunks, shifts, oi_pos, oi_newlen, ci_pos, n_rgs
        )
        meta_start = out.tell()
        out.write(meta_bytes)
        out.write(len(meta_bytes).to_bytes(4, "little"))
        out.write(MAGIC)


def _merged_metadata(
    metas, all_chunks, shifts, oi_pos, oi_newlen, ci_pos, n_rgs
) -> bytes:
    # Schema: part0 root with num_children = sum of parts' root children,
    # then every part's non-root elements in part order.
    total_children = sum(m.root_children() for m in metas)

    def root_transform(fid, ctype, body):
        if fid == _SE_NUM_CHILDREN:
            return enc_i64(total_children)
        return None

    schema_items = [
        reemit_struct(memoryview(metas[0].schema_items[0]), root_transform)
    ]
    for m in metas:
        schema_items.extend(m.schema_items[1:])
    schema_body = join_struct_list(schema_items)

    # Row groups.
    rg_items = []
    for g in range(n_rgs):
        cols = []
        total_byte_size = 0
        total_compressed = 0
        first_offset = None
        for pi, m in enumerate(metas):
            rg = m.row_groups[g]
            tbs = m.rg_field(rg, _RG_TOTAL_BYTE_SIZE)
            if tbs is not None:
                total_byte_size += dec_varint_body(tbs)
            for ci, ch in enumerate(all_chunks[pi][g]):
                key = (pi, g, ci)
                cols.append(
                    ch.reemit(
                        shifts[key], oi_pos[key], oi_newlen[key], ci_pos[key]
                    )
                )
                total_compressed += ch.pages_len
                new_start = ch.pages_start + shifts[key]
                if first_offset is None or new_start < first_offset:
                    first_offset = new_start
        # Re-emit part 0's RowGroup with targeted replacements (the same
        # pattern as the ColumnChunk path) so any field this module does
        # not know about — e.g. one added by a newer writer — survives
        # verbatim, as the module contract promises. num_rows and
        # sorting_columns are kept from part 0 (identical across parts by
        # the row-count check above).
        def rg_transform(fid, ctype, body, g=g, cols=cols,
                         total_byte_size=total_byte_size,
                         total_compressed=total_compressed,
                         first_offset=first_offset):
            if fid == _RG_COLUMNS:
                return join_struct_list(cols)
            if fid == _RG_TOTAL_BYTE_SIZE:
                return enc_i64(total_byte_size)
            if fid == _RG_FILE_OFFSET:
                return enc_i64(
                    first_offset if first_offset is not None else 4
                )
            if fid == _RG_TOTAL_COMPRESSED:
                return enc_i64(total_compressed)
            if fid == _RG_ORDINAL:
                return write_varint(zigzag_encode(g))
            return None

        rg_items.append(
            reemit_struct(memoryview(metas[0].row_groups[g]), rg_transform)
        )
    row_groups_body = join_struct_list(rg_items)

    # Column orders: merge if every part has them.
    orders = [m.column_orders() for m in metas]
    column_orders_body = None
    if all(o is not None for o in orders):
        merged = []
        for o in orders:
            merged.extend(o)
        column_orders_body = join_struct_list(merged)

    # Key-value metadata: union, first occurrence wins.
    from .thrift import encode_key_value_list

    kv: list[tuple[str, str | None]] = []
    seen = set()
    for m in metas:
        for key, val in m.kv_pairs():
            if key not in seen:
                seen.add(key)
                kv.append((key, val))
    kv_body = encode_key_value_list(kv) if kv else None

    out = bytearray()
    prev = 0
    version = metas[0].fields.get(_FMD_VERSION)
    if version is not None:
        out += write_field_header(prev, _FMD_VERSION, version[0])
        out += version[1]
        prev = _FMD_VERSION
    out += write_field_header(prev, _FMD_SCHEMA, CT_LIST)
    out += schema_body
    prev = _FMD_SCHEMA
    out += write_field_header(prev, _FMD_NUM_ROWS, CT_I64)
    out += metas[0].fields[_FMD_NUM_ROWS][1]
    prev = _FMD_NUM_ROWS
    out += write_field_header(prev, _FMD_ROW_GROUPS, CT_LIST)
    out += row_groups_body
    prev = _FMD_ROW_GROUPS
    if kv_body is not None:
        out += write_field_header(prev, _FMD_KV, CT_LIST)
        out += kv_body
        prev = _FMD_KV
    created = metas[0].fields.get(_FMD_CREATED_BY)
    if created is not None:
        out += write_field_header(prev, _FMD_CREATED_BY, CT_BINARY)
        out += created[1]
        prev = _FMD_CREATED_BY
    if column_orders_body is not None:
        out += write_field_header(prev, _FMD_COLUMN_ORDERS, CT_LIST)
        out += column_orders_body
        prev = _FMD_COLUMN_ORDERS
    out.append(CT_STOP)
    return bytes(out)
