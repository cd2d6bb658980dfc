"""Page-level selective Parquet reads for candidate rows.

The reference's query path reads *only* the 1-row data pages containing
candidate rows, via parquet-rs row selections over the page offset index
(pq-vector src/ivf/search.rs:154-244 and the 1-row-per-page layout from
parquet.rs:324-326). pyarrow cannot select below row-group granularity, so
this module implements the page path directly on our Thrift compact-protocol
parser (io/thrift.py):

* parse ``FileMetaData`` far enough for schema leaves, row groups, column
  chunks and their ``OffsetIndex`` locations,
* for a candidate row set: offset-index binary search -> exact page byte
  ranges -> page-header parse -> decompress -> RLE/bit-packed level decode ->
  PLAIN float decode, or a gather from the chunk's dictionary -> row
  extraction.

Supports the layouts the reference reads/writes: List/FixedSizeList of
FLOAT/DOUBLE, PLAIN and dictionary-encoded data pages (V1 and V2), SNAPPY/
ZSTD/GZIP/UNCOMPRESSED codecs, no nulls (nulls are rejected exactly like
search.rs:212-218). Files without an offset index fall back to the row-group
reader in query/selective.py.

This is a copy of the JAX package's module, host code only, which also
serves dictionary-encoded pages page-exact (the JAX package's reader refuses
them) and decodes into buffers each thread keeps from call to call. The
timings in its comments are the JAX package's, measured on that package's
host; none was taken for this port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import struct
import threading

import numpy as np

from ..errors import ExecutionError, FormatError, ValidationError
from ..types import EmbeddingColumn
from .embed import read_footer_metadata
from ..utils.alloc import alloc_matrix, populate
from ..utils.profiling import count_root, tracing_on
from .thrift import (
    CT_BINARY,
    CT_I32,
    CT_I64,
    CT_LIST,
    CT_STRUCT,
    StructField,
    parse_struct_fields,
    read_varint,
    zigzag_decode,
)

# parquet.thrift Type enum
_TYPE_FLOAT = 4
_TYPE_DOUBLE = 5

# CompressionCodec enum
# CompressionCodec enum: 0 UNCOMPRESSED, 1 SNAPPY, 2 GZIP, 3 LZO, 4 BROTLI,
# 5 LZ4 (legacy framed), 6 ZSTD, 7 LZ4_RAW.
_CODECS = {
    0: "none",
    1: "snappy",
    2: "gzip",
    4: "brotli",
    6: "zstd",
    7: "lz4_raw",
}

# PageType enum
_PAGE_DATA = 0
_PAGE_DICT = 2
_PAGE_DATA_V2 = 3

# Encoding enum
_ENC_PLAIN = 0
_ENC_RLE = 3
#: PLAIN_DICTIONARY (2) and RLE_DICTIONARY (8): a data page of indices into
#: the column chunk's dictionary page.
_DICT_ENCODINGS = (2, 8)


def _list_items(buf: memoryview, pos: int) -> tuple[int, int, int]:
    """Parse a list header at pos -> (elem_type, size, payload_pos)."""
    header = buf[pos]
    pos += 1
    elem_type = header & 0x0F
    size = header >> 4
    if size == 15:
        size, pos = read_varint(buf, pos)
    return elem_type, size, pos


@dataclasses.dataclass
class SchemaLeaf:
    path: str
    ptype: int
    max_def: int
    max_rep: int
    type_length: int = 0


@dataclasses.dataclass
class ChunkInfo:
    codec: str
    num_values: int
    data_page_offset: int
    dictionary_page_offset: int | None
    total_compressed_size: int
    offset_index_offset: int | None
    offset_index_length: int | None


@dataclasses.dataclass
class RowGroupInfo:
    num_rows: int
    chunks: list[ChunkInfo]


@dataclasses.dataclass
class PageLocation:
    offset: int
    compressed_page_size: int
    first_row_index: int


def _parse_schema(buf: memoryview, field: StructField) -> list[SchemaLeaf]:
    """Flatten the SchemaElement list into leaves with max def/rep levels."""
    elem_type, size, pos = _list_items(buf, field.body_start)
    if elem_type != CT_STRUCT:
        raise FormatError("schema must be a list of structs")
    elements = []
    for _ in range(size):
        fields, end = parse_struct_fields(buf[pos:])
        elem = {"name": "", "num_children": 0, "repetition": 0, "type": None, "type_length": 0}
        for f in fields:
            if f.field_id == 1 and f.ctype == CT_I32:
                v, _ = read_varint(buf, pos + f.body_start)
                elem["type"] = zigzag_decode(v)
            elif f.field_id == 2 and f.ctype == CT_I32:
                v, _ = read_varint(buf, pos + f.body_start)
                elem["type_length"] = zigzag_decode(v)
            elif f.field_id == 3 and f.ctype == CT_I32:
                v, _ = read_varint(buf, pos + f.body_start)
                elem["repetition"] = zigzag_decode(v)
            elif f.field_id == 4 and f.ctype == CT_BINARY:
                length, p = read_varint(buf, pos + f.body_start)
                elem["name"] = bytes(buf[p : p + length]).decode("utf-8", "replace")
            elif f.field_id == 5 and f.ctype == CT_I32:
                v, _ = read_varint(buf, pos + f.body_start)
                elem["num_children"] = zigzag_decode(v)
        elements.append(elem)
        pos += end

    leaves: list[SchemaLeaf] = []

    def walk(idx: int, path: list[str], max_def: int, max_rep: int) -> int:
        elem = elements[idx]
        rep = elem["repetition"]
        if idx > 0:  # root doesn't count
            if rep == 1:  # OPTIONAL
                max_def += 1
            elif rep == 2:  # REPEATED
                max_def += 1
                max_rep += 1
            path = path + [elem["name"]]
        idx += 1
        if elem["num_children"] == 0:
            leaves.append(
                SchemaLeaf(
                    path=".".join(path),
                    ptype=elem["type"],
                    max_def=max_def,
                    max_rep=max_rep,
                    type_length=elem["type_length"],
                )
            )
            return idx
        for _ in range(elem["num_children"]):
            idx = walk(idx, path, max_def, max_rep)
        return idx

    walk(0, [], 0, 0)
    return leaves


def _parse_column_chunk(buf: memoryview, pos: int, end: int) -> ChunkInfo:
    fields, _ = parse_struct_fields(buf[pos:])
    meta = None
    oi_off = oi_len = None
    for f in fields:
        if f.field_id == 3 and f.ctype == CT_STRUCT:
            meta = (pos + f.body_start, pos + f.body_end)
        elif f.field_id == 4 and f.ctype == CT_I64:
            v, _ = read_varint(buf, pos + f.body_start)
            oi_off = zigzag_decode(v)
        elif f.field_id == 5 and f.ctype == CT_I32:
            v, _ = read_varint(buf, pos + f.body_start)
            oi_len = zigzag_decode(v)
    if meta is None:
        raise FormatError("ColumnChunk missing ColumnMetaData")
    mfields, _ = parse_struct_fields(buf[meta[0] :])
    codec = "none"
    num_values = 0
    data_page_offset = 0
    dict_page_offset = None
    total_compressed = 0
    for f in mfields:
        base = meta[0]
        if f.field_id == 4 and f.ctype == CT_I32:
            v, _ = read_varint(buf, base + f.body_start)
            code = zigzag_decode(v)
            codec = _CODECS.get(code, f"codec{code}")
        elif f.field_id == 5 and f.ctype == CT_I64:
            v, _ = read_varint(buf, base + f.body_start)
            num_values = zigzag_decode(v)
        elif f.field_id == 7 and f.ctype == CT_I64:
            v, _ = read_varint(buf, base + f.body_start)
            total_compressed = zigzag_decode(v)
        elif f.field_id == 9 and f.ctype == CT_I64:
            v, _ = read_varint(buf, base + f.body_start)
            data_page_offset = zigzag_decode(v)
        elif f.field_id == 11 and f.ctype == CT_I64:
            v, _ = read_varint(buf, base + f.body_start)
            dict_page_offset = zigzag_decode(v)
    return ChunkInfo(
        codec=codec,
        num_values=num_values,
        data_page_offset=data_page_offset,
        dictionary_page_offset=dict_page_offset,
        total_compressed_size=total_compressed,
        offset_index_offset=oi_off,
        offset_index_length=oi_len,
    )


def parse_parquet_metadata(
    meta_bytes: bytes,
) -> tuple[list[SchemaLeaf], list[RowGroupInfo]]:
    buf = memoryview(meta_bytes)
    fields, _ = parse_struct_fields(buf)
    leaves: list[SchemaLeaf] = []
    row_groups: list[RowGroupInfo] = []
    for f in fields:
        if f.field_id == 2 and f.ctype == CT_LIST:
            leaves = _parse_schema(buf, f)
        elif f.field_id == 4 and f.ctype == CT_LIST:
            elem_type, size, pos = _list_items(buf, f.body_start)
            if elem_type != CT_STRUCT:
                raise FormatError("row_groups must be a list of structs")
            for _ in range(size):
                rg_fields, rg_end = parse_struct_fields(buf[pos:])
                chunks: list[ChunkInfo] = []
                num_rows = 0
                for rf in rg_fields:
                    if rf.field_id == 1 and rf.ctype == CT_LIST:
                        et, csize, cpos = _list_items(buf, pos + rf.body_start)
                        for _ in range(csize):
                            _, cend = parse_struct_fields(buf[cpos:])
                            chunks.append(_parse_column_chunk(buf, cpos, cpos + cend))
                            cpos += cend
                    elif rf.field_id == 3 and rf.ctype == CT_I64:
                        v, _ = read_varint(buf, pos + rf.body_start)
                        num_rows = zigzag_decode(v)
                row_groups.append(RowGroupInfo(num_rows=num_rows, chunks=chunks))
                pos += rg_end
    return leaves, row_groups


def parse_offset_index(data: bytes) -> list[PageLocation]:
    buf = memoryview(data)
    fields, _ = parse_struct_fields(buf)
    locations: list[PageLocation] = []
    for f in fields:
        if f.field_id == 1 and f.ctype == CT_LIST:
            elem_type, size, pos = _list_items(buf, f.body_start)
            for _ in range(size):
                pf, pend = parse_struct_fields(buf[pos:])
                off = csize = first = 0
                for p in pf:
                    if p.field_id == 1:
                        v, _ = read_varint(buf, pos + p.body_start)
                        off = zigzag_decode(v)
                    elif p.field_id == 2:
                        v, _ = read_varint(buf, pos + p.body_start)
                        csize = zigzag_decode(v)
                    elif p.field_id == 3:
                        v, _ = read_varint(buf, pos + p.body_start)
                        first = zigzag_decode(v)
                locations.append(PageLocation(off, csize, first))
                pos += pend
    return locations


# ----------------------------------------------------------------------
# Page decoding
# ----------------------------------------------------------------------


@dataclasses.dataclass
class PageHeader:
    page_type: int
    uncompressed_size: int
    compressed_size: int
    num_values: int
    encoding: int
    def_encoding: int
    rep_encoding: int
    # V2 only:
    num_rows: int | None = None
    num_nulls: int | None = None
    def_levels_len: int = 0
    rep_levels_len: int = 0
    v2_is_compressed: bool = True
    header_len: int = 0


def parse_page_header(data: bytes | memoryview) -> PageHeader:
    buf = memoryview(data)
    fields, end = parse_struct_fields(buf)
    h = PageHeader(0, 0, 0, 0, _ENC_PLAIN, _ENC_RLE, _ENC_RLE, header_len=end)
    for f in fields:
        if f.field_id == 1:
            v, _ = read_varint(buf, f.body_start)
            h.page_type = zigzag_decode(v)
        elif f.field_id == 2:
            v, _ = read_varint(buf, f.body_start)
            h.uncompressed_size = zigzag_decode(v)
        elif f.field_id == 3:
            v, _ = read_varint(buf, f.body_start)
            h.compressed_size = zigzag_decode(v)
        elif f.field_id == 5 and f.ctype == CT_STRUCT:  # DataPageHeader
            sub, _ = parse_struct_fields(buf[f.body_start :])
            for s in sub:
                v, _ = read_varint(buf, f.body_start + s.body_start)
                val = zigzag_decode(v)
                if s.field_id == 1:
                    h.num_values = val
                elif s.field_id == 2:
                    h.encoding = val
                elif s.field_id == 3:
                    h.def_encoding = val
                elif s.field_id == 4:
                    h.rep_encoding = val
        elif f.field_id == 7 and f.ctype == CT_STRUCT:  # DictionaryPageHeader
            sub, _ = parse_struct_fields(buf[f.body_start :])
            for s in sub:
                if s.field_id in (1, 2) and s.ctype == CT_I32:
                    v, _ = read_varint(buf, f.body_start + s.body_start)
                    if s.field_id == 1:
                        h.num_values = zigzag_decode(v)
                    else:
                        h.encoding = zigzag_decode(v)
        elif f.field_id == 8 and f.ctype == CT_STRUCT:  # DataPageHeaderV2
            sub, _ = parse_struct_fields(buf[f.body_start :])
            h.v2_is_compressed = True
            for s in sub:
                if s.ctype in (0x1, 0x2):  # bool is_compressed
                    h.v2_is_compressed = s.ctype == 0x1
                    continue
                v, _ = read_varint(buf, f.body_start + s.body_start)
                val = zigzag_decode(v)
                if s.field_id == 1:
                    h.num_values = val
                elif s.field_id == 2:
                    h.num_nulls = val
                elif s.field_id == 3:
                    h.num_rows = val
                elif s.field_id == 4:
                    h.encoding = val
                elif s.field_id == 5:
                    h.def_levels_len = val
                elif s.field_id == 6:
                    h.rep_levels_len = val
    return h


def _decompress(data: bytes, codec: str, uncompressed_size: int) -> bytes:
    if codec == "none":
        return data
    import pyarrow as pa

    if codec == "lz4_raw":
        codec = "lz4_raw" if "lz4_raw" in pa.Codec.supported_codecs() else "lz4"
    try:
        return pa.Codec(codec).decompress(data, uncompressed_size).to_pybytes()
    except Exception as exc:
        raise ExecutionError(f"Failed to decompress {codec} page: {exc}") from exc


def decode_rle_levels(data: memoryview, bit_width: int, count: int) -> np.ndarray:
    """RLE/bit-packed hybrid decoder (parquet levels)."""
    out = np.empty(count, dtype=np.int32)
    if bit_width == 0:
        out.fill(0)
        return out
    pos = 0
    filled = 0
    byte_width = (bit_width + 7) // 8
    while filled < count:
        header, pos = read_varint(data, pos)
        if header & 1:
            # bit-packed run: (header >> 1) groups of 8 values
            groups = header >> 1
            n_vals = groups * 8
            n_bytes = groups * bit_width
            chunk = np.frombuffer(data[pos : pos + n_bytes], dtype=np.uint8)
            pos += n_bytes
            bits = np.unpackbits(chunk, bitorder="little")
            vals = bits.reshape(-1, bit_width)
            weights = (1 << np.arange(bit_width)).astype(np.int64)
            decoded = (vals * weights).sum(axis=1)
            take = min(n_vals, count - filled)
            out[filled : filled + take] = decoded[:take]
            filled += take
        else:
            run = header >> 1
            raw = bytes(data[pos : pos + byte_width]) + b"\x00" * (4 - byte_width)
            value = struct.unpack("<I", raw)[0]
            pos += byte_width
            take = min(run, count - filled)
            out[filled : filled + take] = value
            filled += take
    return out


@dataclasses.dataclass
class DecodedPage:
    """Values + row structure decoded from one data page."""

    values: np.ndarray  # float32 flat values
    row_lengths: np.ndarray  # values per row (from rep levels)


def _float_values(data, ptype: int, n: int) -> np.ndarray:
    """``n`` PLAIN FLOAT or DOUBLE values at the start of ``data`` as f32."""
    if ptype == _TYPE_FLOAT:
        return np.frombuffer(data, dtype="<f4", count=n).astype(np.float32, copy=True)
    if ptype == _TYPE_DOUBLE:
        return np.frombuffer(data, dtype="<f8", count=n).astype(np.float32)
    raise ExecutionError("Embedding values are not float32/float64")


def decode_dictionary_page(raw: bytes, codec: str, leaf: SchemaLeaf) -> np.ndarray:
    """A column chunk's dictionary page -> its entries as f32 (PLAIN values,
    narrowed from DOUBLE as data pages are)."""
    header = parse_page_header(raw)
    if header.page_type != _PAGE_DICT:
        raise ExecutionError(f"Expected a dictionary page, got page type {header.page_type}")
    width = 8 if leaf.ptype == _TYPE_DOUBLE else 4
    if (
        header.num_values < 0
        or header.compressed_size < 0
        or header.uncompressed_size < header.num_values * width
        or header.header_len + header.compressed_size > len(raw)
    ):
        raise ExecutionError("Malformed dictionary page header")
    body = memoryview(raw)[header.header_len : header.header_len + header.compressed_size]
    data = _decompress(bytes(body), codec, header.uncompressed_size)
    if len(data) < header.num_values * width:
        raise ExecutionError("Truncated dictionary page")
    return _float_values(data, leaf.ptype, header.num_values)


def _dictionary_values(data, n: int, dictionary: np.ndarray) -> np.ndarray:
    """A dictionary-encoded page's values section (a bit-width byte, then
    ``n`` RLE/bit-packed indices) -> the dictionary's entries."""
    if len(data) < 1:
        raise ExecutionError("Truncated dictionary-encoded page")
    bit_width = data[0]
    if bit_width > 32:
        raise ExecutionError(f"Malformed dictionary index bit width {bit_width}")
    idx = decode_rle_levels(memoryview(data)[1:], bit_width, n)
    if n and (idx.min() < 0 or idx.max() >= dictionary.size):
        raise ExecutionError("Dictionary index out of range")
    return dictionary[idx]


def decode_data_page(
    raw: bytes, codec: str, leaf: SchemaLeaf, fixed_list_size: int | None = None,
    dictionary: np.ndarray | None = None,
) -> DecodedPage:
    """One data page -> its values and row lengths. A dictionary-encoded page
    needs its column chunk's ``dictionary`` (``decode_dictionary_page``)."""
    header = parse_page_header(raw)
    body = memoryview(raw)[header.header_len : header.header_len + header.compressed_size]

    if header.page_type == _PAGE_DICT:
        raise ExecutionError("Expected a data page, got a dictionary page")
    if header.page_type not in (_PAGE_DATA, _PAGE_DATA_V2):
        raise ExecutionError(f"Unsupported page type {header.page_type}")
    dict_encoded = header.encoding in _DICT_ENCODINGS
    if dict_encoded and dictionary is None:
        raise ExecutionError("Dictionary-encoded page read without its dictionary")
    if header.encoding != _ENC_PLAIN and not dict_encoded:
        raise ExecutionError(
            f"Embedding pages must be PLAIN encoded, got encoding {header.encoding}"
        )
    # Header-declared sizes are untrusted; reject instead of slicing with
    # bogus offsets (the native decoder applies the same checks).
    if (
        header.num_values < 0
        or header.compressed_size < 0
        or header.uncompressed_size < 0
        or header.rep_levels_len < 0
        or header.def_levels_len < 0
    ):
        raise ExecutionError("Malformed page header: negative size field")
    if header.page_type == _PAGE_DATA_V2 and (
        header.rep_levels_len + header.def_levels_len
        > min(header.compressed_size, header.uncompressed_size)
    ):
        raise ExecutionError(
            "Malformed page header: level lengths exceed page size"
        )

    n = header.num_values
    rep_bits = (leaf.max_rep).bit_length() if leaf.max_rep else 0
    def_bits = (leaf.max_def).bit_length() if leaf.max_def else 0

    if header.page_type == _PAGE_DATA_V2:
        rep_raw = body[: header.rep_levels_len]
        def_raw = body[header.rep_levels_len : header.rep_levels_len + header.def_levels_len]
        values_raw = bytes(body[header.rep_levels_len + header.def_levels_len :])
        if header.v2_is_compressed:
            values_raw = _decompress(
                values_raw,
                codec,
                header.uncompressed_size
                - header.rep_levels_len
                - header.def_levels_len,
            )
        rep = (
            decode_rle_levels(rep_raw, rep_bits, n)
            if leaf.max_rep
            else np.zeros(n, np.int32)
        )
        defs = (
            decode_rle_levels(def_raw, def_bits, n)
            if leaf.max_def
            else np.full(n, leaf.max_def, np.int32)
        )
    else:
        data = memoryview(_decompress(bytes(body), codec, header.uncompressed_size))
        pos = 0
        if leaf.max_rep:
            (length,) = struct.unpack_from("<I", data, pos)
            rep = decode_rle_levels(data[pos + 4 : pos + 4 + length], rep_bits, n)
            pos += 4 + length
        else:
            rep = np.zeros(n, np.int32)
        if leaf.max_def:
            (length,) = struct.unpack_from("<I", data, pos)
            defs = decode_rle_levels(data[pos + 4 : pos + 4 + length], def_bits, n)
            pos += 4 + length
        else:
            defs = np.full(n, leaf.max_def, np.int32)
        values_raw = bytes(data[pos:])

    if np.any(defs != leaf.max_def):
        raise ExecutionError("Embedding column contains null rows")

    if dict_encoded:
        values = _dictionary_values(values_raw, n, dictionary)
    else:
        values = _float_values(values_raw, leaf.ptype, n)

    if leaf.max_rep:
        row_starts = np.flatnonzero(rep == 0)
        row_lengths = np.diff(np.concatenate([row_starts, [n]]))
    elif fixed_list_size:
        row_lengths = np.full(n // fixed_list_size, fixed_list_size, np.int64)
    else:
        row_lengths = np.ones(n, np.int64)
    return DecodedPage(values=values, row_lengths=row_lengths.astype(np.int64))


# ----------------------------------------------------------------------
# PageReader: candidate rows -> [len, dim] matrix
# ----------------------------------------------------------------------

_SCAN_POOL = None
_SCAN_POOL_LOCK = threading.Lock()


def _scan_pool():
    """Shared thread pool for per-row-group candidate decode — the analog of
    DataFusion's RepartitionExec under the reference's rewritten scan
    (pq-vector src/df_vector/snapshots/...filter_plan_tree.snap:24-39).
    preadv reads and the native decode (ctypes CDLL) both release the GIL,
    so row groups scale with cores. Size via PQVECTOR_TPU_SCAN_THREADS
    (default: cpu count, capped at 16); <=1 disables pooling."""
    global _SCAN_POOL
    if _SCAN_POOL is None:
        with _SCAN_POOL_LOCK:
            if _SCAN_POOL is None:
                workers = int(
                    os.environ.get(
                        "PQVECTOR_TPU_SCAN_THREADS",
                        min(os.cpu_count() or 1, 16),
                    )
                )
                if workers <= 1:
                    _SCAN_POOL = False
                else:
                    from concurrent.futures import ThreadPoolExecutor

                    _SCAN_POOL = ThreadPoolExecutor(
                        max_workers=workers,
                        thread_name_prefix="pqv-scan",
                    )
    return _SCAN_POOL or None


def _dictionary_encoded(page) -> bool:
    """Whether the data page starting ``page`` holds dictionary indices."""
    return parse_page_header(page).encoding in _DICT_ENCODINGS


def _gather_rows(values: np.ndarray, lengths: np.ndarray, gidx: np.ndarray):
    """Rows ``gidx`` of a decoded batch -> (their lengths, their values back
    to back), in fresh arrays."""
    lens = lengths[gidx]
    u = int(lengths[0]) if lengths.size else 0
    if u > 0 and values.size == lengths.size * u and np.all(lengths == u):
        # Uniform rows (embedding columns): one fancy index, no index build.
        return lens, values.reshape(-1, u)[gidx].reshape(-1)
    starts = np.concatenate([[0], np.cumsum(lengths)])[gidx]
    boff = np.concatenate([[0], np.cumsum(lens)])
    idx = (
        np.arange(int(boff[-1]), dtype=np.int64)
        - np.repeat(boff[:-1], lens)
        + np.repeat(starts, lens)
    )
    return lens, values[idx]


def _decode_page(
    raw: bytes, codec: str, leaf: SchemaLeaf, dictionary: np.ndarray | None = None
) -> DecodedPage:
    """Native C++ decode when available (native/pqvector_pages.cpp), Python
    decoder as fallback/oracle; a dictionary-encoded page (``dictionary``
    given) by the Python decoder."""
    if dictionary is not None:
        return decode_data_page(raw, codec, leaf, dictionary=dictionary)
    try:
        from .native import decode_data_page_native

        result = decode_data_page_native(
            raw, codec, leaf.ptype, leaf.max_def, leaf.max_rep
        )
        if result is not None:
            values, row_lengths = result
            return DecodedPage(values=values, row_lengths=row_lengths)
    except FormatError:
        pass  # codec/encoding the native decoder doesn't cover
    return decode_data_page(raw, codec, leaf)


def read_footer_via_store(store, path: str) -> bytes:
    """Parquet footer metadata bytes via ObjectStore range reads.

    Tail magic + footer-length bounds checks live here so every store
    footer read (the selective reader, the engine's row-count reads)
    shares them.
    """
    size = store.head(path)
    tail = store.get_range(path, size - 8, size)
    if tail[4:] != b"PAR1":
        raise FormatError(f"'{path}' is not a valid parquet file")
    meta_len = int.from_bytes(tail[:4], "little")
    if meta_len + 8 > size:
        raise FormatError("Parquet footer length exceeds file size")
    return store.get_range(path, size - 8 - meta_len, size - 8)


class PageSelectiveReader:
    """Read specific rows of a vector column via exact page reads."""

    def __init__(
        self, path: str | os.PathLike, column: EmbeddingColumn, store=None
    ):
        """``store``: optional engine ObjectStore; when given and non-local,
        ALL byte access (footer, offset indexes, page spans) goes through
        ``store.get_range`` so remote files are served end-to-end through
        the store seam (the reference reads candidate pages through its
        store-integrated parquet source, df_vector/access.rs:65-105)."""
        self.path = os.fspath(path)
        self._store = (
            store if store is not None and not store.is_local() else None
        )
        if self._store is None:
            meta = read_footer_metadata(self.path)
        else:
            meta = read_footer_via_store(self._store, self.path)
        leaves, row_groups = parse_parquet_metadata(meta)
        name = str(column)
        matches = [
            (i, leaf)
            for i, leaf in enumerate(leaves)
            if leaf.path.split(".")[0] == name
        ]
        if len(matches) != 1:
            raise ExecutionError(
                f"Embedding column '{name}' not found or ambiguous in schema"
            )
        self.leaf_idx, self.leaf = matches[0]
        self.row_groups = row_groups
        self._rg_starts = np.concatenate(
            [[0], np.cumsum([rg.num_rows for rg in row_groups])]
        )
        self._page_locations: dict[int, list[PageLocation]] = {}
        self._page_firsts: dict[int, np.ndarray] = {}
        self._page_offs: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    @property
    def supports_page_reads(self) -> bool:
        return all(
            rg.chunks[self.leaf_idx].offset_index_offset is not None
            for rg in self.row_groups
        )

    def _open(self):
        """Local file handle, or a null context (None) in store mode —
        byte access then routes through :meth:`_read_at`."""
        if self._store is None:
            return open(self.path, "rb")
        import contextlib

        return contextlib.nullcontext(None)

    def _read_at(self, f, offset: int, length: int) -> bytes:
        if f is not None:
            f.seek(offset)
            return f.read(length)
        return self._store.get_range(self.path, offset, offset + length)

    def _locations(self, rg_idx: int, f) -> list[PageLocation]:
        if rg_idx not in self._page_locations:
            chunk = self.row_groups[rg_idx].chunks[self.leaf_idx]
            if chunk.offset_index_offset is None:
                raise ExecutionError("No offset index for selective page reads")
            data = self._read_at(
                f, chunk.offset_index_offset, chunk.offset_index_length
            )
            self._page_locations[rg_idx] = parse_offset_index(data)
        return self._page_locations[rg_idx]

    def _firsts(self, rg_idx: int, f) -> np.ndarray:
        """first_row_index per page, as an ndarray — building a Python list
        per looked-up row made numpy re-convert ~62k elements per
        searchsorted call (155 ms for 68 rows on a 1-row-page 1M file)."""
        if rg_idx not in self._page_firsts:
            self._page_firsts[rg_idx] = np.asarray(
                [loc.first_row_index for loc in self._locations(rg_idx, f)],
                dtype=np.int64,
            )
        return self._page_firsts[rg_idx]

    def _offs_sizes(self, rg_idx: int, f) -> tuple[np.ndarray, np.ndarray]:
        """(offset, compressed_size) per page as ndarrays — a per-query
        Python comprehension over ~16k PageLocation objects cost ~36 ms."""
        if rg_idx not in self._page_offs:
            locs = self._locations(rg_idx, f)
            self._page_offs[rg_idx] = (
                np.asarray([loc.offset for loc in locs], np.int64),
                np.asarray(
                    [loc.compressed_page_size for loc in locs], np.int64
                ),
            )
        return self._page_offs[rg_idx]

    def read_rows(self, rows: np.ndarray, dim: int) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return np.empty((0, dim), dtype=np.float32)
        total_rows = int(self._rg_starts[-1])
        if rows.max(initial=-1) >= total_rows:
            raise ExecutionError(
                f"Candidate row {int(rows.max())} out of bounds for file with "
                f"{total_rows} rows"
            )
        with self._open() as f:
            rg_of = np.searchsorted(self._rg_starts, rows, side="right") - 1
            batched = self._read_rows_batched(rows, rg_of, dim, f)
            if batched is not None:
                return batched
            values, lengths, _ = self._read_rows_paged(rows, rg_of, f)
        if np.any(lengths != dim):
            raise ExecutionError(
                "Selected embeddings do not match expected dimensions"
            )
        return values.reshape(rows.size, dim)

    def read_rows_ragged(
        self, rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Page-exact read of ``rows`` without a dimension contract.

        Returns ``(values f32, row_lengths i64, pages_read)`` with rows in
        input order. Unlike :meth:`read_rows` this serves ANY float32 leaf
        column (list, fixed-size list, or flat): row lengths come from the
        pages themselves. Used by the SQL engine's selective scan
        (engine/physical.py), where the reference decodes only selected rows
        of the rewritten scan (pq-vector src/df_vector/exec.rs:241-244
        via access.rs:161-176 row selections).
        """
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return (
                np.empty(0, np.float32),
                np.empty(0, np.int64),
                0,
            )
        total_rows = int(self._rg_starts[-1])
        if rows.min() < 0 or rows.max() >= total_rows:
            raise ExecutionError(
                f"Selected row {int(rows.max())} out of bounds for file with "
                f"{total_rows} rows"
            )
        with self._open() as f:
            rg_of = np.searchsorted(self._rg_starts, rows, side="right") - 1
            batched = self._read_rows_ragged_batched(rows, rg_of, f)
            if batched is not None:
                return batched
            return self._read_rows_paged(rows, rg_of, f)

    def _dictionary(self, rg: int, f) -> tuple[np.ndarray, int]:
        """Row group ``rg``'s dictionary, decoded, and its page's bytes."""
        off, length = self._dictionary_span(rg)
        if not length:
            raise ExecutionError(
                "Dictionary-encoded page in a column chunk without a dictionary page"
            )
        chunk = self.row_groups[rg].chunks[self.leaf_idx]
        raw = self._read_at(f, off, length)
        return decode_dictionary_page(raw, chunk.codec, self.leaf), len(raw)

    def _read_rows_paged(
        self, rows: np.ndarray, rg_of: np.ndarray, f
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """One page at a time, each decoded alone: the path without the
        native library, and for pages its batched decode declines. Returns
        ``(values, row_lengths, pages_read)`` with rows in input order. A
        row group's dictionary is read once a call, where a page needs it.
        Each page is counted as it is read, so a read refused partway counts
        the pages it got through."""
        order = np.argsort(rows, kind="stable")
        out_vals: list[np.ndarray] = [None] * rows.size
        out_lens = np.empty(rows.size, np.int64)
        pages = 0
        count_root("dict_pages", 0)
        count_root("dict_bytes", 0)
        dictionaries: dict[int, np.ndarray] = {}
        page_cache = None  # (rg, pidx, page, row_offsets)
        for oi in order:
            row = int(rows[oi])
            rg = int(rg_of[oi])
            local = row - int(self._rg_starts[rg])
            locs = self._locations(rg, f)
            firsts = self._firsts(rg, f)
            pidx = int(np.searchsorted(firsts, local, side="right") - 1)
            if (
                page_cache is not None
                and page_cache[0] == rg
                and page_cache[1] == pidx
            ):
                _, _, page, row_offsets = page_cache
            else:
                loc = locs[pidx]
                raw = self._read_at(f, loc.offset, loc.compressed_page_size)
                chunk = self.row_groups[rg].chunks[self.leaf_idx]
                dictionary = None
                if _dictionary_encoded(raw):
                    if rg not in dictionaries:
                        dictionaries[rg], nbytes = self._dictionary(rg, f)
                        count_root("dict_bytes", nbytes)
                    dictionary = dictionaries[rg]
                page = _decode_page(raw, chunk.codec, self.leaf, dictionary)
                count_root("pages")
                count_root("page_bytes", len(raw))
                count_root("dict_pages", int(dictionary is not None))
                pages += 1
                row_offsets = np.concatenate([[0], np.cumsum(page.row_lengths)])
                page_cache = (rg, pidx, page, row_offsets)
            in_page = local - int(firsts[pidx])
            if in_page >= page.row_lengths.size:
                raise ExecutionError("Row beyond decoded page")
            start = int(row_offsets[in_page])
            length = int(page.row_lengths[in_page])
            out_lens[oi] = length
            out_vals[oi] = page.values[start : start + length]
        return np.concatenate(out_vals), out_lens, pages

    # Gap below which two selected pages are fetched in one read: with the
    # 1-row-per-page layout, neighboring candidate pages are usually within
    # one vector (~4·dim bytes) of each other, so coalescing turns thousands
    # of seek+read pairs into a handful of span reads. Measured sweep on the
    # 1M build_new file (16k candidates/query): 0/4k/16k gap = 65-69 ms,
    # 64k = 109 ms, 256k = 292 ms — dead gap bytes dominate past ~16 KB.
    _COALESCE_GAP = 1 << 12

    def _dictionary_span(self, rg: int) -> tuple[int, int]:
        """(offset, length) of row group ``rg``'s dictionary page: from the
        chunk's dictionary page offset to its first data page. (0, 0) where
        the chunk has none. Its page locations must already be cached."""
        off = self.row_groups[rg].chunks[self.leaf_idx].dictionary_page_offset
        first = self._page_locations[rg][0].offset
        if off is None or not 0 < off < first:
            return 0, 0
        return off, first - off

    def _decode_rg_selection(
        self, rg: int, local: np.ndarray, fd: int, dim: int | None = None,
        count_dict: bool = False,
    ):
        """Decode every page touched by ``local`` rows of one row group in a
        single native FFI call (span-coalesced preadv reads).

        The per-page loop pays a Python + ctypes round-trip per page; on
        1-row-per-page files that overhead dominates the query path (the
        reference amortizes it inside parquet-rs, search.rs:186-198).
        Reads go through ``os.preadv`` (no shared seek state), so calls for
        different row groups may run on a thread pool. ``pqv_decode_pages``
        takes no dictionary, so where it refuses a page and the chunk has a
        dictionary page, that page and the touched pages are laid back to
        back and ``pqv_decode_chunk`` walks them, serving dictionary-encoded
        pages against it (``_decode_with_dictionary``). Returns
        ``(row_lengths, values, pages, page_bytes, dict_pages, dict_bytes)``:
        the rows of ``local`` in its order, and what was read
        (``dict_pages`` counted only under ``count_dict``); or None when the
        native library is unavailable. Raises FormatError for
        codecs/encodings the native decoder doesn't cover. Metadata caches
        (_locations/_firsts/_offs_sizes) must already be warm.
        """
        from .native import decode_pages_native

        firsts = self._page_firsts[rg]
        pidx = np.searchsorted(firsts, local, side="right") - 1
        upages = np.unique(pidx)
        page_rows = np.diff(
            np.concatenate([firsts, [self.row_groups[rg].num_rows]])
        )[upages]
        offs_all, sizes_all = self._page_offs[rg]
        offs = offs_all[upages]
        sizes = sizes_all[upages]
        # Coalesce near-adjacent pages into span reads (vectorized: pages
        # appear in file order, so spans are maximal runs without a gap).
        gap_break = np.flatnonzero(
            offs[1:] > offs[:-1] + sizes[:-1] + self._COALESCE_GAP
        )
        span_first = np.concatenate([[0], gap_break + 1])
        span_last = np.concatenate([gap_break, [upages.size - 1]])
        span_off = offs[span_first]
        span_len = offs[span_last] + sizes[span_last] - span_off
        span_pos = np.concatenate([[0], np.cumsum(span_len)])
        # One preallocated buffer, read in place (b"".join cost ~50 ms/query
        # and an mmap variant measured ~15-25% slower on this layout).
        buf = bytearray(int(span_pos[-1]))
        view = memoryview(buf)
        if fd is not None:
            for s in range(span_first.size):
                dst = view[int(span_pos[s]) : int(span_pos[s + 1])]
                if os.preadv(fd, [dst], int(span_off[s])) != int(span_len[s]):
                    raise FormatError("Truncated page span read")
        else:  # non-local store: ONE get_ranges call for every span, so a
            # remote store can fetch them concurrently (index_exec.rs:96-143
            # semantics — coalesced ranges as parallel requests).
            spans = [
                (int(span_off[s]), int(span_off[s]) + int(span_len[s]))
                for s in range(span_first.size)
            ]
            for s, data in enumerate(self._store.get_ranges(self.path, spans)):
                if len(data) != int(span_len[s]):
                    raise FormatError("Truncated page span read")
                view[int(span_pos[s]) : int(span_pos[s + 1])] = data
        # Buffer offset of each page = span base + offset within the span.
        page_span = (
            np.searchsorted(span_first, np.arange(upages.size), "right") - 1
        )
        buf_offsets = (
            span_pos[page_span] + (offs - span_off[page_span])
        ).astype(np.uint64)
        view.release()
        n_page_rows = int(page_rows.sum())
        chunk = self.row_groups[rg].chunks[self.leaf_idx]
        # Under a dimension contract the touched pages hold exactly rows*dim
        # values (a malformed page trips the native capacity check ->
        # FormatError -> per-page fallback raises the canonical dim error).
        # Without one, first the chunk's mean values a row times the pages'
        # rows (exact for rows of one length), then the chunk's whole leaf
        # value count: that bound for a few pages is a fresh mapping of the
        # chunk's size each call (32 MiB at 65,536 x 128), whose page faults
        # cost system time.
        num_values = int(chunk.num_values)
        if dim:
            caps = [n_page_rows * dim]
        else:
            mean_cap = -(-num_values * n_page_rows // int(self.row_groups[rg].num_rows))
            caps = [mean_cap, num_values] if mean_cap < num_values else [num_values]

        def decode(plain: bool):
            for i, cap in enumerate(caps):
                try:
                    if not plain:
                        return self._decode_with_dictionary(
                            buf, buf_offsets, sizes, chunk, dict_off, dict_bytes,
                            fd, page_rows, cap,
                        )
                    res = decode_pages_native(
                        buf, buf_offsets, sizes, chunk.codec, self.leaf.ptype,
                        self.leaf.max_def, self.leaf.max_rep,
                        row_cap=n_page_rows, value_cap=cap,
                    )
                    # values, row lengths, page row starts
                    return None if res is None else (res[0], res[1], res[3])
                except FormatError:
                    if i + 1 == len(caps):
                        raise

        dict_pages = dict_bytes = 0
        try:
            res = decode(plain=True)
        except FormatError:
            dict_off, dict_bytes = self._dictionary_span(rg)
            if not dict_bytes:
                raise
            res = decode(plain=False)
            if count_dict:
                dict_pages = sum(
                    _dictionary_encoded(memoryview(buf)[p : p + n])
                    for p, n in zip(buf_offsets.tolist(), sizes.tolist())
                )
        if res is None:
            return None
        values, lengths, prs = res
        # Row index of each candidate inside the decoded batch.
        ppos = np.searchsorted(upages, pidx)
        gidx = prs[ppos] + (local - firsts[pidx])
        if np.any(gidx >= prs[ppos + 1]):
            raise ExecutionError("Row beyond decoded page")
        lens, vals = _gather_rows(values, lengths, gidx)
        return (lens, vals, int(upages.size), int(sizes.sum()), dict_pages,
                dict_bytes)

    def _decode_with_dictionary(
        self, buf, buf_offsets, sizes, chunk, dict_off, dict_len, fd,
        page_rows, value_cap,
    ):
        """The touched pages of ``buf`` decoded against their chunk's
        dictionary page (``dict_len`` bytes at ``dict_off``): that page, then
        the pages back to back, walked by ``pqv_decode_chunk``, which serves
        PLAIN and dictionary-encoded pages alike. Returns ``(values,
        row_lengths, page_row_starts)``, the row starts from the offset
        index, or None without the library."""
        from .native import decode_chunk_native

        seq = bytearray(dict_len + int(sizes.sum()))
        view = memoryview(seq)
        if fd is not None:
            if os.preadv(fd, [view[:dict_len]], dict_off) != dict_len:
                raise FormatError("Truncated dictionary page read")
        else:
            data = self._store.get_range(self.path, dict_off, dict_off + dict_len)
            if len(data) != dict_len:
                raise FormatError("Truncated dictionary page read")
            view[:dict_len] = data
        at = dict_len
        for p, n in zip(buf_offsets.tolist(), sizes.tolist()):
            view[at : at + n] = buf[p : p + n]
            at += n
        view.release()
        n_rows = int(page_rows.sum())
        res = decode_chunk_native(
            seq, chunk.codec, self.leaf.ptype, self.leaf.max_def,
            self.leaf.max_rep, row_cap=n_rows, value_cap=value_cap,
            out_values=np.empty(value_cap, np.float32),
        )
        if res is None:
            return None
        values, lengths = res
        if lengths.size != n_rows:
            raise FormatError("Decoded rows disagree with the offset index")
        return values, lengths, np.concatenate([[0], np.cumsum(page_rows)])

    def _decode_selections(
        self, rows: np.ndarray, rg_of: np.ndarray, f, dim: int | None = None
    ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray, int]] | None:
        """Run :meth:`_decode_rg_selection` for every touched row group —
        on the shared scan pool when more than one group is touched and the
        pool has workers — the analog of the multi-partition scan DataFusion
        runs under the reference's rewrite (RepartitionExec,
        .../snapshots/...filter_plan_tree.snap:24-39). Returns ``[(sel,
        row_lengths, values, pages), ...]``, or None without the native
        library or where a page needs the Python decoder. While tracing is
        on, the data pages decoded and their bytes are added to the call's
        root span (``pages``, ``page_bytes``; dictionary-encoded ones also
        under ``dict_pages``), and the dictionary pages' bytes under
        ``dict_bytes``."""
        fd = f.fileno() if f is not None else None
        rgs = [int(r) for r in np.unique(rg_of)]
        sels = {rg: np.flatnonzero(rg_of == rg) for rg in rgs}
        for rg in rgs:  # warm metadata caches serially (they mutate dicts)
            self._locations(rg, f)
            self._firsts(rg, f)
            self._offs_sizes(rg, f)
        count_dict = tracing_on()  # the caller's thread holds the root span

        def one(rg: int):
            local = rows[sels[rg]] - int(self._rg_starts[rg])
            return self._decode_rg_selection(rg, local, fd, dim, count_dict)

        pool = _scan_pool() if len(rgs) > 1 else None
        try:
            if pool is not None:
                results = list(pool.map(one, rgs))
            else:
                results = [one(rg) for rg in rgs]
        except FormatError:
            return None  # unsupported codec/encoding: per-page Python decoder
        if any(r is None for r in results):
            return None
        for key, i in (("pages", 2), ("page_bytes", 3), ("dict_pages", 4),
                       ("dict_bytes", 5)):
            count_root(key, sum(r[i] for r in results))
        return [(sels[rg], r[0], r[1], r[2]) for rg, r in zip(rgs, results)]

    def _read_rows_batched(
        self, rows: np.ndarray, rg_of: np.ndarray, dim: int, f
    ) -> np.ndarray | None:
        """All selected pages per row group in one native decode call.

        Returns None — and the caller falls back to the per-page loop — when
        the native library is unavailable or a page needs the Python decoder.
        """
        decoded = self._decode_selections(rows, rg_of, f, dim=dim)
        if decoded is None:
            return None
        out = np.empty((rows.size, dim), dtype=np.float32)
        for sel, lengths, values, _ in decoded:
            if np.any(lengths != dim):
                raise ExecutionError(
                    "Selected embeddings do not match expected dimensions"
                )
            out[sel] = values.reshape(-1, dim)
        return out

    def _read_rows_ragged_batched(
        self, rows: np.ndarray, rg_of: np.ndarray, f
    ) -> tuple[np.ndarray, np.ndarray, int] | None:
        """Ragged analog of :meth:`_read_rows_batched` (no dimension
        contract). Returns (values, row_lengths, pages_read) with rows in
        input order, or None to fall back."""
        decoded = self._decode_selections(rows, rg_of, f)
        if decoded is None:
            return None
        out_lens = np.empty(rows.size, np.int64)
        for sel, lengths, _, _ in decoded:
            out_lens[sel] = lengths
        pages_read = sum(d[3] for d in decoded)
        u = int(out_lens[0])
        if u > 0 and np.all(out_lens == u):
            # Uniform rows (embedding columns): row slices of one matrix.
            out = np.empty((rows.size, u), np.float32)
            for sel, _, values, _ in decoded:
                out[sel] = values.reshape(-1, u)
            return out.reshape(-1), out_lens, pages_read
        final_starts = np.concatenate([[0], np.cumsum(out_lens)])
        out_vals = np.empty(int(final_starts[-1]), np.float32)
        for sel, lengths, values, _ in decoded:
            boff = np.concatenate([[0], np.cumsum(lengths)])
            dest = (
                np.arange(values.size, dtype=np.int64)
                - np.repeat(boff[:-1], lengths)
                + np.repeat(final_starts[sel], lengths)
            )
            out_vals[dest] = values
        return out_vals, out_lens, pages_read


# ----------------------------------------------------------------------
# Full-column native read (sequential chunk decode, no offset index)
# ----------------------------------------------------------------------


def embedding_leaf_meta(path: str | os.PathLike, column: EmbeddingColumn):
    """(leaf_idx, leaf, row_groups) for the vector column, or None when the
    column is absent/ambiguous or not a float leaf."""
    meta = read_footer_metadata(os.fspath(path))
    leaves, row_groups = parse_parquet_metadata(meta)
    name = str(column)
    matches = [
        (i, leaf)
        for i, leaf in enumerate(leaves)
        if leaf.path.split(".")[0] == name
    ]
    if len(matches) != 1:
        return None
    leaf_idx, leaf = matches[0]
    if leaf.ptype not in (_TYPE_FLOAT, _TYPE_DOUBLE):
        return None
    return leaf_idx, leaf, row_groups


def rg_chunk_span(rg: RowGroupInfo, leaf_idx: int) -> tuple[int, int]:
    """(offset, length) of one row group's whole column chunk, including a
    leading dictionary page when present (the native decoder consumes it
    and serves RLE_DICTIONARY data pages against it)."""
    ch = rg.chunks[leaf_idx]
    start = ch.data_page_offset
    if ch.dictionary_page_offset is not None:
        start = min(start, ch.dictionary_page_offset)
    return start, ch.total_compressed_size


def decode_rg_matrix_native(
    f, rg: RowGroupInfo, leaf_idx: int, leaf: SchemaLeaf, out=None
) -> np.ndarray | None:
    """One row group's vector column as [rows, dim] f32 via the native
    sequential chunk decoder, or None to fall back (unsupported layout /
    library unavailable / ragged rows). ``out`` may be a preallocated
    [rows, dim] slice to decode into."""
    start, length = rg_chunk_span(rg, leaf_idx)
    f.seek(start)
    return decode_rg_matrix_from_buf(f.read(length), rg, leaf_idx, leaf, out)


def decode_rg_matrix_from_buf(
    buf, rg: RowGroupInfo, leaf_idx: int, leaf: SchemaLeaf, out=None
) -> np.ndarray | None:
    """Decode a row group's column chunk from pre-read bytes (a worker of
    ``decode_row_groups`` reads them; in the JAX package the prefetch
    pipeline reads the next chunk while this one decodes)."""
    from .native import decode_chunk_native

    ch = rg.chunks[leaf_idx]
    try:
        res = decode_chunk_native(
            buf, ch.codec, leaf.ptype, leaf.max_def, leaf.max_rep,
            row_cap=rg.num_rows, value_cap=int(ch.num_values),
            out_values=None if out is None else out.reshape(-1),
        )
    except FormatError:
        return None  # unsupported encoding/nulls: pyarrow fallback
    if res is None:
        return None
    values, lens = res
    if lens.size == 0 or lens[0] == 0:
        return None
    dim = int(lens[0])
    if not np.all(lens == dim):
        return None  # ragged: canonical error via the pyarrow path
    if out is not None:
        if out.shape != (lens.size, dim):
            return None
        return out
    return values.reshape(-1, dim)


def embedding_dim_hint(rg: RowGroupInfo, leaf_idx: int) -> int | None:
    """Values per row of a row group's vector column from its metadata (the
    chunk's value count over its row count), or None where they do not
    divide. A hint: the decoder checks every row's length against it."""
    rows, values = rg.num_rows, int(rg.chunks[leaf_idx].num_values)
    if rows <= 0 or values <= 0 or values % rows:
        return None
    return values // rows


#: Row groups a parallel column read decodes at once (``decode_row_groups``).
DECODE_WORKERS = min(8, os.cpu_count() or 1)


def _read_row_group_arrow(path, i: int, column: EmbeddingColumn, dst):
    """Row group ``i``'s vector column through pyarrow (the layouts the
    native decoder declines, with the canonical validation errors), into
    ``dst`` when given."""
    import pyarrow.parquet as pq

    from .reader import extract_embeddings

    table = pq.ParquetFile(path).read_row_group(i, columns=[str(column)])
    mat = extract_embeddings(table, column).data
    if dst is None:
        return mat
    if mat.shape != dst.shape:
        raise ValidationError("Inconsistent embedding dimensions")
    dst[...] = mat
    return dst


def decode_row_groups(path, row_groups, leaf_idx: int, leaf: SchemaLeaf,
                      out=None, workers: int = DECODE_WORKERS,
                      column: EmbeddingColumn | None = None, post=None, span=None):
    """Yield each row group's vector column as [rows, dim] f32 through the
    native chunk decoder, in row-group order, ``workers`` row groups at a
    time: each thread reads its chunk's bytes and decodes them (both
    release the GIL), so the read runs on that many cores where the
    sequential decoder runs on one. ``out``, an [n, dim] array, takes each
    row group in its slice; a function of the row group's position
    (called on the worker) may give each its [rows, dim] destination
    instead. No more than ``workers`` are decoding at once, each submitted
    after the one ``workers`` before it was yielded, so at most
    ``workers + 1`` decoded row groups are alive while the caller holds
    the last one. A row group the decoder declines (or every one, without
    the native library) is read by pyarrow on the worker when ``column``
    names it, and yields None otherwise (the caller falls back); stopping
    early cancels what is queued. ``post(i, matrix)``, where given, runs on
    the worker after the decode and its result is yielded in the matrix's
    place (the staged build's wire encode); what it raises reaches the
    caller. ``span()``, where given, makes the context manager each
    worker runs a row group's whole job in (the staged build's trace span)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from .native import load

    native = load() is not None
    starts = np.zeros(len(row_groups) + 1, np.int64)
    np.cumsum([rg.num_rows for rg in row_groups], out=starts[1:])

    def job(i):
        if span is None:
            return work(i)
        with span():
            return work(i)

    def work(i):
        rg = row_groups[i]
        if callable(out):
            dst = out(i)
        elif out is not None:
            dst = out[starts[i] : starts[i + 1]]
            populate(dst)
        else:
            dst = None
        got = None
        if native:
            start, length = rg_chunk_span(rg, leaf_idx)
            with open(path, "rb") as f:
                f.seek(start)
                buf = f.read(length)
            got = decode_rg_matrix_from_buf(buf, rg, leaf_idx, leaf, out=dst)
        if got is None and column is not None:
            got = _read_row_group_arrow(path, i, column, dst)
        return got if post is None else post(i, got)

    pool = ThreadPoolExecutor(max(1, workers))
    try:
        pending = deque()
        nxt = 0
        while nxt < len(row_groups) or pending:
            while nxt < len(row_groups) and len(pending) < max(1, workers):
                pending.append(pool.submit(job, nxt))
                nxt += 1
            yield pending.popleft().result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def read_embedding_matrix_native(
    path: str | os.PathLike, column: EmbeddingColumn
) -> np.ndarray | None:
    """Whole vector column as a [n, dim] f32 matrix via the native
    sequential chunk decoder, decoding each row group's pages straight into
    a preallocated output (no per-batch Arrow assembly — pyarrow's
    list<float> path measured 89 MB/s single-core on the 1M x 1024 build).
    The row groups decode in parallel (``decode_row_groups``; the JAX
    package decodes one at a time behind a read-ahead thread, which ran at
    200 MB/s on the H100's host, slower than pyarrow's thread pool), into a
    matrix shaped from the metadata (``embedding_dim_hint``). The matrix is
    the same.

    Returns None to fall back to the pyarrow reader (library unavailable,
    dictionary-encoded chunks, non-float leaves, or ragged rows — the
    fallback raises the canonical validation errors).
    """
    from .native import load

    if load() is None:
        return None
    lm = embedding_leaf_meta(path, column)
    if lm is None:
        return None
    leaf_idx, leaf, row_groups = lm
    total_rows = sum(rg.num_rows for rg in row_groups)
    if total_rows == 0:
        return None
    dim = embedding_dim_hint(row_groups[0], leaf_idx)
    if dim is None:
        return None
    # Fault-aware: np.empty first-touch can be slow on a microVM
    # (utils/alloc module docstring); each slice is batch-faulted before
    # the decoder writes it.
    out = alloc_matrix((total_rows, dim), np.float32)
    chunks = decode_row_groups(path, row_groups, leaf_idx, leaf, out=out)
    with contextlib.closing(chunks):
        for got in chunks:
            if got is None:
                return None
    return out
