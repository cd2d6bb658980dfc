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
  PLAIN float decode -> row extraction.

Supports the layouts the reference reads/writes: List/FixedSizeList of
FLOAT/DOUBLE, PLAIN-encoded data pages (V1 and V2), SNAPPY/ZSTD/GZIP/
UNCOMPRESSED codecs, no nulls (nulls are rejected exactly like
search.rs:212-218). Files without an offset index fall back to the row-group
reader in query/selective.py.

This is a copy of the JAX package's module, host code only. The timings in
its comments are the JAX package's, measured on that package's host; none
was taken for this port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import struct
import threading

import numpy as np

from ..errors import ExecutionError, FormatError
from ..types import EmbeddingColumn
from .embed import read_footer_metadata
from ..utils.alloc import alloc_matrix, populate
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


def decode_data_page(
    raw: bytes, codec: str, leaf: SchemaLeaf, fixed_list_size: int | None = None
) -> DecodedPage:
    header = parse_page_header(raw)
    body = memoryview(raw)[header.header_len : header.header_len + header.compressed_size]

    if header.page_type == _PAGE_DICT:
        raise ExecutionError("Dictionary-encoded embedding pages are not supported")
    if header.page_type not in (_PAGE_DATA, _PAGE_DATA_V2):
        raise ExecutionError(f"Unsupported page type {header.page_type}")
    if header.encoding != _ENC_PLAIN:
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

    if leaf.ptype == _TYPE_FLOAT:
        values = np.frombuffer(values_raw, dtype="<f4", count=n).astype(
            np.float32, copy=True
        )
    elif leaf.ptype == _TYPE_DOUBLE:
        values = np.frombuffer(values_raw, dtype="<f8", count=n).astype(np.float32)
    else:
        raise ExecutionError("Embedding values are not float32/float64")

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


def _decode_page(raw: bytes, codec: str, leaf: SchemaLeaf) -> DecodedPage:
    """Native C++ decode when available (native/pqvector_pages.cpp), Python
    decoder as fallback/oracle."""
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
        out = np.empty((rows.size, dim), dtype=np.float32)
        if rows.size == 0:
            return out
        total_rows = int(self._rg_starts[-1])
        if rows.max(initial=-1) >= total_rows:
            raise ExecutionError(
                f"Candidate row {int(rows.max())} out of bounds for file with "
                f"{total_rows} rows"
            )
        order = np.argsort(rows, kind="stable")
        with self._open() as f:
            rg_of = np.searchsorted(self._rg_starts, rows, side="right") - 1
            batched = self._read_rows_batched(rows, rg_of, dim, f)
            if batched is not None:
                return batched
            page_cache: tuple[int, int, DecodedPage, np.ndarray] | None = None
            for oi in order:
                row = int(rows[oi])
                rg = int(rg_of[oi])
                local = row - int(self._rg_starts[rg])
                locs = self._locations(rg, f)
                firsts = self._firsts(rg, f)
                pidx = int(np.searchsorted(firsts, local, side="right") - 1)
                if page_cache is not None and page_cache[0] == rg and page_cache[1] == pidx:
                    _, _, page, row_offsets = page_cache
                else:
                    loc = locs[pidx]
                    raw = self._read_at(
                        f, loc.offset, loc.compressed_page_size
                    )
                    chunk = self.row_groups[rg].chunks[self.leaf_idx]
                    page = _decode_page(raw, chunk.codec, self.leaf)
                    row_offsets = np.concatenate(
                        [[0], np.cumsum(page.row_lengths)]
                    )
                    page_cache = (rg, pidx, page, row_offsets)
                in_page = local - int(firsts[pidx])
                if in_page >= page.row_lengths.size:
                    raise ExecutionError("Row beyond decoded page")
                start = int(row_offsets[in_page])
                length = int(page.row_lengths[in_page])
                if length != dim:
                    raise ExecutionError(
                        "Selected embeddings do not match expected dimensions"
                    )
                out[oi] = page.values[start : start + dim]
        return out

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
        order = np.argsort(rows, kind="stable")
        out_vals: list[np.ndarray] = [None] * rows.size
        out_lens = np.empty(rows.size, np.int64)
        pages_read = 0
        with self._open() as f:
            rg_of = np.searchsorted(self._rg_starts, rows, side="right") - 1
            batched = self._read_rows_ragged_batched(rows, rg_of, f)
            if batched is not None:
                return batched
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
                    raw = self._read_at(
                        f, loc.offset, loc.compressed_page_size
                    )
                    chunk = self.row_groups[rg].chunks[self.leaf_idx]
                    page = _decode_page(raw, chunk.codec, self.leaf)
                    row_offsets = np.concatenate(
                        [[0], np.cumsum(page.row_lengths)]
                    )
                    page_cache = (rg, pidx, page, row_offsets)
                    pages_read += 1
                in_page = local - int(firsts[pidx])
                if in_page >= page.row_lengths.size:
                    raise ExecutionError("Row beyond decoded page")
                start = int(row_offsets[in_page])
                length = int(page.row_lengths[in_page])
                out_lens[oi] = length
                out_vals[oi] = page.values[start : start + length]
        return np.concatenate(out_vals), out_lens, pages_read

    # Gap below which two selected pages are fetched in one read: with the
    # 1-row-per-page layout, neighboring candidate pages are usually within
    # one vector (~4·dim bytes) of each other, so coalescing turns thousands
    # of seek+read pairs into a handful of span reads. Measured sweep on the
    # 1M build_new file (16k candidates/query): 0/4k/16k gap = 65-69 ms,
    # 64k = 109 ms, 256k = 292 ms — dead gap bytes dominate past ~16 KB.
    _COALESCE_GAP = 1 << 12

    def _decode_rg_selection(
        self, rg: int, local: np.ndarray, fd: int, dim: int | None = None
    ):
        """Decode every page touched by ``local`` rows of one row group in a
        single native FFI call (span-coalesced preadv reads).

        The per-page loop pays a Python + ctypes round-trip per page; on
        1-row-per-page files that overhead dominates the query path (the
        reference amortizes it inside parquet-rs, search.rs:186-198).
        Reads go through ``os.preadv`` (no shared seek state), so calls for
        different row groups may run on a thread pool — the analog of the
        multi-partition scan DataFusion runs under the reference's rewrite
        (RepartitionExec, .../snapshots/...filter_plan_tree.snap:24-39).
        Returns ``(values, row_lengths, gidx, n_pages)`` where ``gidx`` maps
        each ``local`` row to its row index inside the decoded batch, or
        None when the native library is unavailable. Raises FormatError for
        codecs/encodings the native decoder doesn't cover. Metadata caches
        (_locations/_firsts/_offs_sizes) must already be warm.
        """
        from .native import decode_pages_native

        firsts = self._page_firsts[rg]
        pidx = np.searchsorted(firsts, local, side="right") - 1
        upages = np.unique(pidx)
        page_rows_all = np.diff(
            np.concatenate([firsts, [self.row_groups[rg].num_rows]])
        )
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
        n_page_rows = int(page_rows_all[upages].sum())
        chunk = self.row_groups[rg].chunks[self.leaf_idx]
        res = decode_pages_native(
            buf,
            buf_offsets,
            sizes,
            chunk.codec,
            self.leaf.ptype,
            self.leaf.max_def,
            self.leaf.max_rep,
            row_cap=n_page_rows,
            # Under a dimension contract the touched pages hold exactly
            # rows*dim values (a malformed page trips the native capacity
            # check -> FormatError -> per-page fallback raises the canonical
            # dim error). Without one, the chunk's leaf value count is the
            # only bound — chunk-wide, so reserve it for the ragged path.
            value_cap=(
                n_page_rows * dim if dim else int(chunk.num_values)
            ),
        )
        if res is None:
            return None
        values, row_lengths, _, prs = res
        # Global row index of each candidate inside the decoded batch.
        ppos = np.searchsorted(upages, pidx)
        gidx = prs[ppos] + (local - firsts[pidx])
        if np.any(gidx >= prs[ppos + 1]):
            raise ExecutionError("Row beyond decoded page")
        return values, row_lengths, gidx, int(upages.size)

    def _decode_selections(
        self, rows: np.ndarray, rg_of: np.ndarray, f, dim: int | None = None
    ) -> list[tuple[np.ndarray, tuple]] | None:
        """Run :meth:`_decode_rg_selection` for every touched row group —
        on the shared scan pool when more than one group is touched and the
        pool has workers. Returns ``[(sel, result), ...]`` or None."""
        fd = f.fileno() if f is not None else None
        rgs = [int(r) for r in np.unique(rg_of)]
        sels = {rg: np.flatnonzero(rg_of == rg) for rg in rgs}
        for rg in rgs:  # warm metadata caches serially (they mutate dicts)
            self._locations(rg, f)
            self._firsts(rg, f)
            self._offs_sizes(rg, f)

        def one(rg: int):
            local = rows[sels[rg]] - int(self._rg_starts[rg])
            return self._decode_rg_selection(rg, local, fd, dim=dim)

        pool = _scan_pool() if len(rgs) > 1 else None
        if pool is not None:
            results = list(pool.map(one, rgs))
        else:
            results = [one(rg) for rg in rgs]
        if any(r is None for r in results):
            return None
        return [(sels[rg], res) for rg, res in zip(rgs, results)]

    def _read_rows_batched(
        self, rows: np.ndarray, rg_of: np.ndarray, dim: int, f
    ) -> np.ndarray | None:
        """All selected pages per row group in one native decode call.

        Returns None — and the caller falls back to the per-page loop — when
        the native library is unavailable or a page needs the Python decoder.
        """
        out = np.empty((rows.size, dim), dtype=np.float32)
        try:
            decoded = self._decode_selections(rows, rg_of, f, dim=dim)
            if decoded is None:
                return None
            for sel, (values, row_lengths, gidx, _) in decoded:
                if np.any(row_lengths[gidx] != dim):
                    raise ExecutionError(
                        "Selected embeddings do not match expected dimensions"
                    )
                starts = np.concatenate([[0], np.cumsum(row_lengths)])[gidx]
                out[sel] = values[starts[:, None] + np.arange(dim)]
        except FormatError:
            return None  # unsupported codec/encoding: per-page Python decoder
        return out

    def _read_rows_ragged_batched(
        self, rows: np.ndarray, rg_of: np.ndarray, f
    ) -> tuple[np.ndarray, np.ndarray, int] | None:
        """Ragged analog of :meth:`_read_rows_batched` (no dimension
        contract): one native decode call per touched row group, vectorized
        variable-length gather. Returns (values, row_lengths, pages_read)
        with rows in input order, or None to fall back."""
        out_lens = np.empty(rows.size, np.int64)
        blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        pages_read = 0
        try:
            decoded = self._decode_selections(rows, rg_of, f)
            if decoded is None:
                return None
            for sel, (values, row_lengths, gidx, n_pages) in decoded:
                pages_read += n_pages
                # Uniform-length fast path (embedding columns): a single
                # reshape+fancy-index replaces the 2M-element repeat/arange
                # index build (~31 ms/query at 16k x 128 candidates).
                u = int(row_lengths[0]) if row_lengths.size else 0
                if u > 0 and values.size == row_lengths.size * u and np.all(
                    row_lengths == u
                ):
                    out_lens[sel] = u
                    blocks.append(
                        (sel, values.reshape(-1, u)[gidx].ravel(), None, u)
                    )
                    continue
                lens_sel = row_lengths[gidx]
                starts_sel = np.concatenate([[0], np.cumsum(row_lengths)])[
                    gidx
                ]
                out_lens[sel] = lens_sel
                # Flat gather of the selected rows' values, in sel order.
                boff = np.concatenate([[0], np.cumsum(lens_sel)])
                idx = (
                    np.arange(int(boff[-1]), dtype=np.int64)
                    - np.repeat(boff[:-1], lens_sel)
                    + np.repeat(starts_sel, lens_sel)
                )
                blocks.append((sel, values[idx], lens_sel, None))
        except FormatError:
            return None  # unsupported codec/encoding: per-page Python decoder
        final_starts = np.concatenate([[0], np.cumsum(out_lens)])
        out_vals = np.empty(int(final_starts[-1]), np.float32)
        for sel, block, lens_sel, u in blocks:
            if u is not None:
                # All-uniform file: destinations are sel-row slices.
                dest0 = final_starts[sel]
                out_vals.reshape(-1)[
                    (dest0[:, None] + np.arange(u)).ravel()
                ] = block
                continue
            boff = np.concatenate([[0], np.cumsum(lens_sel)])
            dest = (
                np.arange(block.size, dtype=np.int64)
                - np.repeat(boff[:-1], lens_sel)
                + np.repeat(final_starts[sel], lens_sel)
            )
            out_vals[dest] = block
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
    """Decode a row group's column chunk from pre-read bytes (the prefetch
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


def read_embedding_matrix_native(
    path: str | os.PathLike, column: EmbeddingColumn
) -> np.ndarray | None:
    """Whole vector column as a [n, dim] f32 matrix via the native
    sequential chunk decoder, decoding each row group's pages straight into
    a preallocated output (no per-batch Arrow assembly — pyarrow's
    list<float> path measured 89 MB/s single-core on the 1M x 1024 build).
    A background thread prefetches the next row group's chunk bytes while
    the current one decodes (read and decode both release the GIL), so the
    load runs at max(disk, decode) instead of their sum.

    Returns None to fall back to the pyarrow reader (library unavailable,
    dictionary-encoded chunks, non-float leaves, or ragged rows — the
    fallback raises the canonical validation errors).
    """
    from .native import load
    from .prefetch import iter_prefetched

    if load() is None:
        return None
    lm = embedding_leaf_meta(path, column)
    if lm is None:
        return None
    leaf_idx, leaf, row_groups = lm
    total_rows = sum(rg.num_rows for rg in row_groups)
    if total_rows == 0:
        return None
    out = None
    dim = None
    row0 = 0
    chunks = iter_prefetched(
        path, row_groups, lambda rg: rg_chunk_span(rg, leaf_idx)
    )
    with contextlib.closing(chunks):
        for rg, buf in chunks:
            if out is None:
                first = decode_rg_matrix_from_buf(buf, rg, leaf_idx, leaf)
                if first is None:
                    return None
                dim = first.shape[1]
                # Fault-aware: np.empty first-touch can be slow on a
                # microVM (utils/alloc module docstring).
                out = alloc_matrix((total_rows, dim), np.float32)
                out[: first.shape[0]] = first
                row0 = first.shape[0]
                continue
            dst = out[row0 : row0 + rg.num_rows]
            # Batch-fault the slice before the decoder writes it: the
            # decoder runs several times faster into warm pages than when
            # each write faults (utils/alloc module docstring).
            populate(dst)
            got = decode_rg_matrix_from_buf(buf, rg, leaf_idx, leaf, out=dst)
            if got is None:
                return None
            row0 += rg.num_rows
    if out is None or row0 != total_rows:
        return None
    return out
