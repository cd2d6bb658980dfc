"""Index payload embedding in Parquet files.

Host-side counterpart of component #6/#8 in SURVEY.md §2
(pq-vector src/ivf/parquet.rs:105-208, 536-611). The payload format and
footer keys are bit-identical to the reference so files interoperate:

* payload: ``b"PQ_VECTOR1"`` + u64 LE index length + index bytes
  (parquet.rs:106, 361-363, 600-604)
* footer key-value keys: ``pq_vector_index_offset`` (decimal string) and
  ``pq_vector_embedding_column`` (parquet.rs:109-112)

In-place append algorithm (parquet.rs:542-611): the index payload is written
starting at ``file_len - 8`` (over the old 8-byte footer tail; the old
metadata bytes become dead space), then the spliced Thrift metadata and a new
``len + "PAR1"`` tail follow. Data pages are never touched.
"""

from __future__ import annotations

import os
import struct

from ..errors import FormatError
from ..index.ivf import IvfIndex
from ..types import EmbeddingColumn
from .thrift import read_key_value_metadata, splice_key_value_metadata

PQ_VECTOR_INDEX_MAGIC = b"PQ_VECTOR1"
PQ_VECTOR_INDEX_OFFSET_KEY = "pq_vector_index_offset"
PQ_VECTOR_EMBEDDING_COLUMN_KEY = "pq_vector_embedding_column"
# Extension key (not in the reference, which is L2-only — its readers ignore
# unknown KV pairs, so files stay mutually readable): distance metric the
# index was trained with ("l2" | "cosine"); cosine = L2 over normalized
# vectors (BASELINE.md config 3).
PQ_VECTOR_METRIC_KEY = "pq_vector_metric"
_PQ_KEYS = frozenset(
    {PQ_VECTOR_INDEX_OFFSET_KEY, PQ_VECTOR_EMBEDDING_COLUMN_KEY, PQ_VECTOR_METRIC_KEY}
)

PARQUET_MAGIC = b"PAR1"
PARQUET_MAGIC_ENCRYPTED = b"PARE"
FOOTER_SIZE = 8  # u32 metadata_len + 4-byte magic


def encode_index_payload(index: IvfIndex) -> bytes:
    index_bytes = index.to_bytes()
    return PQ_VECTOR_INDEX_MAGIC + struct.pack("<Q", len(index_bytes)) + index_bytes


def read_index_from_payload(
    payload: bytes | memoryview, embedding_column: EmbeddingColumn
) -> tuple[IvfIndex, EmbeddingColumn]:
    """Decode a payload blob (parquet.rs:151-174 semantics, same errors)."""
    view = memoryview(payload)
    header_len = len(PQ_VECTOR_INDEX_MAGIC) + 8
    if len(view) < header_len:
        raise FormatError("pq-vector index payload is truncated")
    if bytes(view[: len(PQ_VECTOR_INDEX_MAGIC)]) != PQ_VECTOR_INDEX_MAGIC:
        raise FormatError("Invalid pq-vector index magic")
    (index_len,) = struct.unpack_from("<Q", view, len(PQ_VECTOR_INDEX_MAGIC))
    if len(view) < header_len + index_len:
        raise FormatError("pq-vector index bytes are truncated")
    index = IvfIndex.from_bytes(view[header_len : header_len + index_len])
    return index, embedding_column


class FooterTail:
    """Parsed last-8-bytes of a Parquet file (parquet.rs:552-558)."""

    __slots__ = ("metadata_len", "encrypted")

    def __init__(self, tail: bytes):
        if len(tail) != FOOTER_SIZE:
            raise FormatError("Parquet footer tail must be 8 bytes")
        magic = tail[4:]
        if magic == PARQUET_MAGIC_ENCRYPTED:
            self.encrypted = True
        elif magic == PARQUET_MAGIC:
            self.encrypted = False
        else:
            raise FormatError("Invalid parquet footer magic")
        (self.metadata_len,) = struct.unpack("<I", tail[:4])


def read_footer_metadata(path: str | os.PathLike) -> bytes:
    """Raw Thrift FileMetaData bytes from a Parquet file's footer."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        file_len = f.tell()
        if file_len < FOOTER_SIZE:
            raise FormatError("Parquet file too small to contain a footer")
        f.seek(file_len - FOOTER_SIZE)
        tail = FooterTail(f.read(FOOTER_SIZE))
        if tail.encrypted:
            raise FormatError(
                "Encrypted parquet footers are not supported for in-place indexing"
            )
        if tail.metadata_len + FOOTER_SIZE > file_len:
            raise FormatError("Parquet footer length exceeds file size")
        f.seek(file_len - FOOTER_SIZE - tail.metadata_len)
        return f.read(tail.metadata_len)


def parse_index_metadata(
    kv_pairs: dict[str, str] | list[tuple[str, str | None]],
) -> tuple[int, EmbeddingColumn] | None:
    """(offset, column) from KV pairs, or None if keys absent
    (parquet.rs:120-143)."""
    if isinstance(kv_pairs, dict):
        items = kv_pairs
    else:
        items = {k: v for k, v in kv_pairs if v is not None}
    offset = items.get(PQ_VECTOR_INDEX_OFFSET_KEY)
    column = items.get(PQ_VECTOR_EMBEDDING_COLUMN_KEY)
    if offset is None or column is None:
        return None
    try:
        offset_int = int(offset)
    except ValueError as exc:
        raise FormatError(f"Invalid pq_vector_index_offset value: {offset!r}") from exc
    return offset_int, EmbeddingColumn(column)


def read_index_metadata(path: str | os.PathLike) -> tuple[int, EmbeddingColumn] | None:
    """Read the footer KV pairs and parse the pq-vector keys."""
    kv = read_key_value_metadata(read_footer_metadata(path))
    return parse_index_metadata(kv)


def read_index_metric(path: str | os.PathLike) -> str:
    """Distance metric recorded in the footer ("l2" when absent)."""
    kv = {k: v for k, v in read_key_value_metadata(read_footer_metadata(path))}
    return kv.get(PQ_VECTOR_METRIC_KEY, "l2")


def has_pq_vector_index(path: str | os.PathLike) -> bool:
    """True if the file carries pq-vector index metadata (parquet.rs:187-189)."""
    return read_index_metadata(path) is not None


def read_index_from_parquet(
    path: str | os.PathLike,
) -> tuple[IvfIndex, EmbeddingColumn]:
    """Footer KV -> seek to offset -> decode payload (parquet.rs:191-208)."""
    meta = read_index_metadata(path)
    if meta is None:
        raise FormatError("Missing pq-vector index metadata in parquet footer")
    offset, embedding_column = meta
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        file_len = f.tell()
        if offset >= file_len:
            raise FormatError(
                f"Invalid pq-vector index offset {offset} for file of size {file_len}"
            )
        f.seek(offset)
        payload = f.read()
    try:
        return read_index_from_payload(payload, embedding_column)
    except FormatError as exc:
        raise FormatError(
            f"Failed to decode pq-vector index payload at offset {offset}: {exc}"
        ) from exc


def append_index_inplace(
    path: str | os.PathLike,
    index: IvfIndex,
    embedding_column: EmbeddingColumn,
    metric: str = "l2",
) -> None:
    """Embed the index into an existing Parquet file without rewriting data.

    Mirrors pq-vector src/ivf/parquet.rs:542-611: payload written at
    ``file_len - 8``; spliced metadata (old pq keys stripped, new ones
    appended) + fresh footer tail written after it.

    Routed through the native C++ library (native/pqvector_host.cpp) when it
    is available; the pure-Python path below is the portable fallback and
    byte-identical test oracle.
    """
    from .native import append_index_inplace_native

    extra_kv = {} if metric == "l2" else {PQ_VECTOR_METRIC_KEY: metric}
    if append_index_inplace_native(
        path,
        index.to_bytes(),
        str(embedding_column),
        PQ_VECTOR_INDEX_OFFSET_KEY,
        PQ_VECTOR_EMBEDDING_COLUMN_KEY,
        PQ_VECTOR_INDEX_MAGIC,
        extra_kv=extra_kv,
        extra_drop_keys=tuple(sorted(_PQ_KEYS)),
    ):
        return

    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        file_len = f.tell()
        if file_len < FOOTER_SIZE:
            raise FormatError("Parquet file too small to contain a footer")
        f.seek(file_len - FOOTER_SIZE)
        tail = FooterTail(f.read(FOOTER_SIZE))
        if tail.encrypted:
            raise FormatError(
                "Encrypted parquet footers are not supported for in-place indexing"
            )
        if tail.metadata_len + FOOTER_SIZE > file_len:
            raise FormatError("Parquet footer length exceeds file size")

        f.seek(file_len - FOOTER_SIZE - tail.metadata_len)
        old_metadata = f.read(tail.metadata_len)

        index_offset = file_len - FOOTER_SIZE
        set_pairs = [
            (PQ_VECTOR_INDEX_OFFSET_KEY, str(index_offset)),
            (PQ_VECTOR_EMBEDDING_COLUMN_KEY, str(embedding_column)),
        ]
        set_pairs.extend(extra_kv.items())
        new_metadata = splice_key_value_metadata(
            old_metadata, set_pairs, drop_keys=_PQ_KEYS
        )

        f.seek(index_offset)
        f.write(encode_index_payload(index))
        f.write(new_metadata)
        # Ordered durability: payload + metadata reach disk before the tail
        # that references them. Like the reference, a torn write can still
        # corrupt the footer region (data pages are never touched,
        # SURVEY.md §5.4) — but a completed append is durable once we return.
        f.flush()
        os.fsync(f.fileno())
        f.write(struct.pack("<I", len(new_metadata)) + PARQUET_MAGIC)
        f.truncate()
        f.flush()
        os.fsync(f.fileno())
