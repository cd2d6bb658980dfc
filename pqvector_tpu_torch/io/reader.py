"""Embedding extraction from Parquet (component #7 in SURVEY.md §2).

Counterpart of ``read_parquet_with_embeddings``
(pq-vector src/ivf/parquet.rs:210-305): scan the vector column into a
flat ``[n, d]`` float32 array, accepting ``List``/``LargeList``/
``FixedSizeList`` of float32/float64 (f64 narrowed to f32, parquet.rs:287-291)
and rejecting nulls, ragged dimensions, and zero-length rows
(parquet.rs:241-279).

The decoded matrix is the HBM staging buffer: one contiguous array, one
host->device transfer, then every O(n*d) pass runs on the MXU.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ..errors import FormatError, ValidationError
from ..types import EmbeddingColumn, Embeddings

_FLOAT_TYPES = (pa.float32(), pa.float64())


@dataclasses.dataclass
class ParquetEmbeddings:
    """Mirror of ParquetEmbeddings (parquet.rs:210-214): the full table (for
    rewrite mode) plus the validated embedding matrix."""

    table: pa.Table
    embeddings: Embeddings


def _chunk_vectors(chunk: pa.Array, column: str) -> np.ndarray:
    """Validate one list-array chunk and return its values as [rows, dim] f32."""
    if isinstance(chunk, (pa.ListArray, pa.LargeListArray)):
        if chunk.null_count > 0:
            raise ValidationError("Embedding column contains null rows")
        offsets = np.asarray(chunk.offsets)
        lengths = np.diff(offsets)
        values = chunk.values
        # Respect any slicing: values buffer may be larger than this chunk.
        start, end = int(offsets[0]), int(offsets[-1])
        values = values.slice(start, end - start)
    elif isinstance(chunk, pa.FixedSizeListArray):
        if chunk.null_count > 0:
            raise ValidationError("Embedding column contains null rows")
        width = chunk.type.list_size
        lengths = np.full(len(chunk), width, dtype=np.int64)
        values = chunk.flatten()
    else:
        raise ValidationError(f"Embedding column '{column}' is not a list array")

    if lengths.size == 0:
        return np.empty((0, 0), dtype=np.float32)
    if np.any(lengths == 0):
        raise ValidationError("Embedding row has zero length")
    dim = int(lengths[0])
    if np.any(lengths != dim):
        raise ValidationError("Embedding vectors have inconsistent dimensions")

    if values.type not in _FLOAT_TYPES:
        raise ValidationError("Embedding values are not float32/float64")
    if values.null_count > 0:
        raise ValidationError("Embedding values contain nulls")

    flat = values.to_numpy(zero_copy_only=False)
    return np.ascontiguousarray(flat, dtype=np.float32).reshape(-1, dim)


def extract_embeddings(table: pa.Table, embedding_column: EmbeddingColumn) -> Embeddings:
    """Validate and flatten the embedding column of an Arrow table."""
    column = str(embedding_column)
    if column not in table.column_names:
        raise ValidationError(f"Column '{column}' not found")
    chunked = table.column(column)

    parts: list[np.ndarray] = []
    dim: int | None = None
    for chunk in chunked.chunks:
        mat = _chunk_vectors(chunk, column)
        if mat.shape[0] == 0:
            continue
        if dim is None:
            dim = mat.shape[1]
        elif mat.shape[1] != dim:
            raise ValidationError("Embedding vectors have inconsistent dimensions")
        parts.append(mat)

    if dim is None:
        raise ValidationError("Embedding column has no rows")
    data = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    return Embeddings(data, dim)


def read_parquet_with_embeddings(
    path: str | os.PathLike, embedding_column: EmbeddingColumn
) -> ParquetEmbeddings:
    """Full-file scan: all columns (needed for rewrite mode) + validated
    embedding matrix (parquet.rs:216-305)."""
    table = pq.read_table(path)
    embeddings = extract_embeddings(table, embedding_column)
    return ParquetEmbeddings(table=table, embeddings=embeddings)


def read_embedding_column(
    path: str | os.PathLike, embedding_column: EmbeddingColumn
) -> Embeddings:
    """Projected scan of just the vector column (query-side warm path).

    Tries the native sequential chunk decoder first (pyarrow's list<float>
    assembly measured 89 MB/s single-core on the 1M x 1024 build); pyarrow
    serves layouts the native path declines (dictionary encoding, nulls,
    ragged rows — with the canonical validation errors)."""
    from .pages import read_embedding_matrix_native

    try:
        mat = read_embedding_matrix_native(path, embedding_column)
    except (OSError, FormatError):
        mat = None
    if mat is not None:
        return Embeddings(mat, mat.shape[1])
    table = pq.read_table(path, columns=[str(embedding_column)])
    return extract_embeddings(table, embedding_column)


def infer_vector_dim(path: str | os.PathLike, embedding_column: EmbeddingColumn) -> int:
    """Dimension of the first vector (cheap, reads one batch)."""
    pf = pq.ParquetFile(path)
    column = str(embedding_column)
    if column not in pf.schema_arrow.names:
        raise ValidationError(f"Column '{column}' not found")
    for batch in pf.iter_batches(batch_size=1, columns=[column]):
        if batch.num_rows:
            tbl = pa.Table.from_batches([batch])
            return int(extract_embeddings(tbl, embedding_column).dim)
    raise ValidationError("Embedding column has no rows")
