"""Host-side Parquet IO: embed/extract, footer surgery, property-preserving
rewrite (reference layer: pq-vector src/ivf/parquet.rs)."""

from .embed import (
    FOOTER_SIZE,
    PQ_VECTOR_EMBEDDING_COLUMN_KEY,
    PQ_VECTOR_INDEX_MAGIC,
    PQ_VECTOR_INDEX_OFFSET_KEY,
    append_index_inplace,
    encode_index_payload,
    has_pq_vector_index,
    parse_index_metadata,
    read_index_from_parquet,
    read_index_from_payload,
    read_index_metadata,
)
from .reader import (
    ParquetEmbeddings,
    extract_embeddings,
    infer_vector_dim,
    read_embedding_column,
    read_parquet_with_embeddings,
)
from .writer import collect_column_write_options, write_parquet_with_index

__all__ = [
    "FOOTER_SIZE",
    "PQ_VECTOR_EMBEDDING_COLUMN_KEY",
    "PQ_VECTOR_INDEX_MAGIC",
    "PQ_VECTOR_INDEX_OFFSET_KEY",
    "ParquetEmbeddings",
    "append_index_inplace",
    "collect_column_write_options",
    "encode_index_payload",
    "extract_embeddings",
    "has_pq_vector_index",
    "infer_vector_dim",
    "parse_index_metadata",
    "read_embedding_column",
    "read_index_from_parquet",
    "read_index_from_payload",
    "read_index_metadata",
    "read_parquet_with_embeddings",
    "write_parquet_with_index",
]
