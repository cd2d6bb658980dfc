"""Streaming build paths for datasets larger than host or device memory.

Counterpart of ``pqvector_tpu/index/streaming.py``. The reference
materializes every embedding in RAM before training
(pq-vector src/ivf/parquet.rs:216-305): fine at 1M rows, not at 100M. Here
the build trains on the bounded 5%/100k sample as usual, then runs the full
assignment pass *streamed*: decode Parquet row-group batches, assign each
batch on the device (K1 on the card), and never hold more than one batch of
embeddings.
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from ..errors import FormatError, ValidationError
from ..types import EmbeddingColumn
from .kmeans import assign_clusters


def iter_embedding_batches(
    path: str | os.PathLike,
    embedding_column: EmbeddingColumn,
    batch_rows: int = 131072,
):
    """Yield [rows, dim] float32 matrices from a Parquet vector column.

    Each row group is a batch, decoded by the native chunk decoder where
    its layout allows and by pyarrow where it does not
    (``io/pages.decode_row_groups``), so mixed layouts stream correctly
    with no duplicated rows. ``batch_rows`` bounds what is decoded at
    once: ``batch_rows // rows per row group`` row groups decode in
    parallel (at least one), so no more than that plus one are alive
    while the caller holds a batch. The JAX package decodes one at a time
    behind a read-ahead of two chunks' bytes. A file whose footer the
    page reader cannot parse streams through pyarrow in ``batch_rows``
    batches."""
    import contextlib

    from ..io.pages import DECODE_WORKERS, decode_row_groups, embedding_leaf_meta
    from ..io.reader import extract_embeddings

    pf = pq.ParquetFile(path)
    column = str(embedding_column)
    if column not in pf.schema_arrow.names:
        raise ValidationError(f"Column '{column}' not found")

    try:
        lm = embedding_leaf_meta(path, embedding_column)
    except FormatError:
        lm = None
    if lm is not None:
        leaf_idx, leaf, row_groups = lm
        cap = max((rg.num_rows for rg in row_groups), default=1)
        workers = max(1, min(DECODE_WORKERS, batch_rows // max(1, cap)))
        chunks = decode_row_groups(path, row_groups, leaf_idx, leaf,
                                   workers=workers, column=embedding_column)
        with contextlib.closing(chunks):
            for mat in chunks:
                if mat.shape[0]:
                    yield mat
        return

    for batch in pf.iter_batches(batch_size=batch_rows, columns=[column]):
        if batch.num_rows == 0:
            continue
        table = pa.Table.from_batches([batch])
        yield extract_embeddings(table, embedding_column).data


def assign_clusters_streaming(
    path: str | os.PathLike,
    embedding_column: EmbeddingColumn,
    centroids: np.ndarray,
    batch_rows: int = 131072,
    block_rows: int = 8192,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Nearest-centroid assignment over a Parquet file, one batch at a time
    on ``device``: the reference's full assignment pass
    (pq-vector src/ivf/index.rs:193-206) with O(batch) host memory."""
    parts: list[np.ndarray] = []
    dim = centroids.shape[1]
    for chunk in iter_embedding_batches(path, embedding_column, batch_rows):
        if chunk.shape[1] != dim:
            raise ValidationError(
                "Embedding vectors have inconsistent dimensions"
            )
        parts.append(assign_clusters(chunk, centroids, block_rows, device=device))
    if not parts:
        return np.empty(0, dtype=np.int32)
    return np.concatenate(parts)


def sample_embeddings_streaming(
    path: str | os.PathLike,
    embedding_column: EmbeddingColumn,
    sample_size: int,
    total_rows: int,
    seed: int,
    batch_rows: int = 131072,
) -> np.ndarray:
    """Deterministic uniform sample without materializing the full column.

    Draws global row indices up front (host RNG, O(n) memory for indices
    only) and collects them batch by batch.
    """
    rng = np.random.default_rng(seed)
    chosen = np.sort(rng.choice(total_rows, size=sample_size, replace=False))
    out = None
    base = 0
    pos = 0
    for chunk in iter_embedding_batches(path, embedding_column, batch_rows):
        if out is None:
            out = np.empty((sample_size, chunk.shape[1]), dtype=np.float32)
        end = base + chunk.shape[0]
        while pos < sample_size and chosen[pos] < end:
            out[pos] = chunk[chosen[pos] - base]
            pos += 1
        base = end
        if pos >= sample_size:
            break
    if out is None or pos < sample_size:
        raise ValidationError(
            f"File has fewer rows ({base}) than requested sample indices"
        )
    return out
