"""Selective candidate-row reads from Parquet (component #11 in SURVEY.md §2).

Counterpart of ``read_embeddings_for_rows``
(pq-vector src/ivf/search.rs:154-244). The reference builds
skip/select(1) runs over 1-row pages; pyarrow has no page-level row selection,
so this path reads only the *row groups* that contain candidates (projected to
the vector column) and gathers locally — with files written by our
``cluster_sorted`` layout, candidates collapse to a handful of contiguous
groups. Results are un-permuted back to candidate order exactly like the
reference (search.rs:230-242).
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow.parquet as pq

from ..errors import ExecutionError
from ..types import EmbeddingColumn
from .. io.reader import extract_embeddings


def row_group_row_counts(path: str | os.PathLike) -> np.ndarray:
    md = pq.ParquetFile(path).metadata
    return np.array(
        [md.row_group(i).num_rows for i in range(md.num_row_groups)], dtype=np.int64
    )


def read_embeddings_for_rows(
    path: str | os.PathLike,
    embedding_column: EmbeddingColumn,
    rows: np.ndarray,
    dim: int,
) -> np.ndarray:
    """Read embeddings for specific global row ids; returns [len(rows), dim]
    float32 in the order of ``rows``.

    Prefers exact page-level reads (io/pages.py) when the file carries a page
    offset index and the selection is sparse — the reference's 1-row-per-page
    skip/select path (search.rs:186-198); otherwise reads only the touched
    row groups.
    """
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return np.empty((0, dim), dtype=np.float32)

    try:
        from ..io.pages import PageSelectiveReader

        reader = PageSelectiveReader(path, embedding_column)
        total = int(reader._rg_starts[-1])
        if reader.supports_page_reads and rows.size < max(1, total // 4):
            return reader.read_rows(rows, dim)
    except ExecutionError:
        pass  # fall back to row-group reads below

    pf = pq.ParquetFile(path)
    md = pf.metadata
    counts = np.array(
        [md.row_group(i).num_rows for i in range(md.num_row_groups)], dtype=np.int64
    )
    starts = np.concatenate([[0], np.cumsum(counts)])
    total_rows = int(starts[-1])
    if rows.max(initial=-1) >= total_rows:
        raise ExecutionError(
            f"Candidate row {int(rows.max())} out of bounds for file with "
            f"{total_rows} rows"
        )

    group_of = np.searchsorted(starts, rows, side="right") - 1
    touched = np.unique(group_of)

    column = str(embedding_column)
    out = np.empty((rows.size, dim), dtype=np.float32)
    for g in touched:
        tbl = pf.read_row_group(int(g), columns=[column])
        emb = extract_embeddings(tbl, embedding_column)
        if emb.data.shape[1] != dim:
            raise ExecutionError(
                "Selected embeddings do not match expected dimensions"
            )
        sel = group_of == g
        local = rows[sel] - starts[g]
        out[sel] = emb.data[local]
    return out
