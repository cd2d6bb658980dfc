"""Standalone top-k nearest-neighbor search API (component #10 in SURVEY.md §2).

Counterpart of ``TopkBuilder`` (pq-vector src/ivf/search.rs:49-142) with
identical semantics:

* mandatory ``k`` / ``nprobe`` (> 0),
* query dimension checked against the embedded index (search.rs:91-98),
* candidate rows from the nprobe nearest clusters,
* distances are **square-rooted** and results sorted ascending
  (search.rs:129-141) — note the SQL path returns squared-L2 order without
  sqrt, matching the reference's split behavior (SURVEY.md §7 hard part #4).

Extension: ``topk_batch(path, queries, ...)`` shares one index read and the
candidate IO across a batch (the reference is strictly one query at a time).
All of it is numpy host code, a copy of the JAX package's module.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..errors import ValidationError
from ..index.metrics import normalize_rows, normalize_vector
from ..io.embed import read_index_from_parquet, read_index_metric
from .selective import read_embeddings_for_rows


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """One search hit (search.rs:41-45)."""

    row_idx: int
    distance: float


class TopkBuilder:
    """Fluent top-k search over an indexed Parquet file."""

    def __init__(self, parquet_path: str | os.PathLike, query: np.ndarray):
        self._path = os.fspath(parquet_path)
        self._query = np.asarray(query, dtype=np.float32).reshape(-1)
        self._k: int | None = None
        self._nprobe: int | None = None

    def k(self, k: int) -> "TopkBuilder":
        if k <= 0:
            raise ValidationError("k must be > 0")
        self._k = k
        return self

    def nprobe(self, nprobe: int) -> "TopkBuilder":
        if nprobe <= 0:
            raise ValidationError("nprobe must be > 0")
        self._nprobe = nprobe
        return self

    def search(self) -> list[SearchResult]:
        if self._k is None:
            raise ValidationError("k must be set")
        if self._nprobe is None:
            raise ValidationError("nprobe must be set")
        return topk(self._path, self._query, self._k, self._nprobe)


def topk(
    path: str | os.PathLike, query: np.ndarray, k: int, nprobe: int
) -> list[SearchResult]:
    """Single-query search (search.rs:83-142)."""
    index, embedding_column = read_index_from_parquet(path)
    query = np.asarray(query, dtype=np.float32).reshape(-1)
    if query.size != index.dim:
        raise ValidationError(
            f"Query dimension mismatch: expected {index.dim}, got {query.size}"
        )
    metric = read_index_metric(path)
    if metric == "cosine":
        query = normalize_vector(query)

    rows = index.candidate_rows(query, nprobe)
    embeddings = read_embeddings_for_rows(path, embedding_column, rows, index.dim)
    if metric == "cosine":
        embeddings = normalize_rows(embeddings)

    diff = embeddings - query[None, :]
    distances = np.einsum("nd,nd->n", diff, diff)

    k_eff = min(k, rows.size)
    if k_eff == 0:
        return []
    # Partial select then full sort of the k survivors; ties keep the earlier
    # candidate (stable), mirroring the reference heap's Equal handling
    # (search.rs:32-38).
    part = np.argpartition(distances, k_eff - 1)[:k_eff]
    order = part[np.argsort(distances[part], kind="stable")]
    return [
        SearchResult(row_idx=int(rows[i]), distance=float(np.sqrt(distances[i])))
        for i in order
    ]


def topk_batch(
    path: str | os.PathLike,
    queries: np.ndarray,
    k: int,
    nprobe: int,
) -> list[list[SearchResult]]:
    """Batched search: one index read, shared candidate IO, device-friendly.

    For sustained throughput prefer ``DeviceIvfSearcher``, which keeps the
    embeddings resident in device memory.
    """
    queries = np.asarray(queries, dtype=np.float32)
    if queries.ndim != 2:
        raise ValidationError("queries must be a [batch, dim] matrix")
    index, embedding_column = read_index_from_parquet(path)
    if queries.shape[1] != index.dim:
        raise ValidationError(
            f"Query dimension mismatch: expected {index.dim}, got {queries.shape[1]}"
        )
    metric = read_index_metric(path)
    if metric == "cosine":
        queries = normalize_rows(queries)

    # Union of candidate rows across the batch shares the Parquet IO.
    per_query_rows = [index.candidate_rows(q, nprobe) for q in queries]
    all_rows = np.unique(np.concatenate(per_query_rows)) if per_query_rows else np.empty(0, np.int64)
    embeddings = read_embeddings_for_rows(path, embedding_column, all_rows, index.dim)
    if metric == "cosine":
        embeddings = normalize_rows(embeddings)
    pos = {int(r): i for i, r in enumerate(all_rows)}

    results: list[list[SearchResult]] = []
    for q, rows in zip(queries, per_query_rows):
        sel = np.array([pos[int(r)] for r in rows], dtype=np.int64)
        emb = embeddings[sel]
        diff = emb - q[None, :]
        distances = np.einsum("nd,nd->n", diff, diff)
        k_eff = min(k, rows.size)
        if k_eff == 0:
            results.append([])
            continue
        part = np.argpartition(distances, k_eff - 1)[:k_eff]
        order = part[np.argsort(distances[part], kind="stable")]
        results.append(
            [
                SearchResult(row_idx=int(rows[i]), distance=float(np.sqrt(distances[i])))
                for i in order
            ]
        )
    return results
