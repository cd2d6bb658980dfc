"""IndexBuilder: the public index-construction facade.

Counterpart of ``pqvector_tpu/builder.py`` (pq-vector
src/ivf/parquet.rs:22-103): fluent ``n_clusters`` / ``max_iters`` / ``seed``
setters with defaults (auto sqrt(n), 20, 42) and two build modes:
``build_inplace()`` (footer append, data pages untouched) and
``build_new(output)`` (property-preserving rewrite with the index-friendly
page layout). The build runs on the torch ``device`` given to the
constructor.

Extensions beyond reference parity, as in the JAX package:

* ``block_rows``: row-block size of the k-means update,
* ``cluster_sorted`` (``build_new`` only): rewrite rows grouped by cluster
  so each inverted list is a contiguous row range,
* ``streaming(batch_rows)``: train on the bounded sample, assign in
  Parquet-batch chunks (in-place mode, larger-than-memory data),
* ``metric("cosine")``.

* ``transfer_dtype``: the dtype the rows take to the device ("float32",
  "bfloat16", "int8"; the index is that of the rounded rows),
* ``assign_backend("host")``: the staged build's full assignment on the
  host, only the training sample sent to the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .errors import ValidationError
from .index.build import IvfBuildConfig, build_ivf_index
from .index.ivf import IvfIndex
from .index.metrics import normalize_rows
from .io.embed import append_index_inplace, has_pq_vector_index
from .io.reader import read_parquet_with_embeddings
from .io.writer import write_parquet_with_index
from ._device import resolve_device
from .types import EmbeddingColumn, Embeddings


class IndexBuilder:
    """Build an IVF index on a torch device and embed it into a Parquet file."""

    def __init__(
        self,
        source: str | os.PathLike,
        embedding_column: str,
        device: str | torch.device | None = None,
    ):
        self._source = os.fspath(source)
        self._embedding_column = EmbeddingColumn(embedding_column)
        self._device = resolve_device(device)
        self._n_clusters: int | None = None
        self._max_iters = 20
        self._seed = 42
        self._block_rows = 8192
        self._cluster_sorted = False
        self._metric = "l2"
        self._streaming_batch_rows: int | None = None
        self._transfer_dtype = "auto"
        self._assign_backend = "auto"

    # Fluent setters (parquet.rs:42-55).
    def n_clusters(self, n_clusters: int) -> "IndexBuilder":
        self._n_clusters = n_clusters
        return self

    def max_iters(self, max_iters: int) -> "IndexBuilder":
        self._max_iters = max_iters
        return self

    def seed(self, seed: int) -> "IndexBuilder":
        self._seed = seed
        return self

    def block_rows(self, block_rows: int) -> "IndexBuilder":
        self._block_rows = block_rows
        return self

    def cluster_sorted(self, enabled: bool = True) -> "IndexBuilder":
        self._cluster_sorted = enabled
        return self

    def metric(self, metric: str) -> "IndexBuilder":
        """Distance metric: "l2" (reference parity) or "cosine" (L2 over
        unit-normalized vectors, recorded in the footer)."""
        if metric not in ("l2", "cosine"):
            raise ValidationError(f"Unsupported metric '{metric}'")
        self._metric = metric
        return self

    def transfer_dtype(self, dtype: str) -> "IndexBuilder":
        """Host->device dtype of the build's rows ("auto" | "float32" |
        "bfloat16" | "int8"; "auto" is float32). bfloat16 rounds each
        element to nearest even (2^-8 relative) and keeps the resident
        matrix in bf16, half the device memory; int8 is symmetric per-row
        quantization (~2^-7). The rounding moves only the partition:
        searches re-score at storage precision. Deterministic either way."""
        if dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValidationError(f"Unsupported transfer dtype '{dtype}'")
        self._transfer_dtype = dtype
        return self

    def assign_backend(self, backend: str) -> "IndexBuilder":
        """Where the staged build's full-data assignment runs ("auto" |
        "device" | "host"; "auto" is device). "host" sends only the
        training sample to the device and assigns the decoded f32 rows on
        the host (BLAS sgemm, or a certified bf16 matmul on AMX). The
        in-memory and streaming builds ignore it."""
        if backend not in ("auto", "device", "host"):
            raise ValidationError(f"Unsupported assign backend '{backend}'")
        self._assign_backend = backend
        return self

    def streaming(self, batch_rows: int = 131072) -> "IndexBuilder":
        """Build without materializing the full embedding column: train on
        the bounded sample, then assign in Parquet-batch chunks (in-place
        mode only; larger-than-memory datasets)."""
        self._streaming_batch_rows = batch_rows
        return self

    def _build_config(self) -> IvfBuildConfig:
        return IvfBuildConfig(
            n_clusters=self._n_clusters,
            max_iters=self._max_iters,
            seed=self._seed,
            block_rows=self._block_rows,
            transfer_dtype=self._transfer_dtype,
            assign_backend=self._assign_backend,
        )

    def build_inplace(self) -> IvfIndex:
        """Append the index to the source file without rewriting data pages
        (parquet.rs:57-69). Only the embedding column is read, through the
        native chunk decoder, and each decoded chunk is copied to the device
        while the next decodes (``build_ivf_index_staged``): the same index
        as reading the column and building from it."""
        from .utils.profiling import stage

        config = self._build_config()
        if self._streaming_batch_rows:
            index = self._build_streaming(config)
        else:
            from .index.build import build_ivf_index_staged

            with stage("build.index"):
                index = build_ivf_index_staged(
                    self._source,
                    self._embedding_column,
                    config,
                    normalize=self._metric == "cosine",
                    device=self._device,
                )
        with stage("build.append"):
            append_index_inplace(
                self._source, index, self._embedding_column, metric=self._metric
            )
        return index

    def _build_streaming(self, config: IvfBuildConfig) -> IvfIndex:
        import pyarrow.parquet as pq

        from .index.kmeans import (
            KMeansParams,
            assign_clusters,
            default_n_clusters,
            k_means,
            train_sample_size,
        )
        from .index.streaming import (
            assign_clusters_streaming,
            iter_embedding_batches,
            sample_embeddings_streaming,
        )

        batch_rows = self._streaming_batch_rows
        total_rows = pq.ParquetFile(self._source).metadata.num_rows
        if total_rows == 0:
            raise ValidationError("Cannot build IVF index with zero vectors")
        n_clusters = (
            config.n_clusters
            if config.n_clusters is not None
            else default_n_clusters(total_rows)
        )
        if n_clusters > total_rows:
            raise ValidationError("n_clusters cannot exceed number of vectors")
        sample_size = train_sample_size(total_rows, n_clusters)
        sample = sample_embeddings_streaming(
            self._source,
            self._embedding_column,
            sample_size,
            total_rows,
            seed=config.seed,
            batch_rows=batch_rows,
        )
        if self._metric == "cosine":
            sample = normalize_rows(sample)
        centroids, _ = k_means(
            sample,
            KMeansParams(
                n_clusters=n_clusters,
                max_iters=config.max_iters,
                seed=config.seed,
                block_rows=config.block_rows,
            ),
            device=self._device,
        )
        if self._metric == "cosine":
            # Assign against normalized data: stream with normalization.
            parts = [
                assign_clusters(normalize_rows(chunk), centroids, config.block_rows,
                                device=self._device)
                for chunk in iter_embedding_batches(
                    self._source, self._embedding_column, batch_rows
                )
            ]
            assignments = np.concatenate(parts)
        else:
            assignments = assign_clusters_streaming(
                self._source,
                self._embedding_column,
                centroids,
                batch_rows=batch_rows,
                block_rows=config.block_rows,
                device=self._device,
            )
        return IvfIndex.from_assignments(centroids, assignments)

    def build_new(self, output: str | os.PathLike) -> IvfIndex:
        """Write an indexed copy with preserved column properties
        (parquet.rs:71-86)."""
        config = self._build_config()
        parquet = read_parquet_with_embeddings(self._source, self._embedding_column)
        embeddings = parquet.embeddings
        if self._metric == "cosine":
            embeddings = Embeddings(normalize_rows(embeddings.data), embeddings.dim)
        index = build_ivf_index(embeddings, config, device=self._device)
        table = parquet.table

        if self._cluster_sorted:
            # Permute rows so each cluster is a contiguous range; the inverted
            # lists are renumbered to the new row ids (still explicit in the
            # wire format, so the file stays reference-readable).
            order = np.asarray(index.row_ids, dtype=np.int64)
            table = table.take(order)
            index = IvfIndex(
                dim=index.dim,
                n_clusters=index.n_clusters,
                centroids=index.centroids,
                list_offsets=index.list_offsets,
                row_ids=np.arange(index.total_rows, dtype=np.uint32),
            )

        write_parquet_with_index(
            self._source, output, table, index, self._embedding_column,
            metric=self._metric,
        )
        return index


__all__ = ["IndexBuilder", "has_pq_vector_index"]
