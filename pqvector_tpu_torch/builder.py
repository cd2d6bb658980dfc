"""IndexBuilder: the public index-construction facade.

Counterpart of ``pqvector_tpu/builder.py`` (pq-vector
src/ivf/parquet.rs:22-103): fluent ``n_clusters`` / ``max_iters`` / ``seed``
setters with defaults (auto sqrt(n), 20, 42) and ``build_inplace()``, which
appends the index to the file's footer and leaves its data pages untouched.
The build runs on the torch ``device`` given to the constructor.

Not ported yet: ``build_new`` (the property-preserving rewrite), the
streaming build and the setters that only they or the TPU's host link need
(``cluster_sorted``, ``transfer_dtype``, ``assign_backend``). They exist and
raise ``ValidationError``, so a caller written against the JAX package
learns what is missing by name.
"""

from __future__ import annotations

import os

import torch

from .errors import ValidationError
from .index.build import IvfBuildConfig, build_ivf_index
from .index.ivf import IvfIndex
from .index.metrics import normalize_rows
from .io.embed import append_index_inplace, has_pq_vector_index
from .io.reader import read_embedding_column
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
        self._metric = "l2"

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

    def metric(self, metric: str) -> "IndexBuilder":
        """Distance metric: "l2" (reference parity) or "cosine" (L2 over
        unit-normalized vectors, recorded in the footer)."""
        if metric not in ("l2", "cosine"):
            raise ValidationError(f"Unsupported metric '{metric}'")
        self._metric = metric
        return self

    # Methods of the JAX package's builder that this one does not carry out.
    def _not_ported(self, method: str):
        raise ValidationError(f"IndexBuilder.{method} is not ported")

    def cluster_sorted(self, enabled: bool = True) -> "IndexBuilder":
        self._not_ported("cluster_sorted")

    def transfer_dtype(self, dtype: str) -> "IndexBuilder":
        self._not_ported("transfer_dtype")

    def assign_backend(self, backend: str) -> "IndexBuilder":
        self._not_ported("assign_backend")

    def streaming(self, batch_rows: int = 131072) -> "IndexBuilder":
        self._not_ported("streaming")

    def build_new(self, output: str | os.PathLike) -> IvfIndex:
        self._not_ported("build_new")

    def _build_config(self) -> IvfBuildConfig:
        return IvfBuildConfig(
            n_clusters=self._n_clusters,
            max_iters=self._max_iters,
            seed=self._seed,
            block_rows=self._block_rows,
        )

    def build_inplace(self) -> IvfIndex:
        """Read the embedding column, build on the device, and append the
        index to the source file without rewriting data pages
        (parquet.rs:57-69). The result equals the JAX package's staged
        in-place path for the same centroids: only the embedding column is
        read."""
        config = self._build_config()
        embeddings = read_embedding_column(self._source, self._embedding_column)
        if self._metric == "cosine":
            embeddings = Embeddings(normalize_rows(embeddings.data), embeddings.dim)
        index = build_ivf_index(embeddings, config, device=self._device)
        append_index_inplace(
            self._source, index, self._embedding_column, metric=self._metric
        )
        return index


__all__ = ["IndexBuilder", "has_pq_vector_index"]
