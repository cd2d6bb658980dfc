"""Benchmark harnesses and dataset loaders (reference layer: benches/).

Counterpart of ``pqvector_tpu/bench``: the ANN file readers, the seeded
generators, the query harness (``python -m pqvector_tpu_torch.bench.harness``),
the build benchmark (``...bench.index_build``) and the fvecs/bvecs
converter (``...bench.convert``). The harness and the two builders run on the
CUDA card unless ``--device`` names another torch device."""

from .datasets import (
    random_query,
    read_bvecs,
    read_fvecs,
    read_ivecs,
    sift1m_paths,
    synthetic_embeddings,
    write_embedding_parquet,
)

__all__ = [
    "random_query",
    "read_bvecs",
    "read_fvecs",
    "read_ivecs",
    "sift1m_paths",
    "synthetic_embeddings",
    "write_embedding_parquet",
]
