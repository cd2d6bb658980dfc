"""Benchmark dataset loaders and generators.

Counterpart of ``pqvector_tpu/bench/datasets.py``: the reference's seeded
synthetic Parquet generator (pq-vector benches/bench_util.rs:12-58) and
readers for the standard ANN benchmark formats (SIFT1M, GloVe, DEEP):
``fvecs``, ``bvecs`` and ``ivecs``. Real datasets are read only when already
on disk; ``synthetic_embeddings`` is the port's copy in ``datasets.py``,
which gives the JAX package's bytes for one seed.
"""

from __future__ import annotations

import os

import numpy as np

from ..datasets import synthetic_embeddings
from ..errors import ValidationError

__all__ = [
    "random_query",
    "read_bvecs",
    "read_fvecs",
    "read_ivecs",
    "sift1m_paths",
    "synthetic_embeddings",
    "write_embedding_parquet",
]


def read_fvecs(path: str | os.PathLike, max_rows: int | None = None) -> np.ndarray:
    """Read an .fvecs file: per row, i32 dim then dim f32 values."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.empty((0, 0), dtype=np.float32)
    dim = int(raw[0])
    if dim <= 0 or raw.size % (dim + 1) != 0:
        raise ValidationError(f"Malformed fvecs file: {path}")
    mat = raw.reshape(-1, dim + 1)[:, 1:]
    if max_rows is not None:
        mat = mat[:max_rows]
    return mat.view(np.float32).copy()


def read_ivecs(path: str | os.PathLike, max_rows: int | None = None) -> np.ndarray:
    """Read an .ivecs file (same framing, int32 payload)."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.empty((0, 0), dtype=np.int32)
    dim = int(raw[0])
    if dim <= 0 or raw.size % (dim + 1) != 0:
        raise ValidationError(f"Malformed ivecs file: {path}")
    mat = raw.reshape(-1, dim + 1)[:, 1:]
    if max_rows is not None:
        mat = mat[:max_rows]
    return mat.copy()


def read_bvecs(path: str | os.PathLike, max_rows: int | None = None) -> np.ndarray:
    """Read a .bvecs file: per row, i32 dim then dim u8 values."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.empty((0, 0), dtype=np.float32)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    stride = 4 + dim
    if dim <= 0 or raw.size % stride != 0:
        raise ValidationError(f"Malformed bvecs file: {path}")
    mat = raw.reshape(-1, stride)[:, 4:]
    if max_rows is not None:
        mat = mat[:max_rows]
    return mat.astype(np.float32)


def write_embedding_parquet(
    path: str | os.PathLike,
    embeddings: np.ndarray,
    column: str = "embedding",
    batch_rows: int = 65536,
    row_group_size: int | None = None,
    compression: str = "snappy",
) -> None:
    """Write an (id, vectors) Parquet file like the reference generator
    (bench_util.rs:12-58)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows, dim = embeddings.shape
    schema = pa.schema(
        [pa.field("id", pa.int64()), pa.field(column, pa.list_(pa.float32()))]
    )
    writer = pq.ParquetWriter(path, schema, compression=compression)
    written = 0
    while written < rows:
        n = min(batch_rows, rows - written)
        chunk = np.ascontiguousarray(embeddings[written : written + n])
        flat = pa.array(chunk.reshape(-1), pa.float32())
        offsets = pa.array(np.arange(n + 1, dtype=np.int32) * dim)
        vec = pa.ListArray.from_arrays(offsets, flat)
        table = pa.table(
            {"id": pa.array(np.arange(written, written + n)), column: vec},
            schema=schema,
        )
        writer.write_table(table, row_group_size=row_group_size)
        written += n
    writer.close()


def random_query(dim: int, seed: int = 7) -> np.ndarray:
    """Seeded random query (bench_util.rs random_query analog)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, dim).astype(np.float32)


def sift1m_paths(base_dir: str) -> dict[str, str] | None:
    """The standard SIFT1M layout under ``base_dir`` if it is on disk."""
    paths = {
        "base": os.path.join(base_dir, "sift_base.fvecs"),
        "query": os.path.join(base_dir, "sift_query.fvecs"),
        "groundtruth": os.path.join(base_dir, "sift_groundtruth.ivecs"),
    }
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    return None
