"""Seeded benchmark data and the recall measure.

Counterpart of ``pqvector_tpu/bench/datasets.py`` (``synthetic_embeddings``)
and of the two helpers of the repo's benchmark script that the port's runs
need (``generate_dataset``, ``recall_at_k``). The port keeps its own copies
so that nothing it runs imports the JAX program; from one seed they give the
same bytes as the originals.
"""

from __future__ import annotations

import os

import numpy as np


def synthetic_embeddings(
    rows: int, dim: int, seed: int = 1234, n_modes: int = 256, noise: float = 0.15
) -> np.ndarray:
    """Seeded clustered gaussian-mixture embeddings (gives IVF structure)."""
    rng = np.random.default_rng(seed)
    modes = rng.uniform(-1.0, 1.0, (n_modes, dim)).astype(np.float32)
    which = rng.integers(0, n_modes, rows)
    return modes[which] + noise * rng.standard_normal((rows, dim)).astype(np.float32)


def generate_dataset(
    path: str | os.PathLike, rows: int, dim: int, seed: int = 1234,
    batch_rows: int = 65536,
) -> None:
    """Write a seeded synthetic Parquet file with an ``id`` and an
    ``embedding`` column: a gaussian mixture of 256 modes, drawn batch by
    batch from one generator, so IVF has structure to find."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    n_modes = 256
    modes = rng.uniform(-1.0, 1.0, (n_modes, dim)).astype(np.float32)
    schema = pa.schema(
        [pa.field("id", pa.int64()), pa.field("embedding", pa.list_(pa.float32()))]
    )
    writer = pq.ParquetWriter(path, schema, compression="snappy")
    written = 0
    while written < rows:
        n = min(batch_rows, rows - written)
        which = rng.integers(0, n_modes, n)
        x = modes[which] + 0.15 * rng.standard_normal((n, dim)).astype(np.float32)
        flat = pa.array(x.reshape(-1), pa.float32())
        offsets = pa.array(np.arange(n + 1, dtype=np.int32) * dim)
        vec = pa.ListArray.from_arrays(offsets, flat)
        batch = pa.table(
            {"id": pa.array(np.arange(written, written + n)), "embedding": vec},
            schema=schema,
        )
        writer.write_table(batch)
        written += n
    writer.close()


def recall_at_k(truth_ids, got_ids) -> float:
    """Fraction of the true top-k ids recovered; negative ids are empty slots."""
    hits = 0
    total = 0
    for t, g in zip(truth_ids, got_ids):
        t = set(int(i) for i in t if i >= 0)
        g = set(int(i) for i in g if i >= 0)
        hits += len(t & g)
        total += len(t)
    return hits / max(total, 1)
