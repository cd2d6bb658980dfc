"""Shared example helpers for the PyTorch port (the counterpart of
``common.py``; mirrors pq-vector examples/common/mod.rs).

Env vars: ``PQ_VECTOR_SOURCE`` (source parquet), ``PQ_VECTOR_INDEXED``
(indexed copy), ``PQ_VECTOR_QUERY_ROW`` (row to use as the query vector).
``ensure_indexed`` auto-builds the index if the footer keys are absent
(mod.rs:38-55). When no source is configured, a small synthetic dataset is
generated so the examples run out of the box. ``--device`` names the torch
device of the build and the resident searchers (default: the CUDA card;
``--device cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pqvector_tpu_torch import IndexBuilder, has_pq_vector_index  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data")
DEFAULT_SOURCE = os.path.join(DATA_DIR, "example.parquet")
DEFAULT_COLUMN = "embedding"


def device() -> str | None:
    """The ``--device`` argument of the running example (None: the card)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser.parse_known_args()[0].device


def source_path() -> str:
    path = os.environ.get("PQ_VECTOR_SOURCE", DEFAULT_SOURCE)
    if not os.path.exists(path):
        if path != DEFAULT_SOURCE:
            raise FileNotFoundError(path)
        generate_default(path)
    return path


def indexed_path() -> str:
    return os.environ.get(
        "PQ_VECTOR_INDEXED", source_path().replace(".parquet", "_indexed.parquet")
    )


def query_row() -> int:
    return int(os.environ.get("PQ_VECTOR_QUERY_ROW", "0"))


def generate_default(path: str, rows: int = 10_000, dim: int = 64) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(0)
    modes = rng.uniform(-1, 1, (32, dim)).astype(np.float32)
    x = modes[rng.integers(0, 32, rows)] + 0.1 * rng.standard_normal(
        (rows, dim)
    ).astype(np.float32)
    pq.write_table(
        pa.table(
            {
                "id": pa.array(np.arange(rows)),
                "title": pa.array([f"item-{i}" for i in range(rows)]),
                DEFAULT_COLUMN: pa.array(list(x), pa.list_(pa.float32())),
            }
        ),
        path,
    )
    print(f"generated synthetic dataset: {path} ({rows} x {dim})")


def ensure_indexed(source: str, indexed: str, column: str = DEFAULT_COLUMN) -> str:
    """Build the indexed copy on ``--device`` if it doesn't already carry an
    index (examples/common/mod.rs:38-55)."""
    if os.path.exists(indexed) and has_pq_vector_index(indexed):
        return indexed
    print(f"building index: {source} -> {indexed}")
    IndexBuilder(source, column, device=device()).build_new(indexed)
    return indexed


def read_query_vector(path: str, column: str, row: int) -> np.ndarray:
    import pyarrow.parquet as pq

    table = pq.read_table(path, columns=[column])
    return np.asarray(table.column(column)[row].as_py(), dtype=np.float32)
