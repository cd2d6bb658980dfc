"""Seeded inputs, made on the device from the run's seed.

A frozen copy of the port's benchmark data (``pqvector_tpu_torch/
datasets.py``: ``synthetic_embeddings``, ``generate_dataset``,
``recall_at_k``), rewritten in torch so that rows and queries are drawn on
the device in a few large calls. The mixture is the same: ``n_modes`` mode
centres uniform in [-1, 1]^d, each row a mode centre plus ``noise`` times a
standard normal draw. Queries are fresh draws from the same modes, never rows
of the file. Every stream of draws has its own generator, seeded from the
run's seed and the stream's name, so the same seed gives the same inputs.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for one named stream of a run's draws; any
    whole ``seed``, however large."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def mixture_modes(seed: int, data: dict, dim: int, device) -> torch.Tensor:
    """The mixture's [n_modes, dim] f32 mode centres, uniform in [-1, 1]."""
    gen = generator(seed, "modes", device)
    modes = torch.rand((data["modes"], dim), generator=gen, device=device)
    return modes.mul_(2.0).sub_(1.0)


def mixture_rows(modes: torch.Tensor, count: int, noise: float, seed: int,
                 stream: str, chunk: int = 1 << 17) -> torch.Tensor:
    """``count`` f32 rows: a uniformly drawn mode centre plus ``noise`` times
    a standard normal draw each, on the modes' device."""
    device = modes.device
    gen = generator(seed, stream, device)
    which = torch.randint(0, modes.shape[0], (count,), generator=gen, device=device)
    x = torch.randn((count, modes.shape[1]), generator=gen, device=device)
    x.mul_(noise)
    for lo in range(0, count, chunk):
        x[lo : lo + chunk] += modes[which[lo : lo + chunk]]
    return x


def write_parquet(path: str | os.PathLike, rows: np.ndarray, batch_rows: int,
                  compression: str) -> int:
    """Write ``rows`` [n, d] f32 in ``generate_dataset``'s layout (an int64
    ``id`` column 0..n-1 and a list<float32> ``embedding`` column, one row
    group a batch) and fsync it; returns the file's size in bytes."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n, dim = rows.shape
    schema = pa.schema(
        [pa.field("id", pa.int64()), pa.field("embedding", pa.list_(pa.float32()))]
    )
    with pq.ParquetWriter(path, schema, compression=compression) as writer:
        for lo in range(0, n, batch_rows):
            part = rows[lo : lo + batch_rows]
            m = part.shape[0]
            offsets = pa.array(np.arange(m + 1, dtype=np.int32) * dim)
            vec = pa.ListArray.from_arrays(offsets, pa.array(part.reshape(-1), pa.float32()))
            ids = pa.array(np.arange(lo, lo + m, dtype=np.int64))
            writer.write_table(pa.table({"id": ids, "embedding": vec}, schema=schema))
    with open(path, "rb+") as f:
        os.fsync(f.fileno())
    return os.path.getsize(path)


def recall_at_k(truth_ids: torch.Tensor, got_ids: torch.Tensor) -> float:
    """Share of the true top-k ids ([Q, k], -1 = empty) found among the
    returned ones ([Q, k'])."""
    t = truth_ids[:, :, None]
    hit = ((t == got_ids[:, None, :]) & (t >= 0)).any(dim=2)
    total = int((truth_ids >= 0).sum())
    return int(hit.sum()) / max(total, 1)
