"""A frozen parser of the index payload that the program appends to the file.

The format (pq-vector ``src/ivf/parquet.rs`` and ``src/ivf/index.rs``):
``b"PQ_VECTOR1"``, a u64 LE byte length, then the index: u32 LE dim, u32
LE cluster count, the f32 LE centroids row by row, and for each cluster a
u32 LE list length and its u32 LE row ids. The footer key
``pq_vector_index_offset`` holds the payload's offset; it is read here
through pyarrow, which must still read the file.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"PQ_VECTOR1"
OFFSET_KEY = b"pq_vector_index_offset"


class PayloadError(ValueError):
    pass


def footer_offset(path) -> int | None:
    import pyarrow.parquet as pq

    meta = pq.read_metadata(path).metadata or {}
    value = meta.get(OFFSET_KEY)
    return None if value is None else int(value)


def read_payload(path, offset: int) -> dict:
    """The index at ``offset``: dim, centroids [kc, dim] f32, sizes [kc],
    row_ids [total] int64 (cluster by cluster)."""
    with open(path, "rb") as f:
        f.seek(offset)
        head = f.read(len(MAGIC) + 8)
        if len(head) < len(MAGIC) + 8 or head[: len(MAGIC)] != MAGIC:
            raise PayloadError(f"no payload at offset {offset}")
        (length,) = struct.unpack("<Q", head[len(MAGIC) :])
        body = f.read(length)
    if len(body) != length or length < 8:
        raise PayloadError("payload truncated")
    dim, kc = struct.unpack_from("<II", body, 0)
    end = 8 + 4 * dim * kc
    if dim == 0 or kc == 0 or end > length or (length - end) % 4:
        raise PayloadError("payload header or centroids malformed")
    centroids = np.frombuffer(body, "<f4", dim * kc, 8).reshape(kc, dim).astype(np.float32)
    words = np.frombuffer(body, "<u4", (length - end) // 4, end)
    sizes = np.empty(kc, dtype=np.int64)
    pos = 0
    for c in range(kc):
        if pos >= words.size:
            raise PayloadError("inverted lists truncated")
        sizes[c] = int(words[pos])
        pos += 1 + sizes[c]
    if pos != words.size:
        raise PayloadError("inverted lists do not fill the payload")
    starts = np.concatenate([[0], np.cumsum(sizes + 1)])[:-1]
    keep = np.ones(words.size, dtype=bool)
    keep[starts] = False
    return {"dim": dim, "centroids": centroids, "sizes": sizes,
            "row_ids": words[keep].astype(np.int64)}
