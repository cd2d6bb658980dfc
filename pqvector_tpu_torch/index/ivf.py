"""IVF-flat index structure and bit-identical binary serialization.

This is the TPU-native counterpart of component #5 in SURVEY.md §2
(pq-vector src/ivf/index.rs:8-150). Two representations:

* **Wire format** — byte-for-byte identical to the reference so files indexed
  by either implementation are mutually readable
  (layout defined at pq-vector src/ivf/index.rs:65-128)::

      u32 LE dim
      u32 LE n_clusters
      f32 LE x (n_clusters * dim)          # centroids, row-major
      repeated n_clusters times:
          u32 LE list_len
          u32 LE x list_len                # row ids for this cluster

* **In-memory form** — instead of the reference's ragged ``Vec<Vec<u32>>`` we
  hold a CSR layout (``centroids [k, d] f32``, ``list_offsets [k+1] i64``,
  ``row_ids [total] u32``) which maps directly onto static-shape device
  arrays: the centroid matrix feeds the MXU probe matmul and the CSR pair
  drives candidate gathers without ragged structures.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..errors import FormatError, ValidationError
from ..types import EmbeddingDim

_HEADER = struct.Struct("<II")


@dataclasses.dataclass(frozen=True)
class IvfIndex:
    """IVF-flat coarse index: k centroids + inverted row-id lists (CSR)."""

    dim: int
    n_clusters: int
    centroids: np.ndarray  # [n_clusters, dim] float32
    list_offsets: np.ndarray  # [n_clusters + 1] int64, CSR offsets into row_ids
    row_ids: np.ndarray  # [total_rows] uint32

    def __post_init__(self) -> None:
        if self.dim <= 0:
            raise ValidationError("Embedding dimension must be > 0")
        if self.n_clusters <= 0:
            raise ValidationError("Cluster count must be > 0")
        centroids = np.ascontiguousarray(self.centroids, dtype=np.float32)
        if centroids.shape != (self.n_clusters, self.dim):
            raise ValidationError(
                f"Centroid matrix must be [{self.n_clusters}, {self.dim}], "
                f"got {centroids.shape}"
            )
        offsets = np.ascontiguousarray(self.list_offsets, dtype=np.int64)
        row_ids = np.ascontiguousarray(self.row_ids, dtype=np.uint32)
        if offsets.shape != (self.n_clusters + 1,):
            raise ValidationError("list_offsets must have n_clusters + 1 entries")
        if offsets[0] != 0 or offsets[-1] != row_ids.size:
            raise ValidationError("list_offsets must span row_ids exactly")
        if np.any(np.diff(offsets) < 0):
            raise ValidationError("list_offsets must be non-decreasing")
        object.__setattr__(self, "centroids", centroids)
        object.__setattr__(self, "list_offsets", offsets)
        object.__setattr__(self, "row_ids", row_ids)

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------

    @classmethod
    def from_lists(
        cls, dim: int, centroids: np.ndarray, inverted_lists: list[np.ndarray]
    ) -> "IvfIndex":
        """Build from per-cluster row-id lists (the reference's ragged form)."""
        n_clusters = len(inverted_lists)
        lists = [np.asarray(lst, dtype=np.uint32).ravel() for lst in inverted_lists]
        lens = np.array([lst.size for lst in lists], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)])
        row_ids = (
            np.concatenate(lists) if lists else np.empty(0, dtype=np.uint32)
        )
        return cls(
            dim=dim,
            n_clusters=n_clusters,
            centroids=np.asarray(centroids, dtype=np.float32).reshape(n_clusters, dim),
            list_offsets=offsets,
            row_ids=row_ids,
        )

    @classmethod
    def from_assignments(
        cls, centroids: np.ndarray, assignments: np.ndarray
    ) -> "IvfIndex":
        """Build CSR inverted lists from a full assignment vector.

        Row ids within each cluster stay in ascending row order, matching the
        reference's per-range append order (pq-vector src/ivf/index.rs:193-206).
        """
        centroids = np.asarray(centroids, dtype=np.float32)
        n_clusters, dim = centroids.shape
        assignments = np.asarray(assignments).astype(np.int64, copy=False)
        counts = np.bincount(assignments, minlength=n_clusters).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        # Stable sort by cluster keeps ascending row order inside each list.
        order = np.argsort(assignments, kind="stable")
        row_ids = order.astype(np.uint32)
        return cls(
            dim=dim,
            n_clusters=n_clusters,
            centroids=centroids,
            list_offsets=offsets,
            row_ids=row_ids,
        )

    # ------------------------------------------------------------------
    # Accessors
    # ------------------------------------------------------------------

    @property
    def embedding_dim(self) -> EmbeddingDim:
        return EmbeddingDim(self.dim)

    @property
    def total_rows(self) -> int:
        return int(self.row_ids.size)

    def cluster_rows(self, cluster: int) -> np.ndarray:
        """Row ids of one inverted list."""
        return self.row_ids[self.list_offsets[cluster] : self.list_offsets[cluster + 1]]

    def inverted_lists(self) -> list[np.ndarray]:
        """Materialize the ragged view (tests / interop)."""
        return [self.cluster_rows(c) for c in range(self.n_clusters)]

    def cluster_sizes(self) -> np.ndarray:
        return np.diff(self.list_offsets)

    # ------------------------------------------------------------------
    # Probing (host fallback; the device path lives in query/device_index.py)
    # ------------------------------------------------------------------

    def find_closest_centroids(self, query: np.ndarray, nprobe: int) -> np.ndarray:
        """Indices of the nprobe nearest centroids, ascending by squared L2.

        Ties resolve to the lower cluster index, matching the reference's
        stable sort (pq-vector src/ivf/index.rs:130-149).
        """
        nprobe = min(nprobe, self.n_clusters)
        query = np.asarray(query, dtype=np.float32).reshape(-1)
        diff = self.centroids - query[None, :]
        dists = np.einsum("kd,kd->k", diff, diff)
        return np.argsort(dists, kind="stable")[:nprobe]

    def candidate_rows(self, query: np.ndarray, nprobe: int) -> np.ndarray:
        """Concatenated row ids of the nprobe nearest clusters, in probe order
        (pq-vector src/ivf/index.rs:57-63)."""
        clusters = self.find_closest_centroids(query, nprobe)
        parts = [self.cluster_rows(int(c)) for c in clusters]
        if not parts:
            return np.empty(0, dtype=np.uint32)
        return np.concatenate(parts)

    # ------------------------------------------------------------------
    # Binary serde — byte-identical to pq-vector src/ivf/index.rs:65-128
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        header = _HEADER.pack(self.dim, self.n_clusters)
        centroid_bytes = self.centroids.astype("<f4", copy=False).tobytes()
        k = self.n_clusters
        total = self.total_rows
        # Interleave (len, ids...) per cluster in a single u32 buffer.
        buf = np.empty(k + total, dtype="<u4")
        lens = np.diff(self.list_offsets).astype("<u4")
        len_pos = (self.list_offsets[:-1] + np.arange(k)).astype(np.int64)
        buf[len_pos] = lens
        mask = np.ones(k + total, dtype=bool)
        mask[len_pos] = False
        buf[mask] = self.row_ids.astype("<u4", copy=False)
        return header + centroid_bytes + buf.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes | memoryview) -> "IvfIndex":
        view = memoryview(data)
        if len(view) < _HEADER.size:
            raise FormatError("IVF index buffer too small")
        dim, n_clusters = _HEADER.unpack_from(view, 0)
        if dim == 0:
            raise FormatError("Embedding dimension must be > 0")
        if n_clusters == 0:
            raise FormatError("Cluster count must be > 0")
        offset = _HEADER.size

        centroid_count = n_clusters * dim
        centroid_end = offset + 4 * centroid_count
        if len(view) < centroid_end:
            raise FormatError("IVF index centroids are truncated")
        centroids = (
            np.frombuffer(view, dtype="<f4", count=centroid_count, offset=offset)
            .reshape(n_clusters, dim)
            .copy()
        )
        offset = centroid_end

        tail_bytes = view[offset:]
        if len(tail_bytes) % 4 != 0:
            raise FormatError("IVF index inverted lists are truncated")
        tail = np.frombuffer(tail_bytes, dtype="<u4")
        lens = np.empty(n_clusters, dtype=np.int64)
        pos = 0
        for c in range(n_clusters):
            if pos >= tail.size:
                raise FormatError("IVF index inverted lists are truncated")
            lens[c] = int(tail[pos])
            pos += 1 + lens[c]
        if pos > tail.size:
            raise FormatError("IVF index inverted lists are truncated")

        offsets = np.concatenate([[0], np.cumsum(lens)])
        total = int(offsets[-1])
        row_ids = np.empty(total, dtype=np.uint32)
        pos = 0
        for c in range(n_clusters):
            n = int(lens[c])
            row_ids[offsets[c] : offsets[c] + n] = tail[pos + 1 : pos + 1 + n]
            pos += 1 + n
        return cls(
            dim=dim,
            n_clusters=n_clusters,
            centroids=centroids,
            list_offsets=offsets,
            row_ids=row_ids,
        )
