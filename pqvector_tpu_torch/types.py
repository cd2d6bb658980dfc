"""Validated domain types.

TPU-native re-design of the reference newtypes (component #1 in SURVEY.md §2):

* ``EmbeddingColumn`` — non-empty column name
  (pq-vector src/ivf/mod.rs:18-49).
* ``EmbeddingDim`` — non-zero, u32-representable dimension
  (pq-vector src/ivf/mod.rs:52-70).
* ``Embeddings`` — row-major float32 matrix whose element count divides the
  dimension (pq-vector src/ivf/mod.rs:73-102). Here it is a validated
  ``numpy`` ``[n, d]`` float32 array — the host-side staging form that is
  transferred to device HBM in one shot for MXU work.

These are host-side metadata; no device work happens here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .errors import ValidationError

_U32_MAX = 0xFFFF_FFFF


@dataclasses.dataclass(frozen=True)
class EmbeddingColumn:
    """Non-empty embedding column name (src/ivf/mod.rs:18-49)."""

    name: str

    def __post_init__(self) -> None:
        if not isinstance(self.name, str) or not self.name.strip():
            raise ValidationError("Embedding column name cannot be empty")

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class EmbeddingDim:
    """Non-zero embedding dimension, must fit in u32 (src/ivf/mod.rs:52-70)."""

    value: int

    def __post_init__(self) -> None:
        if not isinstance(self.value, (int, np.integer)) or isinstance(self.value, bool):
            raise ValidationError("Embedding dimension must be an integer")
        if self.value <= 0:
            raise ValidationError("Embedding dimension must be > 0")
        if self.value > _U32_MAX:
            raise ValidationError("Embedding dimension must fit in u32")

    def __int__(self) -> int:
        return int(self.value)


@dataclasses.dataclass(frozen=True)
class ClusterCount:
    """Non-zero cluster count, must fit in u32
    (pq-vector src/ivf/index.rs:17-43)."""

    value: int

    def __post_init__(self) -> None:
        if not isinstance(self.value, (int, np.integer)) or isinstance(self.value, bool):
            raise ValidationError("Cluster count must be an integer")
        if self.value <= 0:
            raise ValidationError("Cluster count must be > 0")
        if self.value > _U32_MAX:
            raise ValidationError("Cluster count must fit in u32")

    def __int__(self) -> int:
        return int(self.value)


class Embeddings:
    """Validated row-major float32 embedding matrix (src/ivf/mod.rs:73-102).

    Stored as a C-contiguous ``[n, d]`` float32 numpy array, ready for a single
    host-to-HBM transfer.
    """

    __slots__ = ("_data", "_dim")

    def __init__(self, data: np.ndarray, dim: EmbeddingDim | int):
        if isinstance(dim, int):
            dim = EmbeddingDim(dim)
        d = int(dim)
        arr = np.asarray(data)
        if arr.ndim == 1:
            if arr.size % d != 0:
                raise ValidationError(
                    "Embedding data length must be a multiple of dimension"
                )
            arr = arr.reshape(-1, d)
        elif arr.ndim == 2:
            if arr.shape[1] != d:
                raise ValidationError(
                    "Embedding data length must be a multiple of dimension"
                )
        else:
            raise ValidationError("Embeddings must be a 1-D buffer or [n, d] matrix")
        self._data = np.ascontiguousarray(arr, dtype=np.float32)
        self._dim = dim

    @property
    def data(self) -> np.ndarray:
        """The ``[n, d]`` float32 matrix."""
        return self._data

    @property
    def dim(self) -> EmbeddingDim:
        return self._dim

    @property
    def row_count(self) -> int:
        return self._data.shape[0]

    def __len__(self) -> int:
        return self.row_count
