"""Distance metrics.

The reference implements squared L2 only (pq-vector src/ivf/index.rs:
461-480); cosine is a pqvector-tpu extension (BASELINE.md config 3)
implemented the standard way: unit-normalize vectors and use L2 — ordering
under L2 on unit vectors equals ordering under cosine distance
(``|u - v|^2 = 2 - 2 cos`` for unit u, v).
"""

from __future__ import annotations

import numpy as np

METRICS = ("l2", "cosine")


def normalize_rows(x: np.ndarray, eps: float = 1e-30) -> np.ndarray:
    """Unit-normalize each row (zero rows stay zero)."""
    x = np.asarray(x, dtype=np.float32)
    norms = np.sqrt(np.einsum("nd,nd->n", x, x))
    return x / np.maximum(norms, eps)[:, None]


def normalize_vector(v: np.ndarray, eps: float = 1e-30) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    n = float(np.sqrt(np.dot(v, v)))
    return v / max(n, eps)
