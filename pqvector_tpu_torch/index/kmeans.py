"""K-means in PyTorch: k-means++ seeding and Lloyd's iterations on a device.

Counterpart of ``pqvector_tpu/index/kmeans.py``, with the same semantics
(pq-vector src/ivf/index.rs:323-457):

* assignment is ``argmin_k |c|^2 - 2 x.c`` (the ``|x|^2`` term is constant
  per row), run by K1 (``kernels/assign.py``) on CUDA tensors;
* Lloyd starts from an all-zero assignment, stops early when no row changes
  (the check comes before the update), and keeps a stale centroid for an
  empty cluster;
* the centroid update is a one-hot matmul in fp32 per row block: cuBLAS
  gives the same bits on every run, where float atomics (``index_add_``)
  would not, so a build is deterministic per seed;
* k-means++ seeding on a <=50k sub-sample draws the random scalars that
  ``jax.random`` gives the JAX package for the same seed, computed on the
  host (``_threefry.kmeans_pp_scalars``), so both pick the same seed rows
  wherever their cumulative sums agree on the boundary a threshold falls at.
  The sums run in a fixed order (``_prefix_sums``) for the same reason as
  the update; ``jnp.cumsum`` may round a boundary differently.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..errors import ValidationError
from ..kernels import assign as _k1
from ..kernels.assign import assign_rows
from ._threefry import kmeans_pp_scalars_from_key, prng_key, split

_INIT_SAMPLE_CAP = 50_000  # pq-vector src/ivf/index.rs:332
_TRAIN_SAMPLE_CAP = 100_000  # pq-vector src/ivf/index.rs:173
_TRAIN_SAMPLE_FRACTION = 20  # 5% == n/20, pq-vector src/ivf/index.rs:172
_SCAN_ROW = 1024  # elements per row of _prefix_sums' two-level scan


@dataclasses.dataclass(frozen=True)
class KMeansParams:
    """Mirror of the reference KMeansParams (pq-vector src/ivf/index.rs:216-220)."""

    n_clusters: int
    max_iters: int = 20
    seed: int = 42
    block_rows: int = 8192


def default_n_clusters(n_vectors: int) -> int:
    """ceil(sqrt(n)) default (pq-vector src/ivf/index.rs:163-166)."""
    return max(1, math.ceil(math.sqrt(n_vectors)))


def train_sample_size(n_vectors: int, n_clusters: int) -> int:
    """5% capped at 100k, at least n_clusters, at most n
    (pq-vector src/ivf/index.rs:172-174)."""
    size = max(n_vectors // _TRAIN_SAMPLE_FRACTION, 1)
    size = min(size, _TRAIN_SAMPLE_CAP)
    return min(max(size, n_clusters), n_vectors)


def sample_indices_host(seed: int, n: int, m: int) -> np.ndarray:
    """Uniform random m-subset of [0, n) without replacement, on host: the
    same numpy draw as the JAX package's, so both sample the same rows."""
    rng = np.random.default_rng(np.uint64(seed))
    return rng.choice(n, size=m, replace=False).astype(np.int64)


def _prefix_sums(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of a 1-D float tensor, summed in an order that
    does not depend on the device's schedule. On CUDA, ``torch.cumsum`` of
    a 1-D float tensor is a single-pass scan whose look-back adds the
    partials of earlier blocks in an order set by timing, so its last bits
    vary between runs, and a k-means++ draw near a boundary picks another
    row. Here each row of 1024 is scanned on its own (a 2-D cumsum gives a
    row to one block; at least two rows, so torch takes that path), and the
    totals of the rows before come from a lower-triangular matmul."""
    m = v.shape[0]
    rows = max(2, -(-m // _SCAN_ROW))
    part = torch.nn.functional.pad(v, (0, rows * _SCAN_ROW - m))
    part = part.view(rows, _SCAN_ROW).cumsum(dim=1)
    lower = torch.ones((rows, rows), dtype=v.dtype, device=v.device).tril(-1)
    return (part + (lower @ part[:, -1])[:, None]).reshape(-1)[:m]


def init_key(seed: int) -> tuple[int, int]:
    """The single build's k-means++ key: ``PRNGKey(seed)`` split in 3, its
    second key (the JAX package's ``k_means``)."""
    return split(prng_key(seed), 3)[1]


def _kmeans_pp_init(sample: torch.Tensor, key: tuple[int, int], n_clusters: int
                    ) -> torch.Tensor:
    """k-means++ seeding (pq-vector src/ivf/index.rs:332-390) on ``sample``'s
    device from a threefry ``key``, a pair of 32-bit words: ``init_key(seed)``
    for the single build, ``split(prng_key(seed))[1]`` for the distributed
    one (``dist/build.py``).

    Each step folds the squared distance to the newest centroid into the
    running minimum and draws the next seed with probability proportional
    to it (first index whose cumulative sum reaches a uniform threshold); an
    all-zero total falls back to a uniform draw. All random numbers are drawn
    up front, the ones ``jax.random`` would give the JAX package's loop for
    this key, so the loop never waits on the host."""
    m, d = sample.shape
    k = n_clusters
    dev = sample.device
    first, u, uniform_idx = kmeans_pp_scalars_from_key(key, m, k)
    u = torch.as_tensor(u, device=dev)
    uniform_idx = torch.as_tensor(uniform_idx, device=dev)

    s_norm = (sample * sample).sum(dim=1)
    centroids = torch.zeros((k, d), dtype=torch.float32, device=dev)
    c = sample[first]
    centroids[0] = c
    min_d = (s_norm + (c * c).sum() - 2.0 * (sample @ c)).clamp_min(0.0)
    for i in range(1, k):
        total = min_d.sum()
        cumsum = _prefix_sums(min_d)
        threshold = (u[i] * total).reshape(1)
        weighted = torch.searchsorted(cumsum, threshold, side="left").clamp_max(m - 1)
        idx = torch.where(total > 0, weighted, uniform_idx[i : i + 1])
        c = sample.index_select(0, idx)[0]
        centroids[i] = c
        d2 = (s_norm + (c * c).sum() - 2.0 * (sample @ c)).clamp_min(0.0)
        min_d = torch.minimum(min_d, d2)
    return centroids


def _lloyd(
    x: torch.Tensor,
    centroids0: torch.Tensor,
    max_iters: int,
    block: int,
    n_clusters: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's loop with early exit (pq-vector src/ivf/index.rs:395-454).

    Each iteration assigns all rows (K1 on CUDA), counts reassignments
    against the previous iteration (the first compares with all zeros),
    stops before the update when nothing changed, and keeps stale centroids
    for empty clusters. Returns (centroids [k, d], assignments [n] int32)."""
    n = x.shape[0]
    k = n_clusters
    dev = x.device
    cluster_ids = torch.arange(k, dtype=torch.int32, device=dev)
    centroids = centroids0.clone()
    prev = torch.zeros(n, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        assign = assign_rows(x, centroids)
        changed = int((assign != prev).sum())
        prev = assign
        if changed == 0:
            break
        sums = torch.zeros_like(centroids)
        counts = torch.zeros(k, dtype=torch.float32, device=dev)
        for lo in range(0, n, block):
            onehot = (assign[lo : lo + block, None] == cluster_ids[None, :]).float()
            sums += onehot.T @ x[lo : lo + block]
            counts += onehot.sum(dim=0)
        centroids = torch.where(
            counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], centroids
        )
    return centroids, prev


def k_means(
    x: np.ndarray | torch.Tensor,
    params: KMeansParams,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Train k-means on ``device``; returns (centroids [k, d] f32,
    assignments [n] i32) as numpy arrays."""
    x = torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))
    n = x.shape[0]
    k = params.n_clusters
    if k <= 0:
        raise ValidationError("n_clusters must be > 0")
    if k > n:
        raise ValidationError("n_clusters cannot exceed number of vectors")

    init_sample_size = max(min(n, _INIT_SAMPLE_CAP), k)
    if init_sample_size == n:
        init_sample = x
    else:
        idx = sample_indices_host(params.seed ^ 0x3C3C3C3C, n, init_sample_size)
        init_sample = x[torch.as_tensor(idx, device=x.device)]

    centroids0 = _kmeans_pp_init(init_sample, init_key(params.seed), k)
    block = min(params.block_rows, max(256, n))
    centroids, assign = _lloyd(x, centroids0, params.max_iters, block, k)
    return centroids.cpu().numpy(), assign.cpu().numpy()


def assign_clusters(
    x: np.ndarray | torch.Tensor,
    centroids: np.ndarray | torch.Tensor,
    block_rows: int = 8192,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Nearest-centroid assignment for all rows, the final inverted-list
    pass (pq-vector src/ivf/index.rs:193-206): K1 on the card, the plain
    assign on the CPU, numpy ids out. ``block_rows`` stands where the JAX
    package has it; K1 masks the ragged last block itself and needs no
    padding to a block."""
    del block_rows
    return _k1.assign_clusters(x, centroids, device=device)


__all__ = [
    "KMeansParams",
    "assign_clusters",
    "default_n_clusters",
    "k_means",
    "sample_indices_host",
    "train_sample_size",
]

