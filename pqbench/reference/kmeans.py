"""Plain k-means: k-means++ seeding, Lloyd's iterations, nearest-centroid
assignment (pq-vector ``src/ivf/index.rs``: a 5% training sample capped at
100k rows, k-means++ on at most 50k of them, then Lloyd with an early stop
and stale centroids for empty clusters).

Deterministic for a seed on one device: the k-means++ draws sum their
weights on the host in f64, the centroid update is a one-hot matmul (no
float atomics). ``rnd`` rounds each operand of a product, for the control
(``control.py``); the reference itself runs in fp32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from . import no_tf32

TRAIN_FRACTION = 20  # 5% of the rows
TRAIN_CAP = 100_000
INIT_CAP = 50_000


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def train_sample_size(n: int, k: int) -> int:
    return min(max(min(max(n // TRAIN_FRACTION, 1), TRAIN_CAP), k), n)


def assign(x: torch.Tensor, centroids: torch.Tensor, rnd=_same, block: int = 1 << 16
           ) -> torch.Tensor:
    """[n] int64 id of the centroid with the least ``|c|^2 - 2 x.c``."""
    no_tf32()
    c = rnd(centroids)
    c_sq = (c * c).sum(dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], block):
        s = c_sq[None, :] - 2.0 * (rnd(x[lo : lo + block]) @ c.T)
        out[lo : lo + block] = torch.argmin(s, dim=1)
    return out


def kmeans_pp(sample: torch.Tensor, k: int, rng: np.random.Generator, rnd=_same
              ) -> torch.Tensor:
    """k-means++ seeding: each next centroid drawn with probability in
    proportion to the squared distance to the nearest one so far."""
    m = sample.shape[0]
    s = rnd(sample)
    s_sq = (s * s).sum(dim=1)
    cents = torch.empty((k, sample.shape[1]), dtype=torch.float32, device=sample.device)
    idx = int(rng.integers(m))
    min_d = None
    for i in range(k):
        c = sample[idx]
        cents[i] = c
        cr = rnd(c)
        d2 = (s_sq + (cr * cr).sum() - 2.0 * (s @ cr)).clamp_min(0.0)
        min_d = d2 if min_d is None else torch.minimum(min_d, d2)
        if i + 1 < k:
            w = np.cumsum(min_d.double().cpu().numpy())
            if w[-1] > 0:
                idx = int(min(np.searchsorted(w, rng.random() * w[-1], side="right"), m - 1))
            else:
                idx = int(rng.integers(m))
    return cents


def lloyd(x: torch.Tensor, cents: torch.Tensor, iters: int, rnd=_same,
          block: int = 1 << 14) -> torch.Tensor:
    """Lloyd's iterations; stops when no row changes its cluster."""
    k = cents.shape[0]
    ids = torch.arange(k, device=x.device)
    prev = None
    for _ in range(iters):
        a = assign(x, cents, rnd)
        if prev is not None and torch.equal(a, prev):
            break
        prev = a
        sums = torch.zeros_like(cents)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device)
        for lo in range(0, x.shape[0], block):
            onehot = (a[lo : lo + block, None] == ids[None, :]).float()
            sums += onehot.T @ rnd(x[lo : lo + block])
            counts += onehot.sum(dim=0)
        cents = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], cents)
    return cents


def train(rows: torch.Tensor, k: int, iters: int, seed: int, rnd=_same):
    """Centroids [k, d] f32 and the assignment [n] int64 of all rows: the
    training sample and the k-means++ draws from ``seed``."""
    no_tf32()
    n = rows.shape[0]
    gen = torch.Generator(device=rows.device)
    gen.manual_seed(int(seed))
    perm = torch.randperm(n, generator=gen, device=rows.device)
    sample = rows[perm[: train_sample_size(n, k)]]
    rng = np.random.default_rng(int(seed))
    cents = kmeans_pp(sample[:INIT_CAP], k, rng, rnd)
    cents = lloyd(sample, cents, iters, rnd)
    return cents, assign(rows, cents, rnd)
