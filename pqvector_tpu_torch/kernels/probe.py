"""The IVF probe: each query's ``nprobe`` nearest centroids.

Every IVF path of the port makes the same decision, and this module is
where it is made on device tensors. The centroid distances are
``|c|^2 - 2 q.c`` from one f32 ``mm`` (IEEE: TF32 stays off), and the
probe is their first ``nprobe`` columns under a stable sort. The columns
are the cluster ids in order, so ties go to the lower cluster id, as the
JAX package's index-stable ``lax.top_k`` gives them. That package takes a
top-k as wide as a power-of-two bucket (so that XLA compiles few shapes)
and keeps its first ``nprobe``; the first ``nprobe`` of a full sort are the
same ids, so the port has no bucket.
"""

from __future__ import annotations

import torch


def mask_width(kc: int) -> int:
    """Columns of a probe mask over ``kc`` clusters: kc + 1 (the last takes
    the pad rows' cluster id, ``kc``, and is never set) rounded up to 128,
    the width K6 takes."""
    return -(-(kc + 1) // 128) * 128


def _nearest(q, centroids, c_sq, nprobe: int) -> torch.Tensor:
    """[B, min(nprobe, kc)] int64 view of the sorted centroid ids."""
    dist = c_sq[None, :] - 2.0 * (q @ centroids.T)
    return torch.argsort(dist, dim=1, stable=True)[:, :nprobe]


def probe_ids(q, centroids, c_sq, nprobe: int) -> torch.Tensor:
    """[B, min(nprobe, kc)] int32: each query's nearest clusters, nearest
    first, ties to the lower cluster id."""
    return _nearest(q, centroids, c_sq, nprobe).to(torch.int32)


def probe_mask(q, centroids, c_sq, nprobe: int) -> torch.Tensor:
    """[B, ``mask_width(kc)``] f32: 1 at the clusters ``probe_ids`` gives,
    0 elsewhere."""
    mask = torch.zeros((q.shape[0], mask_width(centroids.shape[0])),
                       dtype=torch.float32, device=q.device)
    return mask.scatter_(1, _nearest(q, centroids, c_sq, nprobe), 1.0)
