"""Spilled (multi-)assignment: boundary rows replicated into their
runner-up cluster to lift IVF probe recall at unchanged nprobe.

Counterpart of ``pqvector_tpu/query/spill.py``. The probed modes' residual
recall loss is probed-union misses: the true neighbour's home cluster is not
among the query's ``nprobe`` nearest centroids. Spilling duplicates the rows
that are nearly equidistant between two centroids into their runner-up
cluster (the idea behind ScaNN's spilled assignment); the reference's
single-assignment IVF (pq-vector src/ivf/index.rs) has no equivalent.

The runner-up pass is plain torch on the searcher's device, one matrix
product per row block (the JAX package runs the same product outside any
Pallas kernel). The extended layout is the cluster-sorted contiguous-range
layout every mode already serves; only the final top-k needs an id dedup
(``DeviceIvfSearcher`` selects ``2k`` and dedups, since a row appears at
most twice). The layout itself is host numpy, copied from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..errors import ValidationError
from ..index.ivf import IvfIndex


def _runner_up_blocks(emb, centroids, c_sq, primary, block: int):
    """Per-row runner-up cluster and margin, one matrix product per block.

    ``emb`` [n, d] in the assignment dtype (bfloat16 only moves which rows
    sit near the margin threshold, never correctness), ``primary`` [n]
    int32. Returns (runner [n] int32, margin [n] f32) with margin =
    d2(runner) - d2(primary) >= 0 up to float error. Scores drop the
    row-norm constant, which every cluster shares, as the assignment does."""
    n = emb.shape[0]
    runner = torch.empty(n, dtype=torch.int32, device=emb.device)
    margin = torch.empty(n, dtype=torch.float32, device=emb.device)
    cents = centroids.to(emb.dtype)
    for lo in range(0, n, block):
        x = emb[lo : lo + block]
        prim = primary[lo : lo + block].long()[:, None]
        s = c_sq[None, :] - 2.0 * (x @ cents.T).float()
        pd = s.gather(1, prim)[:, 0]
        s.scatter_(1, prim, torch.inf)
        r = torch.argmin(s, dim=1)  # the first minimum, as jnp.argmin
        runner[lo : lo + block] = r.to(torch.int32)
        margin[lo : lo + block] = s.gather(1, r[:, None])[:, 0] - pd
    return runner, margin


def dedup_topk_np(
    d: np.ndarray, ids: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side analog of ``device._dedup_topk`` for searchers whose public
    API returns numpy: collapse duplicate ids in ascending-by-distance
    [B, m] candidates to the k nearest distinct. Keep-first rides the stable
    argsort; invalid slots (id -1, distance inf) stay at the tail."""
    m = ids.shape[1]
    if k >= m:
        return d, ids
    order = np.argsort(ids, axis=1, kind="stable")
    ids_s = np.take_along_axis(ids, order, axis=1)
    dup_s = np.zeros_like(ids_s, dtype=bool)
    dup_s[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    inv = np.argsort(order, axis=1, kind="stable")
    dup = np.take_along_axis(dup_s, inv, axis=1)
    d_m = np.where(dup, np.inf, d)
    idx = np.argsort(d_m, axis=1, kind="stable")[:, :k]
    return (
        np.take_along_axis(d_m, idx, axis=1),
        np.take_along_axis(np.where(dup, -1, ids), idx, axis=1),
    )


def runner_up_assignment(
    embeddings: np.ndarray,
    index: IvfIndex,
    block: int = 65536,
    assign_dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(runner [n] int32, margin [n] f32) for every row of ``embeddings``,
    computed on ``device``.

    The primary assignment is taken from the INDEX (not recomputed), so a
    row whose nearest centroid drifted from its stored list still spills
    relative to where searches will actually find it."""
    if assign_dtype not in (torch.float32, torch.bfloat16):
        raise ValidationError(f"Unsupported assign dtype {assign_dtype}")
    device = resolve_device(device)
    n, d = embeddings.shape
    if n != index.total_rows:
        raise ValidationError(
            f"embeddings rows {n} != index rows {index.total_rows}"
        )
    if index.n_clusters < 2:
        raise ValidationError("spill needs at least 2 clusters")
    primary = np.empty(n, np.int32)
    primary[index.row_ids] = np.repeat(
        np.arange(index.n_clusters, dtype=np.int32), index.cluster_sizes()
    )
    block = max(128, min(block, 1 << 20))
    emb = torch.from_numpy(np.ascontiguousarray(embeddings, np.float32))
    emb = emb.to(device, assign_dtype)
    cents = torch.from_numpy(np.array(index.centroids, np.float32)).to(device)
    c_sq = (cents * cents).sum(dim=1)
    runner, margin = _runner_up_blocks(
        emb, cents, c_sq, torch.from_numpy(primary).to(device), block
    )
    return runner.cpu().numpy(), margin.cpu().numpy()


def build_spilled_layout(
    index: IvfIndex,
    embeddings: np.ndarray,
    spill: float,
    block: int = 65536,
    assign_dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> tuple[IvfIndex, np.ndarray, np.ndarray]:
    """Extended cluster-sorted layout with the ``spill`` fraction of rows
    (smallest runner-up margin first) duplicated into their runner-up
    cluster.

    Returns (ext_index, ext_embeddings, gid):
      * ext_index: identity ``row_ids`` over ``n + n_spill`` rows whose
        CSR lists are the contiguous cluster ranges of the sorted layout,
      * ext_embeddings [n + n_spill, d] in that order,
      * gid [n + n_spill] int32: the ORIGINAL row id of each extended
        position (spill copies point back at their source row).
    """
    if not 0.0 < spill <= 1.0:
        raise ValidationError(f"spill fraction must be in (0, 1], got {spill}")
    embeddings = np.ascontiguousarray(embeddings, np.float32)
    n = embeddings.shape[0]
    runner, margin = runner_up_assignment(
        embeddings, index, block=block, assign_dtype=assign_dtype, device=device
    )
    n_spill = min(n, max(1, int(round(spill * n))))
    spill_rows = np.argpartition(margin, n_spill - 1)[:n_spill].astype(np.int64)

    primary = np.empty(n, np.int32)
    primary[index.row_ids] = np.repeat(
        np.arange(index.n_clusters, dtype=np.int32), index.cluster_sizes()
    )
    ext_orig = np.concatenate([np.arange(n, dtype=np.int64), spill_rows])
    ext_cluster = np.concatenate([primary, runner[spill_rows]])
    order = np.argsort(ext_cluster, kind="stable")
    gid = ext_orig[order].astype(np.int32)
    ext_emb = np.ascontiguousarray(embeddings[ext_orig[order]])

    sizes = np.bincount(ext_cluster, minlength=index.n_clusters)
    offsets = np.zeros(index.n_clusters + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    ext_index = IvfIndex(
        dim=index.dim,
        n_clusters=index.n_clusters,
        centroids=index.centroids,
        list_offsets=offsets,
        row_ids=np.arange(n + n_spill, dtype=np.uint32),
    )
    return ext_index, ext_emb, gid
