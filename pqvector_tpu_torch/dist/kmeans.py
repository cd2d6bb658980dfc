"""Lloyd's iterations with rows sharded over a mesh and summed reductions.

Counterpart of ``pqvector_tpu/dist/kmeans.py``. Rows are padded so that
every shard holds the same number of whole ``block``-row blocks, and the
pad rows weigh nothing. Every shard assigns its rows (K1 on a card,
``kernels/assign.py:assign_rows``) and makes the one-hot sums and counts of
each block of its real rows, as ``index/kmeans.py:_lloyd`` does; ``psum``
adds the blocks' sums one after another in row order across the shards, so
the total has the bits of the single-device loop's, whatever the number of
shards. The price of those bits is a payload of one [k, d] partial a block
(n / block of them) where the JAX package's ``psum`` moves one a shard.
The loop keeps the single-device semantics: an all-zero first assignment,
an early exit on a global change of 0 (before the update, whose sums are
then never made), stale centroids for an empty cluster. The host reads the
changed count once an iteration, after every shard has been launched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ValidationError
from ..kernels.assign import assign_rows
from .mesh import Mesh, device_scope, make_mesh, psum, replicate, shard_rows


def _shard_rows_padded(x: np.ndarray, mesh: Mesh, block_rows: int):
    """Rows padded with zeros so that every shard holds the same number of
    whole ``block``-row blocks -> (per-shard tensors, real rows a shard,
    block)."""
    n, d = x.shape
    block = min(block_rows, max(8, n))
    per_dev = -(-n // mesh.size)
    per_dev = -(-per_dev // block) * block
    xp = np.zeros((per_dev * mesh.size, d), dtype=np.float32)
    xp[:n] = x
    real = [min(max(n - s * per_dev, 0), per_dev) for s in range(mesh.size)]
    return shard_rows(xp, mesh), real, block


def _assign(xs, cents, mesh: Mesh) -> list[torch.Tensor]:
    """Every shard's assignment (K1 on a card), launched under its device."""
    out = []
    for s, dev in enumerate(mesh.devices):
        with device_scope(dev):
            out.append(assign_rows(xs[s], cents[s]))
    return out


def _block_sums(x, assign, real: int, block: int, k: int):
    """One shard: the one-hot sums and counts of each ``block`` of its first
    ``real`` rows (its pad rows follow them), in row order."""
    cluster_ids = torch.arange(k, dtype=torch.int32, device=x.device)
    sums, counts = [], []
    for lo in range(0, real, block):
        hi = min(lo + block, real)
        onehot = (assign[lo:hi, None] == cluster_ids[None, :]).float()
        sums.append(onehot.T @ x[lo:hi])
        counts.append(onehot.sum(dim=0))
    return sums, counts


def distributed_lloyd(
    x: np.ndarray,
    centroids0: np.ndarray,
    max_iters: int,
    mesh: Mesh | None = None,
    block_rows: int = 4096,
):
    """Lloyd's iterations with rows sharded over the mesh.

    Returns (centroids [k, d], assignments [n]) as numpy, with the
    single-device loop's semantics: early exit on zero global
    reassignments, stale centroids for empty clusters. As in ``_lloyd``,
    the block sums are made only once the changed count says that the
    update runs."""
    mesh = mesh or make_mesh()
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    k = centroids0.shape[0]
    if k > n:
        raise ValidationError("n_clusters cannot exceed number of vectors")

    xs, real, block = _shard_rows_padded(x, mesh, block_rows)
    cents = replicate(np.asarray(centroids0, np.float32), mesh)
    prev = [torch.zeros(t.shape[0], dtype=torch.int32, device=t.device) for t in xs]
    for _ in range(max_iters):
        assign = _assign(xs, cents, mesh)
        changed = []
        for s, dev in enumerate(mesh.devices):
            with device_scope(dev):
                changed.append([(assign[s][: real[s]] != prev[s][: real[s]]).sum(
                    dtype=torch.int32)])
        prev = assign
        if int(psum(changed, mesh)[0]) == 0:
            break
        parts = []
        for s, dev in enumerate(mesh.devices):
            with device_scope(dev):
                parts.append(_block_sums(xs[s], assign[s], real[s], block, k))
        sums = psum([p[0] for p in parts], mesh)
        counts = psum([p[1] for p in parts], mesh)
        new = []
        for s, dev in enumerate(mesh.devices):
            with device_scope(dev):
                new.append(torch.where(
                    counts[s][:, None] > 0,
                    sums[s] / counts[s].clamp_min(1.0)[:, None],
                    cents[s],
                ))
        cents = new
    assign = torch.cat([a.to(mesh.devices[0]) for a in prev])
    return cents[0].cpu().numpy(), assign[:n].cpu().numpy()


def distributed_assign(
    x: np.ndarray,
    centroids: np.ndarray,
    mesh: Mesh | None = None,
    block_rows: int = 4096,
) -> np.ndarray:
    """Every row's nearest centroid, rows sharded over the mesh: the
    assignment that one ``distributed_lloyd`` iteration makes, without the
    update that follows it. -> [n] int32 numpy."""
    mesh = mesh or make_mesh()
    x = np.asarray(x, dtype=np.float32)
    xs, _, _ = _shard_rows_padded(x, mesh, block_rows)
    assign = _assign(xs, replicate(np.asarray(centroids, np.float32), mesh), mesh)
    return torch.cat([a.to(mesh.devices[0]) for a in assign])[: x.shape[0]].cpu().numpy()
