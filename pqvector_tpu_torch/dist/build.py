"""IVF index construction with the training loop sharded over a mesh.

Counterpart of ``pqvector_tpu/dist/build.py``: the 5%/100k training sample
(the single build's host draw), k-means++ seeded on the whole sample on the
mesh's first device, Lloyd's iterations with rows sharded
(``distributed_lloyd``), then a row-sharded assignment of every row
(``distributed_assign``: the JAX package runs one more Lloyd iteration and
throws its update away; the assignment is the same).

The seeding keeps the JAX package's distributed key, ``PRNGKey(seed)``
split in 2, its second key, and seeds on the whole training sample. Under
partitionable threefry that key is the single build's (split in 3, its
second key: both are the block of counter (0, 1)); the two builds differ
where the single build caps the init sample at 50k rows, that is where the
training sample is larger (above 1M rows).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ValidationError
from ..index._threefry import prng_key, split
from ..index.build import IvfBuildConfig
from ..index.ivf import IvfIndex
from ..index.kmeans import (
    _kmeans_pp_init,
    default_n_clusters,
    sample_indices_host,
    train_sample_size,
)
from ..types import Embeddings
from .kmeans import distributed_assign, distributed_lloyd
from .mesh import Mesh, device_scope, make_mesh


def build_ivf_index_distributed(
    embeddings: Embeddings,
    config: IvfBuildConfig | None = None,
    mesh: Mesh | None = None,
) -> IvfIndex:
    """Build an IVF index with the training loop sharded over the mesh."""
    config = config or IvfBuildConfig()
    mesh = mesh or make_mesh()
    x = np.asarray(embeddings.data, dtype=np.float32)
    n = embeddings.row_count
    if n == 0:
        raise ValidationError("Cannot build IVF index with zero vectors")
    n_clusters = (
        config.n_clusters if config.n_clusters is not None else default_n_clusters(n)
    )
    if n_clusters > n:
        raise ValidationError("n_clusters cannot exceed number of vectors")

    sample_size = train_sample_size(n, n_clusters)
    if sample_size == n:
        sample = x
    else:
        idx = sample_indices_host(config.seed ^ 0x5A5A5A5A, n, sample_size)
        sample = x[idx]

    dev = mesh.devices[0]
    with device_scope(dev):
        centroids0 = _kmeans_pp_init(
            torch.from_numpy(np.ascontiguousarray(sample)).to(dev),
            split(prng_key(config.seed))[1], n_clusters,
        ).cpu().numpy()

    centroids, _ = distributed_lloyd(
        sample, centroids0, config.max_iters, mesh=mesh, block_rows=config.block_rows
    )
    assignments = distributed_assign(x, centroids, mesh=mesh, block_rows=config.block_rows)
    return IvfIndex.from_assignments(centroids, assignments)
