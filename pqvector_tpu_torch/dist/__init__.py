"""Sharded execution over a one-process device mesh: distributed k-means,
the sharded build, and exact and IVF search fanned out over the shards."""

from .build import build_ivf_index_distributed
from .kmeans import distributed_lloyd
from .mesh import (
    CLUSTER_AXIS,
    DATA_AXIS,
    Mesh,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_rows,
)
from .search import (
    DistributedClusterIvfSearcher,
    DistributedExactSearcher,
    DistributedIvfSearcher,
)

__all__ = [
    "CLUSTER_AXIS",
    "DATA_AXIS",
    "DistributedClusterIvfSearcher",
    "DistributedExactSearcher",
    "DistributedIvfSearcher",
    "Mesh",
    "build_ivf_index_distributed",
    "distributed_lloyd",
    "make_mesh",
    "make_mesh_2d",
    "replicate",
    "shard_rows",
]
