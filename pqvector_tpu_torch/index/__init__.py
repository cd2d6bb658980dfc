"""Core IVF index layer: the index format, k-means and the build."""

from .build import IvfBuildConfig, build_ivf_index
from .ivf import IvfIndex
from .kmeans import (
    KMeansParams,
    assign_clusters,
    default_n_clusters,
    k_means,
    train_sample_size,
)

__all__ = [
    "IvfBuildConfig",
    "IvfIndex",
    "KMeansParams",
    "assign_clusters",
    "build_ivf_index",
    "default_n_clusters",
    "k_means",
    "train_sample_size",
]
