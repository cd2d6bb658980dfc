"""Peaks of the card and the essential work of one call, for roofline shares.

The least time a call could take is the larger of its essential bytes over
the memory rate and its essential operations over the compute rate. The work
is counted from the call's inputs and shapes, whatever implements it: a PR
that replaces a kernel leaves these counts as they are.
"""

from __future__ import annotations

import numpy as np

#: Published dense peaks (NVIDIA's data sheet, SXM part, 700 W), by the name
#: ``torch.cuda.get_device_name()`` gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,
    },
}

STORAGE_BYTES = {"bfloat16": 2, "float32": 4}


def search_call_work(probe: np.ndarray, cluster_sizes: np.ndarray, dim: int, k: int,
                     storage: str) -> dict:
    """Essential work of one IVF search call of B queries.

    ``probe`` [B, nprobe] holds the clusters each query probes, as the
    reference computes them; ``cluster_sizes`` [n_clusters] the rows of
    each. Bytes: the stored rows of the clusters the batch probes, each read
    once; the f32 centroids; the f32 queries; the k f32 rows each query
    re-scores; the outputs (an f32 distance and an int32 id a slot).
    Operations: 2 x probed rows x d a query at the storage type's tensor
    rate, and the probe's 2 x B x clusters x d at the fp32 rate."""
    b = probe.shape[0]
    n_clusters = cluster_sizes.shape[0]
    union = np.unique(probe)
    union_rows = int(cluster_sizes[union].sum())
    probed_rows = int(cluster_sizes[probe].sum())
    nbytes = (union_rows * dim * STORAGE_BYTES[storage] + n_clusters * dim * 4
              + b * dim * 4 + b * k * dim * 4 + b * k * (4 + 4))
    return {
        "bytes": nbytes,
        "tensor_flops": 2 * probed_rows * dim,
        "fp32_flops": 2 * b * n_clusters * dim,
    }


def least_seconds(work: dict, peaks: dict) -> float:
    """The larger of the bytes' time and the operations' time."""
    t_bytes = work["bytes"] / peaks["hbm_bytes_per_s"]
    t_ops = work["tensor_flops"] / peaks["bf16_flops"] + work["fp32_flops"] / peaks["fp32_flops"]
    return max(t_bytes, t_ops)
