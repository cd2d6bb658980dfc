"""Hand-written Hopper kernels (``csrc/``) and their plain torch versions.

K1 ``assign.assign_rows``, K2 ``stream_topk.stream_exact_scan``, K3
``stream_topk.stream_masked_scan``, K4 ``scan_topk.masked_local_scan``, K5
``scan_topk.exact_scan``, K6 ``scan_topk.masked_scan``, K7
``binscan.binned_scan_keys``, K8 ``binscan.binned_scan_select_keys``, K9
``tilemin.tile_min``, K10 ``compact.tile_gather`` and K11
``compact.tile_gather_dma`` launch a CUDA kernel on CUDA tensors and run
the plain version on CPU tensors. ``_build.LAUNCHES`` counts the launches.
"""

from .assign import assign_clusters, assign_rows
from .scan_topk import masked_local_scan, masked_local_topk
from .stream_topk import (
    stream_exact_scan,
    stream_exact_topk,
    stream_masked_scan,
    stream_masked_topk,
)

__all__ = [
    "assign_clusters",
    "assign_rows",
    "masked_local_scan",
    "masked_local_topk",
    "stream_exact_scan",
    "stream_exact_topk",
    "stream_masked_scan",
    "stream_masked_topk",
]
