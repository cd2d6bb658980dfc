"""Query layer: the standalone top-k API (numpy host code) and
device-resident batched exact and IVF search."""

from .device import DeviceIvfSearcher
from .search import SearchResult, TopkBuilder, topk, topk_batch
from .selective import read_embeddings_for_rows

__all__ = [
    "DeviceIvfSearcher",
    "SearchResult",
    "TopkBuilder",
    "read_embeddings_for_rows",
    "topk",
    "topk_batch",
]
