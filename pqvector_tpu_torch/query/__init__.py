"""Query layer: the standalone top-k API (numpy host code),
device-resident batched exact and IVF search, and the serving-plan
autotuner."""

from .autotune import AutotuneReport, ServingPlan, WeatherReport, autotune, probe_weather
from .device import DeviceIvfSearcher
from .search import SearchResult, TopkBuilder, topk, topk_batch
from .selective import read_embeddings_for_rows

__all__ = [
    "AutotuneReport",
    "DeviceIvfSearcher",
    "SearchResult",
    "ServingPlan",
    "TopkBuilder",
    "WeatherReport",
    "autotune",
    "probe_weather",
    "read_embeddings_for_rows",
    "topk",
    "topk_batch",
]
