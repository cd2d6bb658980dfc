"""Query layer: device-resident batched exact and IVF search."""

from .device import DeviceIvfSearcher

__all__ = ["DeviceIvfSearcher"]
