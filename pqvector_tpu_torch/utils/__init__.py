"""Shared host utilities: spans, stages, counters and profiler traces, the
fault-aware allocation of large host matrices, and the kernels' disk
cache."""

from .cache import enable_compilation_cache

__all__ = ["enable_compilation_cache"]
