"""Tracing / profiling hooks (SURVEY.md §5.1).

The reference has no tracing subsystem; its observability surface is the plan
TreeRender with embedded metrics. This package adds, as the JAX package
does:

* ``stage(name)`` — lightweight per-stage wall-clock timers, collected into a
  thread-local stack and queryable afterwards (used by the engine operators),
* ``device_trace(dir)`` — context manager around ``torch.profiler.profile``
  (CPU and, where there is a card, CUDA activities) that writes a Chrome
  trace into ``dir``, gated so it is a no-op unless explicitly requested or
  ``PQVECTOR_TPU_TRACE_DIR`` is set.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

_local = threading.local()


def _records() -> list[tuple[str, float]]:
    if not hasattr(_local, "records"):
        _local.records = []
    return _local.records


@contextlib.contextmanager
def stage(name: str):
    """Record the wall-clock duration of a named stage."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _records().append((name, time.perf_counter() - t0))


def drain_stages() -> list[tuple[str, float]]:
    """Return and clear recorded (stage, seconds) pairs for this thread."""
    records = list(_records())
    _records().clear()
    return records


def current_records() -> list[tuple[str, float]]:
    """This thread's live stage-record list. Hand it to a worker thread
    (with ``add_stage_time``) so the worker's timings surface in the
    caller's ``drain_stages`` — stage records are thread-local."""
    return _records()


def add_stage_time(
    name: str,
    seconds: float,
    records: list[tuple[str, float]] | None = None,
) -> None:
    """Append an externally-timed stage duration (worker threads pass the
    spawner's ``current_records()``; the spawner must join the worker
    before draining)."""
    (_records() if records is None else records).append((name, seconds))


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """torch.profiler trace written as ``trace.json`` into the directory;
    no-op unless a directory is given or PQVECTOR_TPU_TRACE_DIR is set."""
    target = trace_dir or os.environ.get("PQVECTOR_TPU_TRACE_DIR")
    if not target:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(target, "trace.json"))
