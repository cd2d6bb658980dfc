"""Execution metrics (ExecutionPlanMetricsSet analog).

The reference instruments both custom operators with counters surfaced in the
plan tree render (component observability, SURVEY.md §5.5;
pq-vector src/df_vector/exec.rs:405-427, index_exec.rs:283-300):
``files_scanned``, ``candidate_rows`` (SUMMARY), ``embeddings_fetched``
(SUMMARY), ``batches_fetched`` (DEV), plus baseline output rows / elapsed.
"""

from __future__ import annotations

import time


class Count:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def add(self, n: int) -> None:
        self.value += n


class Time:
    __slots__ = ("nanos",)

    def __init__(self) -> None:
        self.nanos = 0

    def timer(self) -> "_Timer":
        return _Timer(self)


class _Timer:
    def __init__(self, target: Time):
        self._target = target
        self._start = 0

    def __enter__(self) -> "_Timer":
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._target.nanos += time.perf_counter_ns() - self._start


class MetricsSet:
    """Named counters/timers for one operator."""

    SUMMARY = "summary"
    DEV = "dev"

    def __init__(self) -> None:
        self._counters: dict[str, tuple[Count, str]] = {}
        self.output_rows = Count()
        self.elapsed_compute = Time()

    def counter(self, name: str, kind: str = SUMMARY) -> Count:
        if name not in self._counters:
            self._counters[name] = (Count(), kind)
        return self._counters[name][0]

    def counters(self) -> dict[str, int]:
        return {name: c.value for name, (c, _) in self._counters.items()}

    def value(self, name: str) -> int:
        entry = self._counters.get(name)
        return entry[0].value if entry else 0
