"""Spans, stages and counters: the port's tracing (SURVEY.md §5.1).

The reference has no tracing subsystem; its observability surface is the plan
TreeRender with embedded metrics. Here a *span* times one piece of a call on
the host: its name, its start and end (``time.perf_counter_ns``), its own id,
its parent's and its root's (the call it belongs to), the thread it ran on,
and counters. The enclosing span on the thread is the parent; a worker thread
names its parent explicitly (``span(name, parent=...)``). A span's self time
is its duration less the part of it that its children cover (``self_ns``).
Finished spans go to one bounded store per process (``read_store``), which
counts the spans it drops.

* ``stage(name)`` is always recorded, tracing or not: the build's stages, its
  seeding, Lloyd and row-group decodes, and the searcher's set-up. A stage
  also lands, as (name, seconds), in the list ``drain_stages`` returns
  (unless ``drain=False``: the build's spans inside its stages): the list
  of the thread that opened the stage's root, so a stage a worker opens
  under an explicit parent reaches the spawner's list. Draining clears that
  list, never the store.
* ``span(name)`` records only while tracing is on: while a torch profiler
  session is live, or inside ``tracing()`` or ``device_trace()``. Off, a
  span is one test and a shared no-op context manager: nothing is
  allocated, retained or synced.
* ``device_counter`` hands a kernel int32 accumulators on the device while
  tracing is on (None off); ``read_store`` folds them into host totals.
* ``count_root(key, n)`` adds to a host counter of the call in progress:
  the outermost span open on the thread, while tracing is on.
* ``device_trace(dir)`` profiles the device (CUDA activity only on a card,
  host ops on the CPU), turns spans on, and writes one Chrome trace in which
  the spans are host-thread events on the profiler's clock.

No span adds a device sync or a launch. A device counter adds one memset
when it starts a fresh accumulator (first use, then every ``FOLD_CALLS``
launches or before its int32 room runs out), and a read syncs once.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch

#: Spans the store holds; beyond it the oldest are dropped, and counted.
CAPACITY = 1 << 16
#: Launches a device accumulator takes before a fresh one replaces it.
FOLD_CALLS = 4096
_INT32_MAX = (1 << 31) - 1

_profiler_enabled = getattr(torch._C._autograd, "_profiler_enabled", lambda: False)
_ids = itertools.count(1)
_lock = threading.Lock()
_forced = 0  # depth of open tracing() blocks


def tracing_on() -> bool:
    """Whether spans and counters record now."""
    return bool(_forced) or _profiler_enabled()


class _Thread(threading.local):
    """A thread's open spans, its finished stages for ``drain_stages``, and
    its native id (read once: a system call)."""

    def __init__(self):
        self.stack: list = []
        self.stages: list[tuple[str, float]] = []
        self.tid = threading.get_native_id()


_local = _Thread()


#: The fields of a finished span as the store keeps it: a tuple of numbers
#: and strings, which the garbage collector stops tracking, so a full store
#: does not slow its passes.
FIELDS = ("name", "id", "parent", "root", "tid", "start_ns", "end_ns", "counters")


class _Store:
    """The finished spans, the newest ``capacity``, and a count of the rest."""

    def __init__(self, capacity: int):
        self.lock = threading.Lock()
        self.spans: deque = deque(maxlen=capacity)
        self.dropped = 0

    def add(self, fields: tuple) -> None:
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(fields)


_store = _Store(CAPACITY)


class Span:
    """One timed piece of work on one thread; a context manager.
    ``count(key, n)`` adds to its counters."""

    __slots__ = ("name", "id", "parent", "root", "tid", "start_ns", "end_ns",
                 "counters", "_explicit", "_drain", "_sink", "_probe", "_before", "_start")

    def __init__(self, name: str, parent: "Span | None" = None, drain: bool = False,
                 counters=None, start_ns: int | None = None):
        self.name = name
        self.counters: dict | None = None
        self._explicit = parent
        self._drain = drain
        self._probe = counters
        self._start = start_ns

    def __enter__(self) -> "Span":
        local = _local
        stack = local.stack
        parent = self._explicit if self._explicit is not None else (
            stack[-1] if stack else None)
        self._explicit = None
        self.id = next(_ids)
        if parent is None:
            self.parent, self.root, self._sink = 0, self.id, local.stages
        else:
            self.parent, self.root, self._sink = parent.id, parent.root, parent._sink
        self.tid = local.tid
        self._before = self._probe() if self._probe is not None and tracing_on() else None
        stack.append(self)
        self.start_ns = time.perf_counter_ns() if self._start is None else self._start
        return self

    def __exit__(self, kind, value, tb) -> bool:
        self.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        if self._before is not None:
            for key, total in self._probe().items():
                self.count(key, total - self._before[key])
        _store.add((self.name, self.id, self.parent, self.root, self.tid, self.start_ns,
                    self.end_ns, tuple(self.counters.items()) if self.counters else ()))
        if self._drain:
            self._sink.append((self.name, (self.end_ns - self.start_ns) / 1e9))
        return False

    def count(self, key: str, n: int = 1) -> None:
        if self.counters is None:
            self.counters = {}
        self.counters[key] = self.counters.get(key, 0) + n


class _Off:
    """What ``span`` gives while tracing is off: shared, and does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, kind, value, tb) -> bool:
        return False

    def count(self, key: str, n: int = 1) -> None:
        pass


_OFF = _Off()


def span(name: str, parent: Span | None = None, start_ns: int | None = None):
    """A span recorded only while tracing is on. ``parent``: the span a
    worker thread's work belongs to (default: the thread's innermost).
    ``start_ns``: an earlier ``time.perf_counter_ns()`` at which the span's
    work began, for work begun before the span could be opened."""
    if _forced or _profiler_enabled():
        return Span(name, parent, start_ns=start_ns)
    return _OFF


def stage(name: str, parent: Span | None = None, counters=None, drain: bool = True) -> Span:
    """A span recorded whether tracing is on or not; unless ``drain`` is
    False, also kept as (name, seconds) for ``drain_stages``. ``counters``:
    a function giving a dict of running totals, read at the start and end
    while tracing is on; the stage's counters are the differences."""
    return Span(name, parent, drain=drain, counters=counters)


def staged(name: str):
    """Decorator: run the function inside ``stage(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with Span(name, drain=True):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count_root(key: str, n: int = 1) -> None:
    """While tracing is on: add ``n`` to the counter ``key`` of this
    thread's outermost open span, the root of the call in progress (none
    open: nothing)."""
    if _forced or _profiler_enabled():
        stack = _local.stack
        if stack:
            stack[0].count(key, n)


def current() -> Span | None:
    """This thread's innermost open span (stages included), if any."""
    stack = _local.stack
    return stack[-1] if stack else None


def drain_stages() -> list[tuple[str, float]]:
    """Return and clear this thread's finished (stage, seconds) pairs, in
    the order they finished. Join the workers that record under a stage of
    this thread first."""
    records = _local.stages
    out = records[:]
    del records[: len(out)]
    return out


@contextlib.contextmanager
def tracing():
    """Spans and counters record inside this block, with no profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


class _Accumulator:
    """A kernel's int32 counters on one device. A fresh tensor replaces the
    live one after ``FOLD_CALLS`` launches or before a launch could pass
    int32; the replaced ones stay alive (a launch may still be adding) until
    a read folds them into the host totals."""

    def __init__(self, keys: tuple[str, ...]):
        self.keys = keys
        self.live: torch.Tensor | None = None
        self.room = self.uses = 0
        self.retired: list[torch.Tensor] = []

    def take(self, device, bound: int) -> torch.Tensor:
        if self.live is None or self.uses >= FOLD_CALLS or self.room < bound:
            if self.live is not None:
                self.retired.append(self.live)
            self.live = torch.zeros(len(self.keys), dtype=torch.int32, device=device)
            self.room, self.uses = _INT32_MAX, 0
        self.room -= bound
        self.uses += 1
        return self.live

    def fold(self, totals: dict) -> None:
        for t in self.retired + ([self.live] if self.live is not None else []):
            for key, value in zip(self.keys, t.tolist()):
                totals[key] = totals.get(key, 0) + value
        self.live, self.retired = None, []


_accumulators: dict = {}
_totals: dict[str, int] = {}


def device_counter(name: str, keys: tuple[str, ...], device, bound: int):
    """While tracing is on: an int32 [len(keys)] tensor on ``device`` for
    one launch to add to, at most ``bound`` to an entry, and one more
    ``<name>.launches`` on the thread's innermost span. Off: None."""
    if not (_forced or _profiler_enabled()):
        return None
    with _lock:
        acc = _accumulators.get((name, device))
        if acc is None:
            acc = _accumulators[(name, device)] = _Accumulator(keys)
        out = acc.take(device, bound)
    stack = _local.stack
    if stack:
        stack[-1].count(name + ".launches")
    return out


def _fold() -> dict[str, int]:
    with _lock:
        for acc in _accumulators.values():
            acc.fold(_totals)
        return dict(_totals)


def read_store() -> dict:
    """Every span in the store (dicts of ``FIELDS``, in the order they
    finished), the count of spans dropped, and the counters' totals
    (int64 on the host: the device accumulators are read, one sync each).
    Clears nothing."""
    counters = _fold()
    store = _store
    with store.lock:
        spans, dropped = list(store.spans), store.dropped
    records = [dict(zip(FIELDS, s)) for s in spans]
    for r in records:
        r["counters"] = dict(r["counters"])
    return {"spans": records, "dropped": dropped, "counters": counters}


def clear_store() -> None:
    """Empty the store (of ``CAPACITY`` spans) and the counters."""
    global _store
    with _lock:
        _accumulators.clear()
        _totals.clear()
        _store = _Store(CAPACITY)


def self_ns(records: list[dict]) -> dict[int, int]:
    """Span id -> its duration less the union of its children's intervals
    within it, ns."""
    kids = defaultdict(list)
    for r in records:
        if r["parent"]:
            kids[r["parent"]].append((r["start_ns"], r["end_ns"]))
    out = {}
    for r in records:
        lo, hi = r["start_ns"], r["end_ns"]
        covered, end = 0, lo
        for a, b in sorted(kids.get(r["id"], ())):
            a, b = max(a, end), min(b, hi)
            if b > a:
                covered += b - a
                end = b
        out[r["id"]] = hi - lo - covered
    return out


def chrome_events(records: list[dict], base_ns: int, offset_ns: int) -> list[dict]:
    """The spans as Chrome-trace complete events of this process: ``ts`` in
    us from ``base_ns`` on the wall clock, a span's perf-counter time plus
    ``offset_ns``; ``args`` holds the ids, the self time and the counters."""
    selfs = self_ns(records)
    pid = os.getpid()
    return [
        {"ph": "X", "cat": "program_span", "name": r["name"], "pid": pid, "tid": r["tid"],
         "ts": (r["start_ns"] + offset_ns - base_ns) / 1e3,
         "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
         "args": {"id": r["id"], "parent": r["parent"], "root": r["root"],
                  "self_us": selfs[r["id"]] / 1e3, **r["counters"]}}
        for r in records
    ]


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """Profile the block and write ``trace.json`` into the directory: the
    device's kernels and copies (CUDA activity only on a card: recording
    host ops slowed a search call by 60% on the H100; host ops on the CPU),
    and every span the block recorded, with spans on throughout. Span times
    map onto the profiler's clock by one offset taken at the start. The
    counters the block added are under ``programCounters``. A no-op unless
    a directory is given or ``PQVECTOR_TPU_TRACE_DIR`` is set."""
    target = trace_dir or os.environ.get("PQVECTOR_TPU_TRACE_DIR")
    if not target:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    os.makedirs(target, exist_ok=True)
    before = _fold()
    with profile(activities=[act]) as prof, tracing():
        offset_ns = time.time_ns() - time.perf_counter_ns()
        t0 = time.perf_counter_ns()
        yield
    path = os.path.join(target, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    store = read_store()
    mine = [r for r in store["spans"] if r["start_ns"] >= t0]
    trace["traceEvents"].extend(
        chrome_events(mine, int(trace.get("baseTimeNanoseconds", 0)), offset_ns))
    trace["programCounters"] = {k: v - before.get(k, 0) for k, v in store["counters"].items()}
    trace["programSpansDropped"] = store["dropped"]
    with open(path, "w") as f:
        json.dump(trace, f)
