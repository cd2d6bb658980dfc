"""The program's spans and counters, read once per process.

``pqvector_tpu_torch.utils.profiling.read_store()`` gives every span the
program recorded in this process (name, id, parent, root, start and end in
ns, counters) and its counters' totals. The search spans and the counters
record only while a profiler session is live (``devtrace.TraceWindow``):
they are the traced calls'. The build's spans are recorded in every build,
as its stages are; the readers take the builds of the untraced window
(``window_stage_ids``), the builds the ``build.*_s`` metrics read. The readers of
``metrics/`` that come from spans share one read, taken the first time one
asks, in the process that ran the cell (``harness.run_cell`` calls them
after the cell's ``drivers/`` module returns). A program without the store (an older one) gives
None, and so do its readers. Self times are the program's ``self_ns``: a
span's duration less the union of its children's intervals.
"""

from __future__ import annotations

import sys

PROGRAM = "pqvector_tpu_torch"
_UNREAD = object()
_store = _UNREAD


def store() -> dict | None:
    """The program's span store, read once; None without one."""
    global _store
    if _store is _UNREAD:
        read = getattr(sys.modules.get(PROGRAM + ".utils.profiling"), "read_store", None)
        _store = read() if read is not None else None
    return _store


def use(st: dict | None) -> None:
    """Take ``st`` as the store (the tests' synthetic stores)."""
    global _store
    _store = st


def _call_of(span: dict, by_id: dict) -> dict | None:
    """The outermost ``search`` span at or above ``span``: its call."""
    call = None
    while span is not None:
        if span["name"] == "search":
            call = span
        span = by_id.get(span["parent"])
    return call


def search_calls(st: dict) -> list[dict]:
    """The traced search calls: ``search`` spans inside no other."""
    by_id = {s["id"]: s for s in st["spans"]}
    return [s for s in st["spans"] if s["name"] == "search" and _call_of(s, by_id) is s]


def search_self_ms(name: str) -> float | None:
    """Mean self time a traced search call of the spans named ``name``, ms
    (0 where the calls have none)."""
    st = store()
    if not st:
        return None
    calls = search_calls(st)
    if not calls:
        return None
    selfs = sys.modules[PROGRAM + ".utils.profiling"].self_ns(st["spans"])
    total = sum(selfs[s["id"]] for s in st["spans"] if s["name"] == name)
    return total / len(calls) / 1e6


def k4_rows_read_pct() -> float | None:
    """Rows K4 fetched a call (its (block, chunk) pairs x the kernels'
    chunk rows) over the layout's rows (the ``rows`` counter of the call's
    ``search`` span), %, over the traced calls that launched K4 with the
    trace's counter."""
    st = store()
    score_tile = sys.modules.get(PROGRAM + ".kernels.score_tile")
    if not st or score_tile is None or "k4.chunks" not in st["counters"]:
        return None
    by_id = {s["id"]: s for s in st["spans"]}
    base = 0
    for s in st["spans"]:
        launches = s["counters"].get("k4.launches", 0)
        call = _call_of(s, by_id) if launches else None
        if call is not None:
            base += launches * call["counters"].get("rows", 0)
    if base <= 0:
        return None
    return 100.0 * st["counters"]["k4.chunks"] * score_tile.CHUNK_ROWS / base


def named(name: str) -> list[dict]:
    st = store()
    return [s for s in st["spans"] if s["name"] == name] if st else []


def seconds(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e9


def mean_seconds(name: str) -> float | None:
    """Mean duration of the spans named ``name``, s."""
    found = named(name)
    if not found:
        return None
    return sum(seconds(s) for s in found) / len(found)


def window_stage_ids(record: dict, name: str) -> set[int]:
    """Ids of the stage spans ``name`` of the builds ``drivers/build_loop.py``
    timed: those whose seconds are among the ones it drained for its window's builds
    (``record["stages"]``, the same ``(end_ns - start_ns) / 1e9``)."""
    drained = {b[name] for b in record.get("stages") or [] if name in b}
    return {s["id"] for s in named(name) if seconds(s) in drained}


def per_window_build(record: dict, name: str, stage: str) -> float | None:
    """Seconds the spans ``name`` under the window builds' stage ``stage``
    take, summed over each build and averaged over the builds."""
    builds = window_stage_ids(record, stage)
    found = [s for s in named(name) if s["parent"] in builds]
    if not found:
        return None
    return sum(seconds(s) for s in found) / len({s["parent"] for s in found})
