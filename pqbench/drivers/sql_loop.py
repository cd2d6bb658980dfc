"""Closed-loop SQL top-k through the program's ``Session`` and its resident
searcher: one client sends one query text a call and waits for the table.

Set-up draws the rows on the device from the seed (``gen.py``'s mixture, the
streams of the search cells), writes them to a Parquet file under
``TMPDIR`` in the configuration's layout (an int64 ``id`` 0..n-1 and a
list<float32> ``embedding``; the codec, row groups of ``row_group_rows``,
data pages of at most ``data_page_bytes``, an offset index, the writer's
default dictionary, or one of at most ``dictionary_page_bytes`` where given), indexes it in place with the program's
``IndexBuilder``, registers it with a ``Session(VectorTopKOptions(nprobe))``
and builds the resident searcher (``Session.device_searcher``, the
configuration's storage and re-score). The client formats its query texts
from ``pool_queries`` fresh mixture draws, ``filtered_share`` of them (every
other one at 0.5) with ``WHERE id >= filter_min_id``, and warms up with
``warmup_calls`` texts of draws of their own. All of that is ``setup_s``.

The window sends ``session.sql(text).collect()`` for ``--seconds``, as
``search_loop``'s does: the same ``Clock`` (CUDA events from the call's
entry to its return, so the host's parse, page reads and top-k count), the
host's span of each call, and ``qps`` = calls over the window. A call that
raises, or that the resident searcher did not serve (``VectorTopKExec``'s
``resident_candidates`` 0: the host path took it), counts as failed. After
the window every call is judged by ``reference/sql.py`` against the file's
own rows and embedded index. A traced run then sends ``trace_seconds`` more
calls under the profiler; the program's ``sql`` spans are its record
(``read_sql_ms``, ``read_per_query``). The file is removed at exit.

Traffic keys: k, filtered_share, filter_min_id, pool_queries, warmup_calls,
trace_seconds.
"""

from __future__ import annotations

import gc
import importlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from pqbench import gen, spans
from pqbench.devtrace import TraceWindow
from pqbench.drivers.search_loop import STORAGE, Clock
from pqbench.harness import device_kind, sync
from pqbench.reference import payload as payload_fmt
from pqbench.reference.sql import SqlReference


def write_file(path: str, rows: np.ndarray, layout: dict) -> int:
    """``rows`` [n, d] f32 as the configuration's file -> its size in bytes."""
    n, dim = rows.shape
    schema = pa.schema(
        [pa.field("id", pa.int64()), pa.field("embedding", pa.list_(pa.float32()))]
    )
    step = layout["row_group_rows"]
    extra = {}
    if "dictionary_page_bytes" in layout:  # else the writer's default, 1 MiB
        extra["dictionary_pagesize_limit"] = layout["dictionary_page_bytes"]
    with pq.ParquetWriter(path, schema, compression=layout["compression"],
                          data_page_size=layout["data_page_bytes"],
                          write_page_index=layout["offset_index"], **extra) as writer:
        for lo in range(0, n, step):
            part = rows[lo : lo + step]
            m = part.shape[0]
            offsets = pa.array(np.arange(m + 1, dtype=np.int32) * dim)
            vec = pa.ListArray.from_arrays(offsets, pa.array(part.reshape(-1), pa.float32()))
            ids = pa.array(np.arange(lo, lo + m, dtype=np.int64))
            writer.write_table(pa.table({"id": ids, "embedding": vec}, schema=schema))
    with open(path, "rb+") as f:
        os.fsync(f.fileno())
    return os.path.getsize(path)


def query_text(q: np.ndarray, k: int, min_id: int | None) -> str:
    """The SQL of one call; each value as the shortest text that reads back
    as the same float32."""
    lit = ", ".join(repr(float(v)) for v in q)
    where = "" if min_id is None else f"WHERE id >= {min_id} "
    return (f"SELECT id, array_distance(embedding, [{lit}]) AS dist FROM t "
            f"{where}ORDER BY dist LIMIT {k}")


def filtered_calls(count: int, share: float) -> np.ndarray:
    """Which of ``count`` calls carry the predicate: ``share`` of them,
    spread evenly (every other one at 0.5, starting with a plain one)."""
    i = np.arange(count)
    return np.floor((i + 1) * share) > np.floor(i * share)


def topk_node(plan):
    """The plan's ``VectorTopKExec``, or None."""
    if plan.name == "VectorTopKExec":
        return plan
    for child in plan.children():
        found = topk_node(child)
        if found is not None:
            return found
    return None


def setup(run, path: str) -> dict:
    """Everything before the window -> state dict."""
    cfg, tr, dev, prog = run.config, run.traffic, run.device, run.program
    t = time.perf_counter()
    modes = gen.mixture_modes(run.seed, cfg["data"], cfg["dim"], dev)
    rows = gen.mixture_rows(modes, cfg["rows"], cfg["data"]["noise"], run.seed, "rows")
    rows_host = rows.cpu().numpy()
    del rows
    noise = cfg["data"]["noise"]
    pool = gen.mixture_rows(modes, tr["pool_queries"], noise, run.seed, "queries").cpu()
    warm = gen.mixture_rows(modes, tr["warmup_calls"], noise, run.seed, "warmup").cpu()
    del modes
    write_file(path, rows_host, cfg["file"])
    del rows_host
    t_file = time.perf_counter() - t
    (prog.IndexBuilder(path, "embedding", device=dev).n_clusters(cfg["n_clusters"])
     .max_iters(cfg["kmeans_iters"]).seed(cfg["kmeans_seed"]).build_inplace())
    sync(dev)
    t_build = time.perf_counter() - t - t_file
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    engine = importlib.import_module(prog.__name__ + ".engine")
    session = engine.Session(engine.VectorTopKOptions(
        nprobe=cfg["nprobe"], max_candidates=cfg["max_candidates"]), device=dev)
    session.register_parquet("t", path)
    searcher = session.device_searcher("t", dtype=STORAGE[cfg["storage"]],
                                       rescore_dtype=cfg["rescore"])
    t_searcher = time.perf_counter() - t - t_file - t_build
    k, share, min_id = tr["k"], tr["filtered_share"], tr["filter_min_id"]
    filtered = filtered_calls(tr["pool_queries"], share)
    texts = [query_text(q, k, min_id if f else None) for q, f in zip(pool.numpy(), filtered)]
    warm_f = filtered_calls(tr["warmup_calls"], share)
    for q, f in zip(warm.numpy(), warm_f):
        session.sql(query_text(q, k, min_id if f else None)).collect()
    sync(dev)
    run.log(f"set-up: rows, queries and file {t_file:.3f} s ({os.path.getsize(path)} bytes), "
            f"build_inplace {t_build:.3f} s, searcher {t_searcher:.3f} s, warm-up "
            f"{time.perf_counter() - t - t_file - t_build - t_searcher:.3f} s")
    return {"session": session, "searcher": searcher, "texts": texts, "pool": pool,
            "filtered": filtered}


def window(run, st) -> dict:
    """The timed loop; in a traced run, then ``trace_seconds`` more calls
    under the profiler."""
    tr, dev = run.traffic, run.device
    session, texts = st["session"], st["texts"]
    clock = Clock(dev)
    lat, host, kept = [], [], {}
    failed = calls = 0
    n_pool = len(texts)

    def call(timed: bool) -> None:
        nonlocal failed, calls
        slot = calls % n_pool
        clock.start()
        h0 = time.perf_counter()
        df = table = None
        try:
            df = session.sql(texts[slot])
            table = df.collect()
        except Exception as exc:  # noqa: BLE001 - a failed call is counted, not fatal
            run.log(f"call {calls} failed: {exc!r}")
        h1 = time.perf_counter()
        ms = clock.stop()
        if table is not None:
            node = topk_node(df.physical_plan())
            if node is None or node.metrics.value("resident_candidates") <= 0:
                run.log(f"call {calls} was not served by the resident searcher")
                table = None
        if timed:
            failed += table is None
            lat.append(ms)
            host.append(h1 - h0)
            if table is not None and calls < n_pool:
                kept[calls] = (table.column("id").to_numpy(),
                               table.column("dist").to_numpy())
        calls += 1

    gc.collect()  # a clean start; the collector then runs as it would under a user
    t_start = time.perf_counter()
    while True:
        call(timed=True)
        if time.perf_counter() - t_start >= run.seconds:
            break
    t_end = time.perf_counter()
    timed_calls = calls
    summary = None
    if run.trace:  # after the window, so that the window is an untraced run's
        tracer = TraceWindow(dev)
        tracer.start()
        t0 = time.perf_counter()
        while True:
            call(timed=False)
            if time.perf_counter() - t0 >= tr["trace_seconds"]:
                break
        summary = tracer.stop()
    if calls > n_pool:
        run.log(f"the pool of {n_pool} queries wrapped: {calls - n_pool} calls repeated")
    lat_a = np.asarray(lat)
    run.log(f"window: {timed_calls} calls in {t_end - t_start:.3f} s, {failed} failed, latency "
            f"ms p50 {np.percentile(lat_a, 50):.4f} p95 {np.percentile(lat_a, 95):.4f} max "
            f"{lat_a.max():.4f}, host span ms mean {1e3 * np.mean(host):.4f}")
    return {"lat_ms": lat, "host_s": host, "kept": kept, "calls": timed_calls,
            "failed": failed, "window_s": t_end - t_start, "trace": summary,
            "traced_calls": calls - timed_calls if run.trace else None}


def reference_for(run, path: str) -> SqlReference:
    """The reference over the file's own rows and embedded index."""
    table = pq.read_table(path, columns=["id", "embedding"])
    emb = table.column("embedding").combine_chunks()
    rows = emb.values.to_numpy(zero_copy_only=False).reshape(len(emb), -1).copy()
    payload = payload_fmt.read_payload(path, payload_fmt.footer_offset(path))
    return SqlReference(torch.from_numpy(rows).to(run.device), table.column("id").to_numpy(),
                        payload, run.traffic["filter_min_id"])


def judge(run, st, path: str, kept: dict) -> tuple[dict, dict, float]:
    """The reference's numbers over the judged calls ``kept`` {call: (ids,
    dist)} -> (numbers, info, recall)."""
    ref = reference_for(run, path)
    order = sorted(kept)
    q = st["pool"][torch.as_tensor(order, dtype=torch.int64)].to(run.device)
    return ref.judge(q, st["filtered"][order], [kept[i] for i in order],
                     run.traffic["k"], run.config["nprobe"])


def run(run) -> dict:
    tmp = tempfile.mkdtemp(prefix="pqbench-sql-")
    try:
        return _run(run, os.path.join(tmp, "t.parquet"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(run, path: str) -> dict:
    st = setup(run, path)
    setup_s = time.perf_counter() - run.t0
    win = window(run, st)
    peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    st["session"] = st["searcher"] = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, info, recall = judge(run, st, path, win["kept"])
    run.log(f"compared {info} in {time.perf_counter() - t:.3f} s: {numbers}")
    if run.trace and read_sql_ms("sql") is not None:
        run.log(f"traced queries: sql span ms mean {read_sql_ms('sql', whole=True):.4f}, "
                f"its own self time {read_sql_ms('sql'):.4f}")
    lat = np.asarray(win["lat_ms"])
    record = {
        "e2e": {
            "qps": win["calls"] / win["window_s"],
            "p95_ms": float(np.percentile(lat, 95)),
            "recall_at_k": recall,
            "setup_s": setup_s,
        },
        "numbers": numbers,
        "attempted": win["calls"],
        "failed": win["failed"],
        "memory_peak_bytes": peak,
        "device_kind": device_kind(run.device),
        "calls": win["calls"],
        "window_s": win["window_s"],
        "host_s": win["host_s"],
        "trace": win["trace"],
    }
    if win["traced_calls"] is not None:
        record["traced_calls"] = win["traced_calls"]
    return record


# The program's ``sql`` spans, for the readers of ``metrics/sql.*``.


def _sql_spans():
    """(the traced queries' root ``sql`` spans, every span under them, the
    program's self-time function), or None where the program recorded no
    ``sql`` span (one without them, or an untraced run)."""
    st = spans.store()
    if not st:
        return None
    roots = {s["id"]: s for s in st["spans"] if s["name"] == "sql" and not s["parent"]}
    if not roots:
        return None
    under = [s for s in st["spans"] if s["root"] in roots]
    return roots, under, sys.modules[spans.PROGRAM + ".utils.profiling"].self_ns


def read_sql_ms(name: str, whole: bool = False) -> float | None:
    """Mean host ms a traced query spends in the spans ``name``: their self
    time, or with ``whole`` their whole duration."""
    found = _sql_spans()
    if found is None:
        return None
    roots, under, self_ns = found
    mine = [s for s in under if s["name"] == name]
    if whole:
        total = sum(s["end_ns"] - s["start_ns"] for s in mine)
    else:
        selfs = self_ns(under)
        total = sum(selfs[s["id"]] for s in mine)
    return total / len(roots) / 1e6


def read_per_query(counter: str) -> float | None:
    """Mean of the root ``sql`` spans' counter ``counter`` a traced query."""
    found = _sql_spans()
    if found is None:
        return None
    roots = found[0]
    return sum(r["counters"].get(counter, 0) for r in roots.values()) / len(roots)
