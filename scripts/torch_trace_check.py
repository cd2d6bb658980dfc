"""Checks and costs of the port's spans and counters (``utils/profiling.py``).

    python scripts/torch_trace_check.py [--seed N] [--seconds S] [--out DIR]
    python scripts/torch_trace_check.py --off-only     # the CPU part alone

1. Off cost (the host's CPU): 10^5 span entries with tracing off, each
   kind a search call makes; one K4 call's sum (six spans, the root's
   ``rows`` count, K4's ``device_counter`` test).
2. On the card: ``torch._C._autograd._profiler_enabled()`` inside a
   CUDA-only ``torch.profiler`` session, as ``pqbench/devtrace.py`` runs one.
3. One ``sift1m.search.b256`` batch (the benchmark's own set-up,
   ``pqbench/drivers/search_loop.py:setup``) through ``search(pallas)``:
   K4's ``k4.chunks`` counter and ``search.k4_rows_read_pct`` against
   ``scan_topk.scored_chunks``.
4. ``device_trace`` over three batches: each kernel's launch (its CUDA
   runtime call, by correlation id) lies in the innermost span open on the
   launching thread at that time; each kernel starts after that span's start.
5. On cost: 10^5 span entries recorded; windows of b256 and b1 calls with
   spans off and on (``tracing()``, no profiler), in turns off, on, on,
   off, with the on windows' host self time a call by span; then builds
   of ``sift1m.build``'s file, in turns. queries/s and s a build, medians.

Prints one JSON line, and keeps it and the trace under ``--out`` (default
``build/trace_check``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import tempfile
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from pqvector_tpu_torch.utils import profiling  # noqa: E402

N = 100_000
SPLIT = ("search", "search.upload", "search.probe", "search.scan", "search.merge",
         "search.refine")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def off_cost() -> dict:
    """ns a span entry costs with tracing off, by kind, best of five."""
    cpu = torch.device("cpu")

    def empty():
        t = time.perf_counter_ns()
        for _ in range(N):
            pass
        return time.perf_counter_ns() - t

    def entry():
        t = time.perf_counter_ns()
        for _ in range(N):
            with profiling.span("search.scan"):
                pass
        return time.perf_counter_ns() - t

    def counted():
        t = time.perf_counter_ns()
        for _ in range(N):
            with profiling.span("search") as call:
                call.count("rows", 1)
        return time.perf_counter_ns() - t

    def counter():  # K4's wrapper: the test, then the counter while on
        t = time.perf_counter_ns()
        for _ in range(N):
            if profiling.tracing_on():
                profiling.device_counter("k4", ("a", "b"), cpu, 1)
        return time.perf_counter_ns() - t

    if profiling.tracing_on():
        raise RuntimeError("tracing is on: the off cost cannot be measured")
    before = profiling.read_store()
    base = min(empty() for _ in range(5))
    kinds = (("span_ns", entry), ("span_count_ns", counted), ("device_counter_ns", counter))
    out = {name: (min(fn() for _ in range(5)) - base) / N for name, fn in kinds}
    # a K4 call: the root with its count, five more spans, K4's counter test
    out["k4_call_ns"] = out["span_count_ns"] + 5 * out["span_ns"] + out["device_counter_ns"]
    out["store_unchanged"] = profiling.read_store() == before
    with profiling.tracing():  # the same entries recorded (the counter on the CPU)
        on = {name: (min(fn() for _ in range(3)) - base) / N for name, fn in kinds}
    profiling.clear_store()
    out["on"] = on
    out["on"]["k4_call_ns"] = on["span_count_ns"] + 5 * on["span_ns"] + on["device_counter_ns"]
    return out


def search_run(seed: int, cell: str, seconds: float):
    import pqvector_tpu_torch
    from pqbench.drivers import search_loop
    from pqbench.harness import Bench, Run

    bench = Bench(ROOT)
    entry = bench.cell(cell)
    return Run(cell, bench.config(entry["config"]), bench.traffic(entry["traffic"]), seed,
               seconds, False, torch.device("cuda"), pqvector_tpu_torch, time.perf_counter(),
               log), search_loop


def k4_check(searcher, q, k: int, nprobe: int) -> dict:
    """One ``pallas`` batch's K4 counter and share against ``scored_chunks``."""
    from pqbench import spans
    from pqvector_tpu_torch.kernels import scan_topk as sc
    from pqvector_tpu_torch.kernels import score_tile
    from pqvector_tpu_torch.kernels.probe import probe_mask

    profiling.clear_store()
    with profiling.tracing():
        searcher.search(q, k, nprobe, mode="pallas")
    st = profiling.read_store()
    spans.use(st)
    got_pct = spans.k4_rows_read_pct()
    qd = searcher._check_queries(q)
    tile = searcher._scan_tile()
    lcl, tc, cmax = searcher._tile_cluster_table(tile)
    mask = probe_mask(qd, searcher.centroids, searcher.c_sq, nprobe)
    lmask = mask[:, tc.long()].permute(1, 0, 2).contiguous()
    _, queries, words, _ = sc.masked_geometry("K4", qd.to(searcher.emb.dtype), searcher.emb,
                                              k, cmax)
    chunks = sc.scored_chunks(lmask > 0.5, lcl, tile, queries)
    if not words:  # no probe table: whole tiles
        chunks = chunks.any(2, keepdim=True).expand(-1, -1, -(-tile // score_tile.CHUNK_ROWS))
    want = [int(chunks.any(2).sum()), int(chunks.sum())]
    want_pct = 100.0 * want[1] * score_tile.CHUNK_ROWS / searcher.n
    union = int(mask[:, : searcher.index.n_clusters].amax(0).sum())
    got = [st["counters"].get("k4.tiles"), st["counters"].get("k4.chunks")]
    return {"counter": got, "scored_chunks": want, "words": words, "queries_a_block": queries,
            "pct": got_pct, "pct_from_rule": want_pct, "exact": got == want and got_pct == want_pct,
            "union_clusters_pct": 100.0 * union / searcher.index.n_clusters,
            "spans": sorted(s["name"] for s in st["spans"])}


def trace_check(searcher, pool, b: int, k: int, nprobe: int, out: Path) -> dict:
    """Three traced batches through ``device_trace``: where each kernel's
    launch falls among the spans, and whether it starts after that span."""
    target = out / "trace"
    with profiling.device_trace(str(target)):
        for i in range(3):
            searcher.search(pool[i * b : (i + 1) * b], k, nprobe)
        torch.cuda.synchronize()
    trace = json.loads((target / "trace.json").read_text())
    ev = trace["traceEvents"]
    spans = [e for e in ev if e.get("cat") == "program_span"]
    launches = {e["args"]["correlation"]: e for e in ev
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    rows, inside, after, missing, tids = [], 0, 0, 0, set()
    for e in ev:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        call = launches.get(e.get("args", {}).get("correlation"))
        if call is None:
            missing += 1
            continue
        tids.add((call["tid"], call["pid"]))
        holders = [s for s in spans
                   if s["ts"] <= call["ts"] and call["ts"] + call.get("dur", 0) <= s["ts"] + s["dur"]]
        span = max(holders, key=lambda s: s["ts"]) if holders else None
        inside += span is not None
        ok = span is not None and e["ts"] >= span["ts"]
        after += ok
        rows.append({"kernel": e["name"][:60], "span": span and span["name"],
                     "launch_in_span_us": span and call["ts"] - span["ts"],
                     "start_after_span_us": span and e["ts"] - span["ts"]})
    k3 = [r for r in rows if "stream_masked_kernel" in r["kernel"]]  # ``auto``'s scan
    sorts = [r for r in rows if "sort" in r["kernel"].lower()]
    merge_starts = sorted(s["ts"] for s in spans if s["name"] == "search.merge")
    return {
        "device_ops": len(rows), "launch_not_found": missing,
        "launch_inside_a_span": inside, "start_after_its_span": after,
        "k3": k3, "sorts_by_span": {n: sum(r["span"] == n for r in sorts)
                                    for n in sorted({r["span"] or "-" for r in sorts})},
        "sorts_after_their_span": all(r["start_after_span_us"] is not None
                                      and r["start_after_span_us"] >= 0 for r in sorts),
        "merge_starts": len(merge_starts),
        "spans": len(spans), "counters": trace.get("programCounters"),
        "launch_threads": sorted(tids), "span_threads": sorted({(s["tid"], s["pid"]) for s in spans}),
    }


def windows(fn, seconds: float, pairs: int) -> dict:
    """``fn()`` repeated for ``seconds`` a window, spans off and on in turns
    (off, on, on, off, ...: ``pairs`` of each) -> {off: [rates], on: [rates],
    split: the on windows' host self ms a call by span}."""
    from pqbench import spans

    out = {"off": [], "on": [], "split": {}}
    for i in range(2 * pairs):
        turn = ("off", "on", "on", "off")[i % 4]
        calls, t0 = 0, time.perf_counter()
        with profiling.tracing() if turn == "on" else contextlib.nullcontext():
            while time.perf_counter() - t0 < seconds:
                fn()
                calls += 1
        out[turn].append(calls / (time.perf_counter() - t0))
        if turn == "on":
            spans.use(profiling.read_store())
            for name in SPLIT:
                out["split"].setdefault(name, []).append(spans.search_self_ms(name))
        profiling.clear_store()
    return out


def on_cost_search(st, run, seconds: float, pairs: int) -> dict:
    searcher, pool = st["searcher"], st["pool"]
    out = {}
    for b in (256, 1):
        calls = pool.shape[0] // b
        slot = iter(range(10**9))

        def call():
            i = next(slot) % calls
            searcher.search(pool[i * b : (i + 1) * b], run.traffic["k"], run.traffic["nprobe"])
            torch.cuda.synchronize()

        for _ in range(20):
            call()
        w = windows(call, seconds, pairs)
        out[f"b{b}"] = {
            "qps_off": [b * r for r in w["off"]], "qps_on": [b * r for r in w["on"]],
            "on_over_off_median": statistics.median(w["on"]) / statistics.median(w["off"]),
            "host_self_ms_spans_alone": {k: statistics.median(v) for k, v in w["split"].items()}}
    return out


def on_cost_build(seed: int, builds: int) -> dict:
    import pqvector_tpu_torch
    from pqbench.drivers import build_loop
    from pqbench.harness import Bench, Run

    bench = Bench(ROOT)
    entry = bench.cell("sift1m.build")
    run = Run("sift1m.build", bench.config(entry["config"]), bench.traffic(entry["traffic"]),
              seed, 0.0, False, torch.device("cuda"), pqvector_tpu_torch, time.perf_counter(),
              log)
    tmp = tempfile.mkdtemp(prefix="trace-check-")
    path = os.path.join(tmp, "rows.parquet")
    try:
        build_loop.write_file(run, path)
        builder = build_loop.builder_for(run, path)
        builder.build_inplace()
        torch.cuda.synchronize()
        times = {"off": [], "on": []}
        for i in range(builds):
            for turn in (("off", "on") if i % 2 == 0 else ("on", "off")):
                t0 = time.perf_counter()
                with profiling.tracing() if turn == "on" else contextlib.nullcontext():
                    builder.build_inplace()
                    torch.cuda.synchronize()
                times[turn].append(time.perf_counter() - t0)
        st = profiling.read_store()["spans"]
        ratio = []  # seeding and Lloyd over their build.train stage, every build
        for train in (t for t in st if t["name"] == "build.train"):
            parts = [t for t in st if t["parent"] == train["id"]
                     and t["name"] in ("build.train.seed", "build.train.lloyd")]
            ratio.append(sum(t["end_ns"] - t["start_ns"] for t in parts)
                         / (train["end_ns"] - train["start_ns"]))
        return {"build_s_off": times["off"], "build_s_on": times["on"],
                "on_over_off_median": statistics.median(times["on"])
                / statistics.median(times["off"]),
                "seed_plus_lloyd_over_train": ratio}
    finally:
        profiling.clear_store()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--seconds", type=float, default=2.0, help="a window of calls")
    ap.add_argument("--pairs", type=int, default=8, help="windows of calls of each kind")
    ap.add_argument("--builds", type=int, default=6, help="builds of each kind")
    ap.add_argument("--out", default=None)
    ap.add_argument("--off-only", action="store_true")
    args = ap.parse_args(argv)
    result = {"torch": torch.__version__, "off": off_cost()}
    log(f"off: {result['off']}")
    if not args.off_only:
        if not torch.cuda.is_available():
            log("no CUDA device")
            return 2
        import subprocess

        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            result["profiler_enabled_under_cuda_only"] = bool(profiling.tracing_on())
        out = Path(args.out or ROOT / "build" / "trace_check")
        out.mkdir(parents=True, exist_ok=True)
        run, search_loop = search_run(args.seed, "sift1m.search.b256", args.seconds)
        st = search_loop.setup(run)
        tr = run.traffic
        b = tr["batch"]
        result["k4"] = k4_check(st["searcher"], st["pool"][:b], tr["k"], tr["nprobe"])
        log(f"k4: {result['k4']}")
        result["trace"] = trace_check(st["searcher"], st["pool"], b, tr["k"], tr["nprobe"], out)
        log(f"trace: { {k: v for k, v in result['trace'].items() if k != 'k3'} }")
        result["on_cost_search"] = on_cost_search(st, run, args.seconds, args.pairs)
        log(f"on cost, search: {result['on_cost_search']}")
        del st
        torch.cuda.empty_cache()
        result["on_cost_build"] = on_cost_build(args.seed, args.builds)
        log(f"on cost, build: {result['on_cost_build']}")
        (out / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
