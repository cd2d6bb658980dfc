"""Closed-loop IVF search: one client sends a batch, waits for the answer
(synchronised on the device), then sends the next.

Set-up draws the rows and a pool of queries on the device from the seed,
builds the coarse index with the reference's own k-means, and hands both to
the program's ``DeviceIvfSearcher``; then it warms the cell's one shape. The
pool is kept in host memory, as a client holds its queries, so it is not in
the card's peak: each call hands the program a batch on the host, and the
program's copy of it to the card is part of the call. The window sends pool
batches for ``--seconds``: no query repeats unless a run outpaces the pool
(the repeats are logged). Each call's latency is taken by CUDA events on
the device clock from its entry to the end of its last device work; the
host's span of the call (entry to return) is kept too.
After the window the first ``recall_calls`` calls and a seeded share of the
rest are judged by the reference (``reference/compare.py``), and recall@k
of the first ones is taken against the exact top-k over all rows. A traced
run then sends ``trace_seconds`` more batches under the profiler.

Traffic keys: batch, k, nprobe, mode, pool_calls, warmup_calls,
recall_calls, check_share, trace_seconds.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from pqbench import gen, roofline
from pqbench.devtrace import TraceWindow
from pqbench.harness import device_kind, sync
from pqbench.reference import kmeans
from pqbench.reference.compare import search_numbers
from pqbench.reference.exact import Layout, exact_topk

STORAGE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Clock:
    """Per-call latency in ms: CUDA events on a card, the host clock else."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def start(self) -> None:
        if self.cuda:
            self.ev[0].record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        """Wait for the device, then the ms since ``start``."""
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize()
            return self.ev[0].elapsed_time(self.ev[1])
        return (time.perf_counter() - self.t) * 1e3


def make_data(run):
    """The mixture's modes and rows [n, d] f32 on the device, and the
    reference's centroids and assignment of the rows."""
    cfg = run.config
    modes = gen.mixture_modes(run.seed, cfg["data"], cfg["dim"], run.device)
    rows = gen.mixture_rows(modes, cfg["rows"], cfg["data"]["noise"], run.seed, "rows")
    cents, assign = kmeans.train(rows, cfg["n_clusters"], cfg["kmeans_iters"], cfg["kmeans_seed"])
    return modes, rows, cents, assign


def setup(run):
    """Everything before the window -> state dict."""
    cfg, tr, dev = run.config, run.traffic, run.device
    t = time.perf_counter()
    modes, rows, cents, assign = make_data(run)
    rows_host = rows.cpu().numpy()
    cents_host, assign_host = cents.cpu().numpy(), assign.cpu().numpy()
    del rows, cents, assign
    b = tr["batch"]
    noise = cfg["data"]["noise"]
    pool = gen.mixture_rows(modes, tr["pool_calls"] * b, noise, run.seed, "queries").cpu()
    warm = gen.mixture_rows(modes, tr["warmup_calls"] * b, noise, run.seed, "warmup").cpu()
    del modes
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    index = run.program.IvfIndex.from_assignments(cents_host, assign_host)
    t_data = time.perf_counter() - t
    searcher = run.program.DeviceIvfSearcher(
        index, rows_host, dtype=STORAGE[cfg["storage"]], metric=cfg["metric"],
        cluster_sorted=cfg["layout"] == "cluster_sorted", rescore_dtype=cfg["rescore"],
        device=dev,
    )
    t_searcher = time.perf_counter() - t - t_data
    for i in range(tr["warmup_calls"]):
        searcher.search(warm[i * b : (i + 1) * b], tr["k"], tr["nprobe"], mode=tr["mode"])
    sync(dev)
    run.log(f"set-up: rows, queries and index {t_data:.3f} s, searcher {t_searcher:.3f} s, "
            f"warm-up {time.perf_counter() - t - t_data - t_searcher:.3f} s")
    rng = np.random.default_rng(gen.stream_seed(run.seed, "check"))
    keep = rng.random(tr["pool_calls"]) < tr["check_share"]
    keep[: tr["recall_calls"]] = True
    return {"searcher": searcher, "pool": pool, "keep": keep, "rows": rows_host,
            "cents": cents_host, "assign": assign_host}


def window(run, st, search) -> dict:
    """The timed loop over ``search(q, k, nprobe, mode=...)``; in a traced
    run, then ``trace_seconds`` more calls under the profiler."""
    tr, dev = run.traffic, run.device
    b, k, nprobe, mode = tr["batch"], tr["k"], tr["nprobe"], tr["mode"]
    pool, keep, calls_in_pool = st["pool"], st["keep"], tr["pool_calls"]
    clock = Clock(dev)
    lat, host, kept = [], [], {}
    failed = calls = 0

    def call(timed: bool) -> None:
        nonlocal failed, calls
        slot = calls % calls_in_pool
        q = pool[slot * b : (slot + 1) * b]
        clock.start()
        h0 = time.perf_counter()
        try:
            out = search(q, k, nprobe, mode=mode)
        except Exception as exc:  # noqa: BLE001 - a failed call is counted, not fatal
            run.log(f"call {calls} failed: {exc!r}")
            failed += b if timed else 0
            out = None
        h1 = time.perf_counter()
        ms = clock.stop()
        if timed:
            lat.append(ms)
            host.append(h1 - h0)
            if out is not None and calls < calls_in_pool and keep[slot]:
                kept[calls] = out
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
    if calls > calls_in_pool:
        run.log(f"the pool of {calls_in_pool} calls wrapped: {calls - calls_in_pool} calls repeated")
    lat_a = np.asarray(lat)
    run.log(f"window: {timed_calls} calls in {t_end - t_start:.3f} s, latency ms p50 "
            f"{np.percentile(lat_a, 50):.4f} p95 {np.percentile(lat_a, 95):.4f} max "
            f"{lat_a.max():.4f}, host span ms mean {1e3 * np.mean(host):.4f}")
    return {"lat_ms": lat, "host_s": host, "kept": kept, "calls": timed_calls,
            "failed": failed, "window_s": t_end - t_start,
            "traced": range(timed_calls, calls), "trace": summary}


def judge(run, st, kept: dict) -> tuple[dict, dict, float | None]:
    """The reference's numbers over the kept calls, and recall@k of the first
    ``recall_calls`` calls -> (numbers, info, recall)."""
    tr, dev = run.traffic, run.device
    b, k, nprobe = tr["batch"], tr["k"], tr["nprobe"]
    order = sorted(kept)
    rows = torch.from_numpy(st["rows"]).to(dev)
    layout = Layout(rows, torch.from_numpy(st["assign"]).to(dev),
                    torch.from_numpy(st["cents"]).to(dev))
    del rows
    q = torch.cat([st["pool"][i * b : (i + 1) * b] for i in order]).to(dev)
    got_d = torch.cat([kept[i][0].to(dev) for i in order]).float()
    got_i = torch.cat([kept[i][1].to(dev) for i in order])
    numbers, info, first, probe = search_numbers(layout, q, got_d, got_i, k, nprobe)
    recall = None
    n_rec = b * sum(1 for i in order if i < tr["recall_calls"])
    if n_rec:
        sel = slice(0, n_rec)  # the recall calls come first in ``order``
        _, pos = exact_topk(layout, q[sel], k, probe[sel], (first[0][sel], first[1][sel]))
        truth = layout.order[pos]
        recall = gen.recall_at_k(truth, got_i[sel].to(torch.int64))
        info["recall_queries"] = n_rec
    return numbers, info, recall


def work(run, st, calls: range) -> dict:
    """Essential work of the ``calls`` (the traced ones)."""
    tr, cfg = run.traffic, run.config
    b = tr["batch"]
    cents = torch.from_numpy(st["cents"]).to(run.device).double()
    sizes = np.bincount(st["assign"], minlength=cfg["n_clusters"])
    total = {"bytes": 0, "tensor_flops": 0, "fp32_flops": 0, "calls": len(calls)}
    c_sq = (cents * cents).sum(dim=1)
    for i in calls:
        slot = i % tr["pool_calls"]
        q = st["pool"][slot * b : (slot + 1) * b].to(run.device).double()
        d2 = c_sq[None, :] - 2.0 * (q @ cents.T)
        probe = torch.sort(d2, dim=1, stable=True)[1][:, : tr["nprobe"]].cpu().numpy()
        w = roofline.search_call_work(probe, sizes, cfg["dim"], tr["k"], cfg["storage"])
        for key in ("bytes", "tensor_flops", "fp32_flops"):
            total[key] += w[key]
    return total


def run(run) -> dict:
    st = setup(run)
    setup_s = time.perf_counter() - run.t0
    searcher = st["searcher"]
    win = window(run, st, searcher.search)
    peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    kept = {i: (d.cpu(), ids.cpu()) for i, (d, ids) in win["kept"].items()}
    del searcher, win["kept"]
    st["searcher"] = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, info, recall = judge(run, st, kept)
    run.log(f"compared {info} in {time.perf_counter() - t:.3f} s")
    b = run.traffic["batch"]
    lat = np.asarray(win["lat_ms"])
    record = {
        "e2e": {
            "qps": b * win["calls"] / win["window_s"],
            "p95_ms": float(np.percentile(lat, 95)),
            "recall_at_k": recall,
            "setup_s": setup_s,
        },
        "numbers": numbers,
        "attempted": b * win["calls"],
        "failed": win["failed"],
        "memory_peak_bytes": peak,
        "device_kind": device_kind(run.device),
        "calls": win["calls"],
        "window_s": win["window_s"],
        "trace": win["trace"],
    }
    if run.trace:
        record["host_s"] = win["host_s"]
        record["traced_calls"] = len(win["traced"])
        record["work"] = work(run, st, win["traced"])
    return record
