"""Back-to-back in-place builds of one Parquet file.

Set-up draws the rows on the device from the seed, writes them in
``generate_dataset``'s layout (``id`` + ``embedding``, one row group per
``row_group_rows``) to a file under ``TMPDIR``, fsyncs it, and runs one
warm ``IndexBuilder(path, "embedding").n_clusters(..).build_inplace()``.
The window runs the same build again and again; it closes when the build
that crosses ``--seconds`` finishes. Each build appends its index after the
last one (the old payloads stay in the file as dead space), so after the
window the reference reads every build's payload at the file's length
before that build, less the 8-byte footer tail, and checks each against the
rows it wrote and against the reference's own k-means of them
(``reference/compare.py``). A traced run then builds for
``trace_seconds`` more under the profiler. The file is removed at exit.

Traffic keys: row_group_rows, compression, trace_seconds.
"""

from __future__ import annotations

import gc
import importlib
import math
import os
import shutil
import tempfile
import time

import numpy as np
import pyarrow.parquet as pq
import torch

from pqbench import gen
from pqbench.devtrace import TraceWindow
from pqbench.harness import device_kind, sync
from pqbench.reference import kmeans
from pqbench.reference import payload as payload_fmt
from pqbench.reference.compare import build_numbers, objective


def write_file(run, path: str):
    """The seeded rows as a Parquet file -> (rows [n, d] f32 on the host,
    file size)."""
    cfg = run.config
    modes = gen.mixture_modes(run.seed, cfg["data"], cfg["dim"], run.device)
    rows = gen.mixture_rows(modes, cfg["rows"], cfg["data"]["noise"], run.seed, "rows")
    rows_host = rows.cpu().numpy()
    del rows, modes
    size = gen.write_parquet(path, rows_host, run.traffic["row_group_rows"],
                             run.traffic["compression"])
    return rows_host, size


def builder_for(run, path: str):
    cfg = run.config
    return (run.program.IndexBuilder(path, "embedding", device=run.device)
            .n_clusters(cfg["n_clusters"]).max_iters(cfg["kmeans_iters"])
            .seed(cfg["kmeans_seed"]))


def reference_objective(run, rows) -> float:
    """The k-means objective of the reference's own training of ``rows``
    (on the device) with the configuration's clusters, iterations and seed."""
    cfg = run.config
    cents, _ = kmeans.train(rows, cfg["n_clusters"], cfg["kmeans_iters"], cfg["kmeans_seed"])
    return objective(rows, cents)


def read_back(run, path: str, rows_host, sizes: list[int]) -> tuple[dict, dict]:
    """The reference's judgement of every build's payload -> (numbers, info)."""
    table = pq.read_table(path, columns=["id", "embedding"])
    emb = table.column("embedding").combine_chunks()
    flat = emb.values.to_numpy(zero_copy_only=False)
    ids = table.column("id").to_numpy()
    faults = 0
    if flat.size != rows_host.size or not np.array_equal(ids, np.arange(rows_host.shape[0])):
        faults += 1
    else:
        faults += int((flat.reshape(rows_host.shape) != rows_host).any(axis=1).sum())
    rows = torch.from_numpy(rows_host).to(run.device)
    if payload_fmt.footer_offset(path) != sizes[-2] - 8:
        faults += 1
    ref_obj = reference_objective(run, rows)
    worst, worst_km = 0.0, -math.inf
    for before in sizes[:-1]:
        try:
            p = payload_fmt.read_payload(path, before - 8)
        except payload_fmt.PayloadError as exc:
            run.log(f"payload at {before - 8}: {exc}")
            faults += 1
            continue
        f, excess, km = build_numbers(rows, p, ref_obj)
        faults += f
        worst, worst_km = max(worst, excess), max(worst_km, km)
    numbers = {"payload_faults": float(faults), "assign_excess": worst, "kmeans_excess": worst_km}
    return numbers, {"builds": len(sizes) - 1, "reference_objective": ref_obj}


def run(run) -> dict:
    tmp = tempfile.mkdtemp(prefix="pqbench-")
    try:
        return _run(run, os.path.join(tmp, "rows.parquet"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(run, path: str) -> dict:
    dev = run.device
    stages_mod = importlib.import_module(run.program.__name__ + ".utils.profiling")
    t = time.perf_counter()
    rows_host, size0 = write_file(run, path)
    t_file = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    builder = builder_for(run, path)
    sizes = [size0]
    builder.build_inplace()
    sync(dev)
    sizes.append(os.path.getsize(path))
    setup_s = time.perf_counter() - run.t0
    run.log(f"set-up: rows and file {t_file:.3f} s, "
            f"warm build {time.perf_counter() - t - t_file:.3f} s")
    stages_mod.drain_stages()

    def build(timed: bool = True) -> dict:
        nonlocal failed
        try:
            builder.build_inplace()
        except Exception as exc:  # noqa: BLE001 - a failed build is counted, not fatal
            run.log(f"build {len(sizes) - 1} failed: {exc!r}")
            failed += timed
        sync(dev)
        sizes.append(os.path.getsize(path))
        stages = {}
        for name, sec in stages_mod.drain_stages():
            stages[name] = stages.get(name, 0.0) + sec
        return stages

    per_build, failed = [], 0
    gc.collect()  # a clean start; the collector then runs as it would under a user
    t_start = time.perf_counter()
    while True:
        per_build.append(build())
        if time.perf_counter() - t_start >= run.seconds:
            break
    t_end = time.perf_counter()
    builds = len(per_build)
    summary = None
    if run.trace:  # after the window, so that the window is an untraced run's
        tracer = TraceWindow(dev)
        tracer.start()
        t0 = time.perf_counter()
        while True:
            build(timed=False)
            if time.perf_counter() - t0 >= run.traffic["trace_seconds"]:
                break
        summary = tracer.stop()
    run.log(f"window: {builds} builds in {t_end - t_start:.3f} s")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del builder
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, info = read_back(run, path, rows_host, sizes)
    run.log(f"compared {info} in {time.perf_counter() - t:.3f} s")
    return {
        "e2e": {"build_s": (t_end - t_start) / builds, "setup_s": setup_s},
        "numbers": numbers,
        "attempted": builds,
        "failed": failed,
        "memory_peak_bytes": peak,
        "device_kind": device_kind(dev),
        "stages": per_build,
        "trace": summary,
    }
