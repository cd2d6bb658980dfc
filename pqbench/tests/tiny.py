"""A throwaway benchmark at a size the CPU holds, for the tests: a copy of
``pqbench/`` under a temporary root with a tiny configuration, traffic
mixes, limits and a ``BENCHMARK.json`` of its own, all found by name."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent

CONFIG = {
    "name": "tiny", "source": "a test", "rows": 6000, "dim": 16, "metric": "l2",
    "n_clusters": 24, "kmeans_iters": 8, "kmeans_seed": 42, "storage": "bfloat16",
    "rescore": "auto", "layout": "cluster_sorted",
    "data": {"kind": "gaussian_mixture", "modes": 8, "noise": 0.15},
    "assumed": [], "reduced": [],
}
SEARCH = {"driver": "search_loop", "batch": 8, "k": 5, "nprobe": 4, "mode": "auto",
          "pool_calls": 64, "warmup_calls": 2, "recall_calls": 4, "check_share": 0.5,
          "trace_seconds": 0.2}
BUILD = {"driver": "build_loop", "row_group_rows": 2048, "compression": "snappy",
         "trace_seconds": 0.2}
LIMITS = {
    "tiny.search": {"dist_err": {"limit": 1e-5}, "select_gap": {"limit": 0.05}},
    "tiny.build": {"payload_faults": {"limit": 0}, "assign_excess": {"limit": 1e-6},
                   "kmeans_excess": {"limit": 0.2}},
}


def make_root(tmp: Path, extra_metric: str | None = None) -> Path:
    """A benchmark root under ``tmp`` with the cells tiny.search and
    tiny.build; ``extra_metric`` adds a per-layer metric file of that name
    that reads the traced run's call count."""
    root = Path(tmp)
    shutil.copytree(PKG, root / "pqbench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "pqbench/configs/tiny.json").write_text(json.dumps(CONFIG))
    (root / "pqbench/traffic/tiny-search.json").write_text(json.dumps(SEARCH))
    (root / "pqbench/traffic/tiny-build.json").write_text(json.dumps(BUILD))
    for cell, lim in LIMITS.items():
        (root / f"pqbench/limits/{cell}.json").write_text(json.dumps(lim))
    search = ["tiny.search"]
    per_layer = [
        {"name": "search.host_ms", "unit": "ms", "better": "lower", "source": "host_clock",
         "layer": "searcher", "moves": "qps", "workloads": search},
        {"name": "search.roofline_pct", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "qps", "workloads": search},
        {"name": "build.train_s", "unit": "s", "better": "lower", "source": "program_span",
         "layer": "build train", "moves": "build_s", "workloads": ["tiny.build"]},
    ]
    if extra_metric:
        (root / f"pqbench/metrics/{extra_metric}.py").write_text(
            "def read(record):\n    return float(record['calls'])\n")
        per_layer.append({"name": extra_metric, "unit": "count", "better": "higher",
                          "source": "program_counter", "layer": "searcher", "moves": "qps",
                          "workloads": search})
    bench = {
        "command": ["python3", "pqbench/run.py"], "paths": ["pqbench"], "run_seconds": 1,
        "configs": [{"name": "tiny", "source": "a test", "file": "pqbench/configs/tiny.json",
                     "reduced": [], "why": "tests"}],
        "workloads": [
            {"name": "tiny.search", "config": "tiny", "traffic": "tiny-search", "chips": 1,
             "why": "tests"},
            {"name": "tiny.build", "config": "tiny", "traffic": "tiny-build", "chips": 1,
             "why": "tests"},
        ],
        "end_to_end": [
            {"name": "qps", "unit": "queries/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": search},
            {"name": "p95_ms", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "device_trace", "workloads": search},
            {"name": "recall_at_k", "unit": "ratio", "better": "higher", "bound": 0.01,
             "source": "host_clock", "workloads": search},
            {"name": "build_s", "unit": "s", "better": "lower", "bound": 0.1,
             "source": "host_clock", "workloads": ["tiny.build"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"},
        ],
        "per_layer": per_layer,
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root: Path, cell: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
             program=None):
    """Run a cell of the tiny root on the CPU -> (result, check rows)."""
    import pqvector_tpu_torch

    from pqbench.harness import Bench, run_cell

    return run_cell(Bench(root), cell, seed, seconds, trace, torch.device("cpu"),
                    program or pqvector_tpu_torch, time.perf_counter(), lambda m: None)
