"""Discovery by name, the result line, and the refusals of the command."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pqbench.harness import Bench
from pqbench.tests.tiny import make_root, run_tiny

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_pqbench_finds_a_throwaway_cell_by_name(tmp_path):
    root = make_root(tmp_path, extra_metric="calls_seen")
    bench = Bench(root)
    assert bench.config("tiny")["rows"] == 6000
    assert bench.traffic("tiny-search")["driver"] == "search_loop"
    assert hasattr(bench.driver("search_loop"), "run")
    assert [m["name"] for m in bench.metrics("tiny.search", traced=True)] == [
        "search.host_ms", "search.roofline_pct", "calls_seen"]
    result, _ = run_tiny(root, "tiny.search", trace=True)
    assert result["metrics"]["calls_seen"]["value"] >= 1
    assert result["metrics"]["calls_seen"]["unit"] == "count"
    assert "search.roofline_pct" not in result["metrics"]  # no card: nothing to read


@pytest.mark.parametrize("cell,trace", [("tiny.search", False), ("tiny.search", True),
                                         ("tiny.build", False), ("tiny.build", True)])
def test_pqbench_result_line_keys(tmp_path, cell, trace):
    root = make_root(tmp_path)
    result, rows = run_tiny(root, cell, trace=trace)
    keys = list(result)
    assert keys[: len(KEYS)] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == trace
    bench = Bench(root)
    names = {m["name"] for m in bench.metrics(cell, trace)}
    if not trace:
        assert set(result["metrics"]) == names
    else:
        assert set(result["metrics"]) <= names
    for name, value, limit in rows:
        assert result["checks"][name] == {"value": value, "limit": limit}
    json.dumps(result)


def test_pqbench_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command runs")
    proc = subprocess.run(
        [sys.executable, "pqbench/run.py", "--workload", "sift1m.search.b256", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_pqbench_command_refuses_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "pqbench", tmp_path / "pqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "pqbench/run.py", "--workload", "sift1m.search.b256", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_pqbench_tiny_cells_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    import pqvector_tpu_torch

    from pqbench.harness import run_cell

    root = make_root(tmp_path)
    for cell in ("tiny.search", "tiny.build"):
        result, _ = run_cell(Bench(root), cell, 3, 0.5, True, torch.device("cuda"),
                             pqvector_tpu_torch, time.perf_counter(), print)
        assert result["correct"] and result["device"]["busy_s"] > 0
