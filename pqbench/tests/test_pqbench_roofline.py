"""The essential work of a search call against counts made by hand."""

import numpy as np
import pytest

from pqbench import roofline


def test_pqbench_search_work_by_hand():
    # 3 queries, nprobe 2, 5 clusters of 10, 20, 30, 40, 50 rows, d = 8, k = 4.
    sizes = np.array([10, 20, 30, 40, 50])
    probe = np.array([[0, 1], [1, 2], [4, 1]])
    w = roofline.search_call_work(probe, sizes, dim=8, k=4, storage="bfloat16")
    union_rows = 10 + 20 + 30 + 50  # clusters 0, 1, 2, 4 read once
    assert w["bytes"] == union_rows * 8 * 2 + 5 * 8 * 4 + 3 * 8 * 4 + 3 * 4 * 8 * 4 + 3 * 4 * 8
    assert w["tensor_flops"] == 2 * 8 * ((10 + 20) + (20 + 30) + (50 + 20))
    assert w["fp32_flops"] == 2 * 3 * 5 * 8


def test_pqbench_least_seconds_takes_the_larger_bound():
    peaks = {"hbm_bytes_per_s": 1e9, "bf16_flops": 1e12, "fp32_flops": 1e11}
    by_bytes = {"bytes": 2e9, "tensor_flops": 1e12, "fp32_flops": 1e10}
    assert roofline.least_seconds(by_bytes, peaks) == pytest.approx(2.0)
    by_ops = {"bytes": 1e8, "tensor_flops": 3e12, "fp32_flops": 2e11}
    assert roofline.least_seconds(by_ops, peaks) == pytest.approx(3.0 + 2.0)


def test_pqbench_roofline_reader_needs_a_known_card():
    from pqbench.harness import _load_module
    from pathlib import Path

    read = _load_module(Path(roofline.__file__).parent / "metrics/search.roofline_pct.py",
                        "metric").read
    trace = {"busy_s": 0.5, "window_s": 1.0, "kernels": 10}
    work = {"bytes": 3.35e11, "tensor_flops": 0, "fp32_flops": 0, "calls": 1}
    rec = {"trace": trace, "work": work, "device_kind": "NVIDIA H100 80GB HBM3"}
    assert read(rec) == pytest.approx(20.0)
    assert read({**rec, "device_kind": "cpu"}) is None
    assert read({**rec, "trace": None}) is None
