"""The ``deep10m-ivf4096`` configuration's files and entries, and the two
readers its K3 cell adds (``metrics/search.k3_rows_read_pct.py``,
``metrics/search.k3_roofline_pct.py``) on synthetic span stores and traces."""

import json
from pathlib import Path

import pytest

import pqvector_tpu_torch.kernels.score_tile  # noqa: F401 - the reader looks up CHUNK_ROWS
from pqbench import roofline, spans
from pqbench.harness import Bench

REPO = Path(__file__).resolve().parents[2]
CELLS = ["deep10m.search.b4096", "deep10m.search.b256"]
H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    return Bench(REPO).reader(name)


@pytest.fixture(autouse=True)
def no_store():
    yield
    spans.use(spans._UNREAD)


def store(calls, counters):
    """A store of search calls, each ``(rows, scan counters)``: a ``search``
    root with its ``rows`` and a ``search.scan`` child."""
    out = []
    for i, (rows, scan) in enumerate(calls):
        root = {"name": "search", "id": 2 * i + 1, "parent": 0, "root": 2 * i + 1, "tid": 1,
                "start_ns": 10 * i, "end_ns": 10 * i + 9, "counters": {"rows": rows}}
        out += [root, {"name": "search.scan", "id": 2 * i + 2, "parent": 2 * i + 1,
                       "root": 2 * i + 1, "tid": 1, "start_ns": 10 * i + 1,
                       "end_ns": 10 * i + 8, "counters": scan}]
    spans.use({"spans": out, "dropped": 0, "counters": counters})


def test_pqbench_k3_rows_read_by_hand():
    # Two K3 calls over 10,000 rows, 500 chunks of 128 rows between them; a
    # K4 call does not count.
    store([(10_000, {"k3.launches": 1}), (10_000, {"k3.launches": 1}),
           (10_000, {"k4.launches": 1})], {"k3.tiles": 40, "k3.chunks": 500, "k4.chunks": 9})
    assert reader("search.k3_rows_read_pct")({}) == pytest.approx(100 * 500 * 128 / 20_000)


@pytest.mark.parametrize("calls,counters", [
    ([(10_000, {"k4.launches": 1})], {"k4.tiles": 3, "k4.chunks": 9}),  # no K3 counter
    ([(10_000, {})], {"k3.tiles": 0, "k3.chunks": 0}),  # no call launched K3
    ([], {}),
])
def test_pqbench_k3_rows_read_gives_none_without_k3(calls, counters):
    store(calls, counters)
    assert reader("search.k3_rows_read_pct")({}) is None


def test_pqbench_k3_rows_read_without_a_store():
    spans.use(None)
    assert reader("search.k3_rows_read_pct")({}) is None


def _record(device_ops, kind=H100):
    work = {"bytes": 3.35e9, "tensor_flops": 0, "fp32_flops": 0, "calls": 10}  # 1 ms least
    return {"trace": {"busy_s": 1.0, "window_s": 2.0, "kernels": 100,
                      "device_ops": device_ops, "idle_gaps": []},
            "work": work, "device_kind": kind}


def test_pqbench_k3_roofline_by_hand():
    ops = [["pqv::stream_masked_kernel<pqv::MmaTile, 4, true>", 0.015],
           ["pqv::stream_masked_kernel<pqv::FmaTile<float, 4>, 4, false>", 0.005],
           ["pqv::merge_partials_kernel", 0.004],
           ["pqv::masked_local_kernel<pqv::MmaTile, 4, true>", 0.5]]
    assert roofline.least_seconds(_record(ops)["work"], roofline.PEAKS[H100]) == \
        pytest.approx(1e-3)
    assert reader("search.k3_roofline_pct")(_record(ops)) == pytest.approx(100 * 1e-3 / 0.02)


@pytest.mark.parametrize("record", [
    _record([["pqv::masked_local_kernel<pqv::MmaTile, 4, true>", 0.5]]),  # K4's route
    _record([["pqv::stream_masked_kernel<pqv::MmaTile, 4, true>", 0.02]], kind="cpu"),
    {"trace": None, "work": None, "device_kind": H100},
])
def test_pqbench_k3_roofline_gives_none_without_k3(record):
    assert reader("search.k3_roofline_pct")(record) is None


def test_pqbench_deep10m_is_in_the_benchmark():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = Bench(REPO)
    config = {c["name"]: c for c in spec["configs"]}["deep10m-ivf4096"]
    assert config["file"] == "pqbench/configs/deep10m-ivf4096.json" and config["reduced"] == []
    cfg = bench.config("deep10m-ivf4096")
    assert (cfg["rows"], cfg["dim"], cfg["n_clusters"], cfg["data"]["modes"]) == (
        10_000_000, 96, 4096, 1024)
    for cell, batch, traffic in zip(CELLS, (4096, 256), ("search-b4096-np4", "search-b256-np4")):
        entry = bench.cell(cell)
        assert (entry["config"], entry["traffic"], entry["chips"]) == (
            "deep10m-ivf4096", traffic, 1)
        mix = bench.traffic(traffic)
        assert (mix["driver"], mix["batch"], mix["k"], mix["nprobe"], mix["mode"]) == (
            "search_loop", batch, 10, 4, "auto")
        for name, lim in bench.limits(cell).items():
            assert lim["lower"] < lim["limit"] < lim["upper"], (cell, name)
        assert {m["name"] for m in bench.metrics(cell, traced=False)} == {
            "qps", "p95_ms", "recall_at_k", "setup_s"}
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in ("search.host_ms", "search.launches", "search.roofline_pct", "idle_pct.search"):
        assert per_layer[name]["workloads"][-2:] == CELLS
    for name in ("search.k3_rows_read_pct", "search.k3_roofline_pct"):
        assert per_layer[name]["workloads"] == ["deep10m.search.b4096"]
        assert (REPO / "pqbench/metrics" / f"{name}.py").is_file()
