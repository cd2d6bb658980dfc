"""The port's spans, stages and counters (``utils/profiling.py``) on the CPU:
ids and self time, a worker's explicit parent, the bounded store, the cost
of tracing off, the spans of one search call, and the exported clock."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from pqvector_tpu_torch import DeviceIvfSearcher, IndexBuilder, IvfIndex
from pqvector_tpu_torch.__main__ import main
from pqvector_tpu_torch.bench.datasets import write_embedding_parquet
from pqvector_tpu_torch.index.kmeans import KMeansParams, k_means
from pqvector_tpu_torch.io import pages
from pqvector_tpu_torch.types import EmbeddingColumn
from pqvector_tpu_torch.utils import profiling

#: What ``drain_stages`` gave for one CPU ``build_inplace`` before spans.
BUILD_STAGES = ["build.decode+transfer", "build.transfer_drain", "build.train",
                "build.assign", "build.index", "build.append"]
#: One ``search(mode="auto")`` on a cluster-sorted layout (K3's path: its
#: partial lists are merged inside the kernel's launch, so no merge span).
SEARCH_SPANS = ["search", "search.probe", "search.refine", "search.scan", "search.upload"]
#: One ``search(mode="pallas")`` there (K4's path: the cross-tile merge).
K4_SEARCH_SPANS = ["search", "search.merge", "search.probe", "search.refine", "search.scan",
                   "search.upload"]


@pytest.fixture(autouse=True)
def fresh_store():
    profiling.clear_store()
    profiling.drain_stages()
    yield
    profiling.clear_store()
    profiling.drain_stages()


def tiny_searcher(n=256, d=8, clusters=4):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    assign = np.arange(n) % clusters
    cents = np.stack([x[assign == c].mean(0) for c in range(clusters)])
    index = IvfIndex.from_assignments(cents, assign)
    return DeviceIvfSearcher(index, x, cluster_sorted=True, device="cpu", row_tile=128), x


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def dur(r):
    return r["end_ns"] - r["start_ns"]


def test_spans_nest_with_parent_root_and_self_time():
    with profiling.tracing():
        with profiling.span("call") as call:
            time.sleep(0.002)
            with profiling.span("a") as a:
                time.sleep(0.002)
                with profiling.span("a.inner") as inner:
                    time.sleep(0.001)
            with profiling.span("b") as b:
                pass
        with profiling.span("next") as nxt:
            pass
    recs = {r["name"]: r for r in profiling.read_store()["spans"]}
    assert recs["call"]["id"] == call.id and recs["call"]["parent"] == 0
    assert recs["call"]["root"] == call.id
    assert recs["a"]["parent"] == call.id and recs["b"]["parent"] == call.id
    assert recs["a.inner"]["parent"] == a.id and inner.root == call.id
    assert {recs[n]["root"] for n in ("a", "a.inner", "b")} == {call.id}
    assert recs["next"]["root"] == nxt.id != call.id and recs["next"]["parent"] == 0
    assert b.start_ns >= a.end_ns
    selfs = profiling.self_ns(list(recs.values()))
    assert selfs[call.id] == dur(recs["call"]) - dur(recs["a"]) - dur(recs["b"])
    assert selfs[a.id] == dur(recs["a"]) - dur(recs["a.inner"]) > 1_000_000
    assert sum(selfs[recs[n]["id"]] for n in ("call", "a", "a.inner", "b")) == dur(recs["call"])


def test_self_time_counts_overlapping_children_once():
    spans = [
        {"name": "p", "id": 1, "parent": 0, "start_ns": 0, "end_ns": 100},
        {"name": "w", "id": 2, "parent": 1, "start_ns": 10, "end_ns": 50},
        {"name": "w", "id": 3, "parent": 1, "start_ns": 30, "end_ns": 70},
        {"name": "w", "id": 4, "parent": 1, "start_ns": 90, "end_ns": 120},
    ]
    assert profiling.self_ns(spans) == {1: 30, 2: 40, 3: 40, 4: 30}


def test_worker_spans_take_an_explicit_parent():
    seen = []

    def work(parent):
        with profiling.span("w", parent=parent):
            seen.append(profiling.current().parent)
            time.sleep(0.001)

    with profiling.tracing():
        with profiling.stage("outer") as outer:
            workers = [threading.Thread(target=work, args=(outer,)) for _ in range(3)]
            for t in workers:
                t.start()
            for t in workers:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in workers)
    recs = by_name(profiling.read_store()["spans"])
    assert len(recs["w"]) == 3 and seen == [outer.id] * 3
    assert all(r["parent"] == outer.id and r["root"] == outer.root for r in recs["w"])
    assert {r["tid"] for r in recs["w"]}.isdisjoint({outer.tid})
    assert [n for n, _ in profiling.drain_stages()] == ["outer"]


def test_decode_workers_record_one_span_a_row_group(tmp_path):
    emb = np.random.default_rng(3).standard_normal((1000, 6)).astype(np.float32)
    path = str(tmp_path / "rows.parquet")
    write_embedding_parquet(path, emb, row_group_size=300)
    leaf_idx, leaf, rgs = pages.embedding_leaf_meta(path, EmbeddingColumn("embedding"))
    with profiling.stage("build.decode+transfer") as parent:
        got = list(pages.decode_row_groups(
            path, rgs, leaf_idx, leaf, workers=2, column=EmbeddingColumn("embedding"),
            span=lambda: profiling.stage("build.decode", parent=parent, drain=False)))
    np.testing.assert_array_equal(np.concatenate(got), emb)
    decode = by_name(profiling.read_store()["spans"])["build.decode"]
    assert len(decode) == len(rgs) == 4
    assert all(r["parent"] == parent.id for r in decode)
    assert [n for n, _ in profiling.drain_stages()] == ["build.decode+transfer"]


def test_the_store_keeps_the_newest_spans_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 4)
    profiling.clear_store()
    with profiling.tracing():
        for i in range(10):
            with profiling.span(f"s{i}"):
                pass
    st = profiling.read_store()
    assert [r["name"] for r in st["spans"]] == ["s6", "s7", "s8", "s9"]
    assert st["dropped"] == 6
    profiling.clear_store()
    assert profiling.read_store() == {"spans": [], "dropped": 0, "counters": {}}
    monkeypatch.undo()
    profiling.clear_store()


def test_tracing_off_retains_nothing_and_leaves_the_stages_as_they_were(tmp_path):
    searcher, x = tiny_searcher()
    before = profiling.read_store()
    assert [r["name"] for r in before["spans"]] == ["searcher.init"]
    assert profiling.span("search") is profiling.span("other")  # one shared no-op
    for i in range(10_000):
        searcher.search(x[i % 64 : i % 64 + 1], 5, 2)
    assert profiling.read_store() == before
    assert profiling.device_counter("k4", ("a", "b"), torch.device("cpu"), 1) is None
    path = str(tmp_path / "rows.parquet")
    write_embedding_parquet(path, x, row_group_size=100)
    profiling.drain_stages()
    IndexBuilder(path, "embedding", device="cpu").n_clusters(4).build_inplace()
    assert [n for n, _ in profiling.drain_stages()] == BUILD_STAGES
    spans = profiling.read_store()["spans"]
    # the stages, and the build's spans in them (not drained); no counter
    assert [r["name"] for r in spans] == ["searcher.init"] + BUILD_STAGES[:2] + [
        "build.train.seed", "build.train.lloyd"] + BUILD_STAGES[2:]
    assert all(r["counters"] == {} for r in spans)


def test_one_search_call_gives_the_spans_of_each_layer_once_under_one_root():
    searcher, x = tiny_searcher()
    profiling.clear_store()
    with profiling.tracing():
        searcher.search(x[:3], 5, 2, mode="auto")
    spans = profiling.read_store()["spans"]
    assert sorted(r["name"] for r in spans) == SEARCH_SPANS
    root = by_name(spans)["search"][0]
    assert root["parent"] == 0 and root["counters"] == {"rows": 256}
    assert all(r["parent"] == root["id"] and r["root"] == root["id"]
               for r in spans if r is not root)
    selfs = profiling.self_ns(spans)
    assert sum(selfs.values()) == dur(root)


def test_a_pallas_search_call_gives_k4s_spans_once_under_one_root():
    searcher, x = tiny_searcher()
    profiling.clear_store()
    with profiling.tracing():
        searcher.search(x[:3], 5, 2, mode="pallas")
    spans = profiling.read_store()["spans"]
    assert sorted(r["name"] for r in spans) == K4_SEARCH_SPANS
    root = by_name(spans)["search"][0]
    assert all(r["parent"] == root["id"] for r in spans if r is not root)
    assert sum(profiling.self_ns(spans).values()) == dur(root)


def test_build_spans_on_the_cpu():
    rows = np.random.default_rng(1).standard_normal((500, 4)).astype(np.float32)
    with profiling.stage("build.train") as train:
        k_means(rows, KMeansParams(8, 5), device="cpu")
    assert [n for n, _ in profiling.drain_stages()] == ["build.train"]
    recs = by_name(profiling.read_store()["spans"])
    seed, lloyd = recs["build.train.seed"][0], recs["build.train.lloyd"][0]
    assert seed["parent"] == lloyd["parent"] == train.id
    assert train.start_ns <= seed["start_ns"] <= seed["end_ns"] <= lloyd["start_ns"]
    assert lloyd["end_ns"] <= train.end_ns


def test_device_counter_folds_into_host_totals(monkeypatch):
    monkeypatch.setattr(profiling, "FOLD_CALLS", 3)
    cpu = torch.device("cpu")
    with profiling.tracing():
        with profiling.span("scan") as scan:
            taken = [profiling.device_counter("k4", ("k4.tiles", "k4.chunks"), cpu, 10)
                     for _ in range(7)]
            for t in taken:
                t += torch.tensor([1, 5], dtype=torch.int32)
        near = profiling.device_counter("big", ("big.n",), cpu, (1 << 31) - 10)
        again = profiling.device_counter("big", ("big.n",), cpu, 100)
    assert len({t.data_ptr() for t in taken}) == 3  # a fresh one every 3 launches
    assert near is not again  # no room left for 100 more
    assert scan.counters == {"k4.launches": 7}
    st = profiling.read_store()
    assert st["counters"] == {"k4.tiles": 7, "k4.chunks": 35, "big.n": 0}
    assert profiling.read_store()["counters"] == st["counters"]  # folded once


def test_span_and_record_function_agree_on_the_exported_clock(tmp_path):
    """Five 10 ms sleeps inside a span and a ``record_function`` of the same
    name: the best of each edge within 100 us on the trace's clock."""
    with profiling.device_trace(str(tmp_path)):
        with torch.profiler.record_function("warm-up"):
            pass
        for i in range(5):
            with profiling.span(f"sleep{i}"):
                with torch.profiler.record_function(f"sleep{i}"):
                    time.sleep(0.01)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    starts, ends = [], []
    for i in range(5):
        mine = [e for e in events if e.get("name") == f"sleep{i}"]
        sp = next(e for e in mine if e.get("cat") == "program_span")
        rf = next(e for e in mine if e.get("cat") == "user_annotation")
        starts.append(abs(sp["ts"] - rf["ts"]))
        ends.append(abs(sp["ts"] + sp["dur"] - rf["ts"] - rf["dur"]))
    assert min(starts) < 100 and min(ends) < 100, (starts, ends)


def test_device_trace_writes_one_trace_with_the_profile_and_the_spans(tmp_path):
    searcher, x = tiny_searcher()
    with profiling.device_trace(str(tmp_path)):
        searcher.search(x[:2], 5, 2)
    assert [p.name for p in tmp_path.iterdir()] == ["trace.json"]
    trace = json.loads((tmp_path / "trace.json").read_text())
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert "cpu_op" in cats and "program_span" in cats
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in spans) == SEARCH_SPANS
    root = next(e for e in spans if e["name"] == "search")
    assert root["args"]["rows"] == 256 and root["args"]["parent"] == 0
    assert all(e["args"]["root"] == root["args"]["id"] for e in spans)
    assert trace["programSpansDropped"] == 0 and trace["programCounters"] == {}
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    # every op inside the call's span, to the clock test's 100 us
    assert root["ts"] - 100 <= min(e["ts"] for e in ops)
    assert max(e["ts"] + e["dur"] for e in ops) <= root["ts"] + root["dur"] + 100


@pytest.mark.parametrize("command", ["build", "search"])
def test_the_cli_writes_a_trace_where_the_directory_is_set(tmp_path, monkeypatch, command):
    x = np.random.default_rng(5).standard_normal((300, 8)).astype(np.float32)
    path = tmp_path / "rows.parquet"
    write_embedding_parquet(str(path), x, row_group_size=100)
    build = ["build", str(path), "--n-clusters", "4", "--device", "cpu"]
    argv = build if command == "build" else [
        "search", str(path), "--device", "cpu", "--device-mode", "auto", "-k", "3"]
    if command == "search":
        assert main(build) == 0
    monkeypatch.setenv("PQVECTOR_TPU_TRACE_DIR", str(tmp_path / "trace"))
    assert main(argv) == 0
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "program_span"}
    want = {"build.index", "build.train.seed", "build.append"} if command == "build" else {
        "searcher.init", "search", "search.scan"}
    assert want <= names
