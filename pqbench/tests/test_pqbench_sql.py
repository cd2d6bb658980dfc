"""The SQL cell (``drivers/sql_loop.py``, ``reference/sql.py``, the
``sql.*`` readers) at a tiny size on the CPU: the sound program reads
``correct``, each planted fault and a call the host path serves do not, and
the readers give None without the program's spans and numbers with them."""

import importlib.util
import json
from pathlib import Path

import pytest

import pqvector_tpu_torch
from pqbench import spans
from pqbench.harness import Bench
from pqbench.tests.tiny import make_root, run_tiny
from pqvector_tpu_torch.engine import exec as texec

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny.sql"
READERS = ["sql.plan_ms", "sql.search_ms", "sql.fetch_ms", "sql.topk_ms", "sql.pages_read"]
#: A chunk's first 64 rows on one dictionary-encoded page, then PLAIN pages,
#: as the writer's 1 MiB dictionary leaves the first ~2,000 rows of a 128-d
#: row group at the cell's size.
CONFIG = {
    "name": "tiny-sql", "source": "a test", "rows": 6000, "dim": 16, "metric": "l2",
    "n_clusters": 24, "kmeans_iters": 8, "kmeans_seed": 42, "storage": "bfloat16",
    "rescore": "auto", "nprobe": 4, "max_candidates": None,
    "data": {"kind": "gaussian_mixture", "modes": 8, "noise": 0.15},
    "file": {"row_group_rows": 2048, "compression": "snappy", "data_page_bytes": 4096,
             "offset_index": True, "dictionary_page_bytes": 4096},
    "assumed": [], "reduced": [],
}
TRAFFIC = {"driver": "sql_loop", "k": 5, "filtered_share": 0.5, "filter_min_id": 3000,
           "pool_queries": 64, "warmup_calls": 2, "trace_seconds": 0.3}
#: At this size the program's select_gap reads 0 on seeds 7-9 and the
#: no_rescore fault's 0.015-0.022.
LIMITS = {"dist_err": {"limit": 1e-5}, "select_gap": {"limit": 0.005},
          "sql_faults": {"limit": 0}}


def calibrate_script():
    spec = importlib.util.spec_from_file_location("sql_calibrate",
                                                  REPO / "scripts/sql_calibrate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_sql_root(tmp: Path) -> Path:
    """The tiny benchmark root with the cell ``tiny.sql`` added."""
    root = make_root(tmp)
    (root / "pqbench/configs/tiny-sql.json").write_text(json.dumps(CONFIG))
    (root / "pqbench/traffic/tiny-sql.json").write_text(json.dumps(TRAFFIC))
    (root / f"pqbench/limits/{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-sql", "source": "a test",
                             "file": "pqbench/configs/tiny-sql.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny-sql", "traffic": "tiny-sql",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"]:
        if m["name"] in ("qps", "p95_ms", "recall_at_k"):
            m["workloads"].append(CELL)
    bench["per_layer"] += [
        {"name": name, "unit": "count" if name == "sql.pages_read" else "ms",
         "better": "lower", "source": "program_span",
         "layer": "SQL engine", "moves": "qps", "workloads": [CELL]} for name in READERS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(autouse=True)
def no_store():
    yield
    spans.use(spans._UNREAD)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_sql_root(tmp_path_factory.mktemp("sql"))


def test_pqbench_sql_cell_is_correct_and_traced(root):
    import pqvector_tpu_torch.utils.profiling as profiling

    profiling.clear_store()
    spans.use(spans._UNREAD)
    result, rows = run_tiny(root, CELL, trace=True)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    checks = result["checks"]
    assert checks["sql_faults"]["value"] == 0
    assert checks["dist_err"]["value"] < 1e-6
    got = {name: result["metrics"][name]["value"] for name in READERS}
    assert all(v > 0 for v in got.values()), got
    st = spans.store()
    roots = [s for s in st["spans"] if s["name"] == "sql" and not s["parent"]]
    mean_ms = sum(s["end_ns"] - s["start_ns"] for s in roots) / len(roots) / 1e6
    parts = sum(got[name] for name in READERS[:4])
    assert parts <= mean_ms * (1 + 1e-9)
    assert all(s["counters"]["rounds"] >= 1 and s["counters"]["rows"] == 5 for s in roots)


@pytest.mark.parametrize("fault", ["fail_predicate", "drop_kth", "no_rescore"])
def test_pqbench_sql_planted_fault_is_not_correct(root, fault, monkeypatch):
    calibrate_script().plant(pqvector_tpu_torch, fault, monkeypatch.setattr)
    result, rows = run_tiny(root, CELL)
    assert result["correct"] is False
    over = {name for name, value, limit in rows if value > limit}
    assert over == ({"select_gap"} if fault == "no_rescore" else
                    {"sql_faults", "dist_err", "select_gap"})


def test_pqbench_sql_call_on_the_host_path_counts_as_failed(root, monkeypatch):
    monkeypatch.setattr(texec.VectorTopKExec, "_try_resident", lambda self, ctx: None)
    result, _ = run_tiny(root, CELL)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0


def test_pqbench_sql_readers_without_and_with_spans():
    for st in (None, {"spans": [], "dropped": 0, "counters": {}}):  # no store; no sql spans
        spans.use(st)
        for name in READERS:
            assert Bench(REPO).reader(name)({}) is None
    ms = 1_000_000
    store = []

    def add(name, start, end, parent=None, **counters):
        sid = len(store) + 1
        store.append({"name": name, "id": sid, "parent": parent["id"] if parent else 0,
                      "root": parent["root"] if parent else sid, "tid": 1,
                      "start_ns": start, "end_ns": end, "counters": counters})
        return store[-1]

    for t0, pages in ((0, 10), (100 * ms, 30)):  # two queries of 40 ms
        root = add("sql", t0, t0 + 40 * ms, rows=10, rounds=1, pages=pages)
        add("sql.plan", t0, t0 + 2 * ms, root)
        search = add("sql.search", t0 + 3 * ms, t0 + 4 * ms, root)
        add("search", t0 + 3 * ms, t0 + 4 * ms, search)  # nests; counted in search whole
        fetch = add("sql.fetch", t0 + 5 * ms, t0 + 35 * ms, root)
        add("sql.topk", t0 + 30 * ms, t0 + 31 * ms, fetch)  # the predicate, inside the scan
        add("sql.topk", t0 + 36 * ms, t0 + 38 * ms, root)
    add("searcher.init", 0, 5 * ms)  # another root: not a query
    spans.use({"spans": store, "dropped": 0, "counters": {}})
    got = {name: Bench(REPO).reader(name)({}) for name in READERS}
    assert got == pytest.approx({"sql.plan_ms": 2.0, "sql.search_ms": 1.0,
                                 "sql.fetch_ms": 29.0, "sql.topk_ms": 3.0,
                                 "sql.pages_read": 20.0})
