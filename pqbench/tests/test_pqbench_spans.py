"""The readers of the program's spans and counters (``pqbench/spans.py`` and
``metrics/``) on synthetic span stores, and on the store of a tiny traced
run on the CPU."""

import json
from pathlib import Path

import pytest

import pqvector_tpu_torch.kernels.score_tile  # noqa: F401 - the readers look up CHUNK_ROWS
from pqbench import spans
from pqbench.harness import Bench
from pqbench.tests.tiny import make_root, run_tiny

REPO = Path(__file__).resolve().parents[2]
SEARCH_MS = ["search.self_ms", "search.upload_ms", "search.probe_ms", "search.scan_ms",
             "search.merge_ms", "search.refine_ms"]
NEW = SEARCH_MS + ["search.k4_rows_read_pct", "setup.searcher_s", "build.seed_s",
                   "build.lloyd_s", "build.decode_s", "build.k1_rescored_pct"]


def reader(name):
    return Bench(REPO).reader(name)


@pytest.fixture(autouse=True)
def no_store():
    yield
    spans.use(spans._UNREAD)


class Store:
    """Builds a synthetic store, ids in order."""

    def __init__(self):
        self.spans, self.counters = [], {}

    def add(self, name, start, end, parent=None, **counters):
        sid = len(self.spans) + 1
        root = sid if parent is None else parent["root"]
        s = {"name": name, "id": sid, "parent": 0 if parent is None else parent["id"],
             "root": root, "tid": 1, "start_ns": start, "end_ns": end, "counters": counters}
        self.spans.append(s)
        return s

    def use(self):
        spans.use({"spans": self.spans, "dropped": 0, "counters": self.counters})


def search_call(st, t0, rows=1000, k4=True):
    """A call of 1 ms: upload 0.1, probe 0.1, scan 0.3, merge 0.2, refine 0.1;
    0.2 ms of its own."""
    ms = 1_000_000
    root = st.add("search", t0, t0 + ms, rows=rows)
    st.add("search.upload", t0 + 50_000, t0 + 150_000, root)
    st.add("search.probe", t0 + 150_000, t0 + 250_000, root)
    scan = st.add("search.scan", t0 + 250_000, t0 + 550_000, root,
                  **({"k4.launches": 1} if k4 else {}))
    st.add("search.merge", t0 + 600_000, t0 + 800_000, root)
    st.add("search.refine", t0 + 800_000, t0 + 900_000, root)
    return root, scan


def test_pqbench_search_readers_by_hand():
    st = Store()
    st.add("searcher.init", 0, 2_500_000_000)
    search_call(st, 3_000_000_000)
    search_call(st, 4_000_000_000)
    st.counters = {"k4.tiles": 100, "k4.chunks": 25}  # 25 x 128 rows over 2 x 1000
    st.use()
    got = {name: reader(name)({}) for name in SEARCH_MS}
    assert got == pytest.approx({"search.self_ms": 0.2, "search.upload_ms": 0.1,
                                 "search.probe_ms": 0.1, "search.scan_ms": 0.3,
                                 "search.merge_ms": 0.2, "search.refine_ms": 0.1})
    assert sum(got.values()) == pytest.approx(1.0)
    assert reader("search.k4_rows_read_pct")({}) == pytest.approx(100 * 25 * 128 / 2000)
    assert reader("setup.searcher_s")({}) == pytest.approx(2.5)


def test_pqbench_nested_search_spans_count_one_call():
    """A call inside a call (``autoscan``'s probe, the loops) is one call;
    its time still sums to the outer span's."""
    st = Store()
    root, _ = search_call(st, 0)
    inner = st.add("search", 910_000, 990_000, root, rows=1000)
    st.add("search.scan", 920_000, 960_000, inner)
    st.use()
    got = {name: reader(name)({}) for name in SEARCH_MS}
    assert got["search.scan_ms"] == pytest.approx(0.34)
    assert got["search.self_ms"] == pytest.approx(0.12 + 0.04)
    assert sum(got.values()) == pytest.approx(1.0)


def test_pqbench_k4_share_counts_only_the_calls_that_ran_k4():
    st = Store()
    search_call(st, 0, rows=1000)
    search_call(st, 2_000_000, rows=500, k4=False)  # K3's call: no K4 counter
    st.counters = {"k4.chunks": 10}
    st.use()
    assert reader("search.k4_rows_read_pct")({}) == pytest.approx(100 * 10 * 128 / 1000)
    st.counters = {}
    st.use()
    assert reader("search.k4_rows_read_pct")({}) is None


def test_pqbench_build_readers_by_hand():
    """Two builds of the window (their stages in the record) and one traced
    build after it: the build's span readers take the window's two."""
    st, record = Store(), {"stages": []}
    for b in range(3):
        t0, slow = b * 10**9, 2 if b == 2 else 1
        index = st.add("build.index", t0, t0 + 900_000_000)
        upload = st.add("build.decode+transfer", t0, t0 + 300_000_000 + b, index)
        for w in range(4):  # two workers, overlapping
            st.add("build.decode", t0 + w * 50_000_000,
                   t0 + w * 50_000_000 + slow * 100_000_000, upload)
        train = st.add("build.train", t0 + 300_000_000, t0 + 700_000_000 + b, index)
        st.add("build.train.seed", t0 + 310_000_000, t0 + 310_000_000 + slow * 190_000_000,
               train)
        st.add("build.train.lloyd", t0 + 500_000_000, t0 + 690_000_000, train)
        st.add("build.assign", t0 + 700_000_000, t0 + 710_000_000, index,
               **({"k1.rows": 1000, "k1.uncertified": 25} if b == 2 else {}))
        if b < 2:
            record["stages"].append({"build.decode+transfer": spans.seconds(upload),
                                     "build.train": spans.seconds(train)})
    st.use()
    assert reader("build.seed_s")(record) == pytest.approx(0.19)
    assert reader("build.lloyd_s")(record) == pytest.approx(0.19)
    assert reader("build.decode_s")(record) == pytest.approx(0.4)
    assert reader("build.k1_rescored_pct")(record) == pytest.approx(2.5)
    assert reader("build.seed_s")({"stages": []}) is None


def test_pqbench_span_readers_give_none_without_a_store():
    spans.use(None)
    assert all(reader(name)({}) is None for name in NEW)
    spans.use({"spans": [], "dropped": 0, "counters": {}})
    assert all(reader(name)({}) is None for name in NEW)


def test_pqbench_span_metrics_are_in_the_benchmark():
    entries = {m["name"]: m for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]}
    search = ["sift1m.search.b256", "ref1024.search.b256", "sift1m.search.b1"]
    for name in NEW:
        assert (REPO / "pqbench/metrics" / f"{name}.py").is_file()
        assert entries[name]["workloads"] == (search if name.startswith(("search", "setup"))
                                              else ["sift1m.build"])


def test_pqbench_tiny_traced_search_reads_the_program_spans(tmp_path):
    """A traced tiny search run on the CPU: every search metric but K4's
    share (no card, no counter) reads, and the six sum to the call's span."""
    from pqvector_tpu_torch.utils import profiling

    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    real = json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
    bench["per_layer"] += [dict(m, workloads=["tiny.search"]) for m in real
                           if m["name"] in SEARCH_MS + ["setup.searcher_s"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    profiling.clear_store()
    spans.use(spans._UNREAD)
    result, _ = run_tiny(root, "tiny.search", trace=True)
    got = {name: result["metrics"][name]["value"] for name in SEARCH_MS}
    assert all(v > 0 for v in got.values()) and result["metrics"]["setup.searcher_s"]["value"] > 0
    st = spans.store()
    calls = spans.search_calls(st)
    mean_ms = sum(c["end_ns"] - c["start_ns"] for c in calls) / len(calls) / 1e6
    assert sum(got.values()) == pytest.approx(mean_ms, rel=1e-9)
    profiling.clear_store()
