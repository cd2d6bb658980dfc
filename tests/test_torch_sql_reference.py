"""The port's SQL front door (``engine.Session``: the host path and the
resident searcher's) against the plain reference of the SQL semantics
(``pqbench/reference/sql.py``: f64, from the file's rows and its embedded
index) on seeded rows in a page-indexed file, and the ``sql`` span tree the
query records while tracing is on."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import pqvector_tpu_torch.engine as tengine
from pqbench.reference import payload as payload_fmt
from pqbench.reference.compare import AMBIGUOUS
from pqbench.reference.sql import SqlReference
from pqvector_tpu_torch.builder import IndexBuilder
from pqvector_tpu_torch.engine.exec import VectorTopKExec
from pqvector_tpu_torch.utils import profiling

N, DIM, CLUSTERS, NPROBE, K, MIN_ID = 4096, 32, 16, 4, 10, 2048
QUERIES = 12
#: The engine's ``dist`` is the square root of an f32 sum of 32 squared
#: differences (each rounding <= 2^-24 of the sum, so < 2e-6 in all, and
#: half that after the root); the reference's is f64.
DIST_RTOL = 1e-5


@pytest.fixture(scope="module", params=["plain", "dictionary"])
def indexed(tmp_path_factory, request):
    """4,096 x 32 rows of 8 seeded modes, pages of 64 rows with an offset
    index, IVF-16 by the port's build. ``plain``: PLAIN pages;
    ``dictionary``: the writer's default, every page dictionary-encoded. The
    page reader serves both page-exact."""
    rng = np.random.default_rng(11)
    modes = rng.uniform(-1, 1, (8, DIM)).astype(np.float32)
    rows = (modes[rng.integers(0, 8, N)] + 0.15 * rng.standard_normal((N, DIM))).astype(np.float32)
    queries = (modes[rng.integers(0, 8, QUERIES)]
               + 0.15 * rng.standard_normal((QUERIES, DIM))).astype(np.float32)
    path = str(tmp_path_factory.mktemp("sqlref") / f"{request.param}.parquet")
    vec = pa.ListArray.from_arrays(pa.array(np.arange(N + 1, dtype=np.int32) * DIM),
                                   pa.array(rows.reshape(-1), pa.float32()))
    pq.write_table(pa.table({"id": pa.array(np.arange(N)), "embedding": vec}), path,
                   compression="snappy", write_page_index=True, row_group_size=1024,
                   data_page_size=64 * DIM * 4, write_batch_size=64,
                   use_dictionary=request.param == "dictionary")
    IndexBuilder(path, "embedding", device="cpu").n_clusters(CLUSTERS).build_inplace()
    payload = payload_fmt.read_payload(path, payload_fmt.footer_offset(path))
    ref = SqlReference(torch.from_numpy(rows), np.arange(N), payload, MIN_ID)
    return path, queries, ref, request.param


def _session(path, dtype=None):
    s = tengine.Session(tengine.VectorTopKOptions(nprobe=NPROBE), device="cpu")
    s.register_parquet("t", path)
    if dtype is not None:
        s.device_searcher("t", dtype=dtype)
    return s


def _sql(q, where):
    lit = ", ".join(repr(float(v)) for v in q)
    return (f"SELECT id, array_distance(embedding, [{lit}]) AS dist FROM t {where} "
            f"ORDER BY dist LIMIT {K}")


def _resident(df):
    node = next(n for n in _walk(df.physical_plan()) if isinstance(n, VectorTopKExec))
    return node.metrics.value("resident_candidates")


def _walk(plan):
    yield plan
    for child in plan.children():
        yield from _walk(child)


@pytest.mark.parametrize("where", ["", f"WHERE id >= {MIN_ID}"], ids=["plain", "filtered"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16+f32"])
def test_sql_paths_equal_the_reference(indexed, dtype, where):
    path, queries, ref, _ = indexed
    filtered = bool(where)
    q = torch.from_numpy(queries)
    d2, ids, passing, _, cd2, _ = ref.answer(q, filtered, K, NPROBE)
    ambiguous = (cd2[:, NPROBE] - cd2[:, NPROBE - 1]) <= AMBIGUOUS * cd2[:, NPROBE - 1]
    assert not bool(ambiguous.any())  # every query's probe is the reference's
    host, resident = _session(path), _session(path, dtype)
    for i, qv in enumerate(queries):
        want = int(min(K, int(passing[i])))
        for session, on_device in ((host, False), (resident, True)):
            df = session.sql(_sql(qv, where))
            table = df.collect()
            assert (_resident(df) > 0) == on_device
            assert table.column("id").to_pylist() == ids[i, :want].tolist()
            np.testing.assert_allclose(table.column("dist").to_numpy(),
                                       d2[i, :want].sqrt().numpy(), rtol=DIST_RTOL)
    got = [(t.column("id").to_numpy(), t.column("dist").to_numpy())
           for t in (resident.sql(_sql(qv, where)).collect() for qv in queries)]
    numbers, _, recall = ref.judge(q, np.full(QUERIES, filtered), got, K, NPROBE)
    assert numbers["sql_faults"] == 0 and numbers["select_gap"] == 0
    assert numbers["dist_err"] < DIST_RTOL and 0 < recall <= 1


def test_sql_span_tree_and_counters(indexed):
    path, queries, _, layout = indexed
    session = _session(path, torch.bfloat16)
    profiling.clear_store()
    with profiling.tracing():
        table = session.sql(_sql(queries[3], f"WHERE id >= {MIN_ID}")).collect()
    st = profiling.read_store()
    roots = [s for s in st["spans"] if s["name"] == "sql" and not s["parent"]]
    assert len(roots) == 1
    root = roots[0]
    mine = [s for s in st["spans"] if s["root"] == root["id"]]
    by_id = {s["id"]: s for s in mine}

    def under(span, name):
        while span["parent"]:
            span = by_id[span["parent"]]
            if span["name"] == name:
                return True
        return False

    names = {s["name"] for s in mine}
    assert {"sql.plan", "sql.search", "sql.fetch", "sql.topk", "search"} <= names
    assert all(under(s, "sql.search") for s in mine if s["name"] == "search")
    assert [s["parent"] for s in mine if s["name"] == "sql.plan"] == [root["id"]]
    assert root["start_ns"] == next(s for s in mine if s["name"] == "sql.plan")["start_ns"]
    c = root["counters"]
    assert c["rows"] == table.num_rows == K
    assert c["rounds"] >= 1 and c["candidates"] >= K
    if layout == "plain":
        assert c["pages"] >= 1 and c["page_bytes"] > c["pages"] * 1024
        assert c["dict_pages"] == c["dict_bytes"] == 0
    else:  # every data page dictionary-encoded, each decoded page-exact
        assert c["pages"] >= 1 and c["dict_pages"] >= 1
        assert c["dict_pages"] == c["pages"] and c["dict_bytes"] > 0
    selfs = profiling.self_ns(mine)
    assert sum(selfs[s["id"]] for s in mine) == root["end_ns"] - root["start_ns"]


@pytest.mark.parametrize("fault", ["none", "moved", "listed_twice", "missing"])
def test_reference_checks_the_index_lists(indexed, fault):
    """The reference holds the program's index to the rows: each row listed
    once, in its f64 nearest cluster up to a near tie; anything else is a
    fault, counted in every judgement's ``sql_faults``."""
    path, queries, _, _ = indexed
    payload = payload_fmt.read_payload(path, payload_fmt.footer_offset(path))
    rows = torch.from_numpy(np.stack(
        pq.read_table(path, columns=["embedding"]).column("embedding").to_numpy(
            zero_copy_only=False)).astype(np.float32))
    row_ids, sizes = payload["row_ids"].copy(), payload["sizes"].copy()
    starts = np.concatenate([[0], np.cumsum(sizes)])
    at = int(np.flatnonzero(row_ids == 0)[0])
    src = int(np.searchsorted(starts, at, side="right") - 1)
    cents = payload["centroids"].astype(np.float64)
    far = int(np.argmax(((cents - rows[0].double().numpy()) ** 2).sum(axis=1)))
    lists = [list(row_ids[starts[c]:starts[c + 1]]) for c in range(len(sizes))]
    if fault == "moved":
        lists[src].remove(0)
        lists[far].append(0)
    elif fault == "listed_twice":
        lists[far].append(0)
    elif fault == "missing":
        lists[src].remove(0)
    bad = dict(payload, row_ids=np.array(sum(lists, []), dtype=np.int64),
               sizes=np.array([len(l) for l in lists], dtype=np.int64))
    ref = SqlReference(rows, np.arange(N), bad, MIN_ID)
    assert ref.index_faults == (0 if fault == "none" else 1)
    numbers, info, _ = ref.judge(torch.from_numpy(queries[:0]), np.zeros(0, bool), [], K, NPROBE)
    assert numbers["sql_faults"] == ref.index_faults == info["index_faults"]


def _write_rows(path, rows, **kw):
    n, dim = rows.shape
    vec = pa.ListArray.from_arrays(pa.array(np.arange(n + 1, dtype=np.int32) * dim),
                                   pa.array(rows.reshape(-1), pa.float32()))
    pq.write_table(pa.table({"id": pa.array(np.arange(n)), "embedding": vec}), path,
                   compression="snappy", write_page_index=True, row_group_size=512,
                   data_page_size=32 * dim * 4, write_batch_size=32, **kw)


@pytest.mark.parametrize("remote", [False, True], ids=["local", "remote"])
def test_dictionary_pages_are_served_page_exact(tmp_path, monkeypatch, remote):
    """A file whose row groups start on dictionary-encoded pages (the
    writer's default: the dictionary fills and the rest falls back to PLAIN)
    is served page-exact by the engine: no query reads its ``embedding``
    column's row groups whole, and every table, on the host path and the
    resident one, equals the one a PLAIN copy of the file gives."""
    from pqvector_tpu_torch.engine.object_store import MemoryStore

    n, dim = 2048, 16
    rng = np.random.default_rng(5)
    modes = rng.uniform(-1, 1, (8, dim)).astype(np.float32)
    rows = (modes[rng.integers(0, 8, n)] + 0.15 * rng.standard_normal((n, dim))).astype(np.float32)
    queries = (modes[rng.integers(0, 8, 6)] + 0.15 * rng.standard_normal((6, dim))).astype(np.float32)
    sessions = {}
    for layout in ("plain", "dictionary"):
        path = str(tmp_path / f"{layout}.parquet")
        _write_rows(path, rows, use_dictionary=layout == "dictionary",
                    dictionary_pagesize_limit=8 << 10)
        IndexBuilder(path, "embedding", device="cpu").n_clusters(8).build_inplace()
        store = MemoryStore({path: open(path, "rb").read()}) if remote else None
        for resident in (False, True):
            s = tengine.Session(tengine.VectorTopKOptions(nprobe=3), device="cpu",
                                **({"object_store": store} if remote else {}))
            s.register_parquet("t", path)
            if resident:
                s.device_searcher("t", dtype=torch.float32)
            sessions[layout, resident] = s
    reads = []
    real = pq.ParquetFile.read_row_group

    def read_row_group(self, i, columns=None, **kw):
        reads.append(tuple(columns or ["*"]))
        return real(self, i, columns=columns, **kw)

    monkeypatch.setattr(pq.ParquetFile, "read_row_group", read_row_group)
    counters = []
    for q in queries:
        lit = ", ".join(repr(float(v)) for v in q)
        for where in ("", "WHERE id >= 1024"):
            text = (f"SELECT id, embedding, array_distance(embedding, [{lit}]) AS dist "
                    f"FROM t {where} ORDER BY dist LIMIT {K}")
            for resident in (False, True):
                want = sessions["plain", resident].sql(text).collect()
                with profiling.tracing():
                    with profiling.span("query") as root:
                        got = sessions["dictionary", resident].sql(text).collect()
                counters.append(root.counters)
                assert got.num_rows == want.num_rows > 0
                assert got.equals(want)
                np.testing.assert_array_equal(
                    np.stack(got.column("embedding").to_numpy(zero_copy_only=False)),
                    rows[got.column("id").to_numpy()])
    assert not [c for c in reads if "embedding" in c or "*" in c]
    assert all(c["pages"] >= 1 for c in counters)
    assert sum(c["dict_pages"] for c in counters) >= 1
    assert sum(c["pages"] - c["dict_pages"] for c in counters) >= 1


@pytest.mark.parametrize("counted", [False, True], ids=["parent", "dict_pages"])
def test_dict_pages_reader(counted):
    """The benchmark's ``sql.dict_pages`` reads the ``dict_pages`` counter of
    the traced queries' root ``sql`` spans, a mean a query; a program whose
    page reader keeps no such counter gives None, as one without spans does."""
    from pathlib import Path

    from pqbench import spans
    from pqbench.harness import Bench

    read = Bench(Path(__file__).resolve().parents[1]).reader("sql.dict_pages")
    store = []
    for i, n in enumerate((0, 3)):
        counters = {"rows": K, "pages": 9, **({"dict_pages": n} if counted else {})}
        store.append({"name": "sql", "id": i + 1, "parent": 0, "root": i + 1, "tid": 1,
                      "start_ns": i * 100, "end_ns": i * 100 + 50, "counters": counters})
    try:
        spans.use(None)
        assert read({}) is None
        spans.use({"spans": store, "dropped": 0, "counters": {}})
        assert read({}) == (1.5 if counted else None)
    finally:
        spans.use(spans._UNREAD)
