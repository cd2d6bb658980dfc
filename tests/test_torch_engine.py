"""The port's SQL engine against the JAX package's on the same files.

Every file is written from a numpy seed and indexed once by the JAX
package; the same SQL then runs through ``pqvector_tpu.engine.Session`` and
``pqvector_tpu_torch.engine.Session(device="cpu")``. Results must carry the
same ids (and every other non-float value), floats within 1e-5 relative;
where the JAX package raises, the port raises the same class name with the
same message. The SQL forms are those of the JAX package's engine tests
(tests/test_engine.py, test_engine_edge_cases.py, test_engine_multifile.py,
test_engine_resident.py, test_engine_page_reads.py); the plan trees are held
to the committed snapshots in tests/snapshots/, which are only read here.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import pqvector_tpu.engine as jengine
import pqvector_tpu_torch.engine as tengine
from pqvector_tpu.builder import IndexBuilder as JIndexBuilder
from pqvector_tpu_torch.engine import exec as texec
from pqvector_tpu_torch.errors import PlanError

SNAPSHOT_DIR = os.path.join(os.path.dirname(__file__), "snapshots")
RTOL = 1e-5

END_TO_END_VECS = [[0.0, 0.0], [1.0, 0.0], [0.0, 2.0], [5.0, 5.0], [2.0, 2.0], [0.1, 0.1]]
FILTER_VECS = [[0.0, 0.0], [0.05, 0.05], [0.2, 0.2], [1.0, 1.0], [1.1, 1.1], [1.4, 1.4]]


def _write(path, vecs, n_clusters, ids=None, row_group_size=None, extra=None):
    vecs = [list(map(float, v)) for v in vecs]
    cols = {
        "id": pa.array(range(len(vecs)) if ids is None else ids, pa.int32()),
        **(extra or {}),
        "vec": pa.array(vecs, pa.list_(pa.float32())),
    }
    pq.write_table(pa.table(cols), path, row_group_size=row_group_size)
    JIndexBuilder(path, "vec").n_clusters(n_clusters).build_inplace()
    return str(path)


def _sessions(paths, options=None, enable=True, name="t"):
    out = []
    for eng, kw in ((jengine, {}), (tengine, {"device": "cpu"})):
        opts = eng.VectorTopKOptions(**(options or {}))
        s = eng.Session(opts, enable_vector_topk=enable, **kw)
        s.register_parquet(name, paths)
        out.append(s)
    return out


def _assert_same_table(got: pa.Table, want: pa.Table):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        typ = want.schema.field(name).type
        if pa.types.is_floating(typ) or (
            pa.types.is_list(typ) and pa.types.is_floating(typ.value_type)
        ):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=RTOL, atol=1e-7)
        else:
            assert g == w, name


def _run_both(paths, sql, options=None, enable=True):
    """-> (JAX table, port table, JAX df, port df), or the two exceptions."""
    js, ts = _sessions(paths, options, enable)
    jdf, tdf = js.sql(sql), ts.sql(sql)
    try:
        want = jdf.collect()
    except Exception as jexc:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(Exception) as texc:
            tdf.collect()
        assert type(texc.value).__name__ == type(jexc).__name__
        assert str(texc.value) == str(jexc)
        return None
    got = tdf.collect()
    _assert_same_table(got, want)
    assert tdf.explain() == jdf.explain()
    assert tdf.explain_tree() == jdf.explain_tree()
    return want, got, jdf, tdf


def _find_topk(plan):
    if plan.name == "VectorTopKExec":
        return plan
    for child in plan.children():
        found = _find_topk(child)
        if found is not None:
            return found
    return None


@pytest.fixture(scope="module")
def six(tmp_path_factory):
    root = tmp_path_factory.mktemp("six")
    return (_write(root / "e2e.parquet", END_TO_END_VECS, 2),
            _write(root / "filter.parquet", FILTER_VECS, 2))


# (fixture file, SQL, options, rewrite enabled) -- tests/test_engine.py
ENGINE_CASES = [
    ("e2e", "SELECT id, vec FROM t WHERE id >= 2 ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 2", {"nprobe": 64}, True),
    ("filter", "SELECT id FROM t WHERE id >= 3 ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 2", {"nprobe": 64}, True),
    ("e2e", "SELECT id FROM t WHERE id >= 2 ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 2", {}, False),
    ("e2e", "SELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0]) DESC LIMIT 2", {"nprobe": 64}, True),
    ("e2e", "SELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 2 OFFSET 1", {"nprobe": 64}, True),
    ("e2e", "SELECT id FROM t ORDER BY array_distance(vec2, [0.0, 0.0]) LIMIT 1", {"nprobe": 64}, True),
    ("e2e", "SELECT id FROM t ORDER BY id DESC LIMIT 3", {"nprobe": 64}, True),
    ("e2e", "SELECT id FROM t ORDER BY CAST(array_distance(vec, [0.0, 0.0]) AS float) LIMIT 2", {"nprobe": 64}, True),
    ("e2e", "SELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 6", {"nprobe": 64, "max_candidates": 3}, True),
    ("e2e", "SELECT id FROM t ORDER BY array_distance([0.0, 0.0], vec) LIMIT 1", {"nprobe": 64}, True),
    ("e2e", "SELECT * FROM t ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 1", {"nprobe": 64}, True),
    ("e2e", "SELECT id, array_distance(vec, [0.0, 0.0]) AS d FROM t ORDER BY d LIMIT 2", {}, False),
    ("e2e", "SELECT id, array_distance(vec, [0.0, 0.0]) AS d FROM t ORDER BY d LIMIT 3", {"nprobe": 1}, True),
    ("e2e", "SELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0, 0.0]) LIMIT 2", {"nprobe": 64}, True),
]


@pytest.mark.parametrize("case", range(len(ENGINE_CASES)))
def test_engine_forms_match_jax(six, case):
    which, sql, options, enable = ENGINE_CASES[case]
    path = six[0] if which == "e2e" else six[1]
    _run_both(path, sql, options, enable)


@pytest.fixture(scope="module")
def twenty(tmp_path_factory):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((20, 4)).astype(np.float32)
    extra = {"name": pa.array([f"n{i}" for i in range(20)]),
             "score": pa.array(rng.uniform(0, 1, 20))}
    return _write(tmp_path_factory.mktemp("edge") / "t.parquet", vecs, 4, extra=extra)


# tests/test_engine_edge_cases.py, at nprobe 4
EDGE_SQL = [
    "SELECT id FROM t LIMIT 3",
    "SELECT id FROM t ORDER BY score LIMIT 5",
    "SELECT id + 1 AS next_id FROM t LIMIT 2",
    "SELECT id FROM t WHERE (id >= 5 AND id < 8) OR id = 15 ORDER BY id",
    "SELECT id FROM t WHERE NOT id < 18 ORDER BY id",
    "SELECT id FROM t WHERE name = 'n7'",
    "SELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0, 0.0, 0.0]) LIMIT 0",
    "SELECT id FROM t WHERE id > 1000 ORDER BY array_distance(vec, [0.0, 0.0, 0.0, 0.0]) LIMIT 3",
    "SELECT magic(id) FROM t LIMIT 1",
    "SELECT id FROM t ORDER BY id LIMIT 5 OFFSET 17",
    "SELECT id, name, score FROM t WHERE score > 0.3 ORDER BY array_distance(vec, [0.5, -0.5, 0.25, 1.0]) LIMIT 4",
    "SELECT name AS who, array_distance(vec, [0.5, -0.5, 0.25, 1.0]) AS d FROM t ORDER BY d LIMIT 5",
]


@pytest.mark.parametrize("case", range(len(EDGE_SQL)))
def test_edge_cases_match_jax(twenty, case):
    _run_both(twenty, EDGE_SQL[case], {"nprobe": 4})


def test_parse_errors_match_jax(twenty):
    """A statement the parser refuses raises the same error in both."""
    js, ts = _sessions(twenty)
    for sql in ("DELETE FROM t", "SELECT id FROM"):
        with pytest.raises(Exception) as jexc:
            js.sql(sql).collect()
        with pytest.raises(Exception) as texc:
            ts.sql(sql).collect()
        assert type(texc.value).__name__ == type(jexc.value).__name__
        assert str(texc.value) == str(jexc.value)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi")
    rng = np.random.default_rng(0)
    return {
        "near": [_write(root / "a.parquet", [[0.0, 0.0], [4.0, 4.0], [8.0, 8.0]], 2, ids=[0, 1, 2]),
                 _write(root / "b.parquet", [[0.1, 0.1], [5.0, 5.0], [9.0, 9.0]], 2, ids=[10, 11, 12])],
        "budget": [_write(root / "c.parquet", rng.normal(0, 1, (10, 2)), 2, ids=list(range(10))),
                   _write(root / "d.parquet", rng.normal(0, 1, (10, 2)), 2, ids=list(range(100, 110)))],
    }


# tests/test_engine_multifile.py
MULTI_CASES = [
    ("near", "SELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 3", {"nprobe": 64}),
    ("budget", "SELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 20", {"nprobe": 64, "max_candidates": 4}),
    ("budget", "SELECT id, vec FROM t WHERE id >= 5 ORDER BY array_distance(vec, [0.2, 0.1]) LIMIT 6", {"nprobe": 1}),
]


@pytest.mark.parametrize("case", range(len(MULTI_CASES)))
def test_multifile_matches_jax(pair, case):
    which, sql, options = MULTI_CASES[case]
    _run_both(pair[which], sql, options)


def test_unindexed_file_among_indexed_fails_alike(tmp_path):
    a = _write(tmp_path / "a.parquet", [[0.0, 0.0], [2.0, 2.0]], 2)
    b = tmp_path / "b.parquet"
    pq.write_table(pa.table({"id": pa.array([9], pa.int32()),
                             "vec": pa.array([[1.0, 1.0]], pa.list_(pa.float32()))}), b)
    assert _run_both([a, str(b)], "SELECT id FROM t ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 1",
                     {"nprobe": 4}) is None


# ----------------------------------------------------------------------
# A few hundred rows, d = 8, row groups of 64 (tests/test_engine_resident.py)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("resident") / "data.parquet")
    offsets = pa.array(np.arange(401, dtype=np.int32) * 8)
    table = pa.table({"id": pa.array(np.arange(400)),
                      "vec": pa.ListArray.from_arrays(offsets, pa.array(x.reshape(-1)))})
    pq.write_table(table, path, row_group_size=64)
    JIndexBuilder(path, "vec").n_clusters(8).build_inplace()
    return path, x


def _query_sql(x, qrow, k=5, where="", cols="id"):
    q = ", ".join(f"{v:.6f}" for v in x[qrow])
    return f"SELECT {cols} FROM t {where} ORDER BY array_distance(vec, [{q}]) LIMIT {k}"


WHERES = ["", "WHERE id >= 200", "WHERE id < 3"]


@pytest.mark.parametrize("qrow", [0, 17, 123, 399])
@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_host_path_matches_jax_on_row_groups(indexed, qrow, nprobe):
    path, x = indexed
    sql = _query_sql(x, qrow, k=7, cols="id, array_distance(vec, [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]) AS d")
    _run_both(path, sql, {"nprobe": nprobe})


def _resident_ids(session, sql):
    df = session.sql(sql)
    table = df.collect()
    return table, _find_topk(df.physical_plan()).metrics.value("resident_candidates")


@pytest.mark.parametrize("where", WHERES)
def test_resident_matches_host_and_jax(indexed, where):
    path, x = indexed
    js, ts = _sessions(path, {"nprobe": 3})
    host = tengine.Session(tengine.VectorTopKOptions(nprobe=3), device="cpu")
    host.register_parquet("t", path)
    js.device_searcher("t")
    searcher = ts.device_searcher("t")
    assert searcher.device == torch.device("cpu")
    assert searcher._spill_dups is False and searcher._delta is None
    assert searcher._deleted_dev is None and searcher._id_domain == 400
    sql = _query_sql(x, 17, k=5, where=where)
    want, jres = _resident_ids(js, sql)
    got, tres = _resident_ids(ts, sql)
    plain, hres = _resident_ids(host, sql)
    assert jres > 0 and tres > 0 and hres == 0
    assert got.column("id").to_pylist() == plain.column("id").to_pylist()
    assert got.column("id").to_pylist() == want.column("id").to_pylist()


@pytest.mark.parametrize("where", ["", "WHERE id >= 200"])
def test_bf16_resident_with_reference_matches_host(indexed, where):
    path, x = indexed
    host = tengine.Session(tengine.VectorTopKOptions(nprobe=3), device="cpu")
    host.register_parquet("t", path)
    res = tengine.Session(tengine.VectorTopKOptions(nprobe=3), device="cpu")
    res.register_parquet("t", path)
    s = res.device_searcher("t", dtype=torch.bfloat16)
    assert s._emb_ref is not None and s.emb.dtype == torch.bfloat16
    sql = _query_sql(x, 17, k=5, where=where)
    got, tres = _resident_ids(res, sql)
    want, _ = _resident_ids(host, sql)
    assert tres > 0
    assert got.column("id").to_pylist() == want.column("id").to_pylist()


def test_bf16_resident_without_reference_falls_back(indexed):
    path, x = indexed
    s = tengine.Session(tengine.VectorTopKOptions(nprobe=3), device="cpu")
    s.register_parquet("t", path)
    s.device_searcher("t", dtype=torch.bfloat16, rescore_dtype=None)
    _, res = _resident_ids(s, _query_sql(x, 3, k=4))
    assert res == 0


def test_stale_searcher_is_not_served(indexed):
    """A searcher whose source_key no longer matches the file (a rewrite
    or re-index since it was built) leaves the query to the host path."""
    path, x = indexed
    s = tengine.Session(tengine.VectorTopKOptions(nprobe=3), device="cpu")
    s.register_parquet("t", path)
    searcher = s.device_searcher("t")
    sql = _query_sql(x, 9, k=4)
    fresh, fres = _resident_ids(s, sql)
    searcher.source_key = (searcher.source_key[0], searcher.source_key[1] - 1)
    stale, sres = _resident_ids(s, sql)
    assert fres > 0 and sres == 0
    assert stale.column("id").to_pylist() == fresh.column("id").to_pylist()
    # device_searcher sees the stale key and builds a new one.
    assert s.device_searcher("t") is not searcher


def test_max_candidates_disables_resident(indexed):
    path, x = indexed
    js, ts = _sessions(path, {"nprobe": 3, "max_candidates": 50})
    js.device_searcher("t")
    ts.device_searcher("t")
    sql = _query_sql(x, 9, k=4)
    want, _ = _resident_ids(js, sql)
    got, res = _resident_ids(ts, sql)
    assert res == 0
    assert got.column("id").to_pylist() == want.column("id").to_pylist()


def test_filter_escalation_reaches_exhaustion(indexed):
    path, x = indexed
    js, ts = _sessions(path, {"nprobe": 8})
    js.device_searcher("t")
    ts.device_searcher("t")
    sql = _query_sql(x, 50, k=5, where="WHERE id < 2")
    want, _ = _resident_ids(js, sql)
    got, res = _resident_ids(ts, sql)
    assert res > 0
    assert got.column("id").to_pylist() == want.column("id").to_pylist()
    assert got.num_rows <= 2


@pytest.fixture(scope="module")
def indexed_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("resident_multi")
    rng = np.random.default_rng(9)
    paths, xs = [], []
    for i, n in enumerate((300, 200)):
        x = rng.standard_normal((n, 8)).astype(np.float32)
        offsets = pa.array(np.arange(n + 1, dtype=np.int32) * 8)
        table = pa.table({"id": pa.array(np.arange(n) + 1000 * i),
                          "vec": pa.ListArray.from_arrays(offsets, pa.array(x.reshape(-1)))})
        p = str(root / f"f{i}.parquet")
        pq.write_table(table, p, row_group_size=64)
        JIndexBuilder(p, "vec").n_clusters(6).build_inplace()
        paths.append(p)
        xs.append(x)
    return paths, xs


@pytest.mark.parametrize("where", ["", "WHERE id >= 1000", "WHERE id < 3 OR id >= 1150"])
def test_multifile_resident_matches_host_and_jax(indexed_pair, where):
    paths, xs = indexed_pair
    qs = ", ".join(f"{v:.6f}" for v in xs[1][7])
    sql = f"SELECT id FROM t {where} ORDER BY array_distance(vec, [{qs}]) LIMIT 6"
    js, ts = _sessions(paths, {"nprobe": 4})
    host = tengine.Session(tengine.VectorTopKOptions(nprobe=4), device="cpu")
    host.register_parquet("t", paths)
    js.device_searcher("t")
    searchers = ts.device_searcher("t")
    assert isinstance(searchers, list) and len(searchers) == 2
    want, _ = _resident_ids(js, sql)
    got, res = _resident_ids(ts, sql)
    plain, _ = _resident_ids(host, sql)
    assert res > 0
    assert got.column("id").to_pylist() == plain.column("id").to_pylist()
    assert got.column("id").to_pylist() == want.column("id").to_pylist()


def test_device_rescore_matches_host_rescore(indexed, monkeypatch):
    """The large-candidate re-score in torch on the session's device ranks
    as the numpy loop does (its threshold lowered so 400 rows take it)."""
    path, x = indexed
    sql = _query_sql(x, 42, k=6, cols="id, array_distance(vec, [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]) AS d")
    off = tengine.Session(tengine.VectorTopKOptions(nprobe=8, use_device=False), device="cpu")
    off.register_parquet("t", path)
    want = off.sql(sql).collect()
    calls = []
    orig = texec._device_sqdist

    def spy(mat, q, device):
        calls.append(device)
        return orig(mat, q, device)

    monkeypatch.setattr(texec, "_DEVICE_THRESHOLD", 1)
    monkeypatch.setattr(texec, "_device_sqdist", spy)
    on = tengine.Session(tengine.VectorTopKOptions(nprobe=8, use_device=True), device="cpu")
    on.register_parquet("t", path)
    got = on.sql(sql).collect()
    assert calls and all(d == torch.device("cpu") for d in calls)
    _assert_same_table(got, want)


def test_session_device_searcher_cache_and_errors(indexed):
    path, x = indexed
    s = tengine.Session(tengine.VectorTopKOptions(nprobe=8), device="cpu")
    s.register_parquet("t", path)
    a = s.device_searcher("t", row_tile=64)
    assert s.device_searcher("t", row_tile=64) is a
    assert s.device_searcher("t") is not a
    _, ids = a.search(x[3], k=1, nprobe=8)
    assert int(ids[0, 0]) == 3
    with pytest.raises(PlanError, match="not registered"):
        s.device_searcher("missing")
    with pytest.raises(Exception, match="not ported"):
        s.device_searcher("t", spill=0.2)


# ----------------------------------------------------------------------
# Plan trees against the committed snapshots (tests/test_plan_snapshots.py,
# tests/test_engine_page_reads.py)
# ----------------------------------------------------------------------


def _snapshot(name):
    with open(os.path.join(SNAPSHOT_DIR, name + ".snap")) as f:
        return f.read()


@pytest.mark.parametrize("name,suffix,options", [
    ("vector_topk_filter_plan_tree",
     "WHERE id >= 2 ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 2", {"nprobe": 64}),
    ("vector_topk_plan_tree",
     "ORDER BY array_distance(vec, [0.0, 0.0]) LIMIT 2", {"nprobe": 64, "max_candidates": 2048}),
])
def test_plan_tree_equals_snapshot(six, name, suffix, options):
    s = tengine.Session(tengine.VectorTopKOptions(**options), device="cpu")
    s.register_parquet("t", six[0])
    df = s.sql(f"SELECT id FROM t {suffix}")
    df.collect()
    assert df.explain_tree() == _snapshot(name)
    assert "VectorTopKExec" in df.explain()


@pytest.fixture(scope="module")
def page_indexed(tmp_path_factory):
    """The JAX package's ``build_new`` output: offset indexes and small
    pages, so the rewritten scan reads candidate pages."""
    root = tmp_path_factory.mktemp("pages")
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((64, 4)).astype(np.float32)
    src, out = root / "src.parquet", root / "indexed.parquet"
    pq.write_table(pa.table({"id": pa.array(range(64), pa.int64()),
                             "vec": pa.array(list(vecs), pa.list_(pa.float32()))}),
                   src, row_group_size=16)
    JIndexBuilder(src, "vec").n_clusters(8).build_new(out)
    return str(out), vecs


def test_page_reads_tree_equals_snapshot(page_indexed):
    path, vecs = page_indexed
    s = tengine.Session(tengine.VectorTopKOptions(nprobe=1), device="cpu")
    s.register_parquet("t", path)
    lit = "[" + ",".join(str(float(v)) for v in vecs[3]) + "]"
    df = s.sql(f"SELECT id FROM t ORDER BY array_distance(vec, {lit}) LIMIT 2")
    df.collect()
    assert df.explain_tree() == _snapshot("vector_topk_page_reads_tree")


@pytest.mark.parametrize("qrow,nprobe,k", [(3, 4, 4), (10, 1, 2), (63, 8, 10)])
def test_page_reads_match_jax_and_fallback(page_indexed, qrow, nprobe, k, monkeypatch):
    path, vecs = page_indexed
    lit = "[" + ",".join(str(float(v)) for v in vecs[qrow]) + "]"
    sql = f"SELECT id, vec FROM t ORDER BY array_distance(vec, {lit}) LIMIT {k}"
    _, got, _, tdf = _run_both(path, sql, {"nprobe": nprobe})
    scan = [p for p in _walk(tdf.physical_plan()) if isinstance(p, tengine.ParquetScanExec)]
    assert scan and scan[0].metrics.value("pages_read") > 0
    monkeypatch.setattr(tengine.ParquetScanExec, "_read_selected_pages",
                        lambda self, *a, **kw: None)
    s = tengine.Session(tengine.VectorTopKOptions(nprobe=nprobe), device="cpu")
    s.register_parquet("t", path)
    assert s.sql(sql).collect().equals(got)


def _walk(plan):
    yield plan
    for c in plan.children():
        yield from _walk(c)
