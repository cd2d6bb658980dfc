"""Spilled multi-assignment of the port (``query/spill.py``,
``DeviceIvfSearcher.with_spill``, ``from_parquet(spill=)``, the SQL
session's ``device_searcher(spill=)``) against the JAX package on the CPU.

Twins of ``tests/test_spill.py``, of
``tests/test_engine_resident.py::test_resident_spilled_lifts_recall`` and of
``tests/test_engine_edge_cases.py::test_session_device_searcher_kwargs_key``.

Tolerances. Runner-up ids equal the JAX package's (with bf16 products,
except where two clusters' scores lie within two bf16 roundings). Margins
come from two f32 matrix products summed in different orders, so they agree
to 1e-5 of max |c|^2 + max |x|^2; the spilled set may then differ only in
rows whose
margin lies within 1e-5 (relative) of the ``n_spill``-th margin. Search
results: ids equal, f32 distances within rtol 1e-5 / atol 1e-5, and rows may
swap only where their two distances tie within that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import pqvector_tpu
import pqvector_tpu_torch
from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.engine.options import VectorTopKOptions as JOptions
from pqvector_tpu.engine.session import Session as JSession
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu.query.device import _dedup_topk as j_dedup_topk
from pqvector_tpu.query.spill import build_spilled_layout as j_build_spilled_layout
from pqvector_tpu.query.spill import dedup_topk_np as j_dedup_topk_np
from pqvector_tpu.query.spill import runner_up_assignment as j_runner_up_assignment
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import index_from_reference
from pqvector_tpu_torch.engine.options import VectorTopKOptions
from pqvector_tpu_torch.engine.session import Session
from pqvector_tpu_torch.query.device import _dedup_topk
from pqvector_tpu_torch.query.spill import (
    build_spilled_layout,
    dedup_topk_np,
    runner_up_assignment,
)


def _clustered(n=3000, d=24, kc=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = 6.0 * rng.standard_normal((kc, d)).astype(np.float32)
    return (centers[rng.integers(0, kc, n)]
            + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    x = _clustered()
    jindex = j_build_ivf_index(JEmbeddings(x, x.shape[1]),
                               JIvfBuildConfig(n_clusters=24, seed=0))
    index = index_from_reference(np.asarray(jindex.centroids), jindex.list_offsets,
                                 jindex.row_ids)
    rng = np.random.default_rng(7)
    q = (x[rng.integers(0, len(x), 48)]
         + 0.3 * rng.standard_normal((48, x.shape[1]))).astype(np.float32)
    return x, jindex, index, q


def _exact_ids(x, q, k):
    d2 = np.sum(q * q, 1)[:, None] - 2.0 * q @ x.T + np.sum(x * x, 1)[None, :]
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def _assert_same(got, want, x, q):
    gd, gi = (t.numpy() for t in got)
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    for b, c in zip(*np.nonzero(gi != wi)):
        assert gi[b, c] >= 0 and wi[b, c] >= 0
        d_g = np.sqrt(((x[gi[b, c]] - q[b]) ** 2).sum())
        d_w = np.sqrt(((x[wi[b, c]] - q[b]) ** 2).sum())
        assert abs(d_g - d_w) <= 1e-5 + 1e-5 * d_w, (b, c)


def _pair(setup, spill=0.3, **kw):
    x, jindex, index, _ = setup
    jkw = dict(kw)
    if "dtype" in jkw:
        jkw["dtype"] = getattr(jnp, jkw["dtype"])
        kw["dtype"] = getattr(torch, kw["dtype"])
    return (JSearcher.with_spill(jindex, x, spill=spill, **jkw),
            DeviceIvfSearcher.with_spill(index, x, spill=spill, device="cpu", **kw))


@pytest.mark.parametrize("assign_dtype", ["float32", "bfloat16"])
def test_runner_up_assignment_matches_jax(setup, assign_dtype):
    x, jindex, index, _ = setup
    want_r, want_m = j_runner_up_assignment(x, jindex,
                                            assign_dtype=getattr(jnp, assign_dtype))
    runner, margin = runner_up_assignment(x, index, assign_dtype=getattr(torch, assign_dtype),
                                          device="cpu")
    cents = index.centroids
    if assign_dtype == "float32":
        np.testing.assert_array_equal(runner, want_r)
        scale = float((cents ** 2).sum(1).max() + (x ** 2).sum(1).max())
        np.testing.assert_allclose(margin, want_m, rtol=0, atol=1e-5 * scale)
    else:
        # The product is rounded to bf16 in both packages, after sums in
        # different orders: the two runners may differ only where their f32
        # scores lie within two bf16 roundings (2 * 2^-8 |x||c|, doubled by
        # the -2x.c form) of each other.
        s = (cents ** 2).sum(1)[None, :] - 2.0 * x @ cents.T
        rows = np.flatnonzero(runner != want_r)
        assert rows.size <= 0.02 * len(x)
        env = 4 * 2.0**-8 * np.linalg.norm(x[rows], axis=1) * np.linalg.norm(cents, axis=1).max()
        gap = np.abs(s[rows, runner[rows]] - s[rows, want_r[rows]])
        assert np.all(gap <= env)
    # the numpy oracle of the JAX package's test
    primary = np.empty(len(x), np.int32)
    primary[index.row_ids] = np.repeat(np.arange(index.n_clusters, dtype=np.int32),
                                       index.cluster_sizes())
    assert np.all(runner != primary)
    if assign_dtype == "float32":
        d2 = -2.0 * x @ cents.T + np.sum(cents * cents, 1)[None, :]
        d2[np.arange(len(x)), primary] = np.inf
        np.testing.assert_array_equal(runner, np.argmin(d2, axis=1))


def test_spilled_layout_matches_jax(setup):
    x, jindex, index, _ = setup
    spill = 0.25
    ext, ext_emb, gid = build_spilled_layout(index, x, spill=spill, device="cpu")
    jext, jext_emb, jgid = j_build_spilled_layout(jindex, x, spill=spill)
    n_spill = int(round(spill * len(x)))
    assert ext.total_rows == jext.total_rows == len(x) + n_spill
    np.testing.assert_array_equal(ext_emb, x[gid])
    counts = np.bincount(gid, minlength=len(x))
    assert counts.min() >= 1 and counts.max() <= 2 and int((counts == 2).sum()) == n_spill
    np.testing.assert_array_equal(ext.row_ids, np.arange(ext.total_rows, dtype=np.uint32))
    # the spilled set: equal but for rows at the n_spill-th margin
    _, margin = runner_up_assignment(x, index, device="cpu")
    mine = set(np.flatnonzero(counts == 2).tolist())
    theirs = set(np.flatnonzero(np.bincount(jgid, minlength=len(x)) == 2).tolist())
    edge = np.partition(margin, n_spill - 1)[n_spill - 1]
    for r in mine ^ theirs:
        assert abs(margin[r] - edge) <= 1e-5 * abs(edge), r
    if mine == theirs:
        assert ext.to_bytes() == jext.to_bytes()
        np.testing.assert_array_equal(gid, jgid)
        np.testing.assert_array_equal(ext_emb, jext_emb)


def test_spill_fraction_validation(setup):
    x, _, index, _ = setup
    for bad in (0.0, 1.5):
        with pytest.raises(ValidationError, match="spill fraction"):
            build_spilled_layout(index, x, spill=bad, device="cpu")


@pytest.mark.parametrize("k", [1, 3, 5])
def test_dedup_topk_matches_jax(k):
    d = np.asarray([[1.0, 1.0, 2.0, 3.0, np.inf, np.inf],
                    [0.5, 0.7, 0.7, 0.9, 1.0, 2.0]], np.float32)
    ids = np.asarray([[7, 7, 3, 7, -1, -1], [4, 9, 4, 9, 2, 5]], np.int32)
    got = _dedup_topk(torch.from_numpy(d), torch.from_numpy(ids), k)
    want = j_dedup_topk(jnp.asarray(d), jnp.asarray(ids), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    host = dedup_topk_np(d, ids, k)
    np.testing.assert_array_equal(host[1], j_dedup_topk_np(d, ids, k)[1])
    np.testing.assert_array_equal(host[1], got[1].numpy())


def test_spilled_exact_matches_ground_truth(setup):
    x, _, _, q = setup
    js, ts = _pair(setup)
    k = 8
    for mode in ("xla", "stream", "pallas", "cert"):
        got = ts.exact(q, k, mode=mode)
        _assert_same(got, js.exact(q, k, mode=mode), x, q)
        ie = got[1].numpy()
        np.testing.assert_array_equal(ie, _exact_ids(x, q, k))
        for r in ie:
            assert len(set(r.tolist())) == k
        assert np.all(np.diff(got[0].numpy(), axis=1) >= -1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spilled_search_modes_match_jax(setup, dtype):
    x, _, _, q = setup
    js, ts = _pair(setup, dtype=dtype, row_tile=128)
    k, nprobe = 8, 4
    for mode in ("gather", "masked", "stream", "pallas", "compact", "scan", "approx"):
        got = ts.search(q, k, nprobe, mode=mode)
        _assert_same(got, js.search(q, k, nprobe, mode=mode), x, q)
        for r in got[1].numpy():
            ids = [v for v in r.tolist() if v >= 0]
            assert len(set(ids)) == len(ids)
    _, i_gather = ts.search(q, k, nprobe, mode="gather")
    _, i_masked = ts.search(q, k, nprobe, mode="masked")
    np.testing.assert_array_equal(i_gather.numpy(), i_masked.numpy())


def test_spilled_recall_lift(setup):
    """At the same nprobe the spilled searcher's probe recall is at least
    the unspilled one's, and the JAX package's spilled recall."""
    x, jindex, index, q = setup
    k, nprobe = 10, 2
    truth = _exact_ids(x, q, k)
    base = DeviceIvfSearcher(index, x, cluster_sorted=True, device="cpu")
    js, spilled = _pair(setup)

    def recall(ids):
        ids = np.asarray(ids)
        return sum(len(set(ids[i].tolist()) & set(truth[i].tolist()))
                   for i in range(len(q))) / truth.size

    r_base = recall(base.search(q, k, nprobe, mode="masked")[1])
    r_spill = recall(spilled.search(q, k, nprobe, mode="masked")[1])
    assert r_spill >= r_base
    assert r_spill > 0.9 or r_spill > r_base
    assert r_spill == recall(js.search(q, k, nprobe, mode="masked")[1])


def test_spilled_bincompact_recall_and_dedup(setup):
    x, _, index, q = setup
    k, nprobe = 8, 2
    truth = _exact_ids(x, q, k)

    def rec(ids):
        ids = np.asarray(ids)
        return sum(len(set(ids[i].tolist()) & set(truth[i].tolist()))
                   for i in range(len(q))) / truth.size

    base = DeviceIvfSearcher(index, x, cluster_sorted=True, device="cpu")
    js, sp = _pair(setup)
    assert base._compact_bin_params(len(q), nprobe, k)[0] > 0
    _, ib = base.search(q, k, nprobe, mode="bincompact")
    got = sp.search(q, k, nprobe, mode="bincompact")
    for r in got[1].numpy():
        ids = [v for v in r.tolist() if v >= 0]
        assert len(set(ids)) == len(ids)
    assert rec(got[1].numpy()) >= rec(ib.numpy())
    _assert_same(got, js.search(q, k, nprobe, mode="bincompact"), x, q)
    # the spilled searcher calibrates and gates at the impls' 2k
    assert sp.calibrate_bincompact(q, nprobe, k) == js.calibrate_bincompact(q, nprobe, k)
    assert sp.bincompact_coverage(len(q), nprobe, k) == js.bincompact_coverage(len(q), nprobe, k)
    assert sp.compact_coverage(len(q), nprobe, k) == pytest.approx(
        js.compact_coverage(len(q), nprobe, k))
    assert sp.can_binscan(k) == js.can_binscan(k)
    assert sp.can_cert(k) == js.can_cert(k)


def test_spilled_search_loop_dedups(setup):
    x, _, _, q = setup
    js, ts = _pair(setup)
    k = 6
    got = ts.search_loop(q, k, 4, reps=2, mode="masked")
    _assert_same(got, js.search_loop(q, k, 4, reps=2, mode="masked"), x, q)
    for r in got[1].numpy():
        ids = [v for v in r.tolist() if v >= 0]
        assert len(set(ids)) == len(ids)
    _, el = ts.exact_loop(q, k, reps=2, mode="xla")
    np.testing.assert_array_equal(el.numpy(), _exact_ids(x, q, k))


def test_spill_needs_two_clusters():
    x = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    jindex = j_build_ivf_index(JEmbeddings(x, 8), JIvfBuildConfig(n_clusters=1, seed=0))
    index = index_from_reference(np.asarray(jindex.centroids), jindex.list_offsets,
                                 jindex.row_ids)
    with pytest.raises(ValidationError, match="at least 2 clusters"):
        build_spilled_layout(index, x, spill=0.2, device="cpu")


@pytest.mark.parametrize("mode", ["binscan", "binscan8", "bincompact8"])
def test_spilled_binned_scans_dedup_and_exact_distances(setup, mode):
    """The binned scans on a spilled layout select 2k (the int8 forms widen
    their fetch on top): distinct original ids, exact distances, the JAX
    package's result."""
    x, _, _, q = setup
    js, ts = _pair(setup)
    k = 6
    assert ts.can_binscan(k, esize=1)
    got = ts.search(q, k, nprobe=4, mode=mode)
    _assert_same(got, js.search(q, k, nprobe=4, mode=mode), x, q)
    d, ids = got[0].numpy(), got[1].numpy()
    for r in ids:
        vals = [v for v in r.tolist() if v >= 0]
        assert len(set(vals)) == len(vals)
    want = np.sqrt(((q[:, None, :] - x[ids]) ** 2).sum(-1))
    ok = ids >= 0
    np.testing.assert_allclose(d[ok], want[ok], rtol=1e-4, atol=1e-4)


def test_spilled_cosine_and_cert_probe(setup):
    """Cosine rows are normalized before the margins; ``cert_probe`` runs at
    the impls' 2k as in the JAX package."""
    x, _, _, q = setup
    js, ts = _pair(setup, metric="cosine", row_tile=128)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    for mode in ("gather", "pallas"):
        _assert_same(ts.search(q, 5, 3, mode=mode), js.search(q, 5, 3, mode=mode), xn, qn)
    frac, margins = ts.cert_probe(q, 5)
    jfrac, jmargins = js.cert_probe(q, 5)
    assert margins.shape == np.asarray(jmargins).shape == (len(q),)
    assert frac == jfrac


# -- from_parquet and the SQL session ---------------------------------------


def _write(path, n=400, dim=8, seed=5):
    x = np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)
    flat = pa.array(x.reshape(-1), pa.float32())
    offsets = pa.array(np.arange(n + 1, dtype=np.int32) * dim)
    pq.write_table(pa.table({"id": pa.array(np.arange(n)),
                             "vec": pa.ListArray.from_arrays(offsets, flat)}),
                   path, row_group_size=64)
    pqvector_tpu.IndexBuilder(path, "vec").n_clusters(8).build_inplace()
    return x


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spill_sql") / "data.parquet")
    return path, _write(path)


def test_from_parquet_spill_equals_with_spill(indexed):
    path, x = indexed
    ts = DeviceIvfSearcher.from_parquet(path, row_tile=64, spill=0.25, device="cpu")
    js = JSearcher.from_parquet(path, row_tile=64, spill=0.25)
    assert ts._spill_dups and ts._row_cluster_sorted
    assert ts._id_domain == js._id_domain == len(x)
    q = x[[3, 50, 199]] + np.float32(0.01)
    for mode in ("auto", "gather", "stream"):
        _assert_same(ts.search(q, 5, 2, mode=mode), js.search(q, 5, 2, mode="gather"), x, q)
    assert ts.source_path == js.source_path and ts.source_key == js.source_key


def _query_sql(x, qrow, k=5, where=""):
    q = ", ".join(f"{v:.6f}" for v in x[qrow])
    return f"SELECT id FROM t {where} ORDER BY array_distance(vec, [{q}]) LIMIT {k}"


def _ids(session, sql):
    return session.sql(sql).collect().column("id").to_pylist()


def test_resident_spilled_lifts_recall(indexed):
    """A spilled resident searcher diverges from the host path on purpose:
    its probe recall is at least the host's at the same nprobe, its results
    carry original ids without duplicates, respect the WHERE filter, and
    equal the JAX package's spilled session."""
    path, x = indexed
    host = Session(VectorTopKOptions(nprobe=3), device="cpu")
    host.register_parquet("t", path)
    res = Session(VectorTopKOptions(nprobe=3), device="cpu")
    res.register_parquet("t", path)
    assert res.device_searcher("t", spill=0.3)._spill_dups
    jres = JSession(JOptions(nprobe=3))
    jres.register_parquet("t", path)
    jres.device_searcher("t", spill=0.3)

    d2 = np.sum((x - x[23]) ** 2, axis=1)
    for where, mask in (("", np.ones(len(x), bool)),
                        ("WHERE id >= 200", np.arange(len(x)) >= 200)):
        truth = set(np.flatnonzero(mask)[np.argsort(d2[mask], kind="stable")[:5]].tolist())
        sql = _query_sql(x, 23, k=5, where=where)
        ids_host, ids_res = _ids(host, sql), _ids(res, sql)
        assert len(set(ids_res)) == len(ids_res) == 5
        assert all(i >= 200 for i in ids_res) or where == ""
        assert len(set(ids_res) & truth) >= len(set(ids_host) & truth)
        assert ids_res == _ids(jres, sql)


def test_session_device_searcher_kwargs_key(indexed):
    """The searcher cache keys on kwargs: a spill= request after a plain
    build must not serve the cached unspilled searcher."""
    path, _ = indexed
    s = Session(device="cpu")
    s.register_parquet("t", path)
    plain = s.device_searcher("t", row_tile=64)
    spilled = s.device_searcher("t", row_tile=64, spill=0.2)
    assert spilled is not plain
    assert spilled._spill_dups and not plain._spill_dups
    assert s.device_searcher("t", row_tile=64, spill=0.2) is spilled
