"""The port's standalone top-k API (``TopkBuilder``, ``topk``, ``topk_batch``,
``read_embeddings_for_rows``) against the JAX package's on the same files:
the fixtures of tests/test_search.py, a multi-row-group and a page-indexed
file made from a numpy seed, a cosine index, and the committed
tests/golden/indexed.parquet. Hits must carry the same row ids, distances
within 1e-6 relative; validation errors must match by class name and
message."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import pqvector_tpu_torch
from pqvector_tpu.builder import IndexBuilder as JIndexBuilder
from pqvector_tpu.query import search as jsearch
from pqvector_tpu.query import selective as jselective
from pqvector_tpu.types import EmbeddingColumn as JColumn
from pqvector_tpu_torch.query import search as tsearch
from pqvector_tpu_torch.query import selective as tselective
from pqvector_tpu_torch.types import EmbeddingColumn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "indexed.parquet")
VECS = [[0.0, 0.0], [1.0, 0.0], [0.0, 2.0], [5.0, 5.0], [2.0, 2.0], [0.1, 0.1]]


def _write(path, vecs, n_clusters, metric="l2", **kw):
    pq.write_table(pa.table({"id": pa.array(range(len(vecs)), pa.int32()),
                             "vec": pa.array([list(map(float, v)) for v in vecs],
                                             pa.list_(pa.float32()))}), path, **kw)
    JIndexBuilder(path, "vec").n_clusters(n_clusters).metric(metric).build_inplace()
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("search")
    rng = np.random.default_rng(1)
    rg = rng.standard_normal((300, 8)).astype(np.float32)
    cos = rng.standard_normal((200, 8)).astype(np.float32)
    paged = rng.standard_normal((400, 8)).astype(np.float32)
    return {
        "six": (_write(root / "six.parquet", VECS, 2), np.asarray(VECS, np.float32)),
        "rg": (_write(root / "rg.parquet", rg, 8, row_group_size=64), rg),
        "cos": (_write(root / "cos.parquet", cos, 6, metric="cosine", row_group_size=64), cos),
        "paged": (_write(root / "paged.parquet", paged, 8, row_group_size=64,
                         write_page_index=True, use_dictionary=False,
                         data_page_size=256, write_batch_size=8), paged),
        "golden": (GOLDEN, np.asarray(pq.read_table(GOLDEN).column("vec").to_pylist(),
                                      np.float32)),
    }


def _same_hits(got, want):
    assert [type(r).__name__ for r in got] == ["SearchResult"] * len(want)
    assert [r.row_idx for r in got] == [r.row_idx for r in want]
    np.testing.assert_allclose([r.distance for r in got], [r.distance for r in want],
                               rtol=1e-6, atol=1e-7)


CASES = [("six", 0, 3, 64), ("six", 3, 6, 1), ("six", 2, 100, 64),
         ("rg", 123, 5, 8), ("rg", 7, 10, 2), ("rg", 299, 1, 1),
         ("cos", 11, 5, 3), ("cos", 150, 8, 6),
         ("paged", 42, 10, 2), ("paged", 0, 4, 1), ("paged", 399, 20, 8),
         ("golden", 0, 3, 64), ("golden", 4, 2, 1)]


@pytest.mark.parametrize("name,row,k,nprobe", CASES)
def test_topk_builder_matches_jax(files, name, row, k, nprobe):
    path, x = files[name]
    q = x[row] + np.float32(0.01)
    want = jsearch.TopkBuilder(path, q).k(k).nprobe(nprobe).search()
    got = pqvector_tpu_torch.TopkBuilder(path, q).k(k).nprobe(nprobe).search()
    _same_hits(got, want)
    _same_hits(tsearch.topk(path, q, k, nprobe), want)


@pytest.mark.parametrize("name,nprobe", [("six", 64), ("rg", 3), ("cos", 2), ("paged", 4), ("golden", 2)])
def test_topk_batch_matches_jax(files, name, nprobe):
    path, x = files[name]
    rows = np.random.default_rng(len(name)).integers(0, x.shape[0], 5)
    queries = x[rows] * np.float32(0.9)
    want = jsearch.topk_batch(path, queries, 4, nprobe)
    got = tsearch.topk_batch(path, queries, 4, nprobe)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_hits(g, w)


@pytest.mark.parametrize("name", ["rg", "paged", "golden"])
def test_read_embeddings_for_rows_matches_jax(files, name):
    """Row-group reads (no offset index) and page reads (a sparse selection
    of a page-indexed file) give the JAX package's matrix."""
    path, x = files[name]
    n, d = x.shape
    for rows in (np.array([n - 1, 0, n // 2, 3]), np.arange(0, n, 7)[::-1], np.empty(0, np.int64)):
        got = tselective.read_embeddings_for_rows(path, EmbeddingColumn("vec"), rows, d)
        want = jselective.read_embeddings_for_rows(path, JColumn("vec"), rows, d)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, x[rows])


def _raise_alike(jfn, tfn):
    with pytest.raises(Exception) as jexc:
        jfn()
    with pytest.raises(Exception) as texc:
        tfn()
    assert type(texc.value).__name__ == type(jexc.value).__name__
    assert str(texc.value) == str(jexc.value)


def test_validation_errors_match_jax(files):
    path, _ = files["six"]
    for mod in (jsearch, tsearch):
        assert mod.TopkBuilder(path, np.zeros(2)).k(1).nprobe(1) is not None
    cases = [
        lambda m: m.TopkBuilder(path, np.zeros(3)).k(1).nprobe(1).search(),
        lambda m: m.TopkBuilder(path, np.zeros(2)).k(0),
        lambda m: m.TopkBuilder(path, np.zeros(2)).nprobe(0),
        lambda m: m.TopkBuilder(path, np.zeros(2)).search(),
        lambda m: m.TopkBuilder(path, np.zeros(2)).k(1).search(),
        lambda m: m.topk_batch(path, np.zeros(2), 1, 1),
        lambda m: m.topk_batch(path, np.zeros((2, 3)), 1, 1),
    ]
    for case in cases:
        _raise_alike(lambda: case(jsearch), lambda: case(tsearch))


def test_out_of_range_rows_raise_alike(files):
    path, x = files["rg"]
    rows = np.array([0, x.shape[0]])
    _raise_alike(
        lambda: jselective.read_embeddings_for_rows(path, JColumn("vec"), rows, 8),
        lambda: tselective.read_embeddings_for_rows(path, EmbeddingColumn("vec"), rows, 8),
    )


def test_public_exports():
    from pqvector_tpu_torch import types

    for name in ("TopkBuilder", "SearchResult", "ClusterCount", "EmbeddingColumn",
                 "EmbeddingDim", "Embeddings"):
        assert name in pqvector_tpu_torch.__all__
    assert pqvector_tpu_torch.TopkBuilder is tsearch.TopkBuilder
    assert pqvector_tpu_torch.SearchResult is tsearch.SearchResult
    assert pqvector_tpu_torch.Embeddings is types.Embeddings
    assert pqvector_tpu_torch.query.topk_batch is tsearch.topk_batch
