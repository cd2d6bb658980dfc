"""The port's benchmark package (``pqvector_tpu_torch/bench``) against the
JAX package's ``bench/`` on the CPU: twins of ``tests/test_bench_utils.py``.

The readers and generators are host code: the same files give the same
arrays, and the same seed the same bytes. The harness runs on
``device="cpu"``; at nprobe = n_clusters its recall is 1.0 in both
packages, and both report the same recall.
"""

import argparse

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from pqvector_tpu.bench import datasets as jds
from pqvector_tpu.bench import harness as jharness
from pqvector_tpu.errors import ValidationError as JValidationError
from pqvector_tpu_torch import ValidationError, has_pq_vector_index
from pqvector_tpu_torch.bench import convert, datasets, harness, index_build


def _write_vecs(path, mat, dtype):
    with open(path, "wb") as f:
        for row in mat:
            np.array([mat.shape[1]], dtype=np.int32).tofile(f)
            row.astype(dtype).tofile(f)


def test_fvecs_round_trip(tmp_path):
    path = tmp_path / "x.fvecs"
    mat = np.arange(12, dtype=np.float32).reshape(3, 4)
    _write_vecs(path, mat, np.float32)
    got = datasets.read_fvecs(path)
    np.testing.assert_array_equal(got, mat)
    np.testing.assert_array_equal(got, jds.read_fvecs(path))
    np.testing.assert_array_equal(datasets.read_fvecs(path, max_rows=2), mat[:2])
    assert datasets.read_fvecs(tmp_path / "x.fvecs", max_rows=0).shape == (0, 4)


def test_ivecs_and_bvecs_round_trip(tmp_path):
    path = tmp_path / "x.ivecs"
    mat = np.arange(6, dtype=np.int32).reshape(2, 3)
    _write_vecs(path, mat, np.int32)
    np.testing.assert_array_equal(datasets.read_ivecs(path), mat)
    np.testing.assert_array_equal(datasets.read_ivecs(path), jds.read_ivecs(path))
    bpath = tmp_path / "x.bvecs"
    bmat = np.array([[0, 7, 255], [1, 2, 3]], dtype=np.uint8)
    with open(bpath, "wb") as f:
        for row in bmat:
            np.array([3], dtype=np.int32).tofile(f)
            row.tofile(f)
    got = datasets.read_bvecs(bpath)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bmat.astype(np.float32))
    np.testing.assert_array_equal(got, jds.read_bvecs(bpath))
    np.testing.assert_array_equal(datasets.read_bvecs(bpath, max_rows=1), got[:1])


def test_malformed_and_empty_files(tmp_path):
    path = tmp_path / "bad.fvecs"
    path.write_bytes(b"\x03\x00\x00\x00\x01\x02")
    for read in (datasets.read_fvecs, datasets.read_ivecs, datasets.read_bvecs):
        with pytest.raises(ValidationError):
            read(path)
    for read in (jds.read_fvecs, jds.read_ivecs):
        with pytest.raises(JValidationError):
            read(path)
    empty = tmp_path / "empty.fvecs"
    empty.write_bytes(b"")
    assert datasets.read_fvecs(empty).shape == (0, 0)
    assert datasets.read_ivecs(empty).shape == (0, 0)
    assert datasets.read_bvecs(empty).shape == (0, 0)


def test_synthetic_and_random_query_equal_the_jax_packages():
    a = datasets.synthetic_embeddings(100, 8, seed=5)
    np.testing.assert_array_equal(a, datasets.synthetic_embeddings(100, 8, seed=5))
    assert a.shape == (100, 8) and a.dtype == np.float32
    np.testing.assert_array_equal(a, jds.synthetic_embeddings(100, 8, seed=5))
    q = datasets.random_query(16)
    assert q.dtype == np.float32
    np.testing.assert_array_equal(q, jds.random_query(16))


def test_write_embedding_parquet_round_trip(tmp_path):
    path = tmp_path / "t.parquet"
    jpath = tmp_path / "j.parquet"
    emb = datasets.synthetic_embeddings(300, 6)
    datasets.write_embedding_parquet(path, emb, batch_rows=128, row_group_size=100)
    jds.write_embedding_parquet(jpath, emb, batch_rows=128, row_group_size=100)
    table = pq.read_table(path)
    assert table.num_rows == 300
    got = np.array(table.column("embedding").to_pylist(), dtype=np.float32)
    np.testing.assert_allclose(got, emb)
    assert pq.ParquetFile(path).metadata.num_row_groups >= 3
    assert path.read_bytes() == jpath.read_bytes()


def test_sift1m_paths(tmp_path):
    assert datasets.sift1m_paths(str(tmp_path)) is None
    for name in ("sift_base.fvecs", "sift_query.fvecs", "sift_groundtruth.ivecs"):
        (tmp_path / name).write_bytes(b"")
    got = datasets.sift1m_paths(str(tmp_path))
    assert got == jds.sift1m_paths(str(tmp_path))
    assert set(got) == {"base", "query", "groundtruth"}


def _harness_args(**kw):
    args = dict(path=None, vector_column="embedding", id_column="id",
                build_mode="both", nprobe=64, max_candidates=None, n_clusters=8,
                k=10, query_row=3, metrics=True, rows=500, dim=16)
    args.update(kw)
    return argparse.Namespace(**args)


def test_query_harness_end_to_end(tmp_path, monkeypatch, capsys):
    """Unindexed ground truth, both builds, the indexed query and its
    recall report, on the CPU; the JAX harness reports the same recall on
    its own run of the same arguments."""
    monkeypatch.chdir(tmp_path)
    results = harness.run(_harness_args(device="cpu"))
    assert results["inplace_recall"] == 1.0  # nprobe >= n_clusters: exact
    assert results["rewrite_recall"] == 1.0
    out = capsys.readouterr().out
    assert "Recall@10: 100.00%" in out
    assert "vector_topk" in out
    assert has_pq_vector_index(tmp_path / "data" / "query_bench_inplace.parquet")
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jharness.run(_harness_args())
    assert want["inplace_recall"] == results["inplace_recall"]
    assert want["rewrite_recall"] == results["rewrite_recall"]


def test_query_harness_without_id_column(tmp_path, monkeypatch):
    """No id column: recall matches rows by their vectors."""
    monkeypatch.chdir(tmp_path)
    emb = datasets.synthetic_embeddings(300, 8, seed=9)
    path = tmp_path / "noid.parquet"
    pq.write_table(pa.table({"embedding": pa.array(list(emb), pa.list_(pa.float32()))}),
                   path)
    results = harness.run(_harness_args(path=str(path), id_column=None,
                                        build_mode="inplace", k=5, query_row=7,
                                        metrics=False, rows=300, dim=8, device="cpu"))
    assert results["inplace_recall"] == 1.0


def test_index_build_and_convert_clis(tmp_path, monkeypatch, capsys):
    """The build benchmark and the fvecs converter on the CPU: an indexed
    file, its size overhead reported."""
    monkeypatch.chdir(tmp_path)
    out = index_build.main(["--rows", "400", "--dim", "8", "--n-clusters", "4",
                            "--device", "cpu"])
    assert out["build_s"] > 0 and out["overhead_bytes"] > 0
    assert has_pq_vector_index(tmp_path / "data" / "build_bench_400x8.parquet")
    assert "Size overhead" in capsys.readouterr().out
    mat = datasets.synthetic_embeddings(200, 8, seed=3)
    _write_vecs(tmp_path / "x.fvecs", mat, np.float32)
    convert.main(["--input", "x.fvecs", "--output", "x.parquet", "--n-clusters", "4",
                  "--max-rows", "150", "--device", "cpu"])
    assert has_pq_vector_index(tmp_path / "x.parquet")
    got = np.array(pq.read_table(tmp_path / "x.parquet").column("embedding").to_pylist(),
                   dtype=np.float32)
    np.testing.assert_array_equal(got, mat[:150])
    convert.main(["--input", "x.fvecs", "--output", "y.parquet", "--no-index"])
    assert not has_pq_vector_index(tmp_path / "y.parquet")
