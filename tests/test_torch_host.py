"""Host code of the torch port against the JAX package: index bytes, Parquet
footers and files that either package reads back, and an import of the port
that stays free of JAX.

The port keeps copies of the JAX package's host modules (importing any
``pqvector_tpu`` module imports jax); these tests hold the copies to the
same bytes.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import pqvector_tpu
import pqvector_tpu_torch
from pqvector_tpu.index.ivf import IvfIndex as JIvfIndex
from pqvector_tpu.io import embed as jembed
from pqvector_tpu.io import reader as jreader
from pqvector_tpu.types import EmbeddingColumn as JColumn
from pqvector_tpu_torch.convert import index_from_reference
from pqvector_tpu_torch.index.ivf import IvfIndex
from pqvector_tpu_torch.io import embed as tembed
from pqvector_tpu_torch.io import reader as treader
from pqvector_tpu_torch.types import EmbeddingColumn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_parquet(path, n=600, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    vec = pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1)), d)
    pq.write_table(pa.table({"id": np.arange(n), "vec": vec}), path)
    return x


def _assignments(n, k, seed):
    return np.random.default_rng(seed).integers(0, k, n)


@pytest.mark.parametrize("n,k,d", [(100, 4, 8), (1, 1, 3), (500, 30, 16)])
def test_index_bytes_equal(n, k, d):
    rng = np.random.default_rng(n)
    cent = rng.standard_normal((k, d)).astype(np.float32)
    assign = _assignments(n, k, seed=k)
    j = JIvfIndex.from_assignments(cent, assign)
    t = IvfIndex.from_assignments(cent, assign)
    assert t.to_bytes() == j.to_bytes()
    assert IvfIndex.from_bytes(j.to_bytes()).to_bytes() == j.to_bytes()
    assert JIvfIndex.from_bytes(t.to_bytes()).to_bytes() == t.to_bytes()
    conv = index_from_reference(j.centroids, j.list_offsets, j.row_ids)
    assert conv.to_bytes() == j.to_bytes()
    assert IvfIndex.from_bytes(conv.to_bytes()).to_bytes() == conv.to_bytes()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_append_inplace_gives_identical_bytes(tmp_path, metric):
    src = tmp_path / "src.parquet"
    _write_parquet(src)
    a, b = tmp_path / "a.parquet", tmp_path / "b.parquet"
    shutil.copy(src, a)
    shutil.copy(src, b)
    rng = np.random.default_rng(1)
    cent = rng.standard_normal((5, 8)).astype(np.float32)
    assign = _assignments(600, 5, seed=2)
    jembed.append_index_inplace(a, JIvfIndex.from_assignments(cent, assign),
                                JColumn("vec"), metric=metric)
    tembed.append_index_inplace(b, IvfIndex.from_assignments(cent, assign),
                                EmbeddingColumn("vec"), metric=metric)
    assert a.read_bytes() == b.read_bytes()
    assert tembed.read_index_metric(b) == jembed.read_index_metric(a) == metric


def test_port_built_file_reads_back_in_jax_package(tmp_path):
    path = tmp_path / "t.parquet"
    x = _write_parquet(path)
    index = pqvector_tpu_torch.IndexBuilder(path, "vec", device="cpu").n_clusters(6).build_inplace()
    assert jembed.has_pq_vector_index(path)
    got, col = jembed.read_index_from_parquet(path)
    assert str(col) == "vec"
    assert got.to_bytes() == index.to_bytes()
    assert pq.read_table(path).num_rows == 600
    np.testing.assert_array_equal(jreader.read_embedding_column(path, col).data, x)


def test_jax_built_file_reads_back_in_port(tmp_path):
    path = tmp_path / "j.parquet"
    x = _write_parquet(path, seed=3)
    index = pqvector_tpu.IndexBuilder(path, "vec").n_clusters(6).build_inplace()
    assert pqvector_tpu_torch.has_pq_vector_index(path)
    got, col = tembed.read_index_from_parquet(path)
    assert got.to_bytes() == index.to_bytes()
    np.testing.assert_array_equal(treader.read_embedding_column(path, col).data, x)


def test_unindexed_file_and_bad_payload(tmp_path):
    path = tmp_path / "plain.parquet"
    _write_parquet(path)
    assert not tembed.has_pq_vector_index(path)
    assert not jembed.has_pq_vector_index(path)
    with pytest.raises(pqvector_tpu_torch.FormatError):
        tembed.read_index_from_payload(b"NOT_A_PAYLOAD_AT_ALL", EmbeddingColumn("vec"))


@pytest.mark.parametrize("width", [None, 4])
def test_read_embedding_column_matches(tmp_path, width):
    """List and FixedSizeList columns decode to the same matrix in both."""
    path = tmp_path / "e.parquet"
    rng = np.random.default_rng(5)
    x = rng.standard_normal((50, 4)).astype(np.float32)
    flat = pa.array(x.reshape(-1))
    if width:
        vec = pa.FixedSizeListArray.from_arrays(flat, width)
    else:
        vec = pa.ListArray.from_arrays(pa.array(np.arange(51, dtype=np.int32) * 4), flat)
    pq.write_table(pa.table({"vec": vec}), path)
    np.testing.assert_array_equal(
        treader.read_embedding_column(path, EmbeddingColumn("vec")).data,
        jreader.read_embedding_column(path, JColumn("vec")).data,
    )


def test_import_leaves_jax_out():
    code = (
        "import sys, pqvector_tpu_torch, pqvector_tpu_torch.convert;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pqvector_tpu' or m.startswith('pqvector_tpu.')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax():
    """The port's sources import neither jax nor the JAX package."""
    pkg = os.path.join(ROOT, "pqvector_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                text = open(os.path.join(dirpath, name)).read()
                for bad in ("import jax", "from jax", "import pqvector_tpu\n",
                            "from pqvector_tpu.", "from pqvector_tpu import",
                            "allow_tf32 = True"):
                    assert bad not in text, f"{name}: {bad!r}"
