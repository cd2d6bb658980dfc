"""The port's host I/O beneath the engine against the JAX package's: the
page-exact reader (``io/pages.py``), its native decoders (``io/native.py``
over the repo's ``native/`` library), the read-ahead (``io/prefetch.py``),
the fault-aware allocation (``utils/alloc.py``) and the stage timers
(``utils/profiling.py``). The port keeps copies of these modules; these
tests hold each copy to its original on the same inputs.

The native cases skip, as tests/test_native.py does, where the native
library cannot be built; that is decided inside each test."""

import os
import shutil
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from pqvector_tpu.io import native as jnative
from pqvector_tpu.io import pages as jpages
from pqvector_tpu.io import prefetch as jprefetch
from pqvector_tpu.io.embed import read_footer_metadata as jfooter
from pqvector_tpu.types import EmbeddingColumn as JColumn
from pqvector_tpu.utils import alloc as jalloc
from pqvector_tpu_torch.errors import ExecutionError
from pqvector_tpu_torch.io import native as tnative
from pqvector_tpu_torch.io import pages as tpages
from pqvector_tpu_torch.io import prefetch as tprefetch
from pqvector_tpu_torch.io.embed import read_footer_metadata as tfooter
from pqvector_tpu_torch.types import EmbeddingColumn
from pqvector_tpu_torch.utils import alloc as talloc
from pqvector_tpu_torch.utils import profiling as tprofiling

D = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vectors():
    return np.random.default_rng(3).standard_normal((500, D)).astype(np.float32)


def _write(path, vecs, dtype=pa.float32(), **kw):
    pq.write_table(pa.table({"id": pa.array(range(len(vecs)), pa.int32()),
                             "vec": pa.array([list(map(float, v)) for v in vecs],
                                             pa.list_(dtype))}),
                   path, write_page_index=True, use_dictionary=False, **kw)
    return str(path)


def _readers(path):
    return (jpages.PageSelectiveReader(path, JColumn("vec")),
            tpages.PageSelectiveReader(path, EmbeddingColumn("vec")))


def _native_or_skip():
    if tnative.load() is None or jnative.load() is None:
        pytest.skip("native library unavailable (no g++?)")


LAYOUTS = {
    "snappy": dict(compression="snappy", row_group_size=64),
    "zstd": dict(compression="zstd", row_group_size=200),
    "gzip": dict(compression="gzip"),
    "none": dict(compression="none", row_group_size=64),
    "small_pages": dict(compression="snappy", data_page_size=64, write_batch_size=16,
                        row_group_size=64),
    "v2": dict(compression="zstd", data_page_version="2.0", row_group_size=64),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_read_rows_matches_jax(tmp_path, vectors, layout):
    path = _write(tmp_path / f"{layout}.parquet", vectors, **LAYOUTS[layout])
    j, t = _readers(path)
    assert t.supports_page_reads and j.supports_page_reads
    np.testing.assert_array_equal(t._rg_starts, j._rg_starts)
    rng = np.random.default_rng(7)
    for rows in (np.array([499, 0, 250, 123, 199, 200, 7]), rng.integers(0, 500, 64),
                 np.arange(0, 500, 37)):
        got = t.read_rows(rows, D)
        np.testing.assert_array_equal(got, j.read_rows(rows, D))
        np.testing.assert_array_equal(got, vectors[rows])
        tv, tl, tp = t.read_rows_ragged(rows)
        jv, jl, jp = j.read_rows_ragged(rows)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp


def test_double_column_narrowed_alike(tmp_path, vectors):
    path = _write(tmp_path / "f64.parquet", vectors.astype(np.float64), dtype=pa.float64())
    j, t = _readers(path)
    rows = np.array([5, 100, 499])
    np.testing.assert_array_equal(t.read_rows(rows, D), j.read_rows(rows, D))


def test_errors_and_metadata_alike(tmp_path, vectors):
    path = _write(tmp_path / "m.parquet", vectors, row_group_size=128)
    j, t = _readers(path)
    with pytest.raises(ExecutionError, match="out of bounds") as texc:
        t.read_rows(np.array([500]), D)
    with pytest.raises(Exception) as jexc:
        j.read_rows(np.array([500]), D)
    assert str(texc.value) == str(jexc.value)
    assert tfooter(path) == jfooter(path)
    tleaves, trgs = tpages.parse_parquet_metadata(tfooter(path))
    jleaves, jrgs = jpages.parse_parquet_metadata(jfooter(path))
    assert [vars(x) for x in tleaves] == [vars(x) for x in jleaves]
    assert [rg.num_rows for rg in trgs] == [rg.num_rows for rg in jrgs]
    assert [[vars(c) for c in rg.chunks] for rg in trgs] == [
        [vars(c) for c in rg.chunks] for rg in jrgs]
    plain = tmp_path / "noindex.parquet"
    pq.write_table(pa.table({"vec": pa.array(vectors.tolist(), pa.list_(pa.float32()))}),
                   plain, write_page_index=False)
    assert not tpages.PageSelectiveReader(plain, EmbeddingColumn("vec")).supports_page_reads
    with pytest.raises(ExecutionError, match="not found"):
        tpages.PageSelectiveReader(plain, EmbeddingColumn("nope"))


@pytest.mark.parametrize("compression", ["snappy", "zstd", "gzip", "none"])
def test_native_page_decode_matches_python(tmp_path, vectors, compression):
    """The port's native page decoder, its Python decoder and the JAX
    package's Python decoder agree value for value."""
    _native_or_skip()
    path = _write(tmp_path / f"nat_{compression}.parquet", vectors, compression=compression)
    _, reader = _readers(path)
    chunk = reader.row_groups[0].chunks[reader.leaf_idx]
    with open(path, "rb") as f:
        f.seek(chunk.offset_index_offset)
        locs = tpages.parse_offset_index(f.read(chunk.offset_index_length))
        f.seek(locs[0].offset)
        raw = f.read(locs[0].compressed_page_size)
    py = tpages.decode_data_page(raw, chunk.codec, reader.leaf)
    jpy = jpages.decode_data_page(raw, chunk.codec, reader.leaf)
    nat = tnative.decode_data_page_native(raw, chunk.codec, reader.leaf.ptype,
                                          reader.leaf.max_def, reader.leaf.max_rep)
    assert nat is not None
    np.testing.assert_array_equal(nat[0], py.values)
    np.testing.assert_array_equal(nat[1], py.row_lengths)
    np.testing.assert_array_equal(py.values, jpy.values)


def test_batched_native_read_matches_python_fallback(tmp_path, vectors, monkeypatch):
    _native_or_skip()
    path = _write(tmp_path / "batched.parquet", vectors, compression="zstd",
                  data_page_size=64, write_batch_size=16, row_group_size=200)
    rows = np.random.default_rng(9).integers(0, 500, size=64)
    _, reader = _readers(path)
    with open(path, "rb") as f:
        batched = reader._read_rows_batched(
            rows, np.searchsorted(reader._rg_starts, rows, side="right") - 1, D, f)
    assert batched is not None  # the native path really ran
    monkeypatch.setattr(tnative, "decode_pages_native", lambda *a, **k: None)
    fallback = reader.read_rows(rows, D)
    np.testing.assert_array_equal(batched, fallback)
    np.testing.assert_array_equal(fallback, vectors[rows])


@pytest.mark.parametrize("tag", ["dict", "plain"])
def test_native_chunk_reader_matches_jax(tmp_path, tag):
    _native_or_skip()
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 7, (3000, 16)) if tag == "dict"
         else rng.standard_normal((3000, 16))).astype(np.float32)
    path = str(tmp_path / f"{tag}.parquet")
    pq.write_table(pa.table({"vec": pa.array(list(x), pa.list_(pa.float32()))}), path,
                   row_group_size=1024, use_dictionary=(tag == "dict"))
    got = tpages.read_embedding_matrix_native(path, EmbeddingColumn("vec"))
    want = jpages.read_embedding_matrix_native(path, JColumn("vec"))
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)


def test_native_builds_against_zstd_declarations(tmp_path, vectors, monkeypatch):
    """The port's build of the repo's native sources, against
    ``io/zstd_decl/zstd.h`` and the runtime ``libzstd.so.1``, decodes a zstd
    page as the Python decoder does."""
    _native_or_skip()
    src = os.path.join(ROOT, "native")
    for name in os.listdir(src):
        if name.endswith((".cpp", "Makefile")):
            shutil.copy(os.path.join(src, name), tmp_path / name)
    lib = tmp_path / "libpqvector_host.so"
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_LIB_PATH", str(lib))
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.ensure_built() and lib.exists()
    path = _write(tmp_path / "z.parquet", vectors, compression="zstd")
    _, reader = _readers(path)
    chunk = reader.row_groups[0].chunks[reader.leaf_idx]
    with open(path, "rb") as f:
        f.seek(chunk.offset_index_offset)
        loc = tpages.parse_offset_index(f.read(chunk.offset_index_length))[0]
        f.seek(loc.offset)
        raw = f.read(loc.compressed_page_size)
    nat = tnative.decode_data_page_native(raw, "zstd", reader.leaf.ptype,
                                          reader.leaf.max_def, reader.leaf.max_rep)
    assert tnative._lib is not None and tnative._lib._name == str(lib)
    py = tpages.decode_data_page(raw, chunk.codec, reader.leaf)
    np.testing.assert_array_equal(nat[0], py.values)
    np.testing.assert_array_equal(nat[1], py.row_lengths)


def test_native_splice_matches_jax(tmp_path, vectors):
    _native_or_skip()
    from pqvector_tpu_torch.io.thrift import splice_key_value_metadata

    path = _write(tmp_path / "kv.parquet", vectors[:10])
    meta = tfooter(path)
    pairs = [("a", "1"), ("b", "2")]
    got = tnative.splice_key_value_metadata_native(meta, pairs, drop_keys={"x"})
    assert got == jnative.splice_key_value_metadata_native(meta, pairs, drop_keys={"x"})
    assert got == splice_key_value_metadata(meta, pairs, drop_keys={"x"})


def test_prefetch_matches_jax(tmp_path):
    data = bytes(range(256)) * 64
    p = tmp_path / "blob.bin"
    p.write_bytes(data)
    spans = [(0, 100), (100, 50), (4096, 1), (len(data) - 7, 7)] + [
        (i * 100, 100) for i in range(40)]
    def read_all(mod, depth):  # a buffer is valid until the next item
        return [(item, bytes(buf)) for item, buf in
                mod.iter_prefetched(str(p), spans, lambda s: s, depth=depth)]

    for depth in (1, 2, 4):
        got = read_all(tprefetch, depth)
        assert got == read_all(jprefetch, depth)
        assert [buf for _, buf in got] == [data[o : o + n] for o, n in spans]
    before = threading.active_count()
    gen = tprefetch.iter_prefetched(str(p), spans, lambda s: s, depth=2)
    next(gen)
    gen.close()
    assert threading.active_count() <= before + 1
    with pytest.raises(OSError, match="short read"):
        list(tprefetch.iter_prefetched(str(p), [(len(data) - 5, 10)], lambda s: s))


@pytest.mark.parametrize("shape", [(4, 3), (3000, 1500)])
def test_alloc_matches_jax(shape):
    t = talloc.alloc_matrix(shape, np.float32)
    j = jalloc.alloc_matrix(shape, np.float32)
    assert t.shape == j.shape == shape and t.dtype == j.dtype
    assert talloc.populate(t) == jalloc.populate(j)
    t[...] = 1.5
    assert float(t.sum()) == 1.5 * t.size


def test_stage_timers_and_trace(tmp_path):
    tprofiling.drain_stages()
    with tprofiling.stage("outer"):
        with tprofiling.stage("inner"):
            pass
    tprofiling.add_stage_time("external", 0.25)
    names = [n for n, _ in tprofiling.drain_stages()]
    assert names == ["inner", "outer", "external"]
    assert tprofiling.drain_stages() == []
    with tprofiling.device_trace(None):  # no directory, no env: a no-op
        pass
    with tprofiling.device_trace(str(tmp_path / "trace")):
        sum(range(10))
    assert (tmp_path / "trace" / "trace.json").exists()
