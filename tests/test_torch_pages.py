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


def test_remote_store_reads_the_same_rows_in_coalesced_ranges(tmp_path, vectors):
    """A file behind a store that is not local is read in coalesced spans
    (one ``get_ranges`` a row group), to the rows a local read gives."""
    from pqvector_tpu_torch.engine.object_store import MemoryStore

    _native_or_skip()
    path = _write(tmp_path / "remote.parquet", vectors, compression="snappy",
                  data_page_size=64, write_batch_size=16, row_group_size=200)
    store = MemoryStore({path: open(path, "rb").read()})
    calls = []
    real = store.get_ranges
    store.get_ranges = lambda p, ranges: calls.append(len(ranges)) or real(p, ranges)
    remote = tpages.PageSelectiveReader(path, EmbeddingColumn("vec"), store=store)
    local = tpages.PageSelectiveReader(path, EmbeddingColumn("vec"))
    rows = np.array([3, 4, 5, 150, 260, 499, 17])
    got, lens, pages = remote.read_rows_ragged(rows)
    np.testing.assert_array_equal(got.reshape(-1, D), vectors[rows])
    assert pages >= 3 and sum(calls) >= 3
    np.testing.assert_array_equal(local.read_rows(rows, D), vectors[rows])


def _write_dictionary(path, x, **kw):
    """``x`` as a list<float32> column ``vec`` (beside an ``id``) with the
    writer's dictionary on, pages of 16 rows and an offset index."""
    n, d = x.shape
    vec = pa.ListArray.from_arrays(pa.array(np.arange(n + 1, dtype=np.int32) * d),
                                   pa.array(x.reshape(-1), pa.float32()))
    pq.write_table(pa.table({"id": pa.array(np.arange(n)), "vec": vec}), path,
                   write_page_index=True, use_dictionary=True, data_page_size=16 * d * 4,
                   write_batch_size=16, **kw)
    return str(path)


def _page_encodings(path):
    """Whether each data page of ``vec`` holds dictionary indices, per row group."""
    _, reader = _readers(path)
    out = []
    with open(path, "rb") as f:
        for rg in range(len(reader.row_groups)):
            flags = []
            for loc in reader._locations(rg, f):
                f.seek(loc.offset)
                flags.append(tpages._dictionary_encoded(f.read(loc.compressed_page_size)))
            out.append(flags)
    return out


#: name -> (values: "noise" fills the dictionary, which falls back to PLAIN
#: mid-chunk; "few" keeps every page dictionary-encoded; the writer's options)
DICT_LAYOUTS = {
    "fallback_snappy": ("noise", dict(compression="snappy", dictionary_pagesize_limit=2048)),
    "fallback_zstd": ("noise", dict(compression="zstd", dictionary_pagesize_limit=2048)),
    "fallback_none": ("noise", dict(compression="none", dictionary_pagesize_limit=2048)),
    "all_dict_snappy": ("few", dict(compression="snappy")),
    "all_dict_zstd": ("few", dict(compression="zstd")),
    "all_dict_none": ("few", dict(compression="none")),
    "v2_fallback": ("noise", dict(compression="zstd", data_page_version="2.0",
                                  dictionary_pagesize_limit=2048)),
    "v2_all_dict": ("few", dict(compression="snappy", data_page_version="2.0")),
}


def _dictionary_file(tmp_path, layout, n=3000, row_group_size=1000):
    kind, kw = DICT_LAYOUTS[layout]
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((n, D)) if kind == "noise"
         else rng.integers(0, 7, (n, D))).astype(np.float32)
    path = _write_dictionary(tmp_path / f"{layout}.parquet", x,
                             row_group_size=row_group_size, **kw)
    table = pq.read_table(path)
    want = np.stack(table.column("vec").to_numpy(zero_copy_only=False)).astype(np.float32)
    return path, want


def _touched_pages(reader, rows):
    """(row group, page) of each page that holds one of ``rows``, from the
    offset index."""
    rg = np.searchsorted(reader._rg_starts, rows, side="right") - 1
    with open(reader.path, "rb") as f:
        return sorted({(int(g), int(np.searchsorted(reader._firsts(int(g), f),
                                                    r - reader._rg_starts[g], "right") - 1))
                       for g, r in zip(rg, rows)})


def _no_native(monkeypatch):
    """The Python decoder alone: the library off, as ``PQVECTOR_TPU_NO_NATIVE`` turns it off."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("PQVECTOR_TPU_NO_NATIVE", "1")
    assert tnative.load() is None


@pytest.mark.parametrize("read", ["local", "store", "python"])
@pytest.mark.parametrize("layout", sorted(DICT_LAYOUTS))
def test_dictionary_pages_match_pyarrow(tmp_path, monkeypatch, layout, read):
    """Dictionary-encoded pages are read page-exact, bit for bit what
    ``pq.read_table`` gives for the same rows: from a local file, through a
    store that is not local (``get_ranges``) and by the Python decoder alone;
    rows in three row groups, read on the scan pool."""
    from pqvector_tpu_torch.engine.object_store import MemoryStore

    path, want = _dictionary_file(tmp_path, layout)
    encodings = _page_encodings(path)
    dict_kind = DICT_LAYOUTS[layout][0]
    for flags in encodings:
        assert flags[0] and (all(flags) if dict_kind == "few" else not all(flags))
    if read == "python":
        _no_native(monkeypatch)
    else:
        _native_or_skip()
    store = MemoryStore({path: open(path, "rb").read()}) if read == "store" else None
    reader = tpages.PageSelectiveReader(path, EmbeddingColumn("vec"), store=store)
    assert len(reader.row_groups) == 3 and tpages._scan_pool() is not None
    rng = np.random.default_rng(4)
    for rows in (np.array([0, 2999, 1000, 15, 16, 1999, 2000, 5]), rng.integers(0, 3000, 97),
                 np.arange(0, 3000, 29)):
        np.testing.assert_array_equal(reader.read_rows(rows, D), want[rows])
        values, lengths, pages = reader.read_rows_ragged(rows)
        np.testing.assert_array_equal(values, want[rows].reshape(-1))
        np.testing.assert_array_equal(lengths, np.full(rows.size, D))
        assert pages == len(_touched_pages(reader, rows))
    if read != "python":  # the batched native decode served them
        rows = np.array([1, 17, 999, 1500, 2998])
        rg_of = np.searchsorted(reader._rg_starts, rows, side="right") - 1
        with reader._open() as f:
            got = reader._read_rows_batched(rows, rg_of, D, f)
        np.testing.assert_array_equal(got, want[rows])


@pytest.mark.parametrize("read", ["native", "python"])
def test_dictionary_pages_are_counted(tmp_path, monkeypatch, read):
    """While tracing, the call's root counts the dictionary-encoded data pages
    it decoded (``dict_pages``, also among ``pages`` and ``page_bytes``) and
    the dictionary pages' bytes it read (``dict_bytes``), once a row group."""
    path, want = _dictionary_file(tmp_path, "fallback_snappy")
    if read == "python":
        _no_native(monkeypatch)
    else:
        _native_or_skip()
    reader = tpages.PageSelectiveReader(path, EmbeddingColumn("vec"))
    encodings = _page_encodings(path)
    with open(path, "rb") as f:
        for rg in range(3):
            reader._locations(rg, f)
    dict_len = [reader._dictionary_span(rg)[1] for rg in range(3)]
    assert all(dict_len)
    for rows in (np.array([0, 1, 17, 1000, 2500]), np.array([2999, 1999]), np.arange(0, 3000, 7)):
        pages = _touched_pages(reader, rows)
        dict_pages = [(rg, p) for rg, p in pages if encodings[rg][p]]
        tprofiling.clear_store()
        with tprofiling.tracing():
            with tprofiling.span("call") as root:
                got, _, n_pages = reader.read_rows_ragged(rows)
        np.testing.assert_array_equal(got, want[rows].reshape(-1))
        c = root.counters
        assert c["pages"] == n_pages == len(pages) and c["page_bytes"] > 0
        assert c["dict_pages"] == len(dict_pages)
        assert c["dict_bytes"] == sum(dict_len[rg] for rg in {rg for rg, _ in dict_pages})


@pytest.mark.parametrize("dictionary", [False, True], ids=["plain", "dictionary"])
def test_ragged_rows_longer_than_the_chunk_mean(tmp_path, monkeypatch, dictionary):
    """Rows of uneven length, read where the touched pages hold more values
    than the chunk's mean a row gives them: the batched decode still serves
    them (it widens its bound to the chunk's), equal to pyarrow's rows."""
    _native_or_skip()
    rng = np.random.default_rng(8)
    lens = np.where(np.arange(600) < 100, 40, 2)
    vals = (rng.integers(0, 5, int(lens.sum())) if dictionary
            else rng.standard_normal(int(lens.sum()))).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    vec = pa.ListArray.from_arrays(pa.array(offsets), pa.array(vals, pa.float32()))
    path = str(tmp_path / "uneven.parquet")
    pq.write_table(pa.table({"id": pa.array(np.arange(600)), "vec": vec}), path,
                   write_page_index=True, use_dictionary=dictionary, data_page_size=256,
                   write_batch_size=16, row_group_size=300, compression="snappy")
    want = pq.read_table(path).column("vec").to_pylist()
    reader = tpages.PageSelectiveReader(path, EmbeddingColumn("vec"))
    monkeypatch.setattr(reader, "_read_rows_paged", None)  # the batched decode alone
    for rows in (np.array([0, 5, 50, 99]), np.array([3, 310, 20, 599, 77])):
        values, lengths, _ = reader.read_rows_ragged(rows)
        np.testing.assert_array_equal(lengths, lens[rows])
        np.testing.assert_array_equal(values, np.concatenate([want[r] for r in rows]))


def test_one_reader_serves_large_small_large(tmp_path):
    """One reader serves a large call, a small one, then the large one again,
    each equal to a fresh reader's answer and to the file's rows."""
    _native_or_skip()
    path, want = _dictionary_file(tmp_path, "fallback_zstd", row_group_size=3000)
    reader = tpages.PageSelectiveReader(path, EmbeddingColumn("vec"))
    large = np.random.default_rng(6).integers(0, 3000, 600)
    small = np.array([2, 2900])
    for rows in (large, small, large):
        fresh = tpages.PageSelectiveReader(path, EmbeddingColumn("vec"))
        got, lengths, pages = reader.read_rows_ragged(rows)
        np.testing.assert_array_equal(got, want[rows].reshape(-1))
        for a, b in zip((got, lengths, pages), fresh.read_rows_ragged(rows)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(reader.read_rows(rows, D), fresh.read_rows(rows, D))


@pytest.mark.parametrize("layout", ["plain", "dictionary"])
def test_rows_returned_survive_the_next_call(tmp_path, vectors, layout):
    """What one call returns is its own: the next call leaves it
    unchanged."""
    _native_or_skip()
    if layout == "plain":
        path = _write(tmp_path / "p.parquet", vectors, data_page_size=64,
                      write_batch_size=16, row_group_size=200)
        want = vectors
    else:
        path, want = _dictionary_file(tmp_path, "all_dict_snappy")
    reader = tpages.PageSelectiveReader(path, EmbeddingColumn("vec"))
    first_rows = np.array([3, 40, 250, 499])
    other_rows = np.array([4, 41, 251, 498, 100, 300])
    matrix = reader.read_rows(first_rows, D)
    values, lengths, _ = reader.read_rows_ragged(first_rows)
    kept = (matrix.copy(), values.copy(), lengths.copy())
    reader.read_rows(other_rows, D)
    reader.read_rows_ragged(other_rows)
    for a, b in zip((matrix, values, lengths), kept):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(matrix, want[first_rows])


def test_native_build_takes_turns_and_renames_into_place(tmp_path, monkeypatch):
    """Builders that find the library missing at once take turns under the
    lock: one runs ``make``, into another name renamed into place, and the
    rest find its finished file; no temporary file is left."""
    src = tmp_path / "native"
    src.mkdir()
    (src / "Makefile").write_text(
        "LIB := libpqvector_host.so\nall: $(LIB)\n$(LIB):\n"
        "\techo make >> runs.txt\n\tsleep 0.3\n\techo whole > $@\n")
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(tnative, "_LIB_PATH", str(src / "libpqvector_host.so"))
    monkeypatch.setattr(tnative, "_LOCK_PATH", str(tmp_path / "lock" / "native.lock"))
    results = []
    threads = [threading.Thread(target=lambda: results.append(tnative.ensure_built()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results == [True] * 4
    assert (src / "runs.txt").read_text() == "make\n"
    assert (src / "libpqvector_host.so").read_text() == "whole\n"
    assert tnative.ensure_built(force=True)
    assert (src / "runs.txt").read_text() == "make\nmake\n"
    assert sorted(p.name for p in src.iterdir()) == ["Makefile", "libpqvector_host.so", "runs.txt"]


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

    def worker(parent):  # a worker's stage names its parent: it reaches the caller's list
        with tprofiling.stage("external", parent=parent):
            pass

    with tprofiling.stage("outer") as outer:
        with tprofiling.stage("inner"):
            pass
        t = threading.Thread(target=worker, args=(outer,))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    names = [n for n, _ in tprofiling.drain_stages()]
    assert names == ["inner", "external", "outer"]
    assert tprofiling.drain_stages() == []
    with tprofiling.device_trace(None):  # no directory, no env: a no-op
        pass
    with tprofiling.device_trace(str(tmp_path / "trace")):
        sum(range(10))
    assert (tmp_path / "trace" / "trace.json").exists()
