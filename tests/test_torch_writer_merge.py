"""``IndexBuilder.build_new`` of the port (``io/writer.py``, ``io/merge.py``)
against the JAX package on the CPU: the same source file and build settings
give the same index and the same output bytes, each package reads the
other's file back, and the split-write-merge layout keeps its properties
(one-row pages on the vector column only, source column properties, column
order, the compact list header past 14 row groups).

Twins of ``tests/test_writer_merge.py`` and the round trips of
``tests/test_interop.py``; exact equality everywhere (host code).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import pqvector_tpu
import pqvector_tpu_torch
from pqvector_tpu.io.embed import read_index_from_parquet as j_read_index
from pqvector_tpu.io.merge import merge_parquet_files as j_merge
from pqvector_tpu.query.search import TopkBuilder as JTopkBuilder
from pqvector_tpu_torch import TopkBuilder, ValidationError, has_pq_vector_index
from pqvector_tpu_torch.io.embed import read_footer_metadata
from pqvector_tpu_torch.io.embed import read_index_from_parquet as t_read_index
from pqvector_tpu_torch.io.merge import merge_parquet_files
from pqvector_tpu_torch.io.pages import (
    PageSelectiveReader,
    parse_offset_index,
    parse_parquet_metadata,
)
from pqvector_tpu_torch.types import EmbeddingColumn


def _source(path, n=600, dim=64, codec_id="gzip"):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    table = pa.table(
        {
            "id": pa.array(np.arange(n), pa.int64()),
            "tag": pa.array([f"t{i % 7}" for i in range(n)]),
            "vec": pa.array(list(x), pa.list_(pa.float32())),
            "score": pa.array(rng.standard_normal(n), pa.float64()),
        }
    )
    pq.write_table(
        table, path, row_group_size=256,
        compression={"id": codec_id, "tag": codec_id, "vec": "snappy", "score": "snappy"},
        use_dictionary=["tag"],
    )
    return x


def _build_new_both(src, tmp_path, n_clusters, cluster_sorted=False, metric="l2"):
    """build_new by each package -> (port output, its index)."""
    jout, tout = str(tmp_path / "j_out.parquet"), str(tmp_path / "t_out.parquet")
    jb = pqvector_tpu.IndexBuilder(src, "vec").n_clusters(n_clusters).metric(metric)
    tb = pqvector_tpu_torch.IndexBuilder(src, "vec", device="cpu").n_clusters(
        n_clusters).metric(metric)
    if cluster_sorted:
        jb, tb = jb.cluster_sorted(), tb.cluster_sorted()
    ji, ti = jb.build_new(jout), tb.build_new(tout)
    assert ti.to_bytes() == ji.to_bytes()
    with open(jout, "rb") as a, open(tout, "rb") as b:
        assert a.read() == b.read()
    return tout, ti


@pytest.fixture()
def built(tmp_path):
    src = str(tmp_path / "src.parquet")
    x = _source(src)
    out, _ = _build_new_both(src, tmp_path, 8)
    return src, out, x


def _pages_per_rg(path, leaf_root):
    meta = read_footer_metadata(path)
    leaves, rgs = parse_parquet_metadata(meta)
    idx = [i for i, lf in enumerate(leaves) if lf.path.split(".")[0] == leaf_root]
    assert len(idx) == 1
    counts = []
    with open(path, "rb") as f:
        for rg in rgs:
            ch = rg.chunks[idx[0]]
            if ch.offset_index_offset is None:
                counts.append(None)
                continue
            f.seek(ch.offset_index_offset)
            counts.append(len(parse_offset_index(f.read(ch.offset_index_length))))
    return counts


def test_embedding_pages_are_one_row(built):
    _, out, _ = built
    assert _pages_per_rg(out, "vec") == [256, 256, 88]


def test_other_columns_keep_normal_pages(built):
    _, out, _ = built
    for col in ("id", "score"):
        for n_pages in _pages_per_rg(out, col):
            assert n_pages is None or n_pages <= 2, (col, n_pages)


def test_column_properties_preserved(built):
    src, out, _ = built
    md_src = pq.ParquetFile(src).metadata.row_group(0)
    md_out = pq.ParquetFile(out).metadata.row_group(0)
    src_cols = {md_src.column(i).path_in_schema: md_src.column(i)
                for i in range(md_src.num_columns)}
    out_cols = {md_out.column(i).path_in_schema: md_out.column(i)
                for i in range(md_out.num_columns)}
    assert set(src_cols) == set(out_cols)
    for path, sc in src_cols.items():
        oc = out_cols[path]
        assert oc.compression == sc.compression, path
        if path.startswith("tag"):
            assert any("DICTIONARY" in e for e in oc.encodings)
        if path.startswith("vec"):
            assert not any("DICTIONARY" in e for e in oc.encodings)


def test_column_order_and_data_roundtrip(built):
    src, out, x = built
    t_src, t_out = pq.read_table(src), pq.read_table(out)
    assert t_out.column_names == t_src.column_names
    np.testing.assert_array_equal(t_out.column("id").to_numpy(), t_src.column("id").to_numpy())
    assert t_out.column("tag").to_pylist() == t_src.column("tag").to_pylist()
    np.testing.assert_allclose(np.array(t_out.column("vec").to_pylist(), np.float32), x)


def test_merged_file_serves_queries(built):
    _, out, x = built
    res = TopkBuilder(out, x[17]).k(3).nprobe(8).search()
    assert res[0].row_idx == 17
    assert [r.row_idx for r in res] == [
        r.row_idx for r in JTopkBuilder(out, x[17]).k(3).nprobe(8).search()]
    r = PageSelectiveReader(out, EmbeddingColumn("vec"))
    assert r.supports_page_reads
    rows = np.array([1, 300, 599])
    np.testing.assert_allclose(r.read_rows(rows, 64), x[rows], rtol=1e-6)


def test_merge_rejects_misaligned_parts(tmp_path):
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"x": list(range(100))}), a, row_group_size=50)
    pq.write_table(pa.table({"y": list(range(100))}), b, row_group_size=40)
    with pytest.raises(ValidationError):
        merge_parquet_files([a, b], str(tmp_path / "m.parquet"))


def test_merge_single_part_roundtrip(tmp_path):
    a, out = str(tmp_path / "a.parquet"), str(tmp_path / "m.parquet")
    vals = np.random.default_rng(0).integers(0, 1000, 500)
    pq.write_table(pa.table({"x": vals}), a, row_group_size=128)
    merge_parquet_files([a], out)
    np.testing.assert_array_equal(pq.read_table(out).column("x").to_numpy(), vals)
    jout = str(tmp_path / "j.parquet")
    j_merge([a], jout)
    with open(out, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()


def test_merge_many_row_groups_long_list_header(tmp_path):
    """>= 15 row groups take the compact protocol's long list header."""
    src = str(tmp_path / "src.parquet")
    n, dim = 2000, 64
    x = np.random.default_rng(9).standard_normal((n, dim)).astype(np.float32)
    pq.write_table(pa.table({"id": pa.array(np.arange(n), pa.int64()),
                             "vec": pa.array(list(x), pa.list_(pa.float32()))}),
                   src, row_group_size=100)
    out, _ = _build_new_both(src, tmp_path, 8)
    assert pq.ParquetFile(out).metadata.num_row_groups == 20
    t = pq.read_table(out)
    np.testing.assert_array_equal(t.column("id").to_numpy(), np.arange(n))
    np.testing.assert_allclose(np.array(t.column("vec").to_pylist(), np.float32), x)
    assert TopkBuilder(out, x[55]).k(2).nprobe(8).search()[0].row_idx == 55


def test_merge_embedding_first_column(tmp_path):
    src = str(tmp_path / "src.parquet")
    n, dim = 500, 64
    x = np.random.default_rng(4).standard_normal((n, dim)).astype(np.float32)
    pq.write_table(pa.table({"vec": pa.array(list(x), pa.list_(pa.float32())),
                             "id": pa.array(np.arange(n), pa.int64())}),
                   src, row_group_size=200)
    out, _ = _build_new_both(src, tmp_path, 4)
    t = pq.read_table(out)
    assert t.column_names == ["vec", "id"]
    np.testing.assert_array_equal(t.column("id").to_numpy(), np.arange(n))
    assert _pages_per_rg(out, "vec")[0] == 200
    for p in _pages_per_rg(out, "id"):
        assert p is None or p <= 2


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_cluster_sorted_build_new_matches_jax(tmp_path, metric):
    """Rows permuted into cluster order, identity lists, the same bytes as
    the JAX package's; either package reads the file back."""
    src = str(tmp_path / "src.parquet")
    x = _source(src, n=700, dim=16)
    out, index = _build_new_both(src, tmp_path, 6, cluster_sorted=True, metric=metric)
    np.testing.assert_array_equal(index.row_ids, np.arange(700, dtype=np.uint32))
    plain = pqvector_tpu_torch.IndexBuilder(src, "vec", device="cpu").n_clusters(6).metric(
        metric).build_new(str(tmp_path / "plain.parquet"))
    order = np.asarray(plain.row_ids, np.int64)
    got = np.array(pq.read_table(out).column("vec").to_pylist(), np.float32)
    np.testing.assert_array_equal(got, x[order])
    np.testing.assert_array_equal(pq.read_table(out).column("id").to_numpy(), order)
    assert j_read_index(out)[0].to_bytes() == t_read_index(out)[0].to_bytes() == index.to_bytes()


def test_jax_built_new_file_reads_back_in_port(tmp_path):
    src = str(tmp_path / "src.parquet")
    x = _source(src, n=300, dim=16)
    out = str(tmp_path / "j.parquet")
    ji = pqvector_tpu.IndexBuilder(src, "vec").n_clusters(5).build_new(out)
    assert has_pq_vector_index(out)
    assert t_read_index(out)[0].to_bytes() == ji.to_bytes()
    s = pqvector_tpu_torch.DeviceIvfSearcher.from_parquet(out, row_tile=128, device="cpu")
    _, ids = s.exact(x[:4], 1)
    np.testing.assert_array_equal(ids.numpy()[:, 0], np.arange(4))


def test_pyarrow_rewrite_roundtrip_keeps_index_keys(tmp_path):
    """interop twin: a pyarrow rewrite keeps the data and the footer keys;
    building afresh in place on the rewrite serves queries."""
    src = tmp_path / "src.parquet"
    vecs = np.random.default_rng(3).standard_normal((200, 8)).astype(np.float32)
    pq.write_table(pa.table({"id": pa.array(range(200), pa.int64()),
                             "vec": pa.array(list(vecs), pa.list_(pa.float32()))}), src)
    path = tmp_path / "indexed.parquet"
    pqvector_tpu_torch.IndexBuilder(src, "vec", device="cpu").n_clusters(8).build_new(path)
    file_kv = pq.ParquetFile(path).metadata.metadata
    assert b"pq_vector_index_offset" in file_kv
    assert file_kv[b"pq_vector_embedding_column"] == b"vec"
    rewritten = tmp_path / "rewritten.parquet"
    pq.write_table(pq.read_table(path), rewritten)
    assert pq.read_table(rewritten).column("id").to_pylist() == list(range(200))
    pqvector_tpu_torch.IndexBuilder(rewritten, "vec", device="cpu").n_clusters(8).build_inplace()
    assert has_pq_vector_index(rewritten)
    assert TopkBuilder(rewritten, vecs[5]).k(3).nprobe(8).search()[0].row_idx == 5
    # two more in-place appends: old keys stripped, the file stays readable
    pqvector_tpu_torch.IndexBuilder(path, "vec", device="cpu").n_clusters(4).build_inplace()
    pqvector_tpu_torch.IndexBuilder(path, "vec", device="cpu").n_clusters(8).build_inplace()
    assert pq.read_table(path).num_rows == 200
    keys = sorted(k for k in pq.ParquetFile(path).metadata.metadata if k.startswith(b"pq_vector"))
    assert keys == [b"pq_vector_embedding_column", b"pq_vector_index_offset"]
    assert TopkBuilder(path, vecs[7]).k(2).nprobe(8).search()[0].row_idx == 7


@pytest.mark.parametrize("codec", ["gzip", "zstd", "snappy"])
def test_column_write_options_match_jax(tmp_path, codec):
    """The options cloned from the source, column by column."""
    from dataclasses import astuple

    from pqvector_tpu.io.writer import collect_column_write_options as j_collect
    from pqvector_tpu_torch.io.writer import collect_column_write_options

    src = str(tmp_path / "src.parquet")
    _source(src, n=300, dim=8, codec_id=codec)
    got = [astuple(o) for o in collect_column_write_options(src)]
    assert got == [astuple(o) for o in j_collect(src)]
    assert len(got) == 4


def _offset_index_bytes(path, leaf_root="vec"):
    meta = read_footer_metadata(path)
    leaves, rgs = parse_parquet_metadata(meta)
    idx = [i for i, lf in enumerate(leaves) if lf.path.split(".")[0] == leaf_root][0]
    ch = rgs[0].chunks[idx]
    with open(path, "rb") as f:
        f.seek(ch.offset_index_offset)
        return f.read(ch.offset_index_length)


@pytest.mark.parametrize("shift", [-3, 0, 7, 1 << 40])
def test_shift_offset_index_matches_jax(built, shift):
    """The plain-layout path and the general re-emit give the JAX
    package's bytes: on a real one-row-a-page offset index, and on layouts
    only the general path takes (an extra PageLocation field, a second
    OffsetIndex field)."""
    from pqvector_tpu.io.merge import _shift_offset_index as j_shift
    from pqvector_tpu_torch.io import merge as tmerge
    from pqvector_tpu_torch.io.thrift import write_varint, zigzag_encode

    _, out, _ = built
    raw = _offset_index_bytes(out)
    assert tmerge._shift_offset_index_plain(raw, shift) is not None
    assert tmerge._shift_offset_index(raw, shift) == j_shift(raw, shift)
    assert parse_offset_index(tmerge._shift_offset_index(raw, shift))[3].offset == (
        parse_offset_index(raw)[3].offset + shift)

    def varint(v):
        return write_varint(zigzag_encode(v))

    loc = b"\x16" + varint(100) + b"\x15" + varint(33) + b"\x16" + varint(2)
    odd = [
        b"\x19\x1c" + loc + b"\x00\x00",  # plain: one PageLocation
        b"\x19\x1c" + loc + b"\x16" + varint(9) + b"\x00\x00",  # a fourth field
        b"\x19\x1c" + loc + b"\x00\x19\x16" + varint(5) + b"\x00",  # a field 2
    ]
    for i, blob in enumerate(odd):
        assert (tmerge._shift_offset_index_plain(blob, shift) is None) == (i > 0)
        assert tmerge._shift_offset_index(blob, shift) == j_shift(blob, shift)


@pytest.mark.parametrize("n", [1, 14, 15, 2000])
def test_shift_offset_index_varint_widths_match_jax(n):
    """Offsets, sizes and first rows of every varint width, lists of short
    and long headers: the array rebase gives the re-emit's bytes."""
    from pqvector_tpu.io.merge import _shift_offset_index as j_shift
    from pqvector_tpu_torch.io import merge as tmerge
    from pqvector_tpu_torch.io.thrift import write_varint, zigzag_encode

    rng = np.random.default_rng(n)
    widths = rng.integers(0, 60, (n, 3))
    vals = (rng.integers(1, 1 << 30, (n, 3)) << widths) >> 30
    body = bytearray()
    for off, size, row in vals.tolist():
        body += b"\x16" + write_varint(zigzag_encode(off)) + b"\x15" + write_varint(
            zigzag_encode(size % (1 << 31))) + b"\x16" + write_varint(zigzag_encode(row)) + b"\x00"
    header = bytes([0x19]) + (bytes([(n << 4) | 0xC]) if n < 15
                              else b"\xfc" + write_varint(n))
    raw = header + bytes(body) + b"\x00"
    for shift in (0, 1, 1 << 20, 12345678901):
        assert tmerge._shift_offset_index_plain(raw, shift) is not None
        assert tmerge._shift_offset_index(raw, shift) == j_shift(raw, shift)
