"""The port's streaming and staged builds against the JAX package on the
CPU: ``index/streaming.py`` (batches, streamed assignment, streamed sample),
``IndexBuilder.streaming()``, ``index/build.py:build_ivf_index_staged`` and
``build_inplace`` through it, with the native chunk decoder under the
column read and the native footer append.

Twins of ``tests/test_streaming.py`` (its bf16 wire in
``tests/test_torch_wires.py``) and of ``test_staged_matches_unstaged`` and
``test_staged_full_sample_branch`` of ``tests/test_staged_build.py``.
Tolerance: none. Assignments, sampled rows and index bytes are equal.
"""

import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import pqvector_tpu
import pqvector_tpu_torch
from pqvector_tpu.bench.datasets import write_embedding_parquet
from pqvector_tpu.index import streaming as jstream
from pqvector_tpu.index.build import IvfBuildConfig as JConfig
from pqvector_tpu.index.build import build_ivf_index_staged as j_staged
from pqvector_tpu.index.kmeans import assign_clusters as j_assign_clusters
from pqvector_tpu.types import EmbeddingColumn as JColumn
from pqvector_tpu_torch import ValidationError
from pqvector_tpu_torch.index import streaming as tstream
from pqvector_tpu_torch.index.build import (
    IvfBuildConfig,
    build_ivf_index,
    build_ivf_index_staged,
    resolve_assign_backend,
    resolve_transfer_dtype,
)
from pqvector_tpu_torch.index.kmeans import assign_clusters
from pqvector_tpu_torch.io.embed import read_index_from_parquet
from pqvector_tpu_torch.types import EmbeddingColumn, Embeddings

COL, JCOL = EmbeddingColumn("embedding"), JColumn("embedding")


@pytest.fixture(scope="module")
def parquet_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "s.parquet"
    vecs = np.random.default_rng(2).standard_normal((1000, 8)).astype(np.float32)
    pq.write_table(pa.table({"embedding": pa.array(list(vecs), pa.list_(pa.float32()))}),
                   path, row_group_size=128)
    return path, vecs


def test_iter_batches_covers_all_rows(parquet_path):
    path, vecs = parquet_path
    got = list(tstream.iter_embedding_batches(path, COL, 256))
    want = list(jstream.iter_embedding_batches(path, JCOL, 256))
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_array_equal(np.concatenate(got), vecs)


def test_streaming_assignment_matches_in_memory(parquet_path):
    path, vecs = parquet_path
    centroids = np.random.default_rng(0).standard_normal((7, 8)).astype(np.float32)
    streamed = tstream.assign_clusters_streaming(path, COL, centroids, batch_rows=200,
                                                 device="cpu")
    np.testing.assert_array_equal(streamed, assign_clusters(vecs, centroids, device="cpu"))
    np.testing.assert_array_equal(
        streamed, jstream.assign_clusters_streaming(path, JCOL, centroids, batch_rows=200))
    np.testing.assert_array_equal(streamed, j_assign_clusters(vecs, centroids))


def test_streaming_sample_deterministic(parquet_path):
    path, vecs = parquet_path
    a = tstream.sample_embeddings_streaming(path, COL, 50, 1000, seed=3, batch_rows=128)
    b = tstream.sample_embeddings_streaming(path, COL, 50, 1000, seed=3, batch_rows=333)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, jstream.sample_embeddings_streaming(path, JCOL, 50, 1000, seed=3, batch_rows=128))
    assert all(any(np.array_equal(row, v) for v in vecs) for row in a[:5])


def test_streaming_sample_bounds(parquet_path):
    path, _ = parquet_path
    with pytest.raises(ValidationError):
        tstream.sample_embeddings_streaming(path, COL, 10, 2000, seed=1)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_builder_streaming_mode_matches_jax(tmp_path, metric):
    """The streamed build gives the JAX package's index bytes; like the
    in-memory build it covers every row exactly once."""
    vecs = np.random.default_rng(4).standard_normal((800, 8)).astype(np.float32)
    table = pa.table({"embedding": pa.array(list(vecs), pa.list_(pa.float32()))})
    paths = [tmp_path / f"{name}.parquet" for name in ("a", "b", "c")]
    for p in paths:
        pq.write_table(table, p, row_group_size=100)
    ti = pqvector_tpu_torch.IndexBuilder(paths[0], "embedding", device="cpu").n_clusters(
        8).seed(5).metric(metric).streaming(batch_rows=150).build_inplace()
    ji = pqvector_tpu.IndexBuilder(paths[1], "embedding").n_clusters(8).seed(5).metric(
        metric).streaming(batch_rows=150).build_inplace()
    assert ti.to_bytes() == ji.to_bytes()
    assert paths[0].read_bytes() == paths[1].read_bytes()
    pqvector_tpu_torch.IndexBuilder(paths[2], "embedding", device="cpu").n_clusters(
        8).seed(5).metric(metric).build_inplace()
    for p in (paths[0], paths[2]):
        index, _ = read_index_from_parquet(p)
        assert index.total_rows == 800
        np.testing.assert_array_equal(np.sort(np.concatenate(index.inverted_lists())),
                                      np.arange(800))


def test_transfer_dtype_and_assign_backend_resolution():
    """"auto" is float32 and device, as in the JAX package off the TPU;
    every other value passes through, as it does there."""
    from pqvector_tpu.index.build import resolve_assign_backend as j_backend
    from pqvector_tpu.index.build import resolve_transfer_dtype as j_wire

    for wire in ("auto", "float32", "bfloat16", "int8"):
        assert resolve_transfer_dtype(IvfBuildConfig(transfer_dtype=wire)) == j_wire(
            JConfig(transfer_dtype=wire))
    for backend in ("auto", "device", "host"):
        assert resolve_assign_backend(IvfBuildConfig(assign_backend=backend)) == j_backend(
            JConfig(assign_backend=backend))
    assert resolve_transfer_dtype(IvfBuildConfig()) == "float32"
    assert resolve_assign_backend(IvfBuildConfig()) == "device"
    with pytest.raises(ValidationError, match="transfer_dtype"):
        IvfBuildConfig(transfer_dtype="float16")
    with pytest.raises(ValidationError, match="assign_backend"):
        IvfBuildConfig(assign_backend="gpu")


def _data(n=4000, d=24, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, d)).astype(np.float32) * 4
    return centers[rng.integers(0, 32, n)] + rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
def test_staged_matches_unstaged(tmp_path, normalize):
    """n = 4000 at 64 clusters trains on a 200-row sample (the sample-first
    branch); 1500-row groups make several chunks. The staged build equals
    the in-memory build on the rows normalized the same way, and at l2 the
    JAX package's staged build."""
    emb = _data()
    path = str(tmp_path / "e.parquet")
    write_embedding_parquet(path, emb, row_group_size=1500)
    cfg = IvfBuildConfig(n_clusters=64, seed=11)
    staged = build_ivf_index_staged(path, "embedding", cfg, batch_rows=700,
                                    normalize=normalize, device="cpu")
    data = emb
    if normalize:
        x = torch.from_numpy(emb)
        data = (x / (x * x).sum(dim=1, keepdim=True).sqrt().clamp_min(1e-30)).numpy()
    unstaged = build_ivf_index(Embeddings(data, emb.shape[1]), cfg, device="cpu")
    assert staged.to_bytes() == unstaged.to_bytes()
    want = j_staged(path, "embedding", JConfig(n_clusters=64, seed=11), batch_rows=700,
                    normalize=normalize)
    if not normalize:
        # (XLA sums the squares of a row in another order than torch, so
        # the cosine rows may differ from the JAX package's in the last bit.)
        assert staged.to_bytes() == want.to_bytes()


def test_staged_full_sample_branch(tmp_path):
    """sample_size == n (tiny data): training sees every row."""
    emb = _data(n=300, d=8)
    path = str(tmp_path / "s.parquet")
    write_embedding_parquet(path, emb, row_group_size=100)
    cfg = IvfBuildConfig(n_clusters=8, seed=5)
    staged = build_ivf_index_staged(path, "embedding", cfg, batch_rows=128, device="cpu")
    unstaged = build_ivf_index(Embeddings(emb, 8), cfg, device="cpu")
    assert staged.to_bytes() == unstaged.to_bytes()
    want = j_staged(path, "embedding", JConfig(n_clusters=8, seed=5), batch_rows=128)
    assert staged.to_bytes() == want.to_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_inplace_is_the_staged_build(tmp_path, seed):
    """``build_inplace`` reads through the native decoder and appends
    through the native footer splice: the file's bytes equal the JAX
    package's, and its index equals reading the column and building."""
    emb = _data(n=3000, d=16, seed=seed)
    src = tmp_path / "src.parquet"
    write_embedding_parquet(str(src), emb, row_group_size=1024)
    a, b = tmp_path / "a.parquet", tmp_path / "b.parquet"
    shutil.copy(src, a)
    shutil.copy(src, b)
    ti = pqvector_tpu_torch.IndexBuilder(a, "embedding", device="cpu").n_clusters(
        20).seed(seed).build_inplace()
    pqvector_tpu.IndexBuilder(b, "embedding").n_clusters(20).seed(seed).build_inplace()
    assert a.read_bytes() == b.read_bytes()
    read_then_build = build_ivf_index(
        Embeddings(emb, 16), IvfBuildConfig(n_clusters=20, seed=seed), device="cpu")
    assert ti.to_bytes() == read_then_build.to_bytes()


def test_staged_rejects_an_empty_column(tmp_path):
    path = tmp_path / "empty.parquet"
    pq.write_table(pa.table({"embedding": pa.array([], pa.list_(pa.float32()))}), path)
    with pytest.raises(pqvector_tpu.errors.ValidationError) as want:
        j_staged(path, "embedding", JConfig(n_clusters=1))
    with pytest.raises(ValidationError) as got:
        build_ivf_index_staged(path, "embedding", IvfBuildConfig(n_clusters=1), device="cpu")
    assert str(got.value) == str(want.value)


def test_upload_chunks_equals_the_rows():
    """The CPU form (and the form for layouts the native decoder declines)
    concatenates the decoded chunks."""
    from pqvector_tpu_torch.index.build import _upload_chunks

    rng = np.random.default_rng(8)
    chunks = [rng.standard_normal((r, 5)).astype(np.float32) for r in (7, 300, 1, 64)]
    got = _upload_chunks(iter(chunks), torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(chunks))
    with pytest.raises(ValidationError, match="Inconsistent"):
        _upload_chunks(iter([chunks[0], np.zeros((2, 4), np.float32)]), torch.device("cpu"))
    with pytest.raises(ValidationError, match="zero vectors"):
        _upload_chunks(iter([]), torch.device("cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 2, 8])
@pytest.mark.parametrize("dictionary", [False, True])
def test_upload_column_on_the_card_equals_the_rows(tmp_path, monkeypatch, cuda_device,
                                                   slots, dictionary):
    """On the card the row groups decode in parallel into pinned slots and
    reach the device on a side stream: the rows, also with one or two slots
    reused by nine row groups, and with dictionary pages, which the native
    decoder may decline."""
    import pqvector_tpu_torch.index.build as tb

    emb = _data(n=5000, d=24, seed=4)
    path = str(tmp_path / "u.parquet")
    pq.write_table(pa.table({"embedding": pa.array(list(emb), pa.list_(pa.float32()))}),
                   path, row_group_size=600, use_dictionary=dictionary)
    monkeypatch.setattr(tb, "_PINNED_BUDGET", slots * 600 * 24 * 4)
    got = tb._upload_column(path, COL, 700, cuda_device)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), emb)


@pytest.mark.cuda
def test_upload_column_on_the_card_takes_declined_row_groups(tmp_path, monkeypatch,
                                                             cuda_device):
    """A row group the native decoder declines is read by pyarrow into its
    pinned slot and copied like the others."""
    import pqvector_tpu_torch.index.build as tb
    from pqvector_tpu_torch.io import pages as tpages

    emb = _data(n=5000, d=24, seed=6)
    path = str(tmp_path / "d.parquet")
    write_embedding_parquet(path, emb, row_group_size=600)
    decode = tpages.decode_rg_matrix_from_buf
    monkeypatch.setattr(tpages, "decode_rg_matrix_from_buf", lambda buf, rg, *a, **k: (
        None if rg.num_rows != 600 or int(rg.chunks[0].data_page_offset) % 2
        else decode(buf, rg, *a, **k)))
    monkeypatch.setattr(tb, "_PINNED_BUDGET", 2 * 600 * 24 * 4)
    got = tb._upload_column(path, COL, 700, cuda_device)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), emb)


def _live_decoded(monkeypatch):
    """Count the decoded row groups alive at once: -> {"now", "most"}."""
    import threading
    import weakref

    from pqvector_tpu_torch.io import pages as tpages

    live = {"now": 0, "most": 0}
    lock = threading.Lock()

    def drop():
        with lock:
            live["now"] -= 1

    def counted(fn):
        def wrapped(*a, **k):
            mat = fn(*a, **k)
            if mat is not None:
                with lock:
                    live["now"] += 1
                    live["most"] = max(live["most"], live["now"])
                weakref.finalize(mat, drop)
            return mat
        return wrapped

    for name in ("decode_rg_matrix_from_buf", "_read_row_group_arrow"):
        monkeypatch.setattr(tpages, name, counted(getattr(tpages, name)))
    return live


@pytest.mark.parametrize("batch_rows", [100, 128, 384])
def test_streaming_bounds_the_decoded_row_groups(parquet_path, monkeypatch, batch_rows):
    """The streaming paths hold at most ``batch_rows // rows per row group``
    row groups decoding (at least one) and the caller's batch: host memory
    stays near ``batch_rows`` rows however many row groups the file has."""
    path, vecs = parquet_path
    live = _live_decoded(monkeypatch)
    workers = max(1, batch_rows // 128)
    seen = []
    for mat in tstream.iter_embedding_batches(path, COL, batch_rows):
        seen.append(mat.copy())
        del mat
    np.testing.assert_array_equal(np.concatenate(seen), vecs)
    assert 1 <= live["most"] <= workers + 1
    assert live["now"] == 0
    live["most"] = 0
    cents = vecs[:16].copy()
    got = tstream.assign_clusters_streaming(path, COL, cents, batch_rows, device="cpu")
    np.testing.assert_array_equal(got, assign_clusters(vecs, cents, device="cpu"))
    assert 1 <= live["most"] <= workers + 1


@pytest.mark.parametrize("workers", [1, 3])
def test_decode_row_groups_reads_declined_row_groups_through_pyarrow(tmp_path, monkeypatch,
                                                                     workers):
    """Given the column, a row group the native decoder declines is read by
    pyarrow in its place (into its slice of ``out`` too); without it the
    row group yields None, as the whole-column read expects."""
    from pqvector_tpu_torch.io import pages as tpages

    emb = _data(n=2500, d=12, seed=7)
    path = str(tmp_path / "declined.parquet")
    write_embedding_parquet(path, emb, row_group_size=300)
    leaf_idx, leaf, rgs = tpages.embedding_leaf_meta(path, COL)
    declined = {id(rg) for rg in rgs[1::2]}
    decode = tpages.decode_rg_matrix_from_buf
    monkeypatch.setattr(tpages, "decode_rg_matrix_from_buf", lambda buf, rg, *a, **k: (
        None if id(rg) in declined else decode(buf, rg, *a, **k)))
    got = list(tpages.decode_row_groups(path, rgs, leaf_idx, leaf, workers=workers,
                                        column=COL))
    np.testing.assert_array_equal(np.concatenate(got), emb)
    out = np.full_like(emb, np.nan)
    for _ in tpages.decode_row_groups(path, rgs, leaf_idx, leaf, out=out, workers=workers,
                                      column=COL):
        pass
    np.testing.assert_array_equal(out, emb)
    plain = list(tpages.decode_row_groups(path, rgs, leaf_idx, leaf, workers=workers))
    assert [m is None for m in plain] == [i % 2 == 1 for i in range(len(rgs))]


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_parallel_row_group_decode_matches_jax(tmp_path, workers):
    """``io/pages.decode_row_groups`` decodes several row groups at once
    and yields them in order: the JAX package's sequential decoder's
    matrices, into slices of one output too; stopping early is clean."""
    from pqvector_tpu.io.pages import decode_rg_matrix_native as j_decode
    from pqvector_tpu.io.pages import embedding_leaf_meta as j_leaf_meta
    from pqvector_tpu_torch.io.pages import decode_row_groups, embedding_leaf_meta

    emb = _data(n=2500, d=12, seed=workers)
    path = str(tmp_path / "rg.parquet")
    write_embedding_parquet(path, emb, row_group_size=300)
    leaf_idx, leaf, rgs = embedding_leaf_meta(path, COL)
    jleaf_idx, jleaf, jrgs = j_leaf_meta(path, JCOL)
    with open(path, "rb") as f:
        want = [j_decode(f, rg, jleaf_idx, jleaf) for rg in jrgs]
    got = list(decode_row_groups(path, rgs, leaf_idx, leaf, workers=workers))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    out = np.empty_like(emb)
    assert all(m is not None for m in decode_row_groups(path, rgs, leaf_idx, leaf, out=out,
                                                         workers=workers))
    np.testing.assert_array_equal(out, emb)
    gen = decode_row_groups(path, rgs, leaf_idx, leaf, workers=workers)
    np.testing.assert_array_equal(next(gen), emb[:300])
    gen.close()


@pytest.mark.parametrize("layout", ["ragged", "two_dims", "plain"])
def test_column_read_shaped_from_metadata_matches_jax(tmp_path, layout):
    """The parallel read shapes its matrix from the metadata's value count;
    ragged rows whose count still divides, and row groups of two widths,
    fall back and raise the JAX package's error."""
    from pqvector_tpu.io.reader import read_embedding_column as j_read
    from pqvector_tpu_torch.io.reader import read_embedding_column as t_read

    path = str(tmp_path / f"{layout}.parquet")
    rng = np.random.default_rng(5)
    if layout == "ragged":  # lengths 3 and 5: 8 values every two rows
        rows = [rng.standard_normal(3 if i % 2 else 5).astype(np.float32) for i in range(400)]
        pq.write_table(pa.table({"embedding": pa.array(rows, pa.list_(pa.float32()))}),
                       path, row_group_size=100)
    elif layout == "two_dims":
        schema = pa.schema([("embedding", pa.list_(pa.float32()))])
        with pq.ParquetWriter(path, schema) as w:
            for d in (4, 6):
                x = rng.standard_normal((120, d)).astype(np.float32)
                w.write_table(pa.table({"embedding": pa.array(list(x), pa.list_(pa.float32()))},
                                       schema=schema))
    else:
        write_embedding_parquet(path, _data(n=900, d=12), row_group_size=200)
    try:
        want = j_read(path, JCOL).data
    except pqvector_tpu.errors.ValidationError as exc:
        with pytest.raises(ValidationError, match=str(exc)):
            t_read(path, COL)
        assert layout != "plain"
        return
    np.testing.assert_array_equal(t_read(path, COL).data, want)
    assert layout == "plain"
