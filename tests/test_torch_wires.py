"""The build's bf16 and int8 transfer wires and the host assignment in the
port against the JAX package on the CPU.

Twins of the 15 tests of ``tests/test_staged_build.py`` and of the wire
tests of ``tests/test_streaming.py``: the same seeded numpy rows go through
``pqvector_tpu.index.build`` and ``pqvector_tpu_torch.index.build``. On the
l2 metric the index bytes are equal; with ``normalize`` the port's staged
build equals its in-memory build on rows normalized the same way (XLA sums
a row's squares in another order than torch, so the cosine rows may differ
from the JAX package's in the last bit). The wire encoders and the host
assignment are equal bit for bit. K1's bf16-row form equals K1 over the
widened rows. Tolerance: none.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import pqvector_tpu.index.build as jb
from pqvector_tpu.bench.datasets import write_embedding_parquet
from pqvector_tpu.types import Embeddings as JEmbeddings
from pqvector_tpu_torch import ValidationError
from pqvector_tpu_torch.index import build as tb
from pqvector_tpu_torch.kernels import _build
from pqvector_tpu_torch.kernels.assign import (
    assign_clusters,
    assign_rows,
    assign_rows_plain,
    bf16_route,
)
from pqvector_tpu_torch.types import Embeddings

WIRES = ["bfloat16", "int8"]


def _data(n=4000, d=24, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, d)).astype(np.float32) * 4
    pick = rng.integers(0, 32, n)
    return centers[pick] + rng.standard_normal((n, d)).astype(np.float32)


def _file(tmp_path, emb, row_group_size, name="e.parquet"):
    path = str(tmp_path / name)
    write_embedding_parquet(path, emb, row_group_size=row_group_size)
    return path


def _cfg(**kw):
    return tb.IvfBuildConfig(**kw), jb.IvfBuildConfig(**kw)


def _normalized(emb):
    x = torch.from_numpy(emb)
    return (x / (x * x).sum(dim=1, keepdim=True).sqrt().clamp_min(1e-30)).numpy()


def _labels(index, n):
    lab = np.empty(n, np.int64)
    for c in range(index.n_clusters):
        lab[index.cluster_rows(c)] = c
    return lab


# ---------------------------------------------------------------- the builds


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("wire", WIRES)
def test_staged_matches_unstaged_under_the_wire(tmp_path, wire, normalize):
    """n = 4000 at 64 clusters trains on a 200-row sample; 1500-row groups
    make several chunks. Staged equals in-memory on the same rows, and at
    l2 both equal the JAX package's staged and in-memory builds."""
    emb = _data()
    path = _file(tmp_path, emb, 1500)
    tcfg, jcfg = _cfg(n_clusters=64, seed=11, transfer_dtype=wire)
    staged = tb.build_ivf_index_staged(path, "embedding", tcfg, batch_rows=700,
                                       normalize=normalize, device="cpu")
    data = _normalized(emb) if normalize else emb
    if normalize and wire == "bfloat16":
        # the staged build normalizes the widened bf16 rows
        data = _normalized(tb._bf16_tensor(tb._cast_bf16(emb)).float().numpy())
        tcfg = tb.IvfBuildConfig(n_clusters=64, seed=11)
    if normalize and wire == "int8":
        codes, scales = tb._encode_int8(emb)
        data = _normalized(tb._dequant_i8(torch.from_numpy(codes),
                                          torch.from_numpy(scales)).numpy())
        tcfg = tb.IvfBuildConfig(n_clusters=64, seed=11)
    unstaged = tb.build_ivf_index(Embeddings(data, emb.shape[1]), tcfg, device="cpu")
    assert staged.to_bytes() == unstaged.to_bytes()
    if not normalize:
        want = jb.build_ivf_index_staged(path, "embedding", jcfg, batch_rows=700)
        assert staged.to_bytes() == want.to_bytes()
        want = jb.build_ivf_index(JEmbeddings(emb, emb.shape[1]), jcfg)
        assert staged.to_bytes() == want.to_bytes()


@pytest.mark.parametrize("wire", WIRES)
def test_staged_matches_unstaged_reduced_wire(tmp_path, wire):
    """The wire encoders are row-local: chunked and whole-matrix encoding
    give one index, the JAX package's."""
    emb = _data()
    path = _file(tmp_path, emb, 1500, "w.parquet")
    tcfg, jcfg = _cfg(n_clusters=64, seed=11, transfer_dtype=wire)
    staged = tb.build_ivf_index_staged(path, "embedding", tcfg, batch_rows=700,
                                       device="cpu")
    unstaged = tb.build_ivf_index(Embeddings(emb, emb.shape[1]), tcfg, device="cpu")
    want = jb.build_ivf_index_staged(path, "embedding", jcfg, batch_rows=700)
    np.testing.assert_array_equal(staged.centroids, unstaged.centroids)
    np.testing.assert_array_equal(staged.row_ids, unstaged.row_ids)
    np.testing.assert_array_equal(staged.list_offsets, unstaged.list_offsets)
    assert staged.to_bytes() == want.to_bytes()


def test_int8_wire_partition_quality():
    """The int8 rounding moves only a few rows: >95% keep the f32 build's
    cluster on separated data; the port's int8 partition is the JAX
    package's."""
    emb = _data(n=3000, d=16, seed=9)
    f32 = tb.build_ivf_index(Embeddings(emb, 16), tb.IvfBuildConfig(n_clusters=16, seed=2),
                             device="cpu")
    tcfg, jcfg = _cfg(n_clusters=16, seed=2, transfer_dtype="int8")
    i8 = tb.build_ivf_index(Embeddings(emb, 16), tcfg, device="cpu")
    assert (_labels(f32, 3000) == _labels(i8, 3000)).mean() > 0.95
    want = jb.build_ivf_index(JEmbeddings(emb, 16), jcfg)
    np.testing.assert_array_equal(_labels(i8, 3000), _labels(want, 3000))


@pytest.mark.parametrize("wire", WIRES)
def test_staged_full_sample_branch(tmp_path, wire):
    """sample_size == n: training sees every (rounded) row."""
    emb = _data(n=300, d=8)
    path = _file(tmp_path, emb, 100, "s.parquet")
    tcfg, jcfg = _cfg(n_clusters=8, seed=5, transfer_dtype=wire)
    staged = tb.build_ivf_index_staged(path, "embedding", tcfg, batch_rows=128, device="cpu")
    unstaged = tb.build_ivf_index(Embeddings(emb, 8), tcfg, device="cpu")
    want = jb.build_ivf_index_staged(path, "embedding", jcfg, batch_rows=128)
    assert staged.to_bytes() == unstaged.to_bytes() == want.to_bytes()


def test_staged_worker_error_propagates(tmp_path, monkeypatch):
    """A failure of the wire encode reaches the caller as itself."""
    emb = _data(n=2000, d=8)
    path = _file(tmp_path, emb, 250, "err.parquet")

    def boom(part, codes=None, scales=None):
        raise RuntimeError("wire worker boom")

    monkeypatch.setattr(tb, "_encode_int8", boom)
    cfg = tb.IvfBuildConfig(n_clusters=8, seed=1, transfer_dtype="int8")
    with pytest.raises(RuntimeError, match="wire worker boom"):
        tb.build_ivf_index_staged(path, "embedding", cfg, batch_rows=100, device="cpu")


def test_decode_workers_raise_what_post_raises(tmp_path):
    """The card's staged path encodes inside the decode workers
    (``decode_row_groups(post=...)``): what the encode raises there reaches
    the consumer, and what it returns is yielded in row-group order."""
    from pqvector_tpu_torch.io.pages import decode_row_groups, embedding_leaf_meta
    from pqvector_tpu_torch.types import EmbeddingColumn

    emb = _data(n=1000, d=8)
    path = _file(tmp_path, emb, 250, "post.parquet")
    leaf_idx, leaf, rgs = embedding_leaf_meta(path, EmbeddingColumn("embedding"))
    got = list(decode_row_groups(path, rgs, leaf_idx, leaf, workers=3,
                                 column=EmbeddingColumn("embedding"),
                                 post=lambda i, m: (i, m.copy())))
    assert [i for i, _ in got] == [0, 1, 2, 3]
    np.testing.assert_array_equal(np.concatenate([m for _, m in got]), emb)

    def boom(i, m):
        if i == 2:
            raise RuntimeError("encode boom")
        return m

    with pytest.raises(RuntimeError, match="encode boom"):
        list(decode_row_groups(path, rgs, leaf_idx, leaf, workers=3,
                               column=EmbeddingColumn("embedding"), post=boom))


# ---------------------------------------------------------------- encoders


@pytest.mark.parametrize("native", [True, False])
def test_native_int8_encode_matches_oracle(monkeypatch, native):
    """Native and numpy int8 codes, the port's and the JAX package's, are
    one: zero rows (scale 1, codes 0) and magnitudes near the f32 maximum."""
    if not native:
        monkeypatch.setattr("pqvector_tpu_torch.io.native.load", lambda: None)
    rng = np.random.default_rng(12)
    part = rng.standard_normal((700, 33)).astype(np.float32) * 100
    part[5] = 0.0
    part[6, 0] = np.float32(3.2e38)
    c_t, s_t = tb._encode_int8(part)
    c_o, s_o = tb._encode_int8_np(part)
    c_j, s_j = jb._encode_int8(part)
    for c, s in ((c_o, s_o), (c_j, s_j), jb._encode_int8_np(part)):
        np.testing.assert_array_equal(c_t, c)
        np.testing.assert_array_equal(s_t, s)
    codes, scales = np.empty_like(c_t), np.empty_like(s_t)
    tb._encode_int8(part, codes=codes, scales=scales)
    np.testing.assert_array_equal(codes, c_t)
    np.testing.assert_array_equal(scales, s_t)


def _edge_values():
    rng = np.random.default_rng(7)
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    return np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                  1e-40, -1e-40, 3.4e38, -3.4e38, tiny, -tiny, 1.1754942e-38,
                  1.0039062, 1.0039063, 1.0117186, 1.0117188,  # halfway cases
                  1.00390625, 1.01171875, -1.00390625, -1.01171875, 2.0],
                 np.float32),
    ]).reshape(-1, 2)


@pytest.mark.parametrize("native", [True, False])
def test_native_bf16_cast_matches_mldtypes(monkeypatch, native):
    """The port's cast (native, or numpy integer arithmetic without the
    library) gives the JAX package's bits: halfway cases to even,
    subnormals, +-inf, and the f32 maximum rounding to inf; a NaN stays a
    NaN. The numpy form keeps the NaN bits of ``ml_dtypes`` too."""
    import ml_dtypes

    if not native:
        monkeypatch.setattr("pqvector_tpu_torch.io.native.load", lambda: None)
    vals = _edge_values()
    got = tb._cast_bf16(vals)
    want = jb._cast_bf16(vals).view(np.uint16)
    assert got.dtype == np.uint16 and got.shape == vals.shape
    nan = np.isnan(vals)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(tb._bf16_tensor(got).float().numpy()[nan]).all()
    np.testing.assert_array_equal(tb._cast_bf16_np(vals),
                                  vals.astype(ml_dtypes.bfloat16).view(np.uint16))
    out = np.empty(vals.shape, np.uint16)
    assert tb._cast_bf16(vals, out=out) is out
    np.testing.assert_array_equal(out, got)
    with pytest.raises(ValueError, match="contiguous uint16"):
        tb._cast_bf16(vals, out=np.empty((vals.shape[0], 4), np.uint16)[:, ::2])
    with pytest.raises(ValueError, match="contiguous int8"):
        tb._encode_int8(vals[:, :1].copy(), codes=np.empty((vals.shape[0], 2), np.int8))


def test_dequant_is_one_rounding_an_element():
    """``codes.float() * scale``: the JAX package's dequantized rows."""
    import jax.numpy as jnp

    codes, scales = tb._encode_int8(_data(n=500, d=16, seed=4))
    got = tb._dequant_i8(torch.from_numpy(codes), torch.from_numpy(scales)).numpy()
    want = np.asarray(jb._dequant_i8(jnp.asarray(codes), jnp.asarray(scales)))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- host assign


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_host_assign_matches_device(tmp_path, wire):
    """Centroids equal the device build's bit for bit; at the f32 wire the
    partitions are equal; the host ids read the exact rows (> 99.9% nearest
    by the f64 truth); the index is the JAX package's host build's."""
    emb = _data()
    path = _file(tmp_path, emb, 1500, "h.parquet")
    dev = tb.build_ivf_index_staged(
        path, "embedding",
        tb.IvfBuildConfig(n_clusters=64, seed=11, transfer_dtype=wire,
                          assign_backend="device"), batch_rows=700, device="cpu")
    tcfg, jcfg = _cfg(n_clusters=64, seed=11, transfer_dtype=wire, assign_backend="host")
    host = tb.build_ivf_index_staged(path, "embedding", tcfg, batch_rows=700, device="cpu")
    np.testing.assert_array_equal(host.centroids, dev.centroids)
    if wire == "float32":
        assert host.to_bytes() == dev.to_bytes()
    d2 = ((emb[:, None, :].astype(np.float64)
           - host.centroids[None].astype(np.float64)) ** 2).sum(-1)
    assert (_labels(host, len(emb)) == np.argmin(d2, axis=1)).mean() > 0.999
    want = jb.build_ivf_index_staged(path, "embedding", jcfg, batch_rows=700)
    assert host.to_bytes() == want.to_bytes()


def test_host_assign_normalized(tmp_path):
    """Cosine: the sample is normalized on the device, the host normalizes
    each block; the partitions agree with the device build's."""
    emb = _data()
    path = _file(tmp_path, emb, 1500, "hn.parquet")
    dev = tb.build_ivf_index_staged(
        path, "embedding", tb.IvfBuildConfig(n_clusters=32, seed=4, assign_backend="device"),
        batch_rows=700, normalize=True, device="cpu")
    host = tb.build_ivf_index_staged(
        path, "embedding", tb.IvfBuildConfig(n_clusters=32, seed=4, assign_backend="host"),
        batch_rows=700, normalize=True, device="cpu")
    np.testing.assert_array_equal(host.centroids, dev.centroids)
    np.testing.assert_array_equal(host.row_ids, dev.row_ids)


def test_host_assign_full_sample_branch(tmp_path):
    emb = _data(n=300, d=8)
    path = _file(tmp_path, emb, 100, "hs.parquet")
    dev = tb.build_ivf_index_staged(
        path, "embedding", tb.IvfBuildConfig(n_clusters=8, seed=5, assign_backend="device"),
        batch_rows=128, device="cpu")
    tcfg, jcfg = _cfg(n_clusters=8, seed=5, assign_backend="host")
    host = tb.build_ivf_index_staged(path, "embedding", tcfg, batch_rows=128, device="cpu")
    assert host.to_bytes() == dev.to_bytes()
    assert host.to_bytes() == jb.build_ivf_index_staged(
        path, "embedding", jcfg, batch_rows=128).to_bytes()


def test_assign_backend_validation():
    with pytest.raises(ValidationError):
        tb.IvfBuildConfig(assign_backend="gpu")
    assert tb.resolve_assign_backend(tb.IvfBuildConfig()) == "device"
    assert tb.resolve_assign_backend(tb.IvfBuildConfig(assign_backend="host")) == "host"


def _near_tie_case(n, d, k, seed, cseed):
    emb = _data(n=n, d=d, seed=seed)
    rng = np.random.default_rng(cseed)
    return emb, emb[rng.integers(0, len(emb), k)] + 0.01


@pytest.mark.parametrize("normalize", [False, True])
def test_host_gemm_bf16_matches_f32_exactly(normalize):
    """The certified bf16 GEMM returns the f32 sgemm's partition, on
    centroids drawn from the data (near ties that take the f32 re-score),
    deterministically; both GEMMs give the JAX package's ids."""
    emb, centroids = _near_tie_case(3000, 32, 48, 9, 1)
    parts = [emb[:1200], emb[1200:]]
    got = {}
    for gemm in ("f32", "bf16"):
        got[gemm] = tb._assign_clusters_host(parts, centroids, block_rows=512, gemm=gemm,
                                             normalize=normalize)
        want = jb._assign_clusters_host(parts, centroids, block_rows=512, gemm=gemm,
                                        normalize=normalize)
        np.testing.assert_array_equal(got[gemm], want)
    np.testing.assert_array_equal(got["f32"], got["bf16"])
    again = tb._assign_clusters_host(parts, centroids, block_rows=512, gemm="bf16",
                                     normalize=normalize)
    np.testing.assert_array_equal(again, got["bf16"])


@pytest.mark.parametrize("amx", [True, False])
@pytest.mark.parametrize("env", [None, "bf16", "f32"])
def test_resolve_host_gemm_gating(monkeypatch, env, amx):
    """The environment override wins; otherwise bf16 only on a lossy wire
    with AMX-BF16: the JAX package's rule, case for case."""
    if env is None:
        monkeypatch.delenv("PQVECTOR_TPU_HOST_GEMM", raising=False)
    else:
        monkeypatch.setenv("PQVECTOR_TPU_HOST_GEMM", env)
    monkeypatch.setattr(tb, "_HOST_AMX_BF16", amx)
    monkeypatch.setattr(jb, "_HOST_AMX_BF16", amx)
    for wire in ("float32", "bfloat16", "int8"):
        assert tb.resolve_host_gemm(wire) == jb.resolve_host_gemm(wire)
    if env is None:
        assert tb.resolve_host_gemm("float32") == "f32"
        assert tb.resolve_host_gemm("bfloat16") == ("bf16" if amx else "f32")
    else:
        assert tb.resolve_host_gemm("int8") == env


def test_host_gemm_reads_the_environment(monkeypatch):
    """``PQVECTOR_TPU_HOST_GEMM`` picks the GEMM of a host-assign build: the
    same index either way."""
    emb, centroids = _near_tie_case(2000, 16, 24, 3, 5)
    ids = []
    for gemm in ("f32", "bf16"):
        monkeypatch.setenv("PQVECTOR_TPU_HOST_GEMM", gemm)
        ids.append(tb._assign_clusters_host([emb], centroids,
                                            gemm=tb.resolve_host_gemm("bfloat16")))
    np.testing.assert_array_equal(ids[0], ids[1])


def test_host_gemm_bf16_numpy_fallback_matches(monkeypatch):
    """Without the native library both GEMMs take numpy's argmin and
    margins: the same ids, the JAX package's under the same fallback."""
    monkeypatch.setattr("pqvector_tpu_torch.io.native.load", lambda: None)
    monkeypatch.setattr("pqvector_tpu.io.native.load", lambda: None)
    emb, centroids = _near_tie_case(2000, 32, 40, 12, 2)
    for gemm in ("f32", "bf16"):
        got = tb._assign_clusters_host([emb], centroids, block_rows=512, gemm=gemm)
        want = jb._assign_clusters_host([emb], centroids, block_rows=512, gemm=gemm)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, tb._assign_clusters_host([emb], centroids, block_rows=512, gemm="f32"))


def test_native_assign_margin_bf16_vs_oracle():
    """The port's binding of the native two-minimum pass (argtypes set) on
    odd k, k < 16, duplicated minima and random envelopes."""
    import ctypes

    import ml_dtypes

    from pqvector_tpu_torch.io.native import load

    lib = load()
    if lib is None or not hasattr(lib, "pqv_assign_margin_bf16"):
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(33)
    for n, k in ((64, 1000), (33, 37), (16, 5), (7, 16), (5, 1)):
        sc = rng.standard_normal((n, k)).astype(np.float32)
        if k >= 3:
            sc[0, 2] = sc[0, 0]
        sb = sc.astype(ml_dtypes.bfloat16)
        bias = rng.standard_normal(k).astype(np.float32) ** 2
        env = np.abs(rng.standard_normal(n).astype(np.float32)) * 0.05
        red = bias[None, :] - 2.0 * sb.astype(np.float32)
        oidx = np.argmin(red, axis=1).astype(np.int32)
        r2 = red.copy()
        r2[np.arange(n), oidx] = np.inf
        m2 = r2.min(axis=1) if k > 1 else np.full(n, np.inf, np.float32)
        oamb = (m2 - red[np.arange(n), oidx]) <= env
        idx = np.empty(n, np.int32)
        amb = np.empty(n, np.uint8)
        rc = lib.pqv_assign_margin_bf16(
            sb.view(np.uint16).ctypes.data_as(ctypes.c_void_p), n, k,
            bias.ctypes.data_as(ctypes.c_void_p), env.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.c_void_p), amb.ctypes.data_as(ctypes.c_void_p))
        assert rc == 0
        np.testing.assert_array_equal(idx, oidx, err_msg=f"k={k}")
        np.testing.assert_array_equal(amb.astype(bool), oamb, err_msg=f"k={k}")


# ---------------------------------------------------------------- front door


def test_bf16_transfer_build_matches_f32_quality(tmp_path):
    """``IndexBuilder.transfer_dtype("bfloat16").build_inplace()``: a valid
    index whose co-assignment agrees with the f32 build's on >= 98% of row
    pairs, with the JAX package's bytes; unknown dtypes raise."""
    import pqvector_tpu
    from pqvector_tpu_torch.builder import IndexBuilder

    rng = np.random.default_rng(33)
    n, d = 3000, 16
    centers = rng.uniform(-4, 4, (8, d)).astype(np.float32)
    x = (centers[rng.integers(0, 8, n)] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    offsets = pa.array(np.arange(n + 1, dtype=np.int32) * d)
    table = pa.table({"id": pa.array(np.arange(n)),
                      "vec": pa.ListArray.from_arrays(offsets, pa.array(x.reshape(-1)))})
    paths = []
    for name in ("f32.parquet", "bf16.parquet", "jax.parquet"):
        paths.append(str(tmp_path / name))
        pq.write_table(table, paths[-1])
    f32 = IndexBuilder(paths[0], "vec", device="cpu").n_clusters(8).seed(3).build_inplace()
    bf16 = (IndexBuilder(paths[1], "vec", device="cpu").n_clusters(8).seed(3)
            .transfer_dtype("bfloat16").build_inplace())
    want = (pqvector_tpu.IndexBuilder(paths[2], "vec").n_clusters(8).seed(3)
            .transfer_dtype("bfloat16").build_inplace())
    assert bf16.n_clusters == 8 and bf16.total_rows == n
    assert bf16.to_bytes() == want.to_bytes()
    a, b = _labels(f32, n), _labels(bf16, n)
    pairs = rng.integers(0, n, (500, 2))
    same_a = a[pairs[:, 0]] == a[pairs[:, 1]]
    same_b = b[pairs[:, 0]] == b[pairs[:, 1]]
    assert (same_a == same_b).mean() >= 0.98
    with pytest.raises(ValidationError, match="transfer_dtype"):
        tb.IvfBuildConfig(transfer_dtype="float16")
    with pytest.raises(ValidationError, match="transfer dtype"):
        IndexBuilder(paths[0], "vec", device="cpu").transfer_dtype("int4")


def test_transfer_dtype_auto_resolution():
    assert tb.IvfBuildConfig().transfer_dtype == "auto"
    for wire in ("auto", "float32", "bfloat16", "int8"):
        assert tb.resolve_transfer_dtype(tb.IvfBuildConfig(transfer_dtype=wire)) == (
            jb.resolve_transfer_dtype(jb.IvfBuildConfig(transfer_dtype=wire)))
    assert tb.resolve_transfer_dtype(tb.IvfBuildConfig()) == "float32"


# ---------------------------------------------------------------- K1 on bf16 rows


def _bf16_rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("n,d,k", [(1, 3, 1), (777, 24, 13), (9000, 16, 40)])
def test_k1_bf16_rows_equal_k1_over_widened_rows_on_cpu(n, d, k):
    """``assign_rows`` on bf16 rows (more than one plain block at n = 9000)
    gives the ids over ``x.float()`` bit for bit, and launches nothing on
    the CPU; ``assign_clusters`` keeps a bf16 tensor bf16."""
    x = _bf16_rows(n, d, seed=n + k)
    c = torch.from_numpy(np.random.default_rng(k).standard_normal((k, d)).astype(np.float32))
    before = dict(_build.LAUNCHES)
    got = assign_rows(x, c)
    assert _build.LAUNCHES == before
    assert got.dtype == torch.int32
    assert torch.equal(got, assign_rows(x.float(), c))
    assert torch.equal(got, assign_rows_plain(x, c))
    np.testing.assert_array_equal(assign_clusters(x, c, device="cpu"), got.numpy())


def test_k1_rejects_other_row_dtypes():
    with pytest.raises(TypeError):
        assign_rows(torch.zeros(4, 8, dtype=torch.float16), torch.zeros(2, 8))
    with pytest.raises(TypeError):
        assign_rows(torch.zeros(4, 8, dtype=torch.bfloat16),
                    torch.zeros(2, 8, dtype=torch.bfloat16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1, 3, 1), (129, 100, 7), (100_003, 128, 1024),
                                   (4097, 1024, 1000)])
def test_k1_bf16_kernel_equals_plain_on_card(cuda_device, n, d, k):
    """The bf16-row form of K1 against its plain version and against the
    f32 form over the widened rows: ids equal bit for bit. It is one launch
    of the FMA form, or one of the screen and at most one re-score."""
    x = _bf16_rows(n, d, seed=d).to(cuda_device)
    c = torch.from_numpy(np.random.default_rng(k).standard_normal((k, d)).astype(
        np.float32)).to(cuda_device)
    before = dict(_build.LAUNCHES)
    got = assign_rows(x, c)
    torch.cuda.synchronize()
    made = {key: _build.LAUNCHES[key] - before[key] for key in before}
    screened = made["K1_bf16_screen"]
    assert screened == (bf16_route(d, k, x.data_ptr()) == "screen")
    assert made["K1_bf16"] == 1 + screened * made["K1_bf16_rescore"]
    assert torch.equal(got, assign_rows_plain(x, c))
    assert torch.equal(got, assign_rows(x.float(), c))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_staged_wire_build_on_card_equals_in_memory(cuda_device, tmp_path, wire):
    """The card's staged path (encode in the decode workers, pinned wire
    slots, side-stream copies) gives the in-memory build's bytes."""
    emb = _data(n=20_000, d=64)
    path = _file(tmp_path, emb, 3000)
    cfg = tb.IvfBuildConfig(n_clusters=64, seed=11, transfer_dtype=wire)
    staged = tb.build_ivf_index_staged(path, "embedding", cfg, device=cuda_device)
    unstaged = tb.build_ivf_index(Embeddings(emb, 64), cfg, device=cuda_device)
    assert staged.to_bytes() == unstaged.to_bytes()
