"""``mode="cert"`` of the port against the JAX package's and against a
numpy float64 oracle, on the CPU (K9's plain version).

Tolerances: ids equal, except that rows whose f32 distances tie may swap
(the two packages sum the squares in other orders); distances within 1e-5
relative. ``cert_probe``'s certified masks are equal except where
``|margin|`` is under the arithmetic envelope
``max(d, 128) * 2^-21 * (|q|^2 + max |x|^2)``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pqvector_tpu_torch.query.device as tdev
from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu.query.device import _topk_min_wide as j_topk_min_wide
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import copy_searcher_knobs, index_from_reference
from pqvector_tpu_torch.kernels import _build


def _pair(x, n_clusters=8, dtype="float32", **kw):
    """The JAX searcher and the port's over one index (row_tile 128)."""
    index = j_build_ivf_index(JEmbeddings(x, x.shape[1]),
                              JIvfBuildConfig(n_clusters=n_clusters, seed=0))
    js = JSearcher(index, x, dtype=getattr(jnp, dtype), row_tile=128, **kw)
    ts = DeviceIvfSearcher(
        index_from_reference(np.asarray(index.centroids), index.list_offsets,
                             index.row_ids),
        x, dtype=getattr(torch, dtype), row_tile=128, device="cpu", **kw)
    return js, ts


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(11)
    modes = rng.uniform(-1, 1, (16, 32)).astype(np.float32)
    x = modes[rng.integers(0, 16, 3000)] + 0.15 * rng.standard_normal(
        (3000, 32)).astype(np.float32)
    queries = x[rng.integers(0, 3000, 8)] + 0.05 * rng.standard_normal(
        (8, 32)).astype(np.float32)
    return x.astype(np.float32), queries.astype(np.float32)


def _wall():
    """Planted winners 1e-3 apart inside a wall of near-ties, spaced inside
    the certificate's slack (tests/test_cert.py)."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal(24).astype(np.float32)
    dirs = rng.standard_normal((1280, 24)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = (1.0 + 2e-3 + 1e-2 * rng.random(1280)).astype(np.float32)
    radii[:40] = 1.0 + 1e-3 * np.arange(40)
    x = (base[None, :] + dirs * radii[:, None]).astype(np.float32)
    x = x[rng.permutation(1280)]
    return x, np.stack([base, base + 1e-5]).astype(np.float32)


def _oracle(x, q, k):
    d = ((x.astype(np.float64) - q[None, :].astype(np.float64)) ** 2).sum(1)
    idx = np.argsort(d, kind="stable")[:k]
    return idx, np.sqrt(d[idx])


def _assert_same(got, want, x, queries):
    """ids equal (f32 ties may swap), distances within 1e-5 relative."""
    gd, gi = got[0].numpy(), got[1].numpy()
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-7)
    for b, c in zip(*np.nonzero(gi != wi)):
        d_g = ((x[gi[b, c]] - queries[b]) ** 2).sum()
        d_w = ((x[wi[b, c]] - queries[b]) ** 2).sum()
        assert abs(d_g - d_w) <= 1e-5 * max(d_w, 1e-12), (b, c)


def _assert_oracle(got, x, queries, k):
    for b, q in enumerate(queries):
        idx, d = _oracle(x, q, k)
        np.testing.assert_array_equal(got[1].numpy()[b], idx)
        np.testing.assert_allclose(got[0].numpy()[b], d, rtol=1e-5)


@pytest.mark.parametrize("pass1", ["highest", "high", "storage"])
@pytest.mark.parametrize("sorted_", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cert_matches_jax_and_oracle(clustered, dtype, sorted_, pass1):
    x, queries = clustered
    js, ts = _pair(x, dtype=dtype, cluster_sorted=sorted_)
    js.cert_pass1 = pass1
    copy_searcher_knobs(js, ts)
    assert ts.can_cert(10) and js.can_cert(10)
    assert ts._cert_tile_checked(10) == js._cert_tile_checked(10)
    got = ts.exact(queries, 10, "cert")
    _assert_same(got, js.exact(queries, 10, "cert"), x, queries)
    _assert_oracle(got, x, queries, 10)  # bf16 storage too: pass 2 reads the f32 copy
    also = ts.search(queries, 10, 1, "cert")  # nprobe is ignored
    np.testing.assert_array_equal(also[1].numpy(), got[1].numpy())


@pytest.mark.parametrize("pass1", ["highest", "high", "storage"])
@pytest.mark.parametrize("fetch", [0, 1, 3])
def test_cert_probe_matches_jax(clustered, pass1, fetch):
    x, queries = clustered
    js, ts = _pair(x, dtype="bfloat16")
    js.cert_pass1, js.cert_fetch_tiles = pass1, fetch
    copy_searcher_knobs(js, ts)
    j_rate, j_margin = js.cert_probe(queries, 10)
    t_rate, t_margin = ts.cert_probe(queries, 10)
    assert t_margin.shape == (len(queries),)
    max_sq = (x * x).sum(1).max()
    env = 128 * 2.0**-21 * ((queries * queries).sum(1) + max_sq)
    np.testing.assert_allclose(t_margin, j_margin, atol=float(env.max()))
    differ = (t_margin >= 0) != (j_margin >= 0)
    assert (np.abs(j_margin)[differ] <= env[differ]).all()
    if not differ.any():
        assert t_rate == j_rate
    if fetch == 0 and pass1 != "storage":
        assert t_rate == 1.0
    if fetch == 1:
        assert t_rate < 1.0  # one tile cannot hold ten winners' certificate


def test_cert_narrow_fetch_falls_back_exactly(clustered, monkeypatch):
    x, queries = clustered
    js, ts = _pair(x)
    ts.cert_fetch_tiles = js.cert_fetch_tiles = 1
    calls = []
    fallback = ts._exact_fallback
    monkeypatch.setattr(ts, "_exact_fallback",
                        lambda q, k: calls.append(k) or fallback(q, k))
    got = ts.exact(queries, 10, "cert")
    assert calls == [10]  # the certificate refused, once for the whole batch
    _assert_same(got, js.exact(queries, 10, "cert"), x, queries)
    _assert_oracle(got, x, queries, 10)
    ts.cert_fetch_tiles = 0
    ts.exact(queries, 10, "cert")
    assert calls == [10]  # certified: no fallback


def test_cert_fallback_beyond_kernel_k(clustered):
    """k > 128 falls back to the plain exact scan, not to K2."""
    x, queries = clustered
    _, ts = _pair(x)
    ts.cert_fetch_tiles = 1
    got = ts.exact(queries[:2], 130, "cert")
    want = ts.exact(queries[:2], 130, "xla")
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("pass1", ["highest", "high"])
def test_cert_adversarial_ties(pass1):
    x, queries = _wall()
    js, ts = _pair(x)
    js.cert_pass1 = pass1
    copy_searcher_knobs(js, ts)
    assert ts.cert_probe(queries, 10)[0] == js.cert_probe(queries, 10)[0]
    ts.cert_fetch_tiles = js.cert_fetch_tiles = 4  # fewer than the 11 tiles
    assert ts.cert_probe(queries, 10)[0] == js.cert_probe(queries, 10)[0]
    _, ic = ts.exact(queries, 10, "cert")
    _, jc = js.exact(queries, 10, "cert")
    for b, q in enumerate(queries):
        d64 = ((x.astype(np.float64) - q[None, :]) ** 2).sum(1)
        truth = np.sort(d64)[:10]
        for ids in (ic.numpy()[b], np.asarray(jc)[b]):
            got = d64[ids]
            assert (got <= truth[-1] + 1e-5).all()
            np.testing.assert_allclose(np.sort(got)[:9], truth[:9], atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cert_pass2_forms_agree(clustered, dtype, monkeypatch):
    """"fused", "scan" and "auto" (on either side of the budget) return the
    same bits."""
    x, queries = clustered
    _, ts = _pair(x, dtype=dtype)
    outs = []
    for form, budget in (("fused", None), ("scan", None), ("auto", None), ("auto", 0)):
        if budget is not None:
            monkeypatch.setattr(tdev, "_CERT_FUSE_BUDGET", budget)
        ts.cert_pass2 = form
        d, ids = ts.exact(queries, 10, "cert")
        outs.append((d.numpy(), ids.numpy()))
    for d, ids in outs[1:]:
        np.testing.assert_array_equal(ids, outs[0][1])
        np.testing.assert_array_equal(d, outs[0][0])


def test_cert_k_exceeds_rows():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    js, ts = _pair(x, n_clusters=4)
    d, ids = ts.exact(q, 60, "cert")
    jd, ji = js.exact(q, 60, "cert")
    assert ids.shape == (3, 60)
    assert (ids[:, :50] >= 0).all() and (ids[:, 50:] == -1).all()
    assert torch.isinf(d[:, 50:]).all()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)


@pytest.mark.parametrize("pass1", ["highest", "storage"])
def test_cert_loops_match_single_calls(clustered, pass1):
    x, queries = clustered
    js, ts = _pair(x, dtype="bfloat16")
    js.cert_pass1 = pass1
    copy_searcher_knobs(js, ts)
    d, ids = ts.exact(queries, 10, "cert")
    for got in (ts.exact_loop(queries, 10, reps=2, mode="cert"),
                ts.search_loop(queries, 10, nprobe=1, reps=2, mode="cert")):
        np.testing.assert_array_equal(got[1].numpy(), ids.numpy())
        np.testing.assert_array_equal(got[0].numpy(), d.numpy())
    _, jl = js.exact_loop(queries, k=10, reps=2, mode="cert")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jl))


@pytest.mark.parametrize("chunk", [128, 333, 65536])
@pytest.mark.parametrize("m", [1, 7, 1000])
def test_topk_min_wide_chunked_matches_direct_and_jax(m, chunk):
    rng = np.random.default_rng(9)
    keys = rng.integers(-50, 50, (4, 1000)).astype(np.float32)  # many ties
    v, i = tdev._topk_min_wide(torch.from_numpy(keys), m, chunk=chunk)
    order = np.argsort(keys, axis=1, kind="stable")[:, :m]  # ties: lower column
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(keys, order, 1))
    jv, ji = j_topk_min_wide(jnp.asarray(keys), m, chunk=chunk)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k", [1, 3, 64])
def test_select_cols_orders_ties_by_column(k):
    rng = np.random.default_rng(k)
    d = rng.integers(0, 4, (6, 64)).astype(np.float32)
    d[0] = np.inf
    d[1, 10:] = np.inf
    v, c = tdev.select_cols(torch.from_numpy(d), k)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(c.numpy(), order)
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(d, order, 1))


@pytest.mark.parametrize(
    "knob,value",
    [("cert_pass1", "bogus"), ("cert_pass2", "both"), ("tilescan_tile", 96),
     ("tilescan_tile", 1)],
)
def test_cert_rejects_bad_knobs(clustered, knob, value):
    x, queries = clustered
    _, ts = _pair(x)
    setattr(ts, knob, value)
    with pytest.raises(ValidationError):
        ts.exact(queries, 10, "cert")
    if knob == "tilescan_tile":
        assert not ts.can_cert(10)


def test_cert_tile_knob_and_auto_shrink(clustered):
    x, queries = clustered
    js, ts = _pair(x)
    for tile in (2, 16, 64):
        ts.tilescan_tile = js.tilescan_tile = tile
        assert ts._cert_tile_checked(10) == tile
        _assert_same(ts.exact(queries, 10, "cert"), js.exact(queries, 10, "cert"),
                     x, queries)
    ts.tilescan_tile = js.tilescan_tile = 0
    for k in (10, 40, 200, 2000):  # auto: 128, halved while k exceeds the tiles
        assert ts._cert_tile_checked(k) == js._cert_tile_checked(k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fetch", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cert_on_card_equals_k2(cuda_device, clustered, dtype, fetch):
    """On the card cert runs K9 and, when the certificate refuses, K2."""
    x, queries = clustered
    index = j_build_ivf_index(JEmbeddings(x, 32), JIvfBuildConfig(n_clusters=8, seed=0))
    ts = DeviceIvfSearcher(
        index_from_reference(np.asarray(index.centroids), index.list_offsets,
                             index.row_ids),
        x, dtype=getattr(torch, dtype), row_tile=128, device=cuda_device)
    ts.cert_fetch_tiles = fetch
    before = dict(_build.LAUNCHES)
    d, ids = ts.exact(queries, 10, "cert")
    assert _build.LAUNCHES["K9"] == before["K9"] + 1
    assert _build.LAUNCHES["K2"] == before["K2"] + fetch
    _assert_oracle((d.cpu(), ids.cpu()), x, queries, 10)
