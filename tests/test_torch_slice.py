"""The port's slice end to end on the CPU, against the JAX package.

A small Parquet file is indexed in place by each package; both read either
file. ``DeviceIvfSearcher(..., cluster_sorted=True)`` of each package then
serves the same index and rows, and every ported mode is compared with the
JAX package's: exact ``auto``/``stream``/``pallas``/``binscan``/``binscan8``/
``cert``/``approx``, search ``auto``/``stream``/``pallas``/``gather``/
``binscan``/``binscan8``/``bincompact``/``bincompact8``/``cert``/``scan``/
``approx``/``masked``/``compact``, both ``xbin``/``xbin8``/``autoscan``
(``tilescan`` refuses the sorted layout in both) and the loops, at f32 and
at bf16 with the f32 re-score,
and the layout in file order through K6. The rows lie on a 1/4 grid with
|x| <= 4, so bf16 stores them exactly and bf16 selection can be held to the same ids (data whose
neighbours lie closer than bf16's 2^-8 would select differently; that is
what the re-score copy is for). Many distances tie there. The comparison is
under the (distance, id) order, d² at rtol 1e-5 and atol 1e-5 * |q|^2; ids
tied with the k-th distance may differ, because the JAX stream kernels and
gather path do not always keep the lower id at the boundary. Among
themselves the port's modes must agree exactly.
"""

import os
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import pqvector_tpu
import pqvector_tpu_torch
from pqvector_tpu.io.embed import read_index_from_parquet as j_read_index
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher
from pqvector_tpu_torch.convert import copy_searcher_knobs
from pqvector_tpu_torch.errors import ValidationError
from pqvector_tpu_torch.io.embed import read_index_from_parquet as t_read_index

N, D, KC, K, NPROBE, TILE = 3000, 16, 12, 10, 3, 256


def _grid_file(path, seed):
    rng = np.random.default_rng(seed)
    cent = rng.integers(-8, 9, (KC, D)).astype(np.float32) / 4.0
    x = cent[rng.integers(0, KC, N)] + rng.integers(-2, 3, (N, D)).astype(np.float32) / 4.0
    vec = pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1)), D)
    pq.write_table(pa.table({"id": np.arange(N), "embedding": vec}), path)
    q = x[rng.integers(0, N, 8)] + rng.integers(-1, 2, (8, D)).astype(np.float32) / 4.0
    return x, q


@pytest.fixture(scope="module", params=["port", "jax"])
def indexed(request, tmp_path_factory):
    """A grid file indexed in place by the port or by the JAX package."""
    path = tmp_path_factory.mktemp(request.param) / "slice.parquet"
    x, q = _grid_file(path, seed=11)
    if request.param == "port":
        builder = pqvector_tpu_torch.IndexBuilder(path, "embedding", device="cpu")
    else:
        builder = pqvector_tpu.IndexBuilder(path, "embedding")
    built = builder.n_clusters(KC).build_inplace()
    assert pqvector_tpu_torch.has_pq_vector_index(path)
    assert pqvector_tpu.io.embed.has_pq_vector_index(path)
    assert t_read_index(path)[0].to_bytes() == built.to_bytes()
    assert j_read_index(path)[0].to_bytes() == built.to_bytes()
    return path, x, q


def _canon(d, i):
    d = np.asarray(d, np.float64)
    i = np.asarray(i).astype(np.int64)
    d = np.where(i >= 0, d, np.inf)
    i = np.where(np.isfinite(d), i, -1)
    order = np.lexsort((i, d), axis=-1)
    return np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)


def assert_match(got, want, q):
    gd, gi = _canon(*(t.numpy() if isinstance(t, torch.Tensor) else t for t in got))
    wd, wi = _canon(*(np.asarray(t) for t in want))
    scale = float((q.astype(np.float64) ** 2).sum(1).max())
    # sqrt distances: compare squares at the stated d² tolerance
    np.testing.assert_allclose(gd ** 2, wd ** 2, rtol=1e-5, atol=1e-5 * scale)
    kth = np.where(np.isfinite(wd), wd, -np.inf).max(axis=1, keepdims=True)
    inner = wd ** 2 < kth ** 2 - 1e-5 * scale
    np.testing.assert_array_equal(np.where(inner, gi, 0), np.where(inner, wi, 0))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def searchers(request, indexed):
    path, x, q = indexed
    jdt = jnp.float32 if request.param == "float32" else jnp.bfloat16
    tdt = torch.float32 if request.param == "float32" else torch.bfloat16
    index, _ = j_read_index(path)
    js = JSearcher(index, x, dtype=jdt, row_tile=TILE, cluster_sorted=True)
    ts = DeviceIvfSearcher.from_parquet(path, dtype=tdt, row_tile=TILE,
                                        cluster_sorted=True, device="cpu")
    assert ts._ref() is None if tdt == torch.float32 else ts._ref() is not None
    return js, ts, q


@pytest.mark.parametrize("jmode,tmode", [("xla", "auto"), ("stream", "stream"), ("xla", "xla")])
def test_exact_matches_jax(searchers, jmode, tmode):
    js, ts, q = searchers
    assert_match(ts.exact(q, K, tmode), js.exact(q, K, jmode), q)


@pytest.mark.parametrize(
    "jmode,tmode",
    [("gather", "auto"), ("stream", "stream"), ("pallas", "pallas"), ("gather", "gather")],
)
def test_search_matches_jax(searchers, jmode, tmode):
    js, ts, q = searchers
    assert_match(ts.search(q, K, NPROBE, tmode), js.search(q, K, NPROBE, jmode), q)


@pytest.mark.parametrize(
    "call,mode",
    [("exact", "pallas"), ("exact", "binscan"), ("exact", "binscan8"),
     ("search", "binscan"), ("search", "binscan8"), ("search", "bincompact"),
     ("search", "bincompact8")],
)
def test_slice2_modes_match_jax(searchers, call, mode):
    js, ts, q = searchers
    args = (q, K) if call == "exact" else (q, K, NPROBE)
    assert_match(getattr(ts, call)(*args, mode), getattr(js, call)(*args, mode), q)


def test_port_modes_agree_exactly(searchers):
    _, ts, q = searchers
    ref = ts.exact(q, K, "xla")
    for mode in ("auto", "stream"):
        got = ts.exact(q, K, mode)
        assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
    ref = ts.search(q, K, NPROBE, "gather")
    for mode in ("auto", "stream", "pallas"):
        got = ts.search(q, K, NPROBE, mode)
        assert torch.equal(got[1], ref[1]), mode
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)


def test_more_k_than_candidates(searchers):
    """k beyond the probed rows (and beyond a kernel's 128, so ``auto``
    takes gather): -1 ids and +inf distances, as in JAX."""
    js, ts, q = searchers
    got_d, got_i = ts.search(q, 300, 1)
    want_d, want_i = js.search(q, 300, 1, "gather")
    np.testing.assert_array_equal((got_i.numpy() < 0).sum(1), (np.asarray(want_i) < 0).sum(1))
    assert np.isinf(got_d.numpy()[got_i.numpy() < 0]).all()


@pytest.mark.parametrize("mode", ["xbin", "xbin8", "tilescan", "autoscan"])
def test_slice11_modes_match_jax(searchers, mode):
    """The packed-key scans and ``autoscan`` (under one injected degraded
    weather report in both packages, so K7's ``binscan``) on the file, as
    the JAX package serves them; ``tilescan`` refuses this cluster-sorted
    layout in both."""
    from pqvector_tpu.errors import ValidationError as JValidationError
    from pqvector_tpu.query.autotune import WeatherReport as JWeatherReport
    from pqvector_tpu_torch.query.autotune import WeatherReport

    js, ts = searchers[:2]
    q = searchers[2]
    for s, report in ((js, JWeatherReport), (ts, WeatherReport)):
        s._weather = None
        s.weather_prober = lambda searcher, qq, k, budget_s=1.0, r=report: r(
            floor_qps=1.0, extract_qps=0.1, extract_frac=0.1, degraded=True,
            batch=len(qq), k=k)
    try:
        if mode == "tilescan":
            with pytest.raises(ValidationError, match="cluster-sorted"):
                ts.search(q, K, NPROBE, mode)
            with pytest.raises(JValidationError, match="cluster-sorted"):
                js.search(q, K, NPROBE, mode)
            return
        assert_match(ts.search(q, K, NPROBE, mode), js.search(q, K, NPROBE, mode), q)
        assert_match(ts.exact(q, K, mode), js.exact(q, K, mode), q)
    finally:
        js.weather_prober = ts.weather_prober = None
        js._weather = ts._weather = None


@pytest.mark.parametrize(
    "call,mode",
    [("exact", "cert"), ("exact", "approx"), ("search", "cert"), ("search", "scan"),
     ("search", "approx"), ("search", "masked"), ("search", "compact")],
)
def test_slice3_modes_match_jax(searchers, call, mode):
    """A file indexed by either package, served by both in every mode of
    slice 3, through the single calls and through the loops."""
    js, ts, q = searchers
    copy_searcher_knobs(js, ts)
    args = (q, K) if call == "exact" else (q, K, NPROBE)
    want = getattr(js, call)(*args, mode)
    assert_match(getattr(ts, call)(*args, mode), want, q)
    assert_match(getattr(ts, call + "_loop")(*args, reps=2, mode=mode), want, q)


@pytest.mark.parametrize("pass1", ["highest", "high", "storage"])
def test_cert_is_exact_on_the_file(searchers, pass1):
    """cert equals the exact scan whatever its pass-1 precision and whether
    or not the certificate holds (one fetched tile forces the fallback)."""
    _, ts, q = searchers
    ref = ts.exact(q, K, "xla")
    ts.cert_pass1 = pass1
    for fetch in (0, 1):
        ts.cert_fetch_tiles = fetch
        assert_match(ts.exact(q, K, "cert"), ref, q)
    ts.cert_pass1, ts.cert_fetch_tiles = "highest", 0


def test_auto_routes_unsorted_layout_to_gather(indexed):
    """On a layout in file order ``auto`` takes K6 (``pallas``) or
    ``gather`` by the rule measured on the card, and ``gather`` for k > 128;
    ``pallas`` there runs K6 and agrees with the JAX searcher's."""
    path, x, q = indexed
    index, _ = t_read_index(path)
    ts = DeviceIvfSearcher(index, x, row_tile=TILE, device="cpu")
    sorted_ts = DeviceIvfSearcher(index, x, row_tile=TILE, cluster_sorted=True,
                                 device="cpu")
    assert not ts._row_cluster_sorted and sorted_ts._row_cluster_sorted
    # Ties order on resident row ids, which the sorted layout renumbers, so
    # ids tied with the k-th distance may differ between the two layouts.
    assert_match(ts.search(q, K, NPROBE), sorted_ts.search(q, K, NPROBE), q)
    picked = ts._unsorted_auto(q.shape[0], NPROBE)
    assert picked in ("pallas", "gather")
    got = ts.search(q, K, NPROBE)
    want = ts.search(q, K, NPROBE, picked)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    got = ts.search(q, 300, NPROBE)
    want = ts.search(q, 300, NPROBE, "gather")
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    js = JSearcher(j_read_index(path)[0], x, row_tile=TILE)
    assert_match(ts.search(q, K, NPROBE, "pallas"), js.search(q, K, NPROBE, "pallas"), q)


@pytest.mark.parametrize(
    "n_pad,d,kc,lmax,nprobe,batch,dtype,want",
    [
        # K6 against gather on the H100 (PERF.md §5), bf16 storage: the
        # bench's 1M x 128 IVF-1024 file at nprobe 8, where K6 won at every
        # batch size ...
        (1_003_520, 128, 1024, 4039, 8, 1, torch.bfloat16, "pallas"),
        (1_003_520, 128, 1024, 4039, 8, 4, torch.bfloat16, "pallas"),
        (1_003_520, 128, 1024, 4039, 8, 16, torch.bfloat16, "pallas"),
        (1_003_520, 128, 1024, 4039, 8, 64, torch.bfloat16, "pallas"),
        (1_003_520, 128, 1024, 4039, 8, 256, torch.bfloat16, "pallas"),
        # ... and the 10M x 96 IVF-4096 rung at nprobe 4, where it won too
        # (by 1.2x at B = 256, where the old K6 lost 4x).
        (10_002_432, 96, 4096, 9948, 4, 1, torch.bfloat16, "pallas"),
        (10_002_432, 96, 4096, 9948, 4, 16, torch.bfloat16, "pallas"),
        (10_002_432, 96, 4096, 9948, 4, 256, torch.bfloat16, "pallas"),
        # Where the model, not a timing, decides: f32 rows on the fp32 patch
        # at the rung's B = 256, and a batch of 4096 there (K6's 16 query
        # groups against a gather linear in its candidates).
        (10_002_432, 96, 4096, 9948, 4, 256, torch.float32, "gather"),
        (10_002_432, 96, 4096, 9948, 4, 4096, torch.bfloat16, "gather"),
    ],
)
def test_unsorted_auto_follows_the_card_measurements(n_pad, d, kc, lmax, nprobe, batch,
                                                     dtype, want):
    layout = SimpleNamespace(emb=torch.empty((n_pad, 0), dtype=dtype), dim=d,
                             clusters=torch.empty((1, lmax)),
                             index=SimpleNamespace(n_clusters=kc))
    assert DeviceIvfSearcher._unsorted_auto(layout, batch, nprobe) == want


def test_cosine_metric_end_to_end(tmp_path):
    path = tmp_path / "cos.parquet"
    x, q = _grid_file(path, seed=4)
    pqvector_tpu_torch.IndexBuilder(path, "embedding", device="cpu").n_clusters(KC).metric(
        "cosine").build_inplace()
    ts = DeviceIvfSearcher.from_parquet(path, row_tile=TILE, cluster_sorted=True,
                                        device="cpu")
    index, _ = j_read_index(path)
    js = JSearcher(index, x, row_tile=TILE, metric="cosine", cluster_sorted=True)
    assert_match(ts.search(q, K, NPROBE), js.search(q, K, NPROBE, "gather"), q / 100.0)


def test_from_parquet_carries_the_jax_searchers_provenance(indexed):
    """``source_path``, ``source_column`` and ``source_key`` on one file, and
    ``spill`` / ``assign_dtype`` in the reference's positions."""
    path, _, _ = indexed
    js = JSearcher.from_parquet(path, jnp.float32, TILE, 0.0, jnp.float32)
    ts = DeviceIvfSearcher.from_parquet(path, torch.float32, TILE, 0.0, torch.float32,
                                        device="cpu")
    assert ts.source_path == js.source_path == os.fspath(path)
    assert ts.source_column == js.source_column == "embedding"
    assert ts.source_key == js.source_key
    assert ts.source_key == (os.stat(path).st_size, os.stat(path).st_mtime_ns)
    # spill > 0 builds the spilled layout, with the same provenance
    js = JSearcher.from_parquet(path, jnp.float32, TILE, 0.25, jnp.float32)
    ts = DeviceIvfSearcher.from_parquet(path, torch.float32, TILE, 0.25, torch.float32,
                                        device="cpu")
    assert ts._spill_dups and js._spill_dups
    assert (ts.source_path, ts.source_column, ts.source_key) == (
        js.source_path, js.source_column, js.source_key)
    _, _, q = indexed
    assert_match(ts.search(q, K, NPROBE), js.search(q, K, NPROBE, "gather"), q)


def test_from_parquet_source_key_when_the_file_cannot_be_stated(indexed, monkeypatch):
    path, _, _ = indexed
    real_stat = os.stat

    def no_stat(p, *args, **kwargs):
        if os.fspath(p) == os.fspath(path):
            raise OSError("gone")
        return real_stat(p, *args, **kwargs)

    ts = DeviceIvfSearcher.from_parquet(path, row_tile=TILE, device="cpu")
    assert ts.source_key != (-1, -1)
    import pqvector_tpu_torch.query.device as tdevice

    monkeypatch.setattr(tdevice.os, "stat", no_stat)
    ts = DeviceIvfSearcher.from_parquet(path, row_tile=TILE, device="cpu")
    assert ts.source_key == (-1, -1)


@pytest.mark.parametrize("method,args", [
    ("transfer_dtype", ("bfloat16",)), ("assign_backend", ("host",)),
])
def test_unported_builder_methods_raise_by_name(indexed, tmp_path, method, args):
    """Both builders have them, and both are ported: the port's
    ``build_inplace`` under the bf16 wire or the host assignment writes the
    JAX package's file bytes; a value neither takes raises by name."""
    path, _, _ = indexed
    j_path, t_path = tmp_path / "j.parquet", tmp_path / "t.parquet"
    shutil.copy(path, j_path)
    shutil.copy(path, t_path)
    jb = getattr(pqvector_tpu.IndexBuilder(j_path, "embedding").n_clusters(KC), method)(*args)
    tb = pqvector_tpu_torch.IndexBuilder(t_path, "embedding", device="cpu").n_clusters(KC)
    assert getattr(tb, method)(*args) is tb
    assert tb.build_inplace().to_bytes() == jb.build_inplace().to_bytes()
    assert t_path.read_bytes() == j_path.read_bytes()
    with pytest.raises(ValidationError, match="Unsupported"):
        getattr(tb, method)("float16")


@pytest.mark.parametrize("method", ["cluster_sorted", "streaming", "build_new"])
def test_builder_methods_of_the_jax_package_work(indexed, tmp_path, method):
    """``cluster_sorted().build_new``, ``streaming().build_inplace`` and
    ``build_new`` give the JAX package's index bytes on the slice's file."""
    path, _, _ = indexed
    if method == "streaming":  # in place, each on a copy
        shutil.copy(path, tmp_path / "j.parquet")
        shutil.copy(path, tmp_path / "t.parquet")
        path_j, path_t = tmp_path / "j.parquet", tmp_path / "t.parquet"
    else:
        path_j = path_t = path
    jb = pqvector_tpu.IndexBuilder(path_j, "embedding").n_clusters(KC)
    tb = pqvector_tpu_torch.IndexBuilder(path_t, "embedding", device="cpu").n_clusters(KC)
    if method == "streaming":
        want = jb.streaming(700).build_inplace()
        got = tb.streaming(700).build_inplace()
    else:
        if method == "cluster_sorted":
            jb, tb = jb.cluster_sorted(), tb.cluster_sorted()
        want = jb.build_new(tmp_path / "j.parquet")
        got = tb.build_new(tmp_path / "t.parquet")
    assert got.to_bytes() == want.to_bytes()
    assert (tmp_path / "t.parquet").read_bytes() == (tmp_path / "j.parquet").read_bytes()
