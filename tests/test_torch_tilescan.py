"""``tilescan`` (the per-tile argmin full scan, plain torch in the port as it
is plain XLA in the JAX package) against the JAX package on the CPU.

Twins of ``tests/test_tilescan.py``, one for each of its tests, on its
fixtures: each runs the JAX function or searcher and the port's on the same
seeded numpy inputs, holds the port to the JAX result and to the JAX test's
own assertions.

Tolerance: ids equal, except that rows whose f32 distances tie within 1e-5
relative may swap; distances within rtol 1e-5. The chunked form is held to
the one-call form bit for bit, as in the JAX test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pqvector_tpu.query.device as jdev
import pqvector_tpu_torch.query.device as tdev
from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.errors import ValidationError as JValidationError
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import index_from_reference


def _pair_of(x, n_clusters, seed, **kw):
    jindex = j_build_ivf_index(JEmbeddings(x, x.shape[1]),
                               JIvfBuildConfig(n_clusters=n_clusters, seed=seed))
    index = index_from_reference(np.asarray(jindex.centroids), jindex.list_offsets,
                                 jindex.row_ids)
    jkw = {k: getattr(jnp, v) if k == "dtype" else v for k, v in kw.items()}
    tkw = {k: getattr(torch, v) if k == "dtype" else v for k, v in kw.items()}
    return JSearcher(jindex, x, **jkw), DeviceIvfSearcher(index, x, device="cpu", **tkw)


def brute_force(x, q, k):
    d = ((x - q[None, :]) ** 2).sum(1)
    idx = np.argsort(d, kind="stable")[:k]
    return idx, np.sqrt(d[idx])


def _np(res):
    return tuple(r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r) for r in res)


def _assert_same(got, want, x, q):
    gd, gi = _np(got)
    wd, wi = _np(want)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-7)
    for b, c in zip(*np.nonzero(gi != wi)):
        assert gi[b, c] >= 0 and wi[b, c] >= 0
        d_g = ((x[gi[b, c]] - q[b]) ** 2).sum()
        d_w = ((x[wi[b, c]] - q[b]) ** 2).sum()
        assert abs(d_g - d_w) <= 1e-5 * max(d_w, 1e-12), (b, c)


@pytest.fixture(scope="module")
def planted():
    """The JAX test's fixture: 600 far rows plus 5 planted neighbours of
    each query more than 16 rows apart, so tiles of up to 16 rows select
    without collisions and tilescan must equal the exact scan."""
    rng = np.random.default_rng(5)
    x = 10.0 + rng.standard_normal((600, 24)).astype(np.float32)
    queries = rng.standard_normal((4, 24)).astype(np.float32)
    spots = np.array([17, 120, 260, 391, 555])
    for b, q in enumerate(queries):
        for j, r in enumerate(spots):
            x[r + b] = q + 1e-3 * (j + 1)
    js, ts = _pair_of(x, 8, 0, row_tile=128)
    js.tilescan_tile = ts.tilescan_tile = 16
    return x, js, ts, queries


def test_tilescan_matches_exact_when_collision_free(planted):
    x, js, ts, queries = planted
    assert ts.can_tilescan(5) and js.can_tilescan(5)
    de, ie = ts.exact(queries, k=5)
    d1, i1 = ts.search(queries, k=5, nprobe=1, mode="tilescan")
    np.testing.assert_array_equal(i1.numpy(), ie.numpy())
    np.testing.assert_allclose(d1.numpy(), de.numpy(), rtol=1e-5)
    _assert_same((d1, i1), js.search(queries, k=5, nprobe=1, mode="tilescan"), x, queries)
    _, il = ts.search_loop(queries, k=5, nprobe=1, reps=2, mode="tilescan")
    np.testing.assert_array_equal(il.numpy(), ie.numpy())
    got = ts.exact_loop(queries, k=5, reps=2, mode="tilescan")
    np.testing.assert_array_equal(got[1].numpy(), ie.numpy())
    _assert_same(got, js.exact_loop(queries, k=5, reps=2, mode="tilescan"), x, queries)


def test_tilescan_provenance_and_ordering(planted):
    """What tilescan selects decodes to distinct real rows with exact
    distances, ascending, as the JAX function's."""
    x, js, ts, queries = planted
    got = tdev._exact_tilescan_impl(ts._check_queries(queries), ts.emb, ts.emb_sq, 5, 64)
    want = jdev._exact_tilescan_impl(js._check_queries(queries), js.emb, js.emb_sq, k=5,
                                     tile=64)
    _assert_same(got, want, x, queries)
    d2, ids = _np(got)
    for b, qq in enumerate(queries):
        row = ids[b][ids[b] >= 0]
        assert len(set(row.tolist())) == len(row)
        np.testing.assert_allclose(d2[b][: len(row)], ((x[row] - qq) ** 2).sum(1), rtol=1e-4)
        assert np.all(np.diff(d2[b]) >= -1e-5)


def test_tilescan_chunked_matches_unchunked(planted):
    """Steps of rows stack independent tile tables: the same selection as
    the one-call form for any step, and the JAX function's."""
    x, js, ts, queries = planted
    q = ts._check_queries(queries)
    n_pad = int(ts.emb.shape[0])
    ref_d, ref_i = tdev._exact_tilescan_impl(q, ts.emb, ts.emb_sq, 5, 16, chunk_rows=-1)
    for rows in (16, 128, 256, n_pad // 2, n_pad):
        d2, ids = tdev._exact_tilescan_impl(q, ts.emb, ts.emb_sq, 5, 16, chunk_rows=rows)
        assert torch.equal(ids, ref_i)
        np.testing.assert_allclose(d2.numpy(), ref_d.numpy(), rtol=1e-6)
        _assert_same((d2, ids), jdev._exact_tilescan_impl(
            js._check_queries(queries), js.emb, js.emb_sq, k=5, tile=16, chunk_rows=rows),
            x, queries)


@pytest.mark.parametrize("b,n_pad,tile,chunk_rows", [
    (4, 1024, 128, 0), (4, 1024, 128, -1), (4, 1024, 128, 512),
    ((2 << 30) // 4 // 1024 + 1, 2048, 128, 0), (4096, 1_003_520, 128, 0),
    (256, 1_003_520, 128, 0), (4096, 10_002_432, 64, 0),
])
def test_tilescan_auto_chunk_policy(b, n_pad, tile, chunk_rows):
    """One call while the worst-case block fits the budget, -1 forced,
    explicit steps kept, tile-aligned steps beyond: the JAX package's
    policy."""
    got = tdev._tilescan_auto_chunk(b, n_pad, tile, chunk_rows)
    assert got == jdev._tilescan_auto_chunk(b, n_pad, tile, chunk_rows)
    if chunk_rows == 0 and b * n_pad * 4 > tdev._TILESCAN_FUSE_BUDGET:
        assert got and got % tile == 0


def test_tilescan_eligibility(planted):
    _, js, ts, _ = planted
    z = np.zeros((1, 24), np.float32)
    try:
        for s, err in ((ts, ValidationError), (js, JValidationError)):
            s.tilescan_tile = 7  # not a power of two
            with pytest.raises(err, match="power of two"):
                s.search(z, k=5, nprobe=1, mode="tilescan")
            assert not s.can_tilescan(5)
            s.tilescan_tile = 128  # nt = 5 < k = 6
            with pytest.raises(err, match="exceeds"):
                s.search(z, k=6, nprobe=1, mode="tilescan")
    finally:
        ts.tilescan_tile = js.tilescan_tile = 16
    assert ts._tilescan_tile_checked(5) == js._tilescan_tile_checked(5) == 16
    ts.tilescan_tile = js.tilescan_tile = 0
    try:
        for kk in (1, 5, 40):
            t = ts._tilescan_tile_checked(kk)
            assert t == js._tilescan_tile_checked(kk)
            assert int(ts.emb.shape[0]) // t >= kk
    finally:
        ts.tilescan_tile = js.tilescan_tile = 16


def test_tilescan_refused_on_cluster_sorted():
    """A cluster-sorted layout packs a cluster's neighbours into one tile,
    which keeps only its best row: both packages refuse it."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    js, ts = _pair_of(x, 6, 3, row_tile=128, cluster_sorted=True)
    assert ts._row_cluster_sorted and not ts.can_tilescan(5) and not js.can_tilescan(5)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    for call in (lambda s: s.search(q, k=5, nprobe=1, mode="tilescan"),
                 lambda s: s.exact(q, k=5, mode="tilescan")):
        with pytest.raises(ValidationError, match="cluster-sorted"):
            call(ts)
        with pytest.raises(JValidationError, match="cluster-sorted"):
            call(js)


def test_tilescan_random_recall_bounded():
    """On random rows tile collisions are the only loss: recall stays high
    at tile 8, and the ids are the JAX package's."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    js, ts = _pair_of(x, 12, 1, row_tile=128)
    js.tilescan_tile = ts.tilescan_tile = 8
    queries = rng.standard_normal((16, 16)).astype(np.float32)
    got = ts.search(queries, k=5, nprobe=1, mode="tilescan")
    _assert_same(got, js.search(queries, k=5, nprobe=1, mode="tilescan"), x, queries)
    ids = got[1].numpy()
    hits = 0
    for b, q in enumerate(queries):
        want, _ = brute_force(x, q, 5)
        hits += len(set(ids[b].tolist()) & set(want.tolist()))
    assert hits >= 0.85 * queries.shape[0] * 5


def test_tilescan_bf16_storage_rescores_f32():
    """bf16 storage with its f32 copy: the distances are f32-exact for what
    tilescan selects, and the selection is the JAX package's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    js, ts = _pair_of(x, 6, 2, row_tile=128, dtype="bfloat16")
    js.tilescan_tile = ts.tilescan_tile = 4
    queries = rng.standard_normal((3, 16)).astype(np.float32)
    got = ts.search(queries, k=3, nprobe=1, mode="tilescan")
    _assert_same(got, js.search(queries, k=3, nprobe=1, mode="tilescan"), x, queries)
    d, ids = _np(got)
    for b, q in enumerate(queries):
        row = ids[b][ids[b] >= 0]
        np.testing.assert_allclose(d[b][: len(row)], np.sqrt(((x[row] - q) ** 2).sum(1)),
                                   rtol=1e-4)
