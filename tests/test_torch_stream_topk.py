"""K2 and K3 (streaming top-k) in the torch port against the JAX package.

Both packages run on one resident layout: a JAX ``DeviceIvfSearcher``
builds it and ``convert.searcher_state_from_reference`` carries its arrays
over. The JAX side runs its Pallas kernels in interpret mode; the port's
wrappers run their plain versions on CPU tensors.

Results are compared under the (distance, id) order: equal ids, and d² at
rtol 1e-5 and atol 1e-5 * |q|^2, except that ids tied with the k-th
distance may differ from the JAX kernels'. Those evict the first slot that
holds the current worst distance, which under a tie need not be the higher
id, so they do not always keep the lower id at the boundary; the port does,
and a numpy oracle holds it to that exactly. Most data here lies on a 1/4 grid with
|x| <= 4, so every score is exact in f32 and in bf16 and many distances tie:
that tests the tie rule, and it is why bf16 storage may be held to equal
ids. bf16 rounds at 2^-8, and data whose neighbours lie closer than that
could select differently, which is why searchers re-score in f32.

K2 runs on the score tile of ``csrc/score_tile.cuh`` (128 queries x 128 rows
a block, runs of rows merged in a second launch). Its awkward shapes (d = 3
and 100, k = 1 and 128, B = 1 to 256, a last tile that is partly pad, fewer
rows than k) go through the JAX kernel and the wrapper on the CPU here, and
through the kernel on the card against the plain version, on both back ends
and over several splits of the rows: grid data, so equal bit for bit. On
continuous f32 data ids must be equal wherever neighbouring distances differ
by more than 1e-5 relative; bf16 results are compared after the f32 re-score.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pqvector_tpu.index.ivf import IvfIndex as JIvfIndex
from pqvector_tpu.kernels import stream_topk as jst
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch.convert import searcher_state_from_reference
from pqvector_tpu_torch.kernels import _build, score_tile
from pqvector_tpu_torch.kernels import stream_topk as tst
from pqvector_tpu_torch.kernels.probe import mask_width, probe_ids, probe_mask
from pqvector_tpu_torch.kernels.scan_topk import select_lex

TILE = 256


def _grid_data(n, d, kc, seed):
    rng = np.random.default_rng(seed)
    cent = rng.integers(-8, 9, (kc, d)).astype(np.float32) / 4.0
    x = cent[rng.integers(0, kc, n)] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4.0
    q = x[rng.integers(0, n, 8)] + rng.integers(-1, 2, (8, d)).astype(np.float32) / 4.0
    return x, q, cent


def _layout(x, cent, dtype):
    assign = ((x[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
    index = JIvfIndex.from_assignments(cent, assign)
    js = JSearcher(index, x, dtype=dtype, row_tile=TILE, cluster_sorted=True)
    lcl, tc, _ = js._tile_cluster_table(TILE)
    arrays = {
        "emb": np.asarray(js.emb),
        "emb_sq": np.asarray(js._pallas_emb_sq()),
        "_emb_ref": None if js._emb_ref is None else np.asarray(js._emb_ref),
        "centroids": np.asarray(js.centroids),
        "c_sq": np.asarray(js.c_sq),
        "local_cluster": np.asarray(lcl),
        "tile_clusters": np.asarray(tc),
    }
    return js, arrays, searcher_state_from_reference(arrays, device="cpu")


def _offsets(t):
    """The layout's ``cluster_offsets``, from each row's cluster as the
    tile tables give it."""
    tc, lcl = t["tile_clusters"], t["local_cluster"]
    row_cluster = tc.gather(1, lcl.view(tc.shape[0], -1).long()).reshape(-1)
    return tst.cluster_offsets(row_cluster, t["centroids"].shape[0])


def _canon(d, i):
    d = np.asarray(d, np.float64)
    i = np.asarray(i).astype(np.int64)
    fin = np.isfinite(d)
    d, i = np.where(fin, d, np.inf), np.where(fin, i, -1)
    order = np.lexsort((i, d), axis=-1)
    return np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)


def assert_topk_match(got, want, q, boundary_ties=False):
    """Equal (distance, id) lists; with ``boundary_ties``, ids whose distance
    ties the row's k-th may differ."""
    gd, gi = _canon(*got)
    wd, wi = _canon(*want)
    scale = (np.asarray(q, np.float64) ** 2).sum(1, keepdims=True)
    tol = 1e-5 * scale.max()
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=tol)
    inner = np.ones_like(gi, dtype=bool)
    if boundary_ties:
        kth = np.where(np.isfinite(wd), wd, -np.inf).max(axis=1, keepdims=True)
        inner = wd < kth - tol - 1e-5 * np.abs(kth)
    np.testing.assert_array_equal(np.where(inner, gi, 0), np.where(inner, wi, 0))


def lex_oracle(q, x, sq, k, probed=None):
    """Brute-force top-k by (partial distance, id) in float64 on exact data."""
    part = sq[None, :].astype(np.float64) - 2.0 * q.astype(np.float64) @ x.astype(np.float64).T
    part = np.where(np.isfinite(sq)[None, :], part, np.inf)
    if probed is not None:
        part = np.where(probed, part, np.inf)
    ids = np.broadcast_to(np.arange(x.shape[0]), part.shape)
    order = np.lexsort((ids, part), axis=-1)[:, :k]
    d = np.take_along_axis(part, order, -1)
    return np.where(np.isfinite(d), order, -1)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 33])
def test_stream_exact_matches_jax(dtype, k):
    x, q, cent = _grid_data(1500, 16, 12, seed=k)
    _, a, t = _layout(x, cent, dtype)
    want = jst.pallas_stream_exact_topk(
        jnp.asarray(q), jnp.asarray(a["emb"]), jnp.asarray(a["emb_sq"]), k,
        tile=TILE, interpret=True,
        emb_ref=None if a["_emb_ref"] is None else jnp.asarray(a["_emb_ref"]),
    )
    got = tst.stream_exact_topk(
        torch.from_numpy(q), t["emb"], t["emb_sq"], k, tile=TILE, emb_ref=t["_emb_ref"]
    )
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q, boundary_ties=True)


@pytest.mark.parametrize("k", [1, 7, 64])
def test_stream_exact_scan_keeps_lower_ids_on_ties(k):
    """The port's K2 selection is the exact (distance, id) top-k."""
    x, q, cent = _grid_data(1500, 16, 12, seed=k + 100)
    _, a, t = _layout(x, cent, jnp.float32)
    d, i = tst.stream_exact_scan(torch.from_numpy(q), t["emb"], t["emb_sq"], k, TILE)
    sq = np.where(a["emb_sq"] >= 1e38, np.inf, a["emb_sq"])
    np.testing.assert_array_equal(i.numpy(), lex_oracle(q, a["emb"], sq, k))


def test_stream_exact_continuous_f32():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1000, 32)).astype(np.float32)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    cent = x[:6].copy()
    _, a, t = _layout(x, cent, jnp.float32)
    want = jst.pallas_stream_exact_topk(
        jnp.asarray(q), jnp.asarray(a["emb"]), jnp.asarray(a["emb_sq"]), 16,
        tile=TILE, interpret=True,
    )
    got = tst.stream_exact_topk(torch.from_numpy(q), t["emb"], t["emb_sq"], 16, tile=TILE)
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q)


def test_stream_exact_fewer_rows_than_k():
    """Pad rows (+3e38) never enter; empty slots come back as inf / -1."""
    x, q, cent = _grid_data(5, 8, 2, seed=1)
    _, a, t = _layout(x, cent, jnp.float32)
    want = jst.pallas_stream_exact_topk(
        jnp.asarray(q), jnp.asarray(a["emb"]), jnp.asarray(a["emb_sq"]), 9,
        tile=TILE, interpret=True,
    )
    got_d, got_i = tst.stream_exact_topk(torch.from_numpy(q), t["emb"], t["emb_sq"], 9, tile=TILE)
    assert_topk_match((got_d.numpy(), got_i.numpy()), tuple(map(_np, want)), q)
    assert np.isinf(got_d.numpy()[:, 5:]).all()
    assert (got_i.numpy()[:, 5:] == -1).all()


@pytest.mark.parametrize("nprobe", [1, 3, 12])
def test_probe_mask_matches_jax(nprobe):
    x, q, cent = _grid_data(1500, 16, 12, seed=nprobe)
    _, a, t = _layout(x, cent, jnp.float32)
    want_mask = jst._probe_mask(
        jnp.asarray(q), jnp.asarray(a["centroids"]), jnp.asarray(a["c_sq"]),
        jnp.int32(nprobe), 12, mask_width(12),
    )
    got_mask = probe_mask(torch.from_numpy(q), t["centroids"], t["c_sq"], nprobe)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def _jax_buckets(nprobe, kc):
    """Every top-k width the JAX package probes ``nprobe`` of ``kc`` clusters
    with: ``nprobe`` itself, its power of two, the searcher's floor of 128
    (``_max_probe_bucket``) and the compact modes' floor of 8
    (``_compact_probe_bucket``), each capped at ``kc``."""
    p = 1 << max(0, nprobe - 1).bit_length()
    return sorted({min(w, kc) for w in (nprobe, p, max(p, min(128, kc)), max(p, 8))})


@pytest.mark.parametrize("nprobe", [1, 3, 5, 17, 40])
def test_probe_ids_are_the_jax_probe_at_every_bucket(nprobe):
    """``probe_ids`` is one stable sort with no bucket: its ids are the set
    bits of the JAX package's ``_probe_mask`` at every width that package
    passes, nearest first with ties to the lower cluster id. Every centroid
    appears twice, so each distance ties at least once."""
    rng = np.random.default_rng(nprobe)
    half = rng.integers(-8, 9, (20, 8)).astype(np.float32) / 4
    cent = np.concatenate([half, half[rng.permutation(20)]])
    q = np.concatenate([half[:6], rng.integers(-8, 9, (10, 8)).astype(np.float32) / 4])
    c_sq = (cent * cent).sum(1)
    ids = probe_ids(torch.from_numpy(q), torch.from_numpy(cent), torch.from_numpy(c_sq),
                    nprobe)
    assert ids.dtype == torch.int32 and ids.shape == (16, nprobe)
    dist = c_sq[None, :] - 2.0 * (q @ cent.T)  # exact: the data lies on a 1/4 grid
    order = np.lexsort((np.broadcast_to(np.arange(40), dist.shape), dist), axis=-1)
    np.testing.assert_array_equal(ids.numpy(), order[:, :nprobe])
    got = np.zeros((16, mask_width(40)), np.float32)
    np.put_along_axis(got, ids.numpy().astype(np.int64), 1.0, axis=1)
    for width in _jax_buckets(nprobe, 40):
        want = jst._probe_mask(jnp.asarray(q), jnp.asarray(cent), jnp.asarray(c_sq),
                               jnp.int32(nprobe), width, mask_width(40))
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"width {width}")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("nprobe,k", [(1, 10), (3, 5), (12, 40), (2, 128)])
def test_stream_masked_matches_jax(dtype, nprobe, k):
    x, q, cent = _grid_data(1500, 16, 12, seed=nprobe + k)
    _, a, t = _layout(x, cent, dtype)
    want = jst.pallas_stream_masked_topk(
        jnp.asarray(q), jnp.asarray(a["centroids"]), jnp.asarray(a["c_sq"]),
        jnp.asarray(a["local_cluster"]), jnp.asarray(a["tile_clusters"]),
        jnp.asarray(a["emb"]), jnp.asarray(a["emb_sq"]), jnp.int32(nprobe), k,
        max_probe=12, tile=TILE, cmax=a["tile_clusters"].shape[1], interpret=True,
        emb_ref=None if a["_emb_ref"] is None else jnp.asarray(a["_emb_ref"]),
    )
    got = tst.stream_masked_topk(
        torch.from_numpy(q), t["centroids"], t["c_sq"], _offsets(t), t["emb"],
        t["emb_sq"], nprobe, k, emb_ref=t["_emb_ref"],
    )
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q, boundary_ties=True)


@pytest.mark.parametrize("nprobe,k", [(2, 9), (12, 100)])
def test_stream_masked_scan_keeps_lower_ids_on_ties(nprobe, k):
    """The port's K3 selection is the exact (distance, id) top-k of the
    probed rows."""
    x, q, cent = _grid_data(1500, 16, 12, seed=nprobe * k)
    _, a, t = _layout(x, cent, jnp.float32)
    qt = torch.from_numpy(q)
    mask = probe_mask(qt, t["centroids"], t["c_sq"], nprobe)
    probe = probe_ids(qt, t["centroids"], t["c_sq"], nprobe)
    _, i = tst.stream_masked_scan(qt, t["emb"], t["emb_sq"], _offsets(t), probe, k)
    lcl = a["local_cluster"].astype(np.int64)
    row_cluster = a["tile_clusters"][np.arange(lcl.size) // TILE, lcl]
    probed = mask.numpy()[:, row_cluster] > 0.5
    sq = np.where(a["emb_sq"] >= 1e38, np.inf, a["emb_sq"])
    np.testing.assert_array_equal(i.numpy(), lex_oracle(q, a["emb"], sq, k, probed))


def test_convert_keeps_bf16_bits_and_int32_ids():
    x, _, cent = _grid_data(300, 8, 3, seed=2)
    _, a, t = _layout(x, cent, jnp.bfloat16)
    assert t["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t["emb"].view(torch.int16).numpy(), a["emb"].view(np.int16)
    )
    assert a["emb"].dtype == ml_dtypes.bfloat16
    assert t["local_cluster"].dtype == torch.int32
    np.testing.assert_array_equal(t["local_cluster"].numpy(), a["local_cluster"])


def _padded_grid(n, d, tile, nq, seed):
    """Rows on a 1/4 grid, padded past n to a multiple of ``tile`` with zero
    rows whose norm is +3e38, and queries near them."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, (17, d)).astype(np.float32) / 4
    x = base[rng.integers(0, 17, n)] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4
    n_pad = -(-(n + 1) // tile) * tile
    emb = np.zeros((n_pad, d), np.float32)
    emb[:n] = x
    sq = np.full(n_pad, 3.0e38, np.float32)
    sq[:n] = (x * x).sum(1)
    q = x[rng.integers(0, n, nq)] + rng.integers(-1, 2, (nq, d)).astype(np.float32) / 4
    return emb, sq, q


AWKWARD = [  # n, tile, k, d, B
    (1500, 256, 1, 3, 1),
    (1500, 256, 128, 100, 13),
    (900, 128, 10, 8, 64),
    (900, 128, 10, 96, 65),
    (700, 64, 33, 40, 256),
    (5, 256, 9, 136, 5),
    (1000, 512, 128, 16, 130),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,tile,k,d,b", AWKWARD)
def test_stream_exact_matches_jax_at_awkward_shapes(n, tile, k, d, b, dtype):
    emb, sq, q = _padded_grid(n, d, tile, b, seed=n + k + d)
    want = jst.pallas_stream_exact_topk(
        jnp.asarray(q), jnp.asarray(emb, getattr(jnp, dtype)), jnp.asarray(sq), k,
        tile=tile, interpret=True)
    got = tst.stream_exact_topk(
        torch.from_numpy(q), torch.from_numpy(emb).to(getattr(torch, dtype)),
        torch.from_numpy(sq), k, tile)
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q, boundary_ties=True)
    assert got[0].shape == (b, k) and (got[1].numpy()[:, min(n, k):] == -1).all()


@pytest.mark.parametrize("n,tile,k,d,b", AWKWARD)
def test_stream_exact_scan_is_the_lex_topk_at_awkward_shapes(n, tile, k, d, b):
    """Lower row ids win ties; pad rows never enter; n < k leaves (+3e38, -1)."""
    emb, sq, q = _padded_grid(n, d, tile, b, seed=n + k + d + 1)
    got_d, got_i = tst.stream_exact_scan(
        torch.from_numpy(q), torch.from_numpy(emb), torch.from_numpy(sq), k, tile)
    want = lex_oracle(q, emb, np.where(sq >= 1e38, np.inf, sq), k)
    np.testing.assert_array_equal(got_i.numpy(), want)
    empty = got_i.numpy() < 0
    assert (got_d.numpy()[empty] == np.float32(3.0e38)).all()
    assert empty.sum() == b * max(0, k - n)


def _scan_in_runs(qf, emb, sq, k, units):
    """What K2's launch computes: each run's own top-k lists, merged under
    the (distance, id) order."""
    run = tst.run_rows(emb.shape[0], units)
    parts = [tst.stream_exact_scan_plain(qf, emb[lo:lo + run], sq[lo:lo + run], k)
             for lo in range(0, emb.shape[0], run)]
    d = torch.cat([p[0] for p in parts], dim=1)
    i = torch.cat([torch.where(p[1] >= 0, p[1] + lo, -1)
                   for p, lo in zip(parts, range(0, emb.shape[0], run))], dim=1)
    return select_lex(d, i, k)


@pytest.mark.parametrize("units", [1, 2, 3, 7, 1000])
@pytest.mark.parametrize("n,tile,k,d,b", AWKWARD[1:5])
def test_stream_exact_result_does_not_depend_on_the_split(n, tile, k, d, b, units):
    emb, sq, q = _padded_grid(n, d, tile, b, seed=n + d)
    qf, e, s = torch.from_numpy(q), torch.from_numpy(emb), torch.from_numpy(sq)
    want = tst.stream_exact_scan(qf, e, s, k, tile)
    got = _scan_in_runs(qf, e, s, k, units)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("d,k,b", [(3, 1, 13), (100, 16, 64), (40, 128, 65)])
def test_stream_exact_continuous_f32_awkward(d, k, b):
    """Continuous data: ids equal wherever the neighbouring distances differ
    by more than 1e-5 relative (cuBLAS-free here, but the JAX kernel and
    torch sum in other orders)."""
    rng = np.random.default_rng(d + k)
    n, tile = 1100, 128
    emb = np.zeros((1152, d), np.float32)
    emb[:n] = rng.standard_normal((n, d)).astype(np.float32)
    sq = np.full(1152, 3.0e38, np.float32)
    sq[:n] = (emb[:n] * emb[:n]).sum(1)
    q = rng.standard_normal((b, d)).astype(np.float32)
    want = jst.pallas_stream_exact_topk(
        jnp.asarray(q), jnp.asarray(emb), jnp.asarray(sq), k, tile=tile, interpret=True)
    got = tst.stream_exact_topk(torch.from_numpy(q), torch.from_numpy(emb),
                                torch.from_numpy(sq), k, tile)
    gd, gi = _canon(*map(_np, got))
    wd, wi = _canon(*map(_np, want))
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5 * (q * q).sum(1).max())
    gap = np.minimum(np.diff(wd, axis=1, prepend=-np.inf), np.diff(wd, axis=1, append=np.inf))
    clear = gap > 1e-5 * np.abs(wd) + 1e-5
    np.testing.assert_array_equal(np.where(clear, gi, 0), np.where(clear, wi, 0))
    assert clear.mean() > 0.9


def test_k2_and_k3_split_rows_by_their_own_rules():
    """K2 fills one wave of 128-query blocks with runs of rows; K3 cuts a
    probed cluster's rows into segments only while a batch has too few probe
    ids to give the card about a thousand work items."""
    assert tst.scan_units(7840, 256) == 131
    assert tst.masked_segments(256 * 8) == 1
    assert tst.masked_segments(1) == tst.MAX_SEGMENTS
    assert tst.masked_segments(4096 * 4) == 1
    assert tst.masked_segments(256 * 4) == 1
    assert tst.masked_segments(16 * 8) == 8 and tst.masked_segments(64 * 8) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kernels_match_plain_on_card(cuda_device, dtype):
    x, q, cent = _grid_data(20_000, 64, 40, seed=5)
    _, _, t = _layout(x, cent, dtype)
    t = {k: None if v is None else v.to(cuda_device) for k, v in t.items()}
    qf = torch.from_numpy(q).to(cuda_device).to(t["emb"].dtype)
    got = tst.stream_exact_scan(qf, t["emb"], t["emb_sq"], 50, TILE)
    want = tst.stream_exact_scan_plain(qf, t["emb"], t["emb_sq"], 50)
    assert_topk_match(tuple(v.cpu().numpy() for v in got),
                      tuple(v.cpu().numpy() for v in want), q)
    probe = probe_ids(qf.float(), t["centroids"], t["c_sq"], 4)
    args = (qf, t["emb"], t["emb_sq"], _offsets(t), probe, 50)
    got = tst.stream_masked_scan(*args)
    want = tst.stream_masked_scan_plain(*args)
    assert_topk_match(tuple(v.cpu().numpy() for v in got),
                      tuple(v.cpu().numpy() for v in want), q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,tile,k,d,b", AWKWARD + [(3000, 1024, 10, 128, 257),
                                                     (1500, 128, 10, 16, 4096)])
def test_stream_exact_kernel_equals_plain_on_card(cuda_device, dtype, n, tile, k, d, b):
    """Grid data: both back ends equal the plain version bit for bit, over
    every split of the rows."""
    emb, sq, q = _padded_grid(n, d, tile, b, seed=n + tile + k)
    qf = torch.from_numpy(q).to(cuda_device).to(dtype)
    e = torch.from_numpy(emb).to(cuda_device).to(dtype)
    s = torch.from_numpy(sq).to(cuda_device)
    want = tst.stream_exact_scan_plain(qf, e, s, k)
    before = _build.LAUNCHES["K2"]
    got = tst.stream_exact_scan(qf, e, s, k, tile)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K2"] == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    for units in (1, 3, 1000):
        got = tst._stream_exact_cuda(qf, e, s, k, units=units)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("d,want", [(128, "wgmma"), (100, "fma")])
def test_stream_exact_bf16_back_end_follows_the_rule(cuda_device, d, want):
    emb, sq, q = _padded_grid(2000, d, 256, 37, seed=d)
    qf = torch.from_numpy(q).to(cuda_device).to(torch.bfloat16)
    e = torch.from_numpy(emb).to(cuda_device).to(torch.bfloat16)
    s = torch.from_numpy(sq).to(cuda_device)
    assert score_tile.pick_backend(e.dtype, d, qf.data_ptr(), e.data_ptr()) == want
    got = tst.stream_exact_scan(qf, e, s, 10, 256)
    ref = tst.stream_exact_scan_plain(qf, e, s, 10)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
    # a contiguous view that starts off a 16-byte boundary falls to the fp32 patch
    flat = torch.zeros(e.numel() + 8, dtype=e.dtype, device=cuda_device)
    off = flat[1 : 1 + e.numel()].view_as(e).copy_(e)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert score_tile.pick_backend(off.dtype, d, qf.data_ptr(), off.data_ptr()) == "fma"
    got = tst.stream_exact_scan(qf, off, s, 10, 256)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
