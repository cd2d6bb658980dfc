"""K5 (exact per-tile scan) and K6 (per-tile scan under a global probe
mask) in the torch port against the JAX package.

The JAX side runs ``pallas_exact_topk``/``pallas_masked_topk`` in interpret
mode, the port its plain versions on CPU tensors. The layout comes from a
JAX ``DeviceIvfSearcher`` in file order (``cluster_sorted=False``, the
layout K6 serves) through ``convert.searcher_state_from_reference``. The
rows lie on a 1/4 grid with |x| <= 4, so every score is exact in f32 and
bf16 and many distances tie; both packages keep the lower row id on ties
(the JAX kernel extracts each tile's minima in column order and merges
index-stably), so ids must be equal, d² at rtol 1e-5 and atol 1e-5 * |q|^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqvector_tpu.index.ivf import IvfIndex as JIvfIndex
from pqvector_tpu.kernels import scan_topk as jsc
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import index_from_reference, searcher_state_from_reference
from pqvector_tpu_torch.kernels import scan_topk as tsc
from pqvector_tpu_torch.kernels.probe import probe_mask
from pqvector_tpu_torch.utils import profiling

TILE = 256


def _grid_data(n, d, kc, seed):
    rng = np.random.default_rng(seed)
    cent = rng.integers(-8, 9, (kc, d)).astype(np.float32) / 4.0
    x = cent[rng.integers(0, kc, n)] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4.0
    q = x[rng.integers(0, n, 8)] + rng.integers(-1, 2, (8, d)).astype(np.float32) / 4.0
    return x, q, cent


def _layout(x, cent, dtype):
    """A JAX searcher in file order and the port's tensors of its arrays."""
    assign = ((x[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
    index = JIvfIndex.from_assignments(cent, assign)
    js = JSearcher(index, x, dtype=dtype, row_tile=TILE)
    arrays = {
        "emb": np.asarray(js.emb),
        "emb_sq": np.asarray(js._pallas_emb_sq()),
        "_emb_ref": None if js._emb_ref is None else np.asarray(js._emb_ref),
        "centroids": np.asarray(js.centroids),
        "c_sq": np.asarray(js.c_sq),
        "row_cluster": np.asarray(js.row_cluster),
    }
    return js, arrays, searcher_state_from_reference(arrays, device="cpu")


def _canon(d, i):
    d = np.asarray(d, np.float64)
    i = np.asarray(i).astype(np.int64)
    fin = np.isfinite(d)
    d, i = np.where(fin, d, np.inf), np.where(fin, i, -1)
    order = np.lexsort((i, d), axis=-1)
    return np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)


def assert_topk_match(got, want, q, squared=True):
    gd, gi = _canon(*got)
    wd, wi = _canon(*want)
    np.testing.assert_array_equal(gi, wi)
    if not squared:
        gd, wd = gd ** 2, wd ** 2
    scale = (np.asarray(q, np.float64) ** 2).sum(1).max()
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5 * scale)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ref(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_exact_topk_matches_jax(dtype, k):
    x, q, cent = _grid_data(1500, 16, 12, seed=k)
    _, a, t = _layout(x, cent, dtype)
    want = jsc.pallas_exact_topk(
        jnp.asarray(q), jnp.asarray(a["emb"]), jnp.asarray(a["emb_sq"]), k,
        tile=TILE, interpret=True, emb_ref=_ref(a["_emb_ref"]),
    )
    got = tsc.exact_topk(torch.from_numpy(q), t["emb"], t["emb_sq"], k, TILE,
                         emb_ref=t["_emb_ref"])
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("nprobe,k", [(1, 10), (3, 1), (5, 33), (12, 128)])
def test_masked_topk_matches_jax(dtype, nprobe, k):
    x, q, cent = _grid_data(1500, 16, 12, seed=nprobe * 5 + k)
    _, a, t = _layout(x, cent, dtype)
    want = jsc.pallas_masked_topk(
        jnp.asarray(q), jnp.asarray(a["centroids"]), jnp.asarray(a["c_sq"]),
        jnp.asarray(a["row_cluster"]), jnp.asarray(a["emb"]),
        jnp.asarray(a["emb_sq"]), jnp.int32(nprobe), k, max_probe=12, tile=TILE,
        interpret=True, emb_ref=_ref(a["_emb_ref"]),
    )
    got = tsc.masked_topk(
        torch.from_numpy(q), t["centroids"], t["c_sq"], t["row_cluster"], t["emb"],
        t["emb_sq"], nprobe, k, TILE, emb_ref=t["_emb_ref"],
    )
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q)


def _tile_oracle(q, emb, sq, probed, k, tile):
    """Per tile: the (distance, id) top-k of the probed rows, in float64."""
    out_i = []
    for t0 in range(emb.shape[0] // tile):
        rows = np.arange(t0 * tile, (t0 + 1) * tile)
        part = sq[rows][None, :] - 2.0 * q.astype(np.float64) @ emb[rows].T
        part = np.where(probed[:, rows] & (sq[rows] < 1e38)[None, :], part, np.inf)
        order = np.lexsort((np.broadcast_to(rows, part.shape), part), axis=-1)[:, :k]
        best = np.take_along_axis(part, order, -1)
        out_i.append((np.where(np.isfinite(best), rows[order], -1), best))
    return out_i


@pytest.mark.parametrize("masked", [False, True])
def test_scan_per_tile_oracle(masked):
    """K5 and K6 per tile: the (distance, id) top-k of the (probed) rows,
    empty slots (+3e38, -1) where a tile has fewer."""
    x, q, cent = _grid_data(700, 8, 6, seed=4)
    _, a, t = _layout(x, cent, jnp.float32)
    qt = torch.from_numpy(q)
    k = 20
    emb, sq = a["emb"].astype(np.float64), a["emb_sq"].astype(np.float64)
    if masked:
        mask = probe_mask(qt, t["centroids"], t["c_sq"], 2)
        d, i = tsc.masked_scan(qt, t["emb"], t["emb_sq"], t["row_cluster"], mask, k, TILE)
        probed = mask.numpy()[:, a["row_cluster"]] > 0.5
    else:
        d, i = tsc.exact_scan(qt, t["emb"], t["emb_sq"], k, TILE)
        probed = np.ones((q.shape[0], emb.shape[0]), bool)
    for tile, (want_i, best) in enumerate(_tile_oracle(q, emb, sq, probed, k, TILE)):
        np.testing.assert_array_equal(i[tile].numpy(), want_i)
        np.testing.assert_allclose(
            np.where(want_i >= 0, d[tile].numpy(), 0.0), np.where(want_i >= 0, best, 0.0)
        )
        assert (d[tile].numpy()[want_i < 0] == np.float32(3.0e38)).all()


def test_pad_rows_never_probed():
    """Pad rows carry cluster id kc, whose mask slot is set for no query, so
    they never enter a list even under a mask of all clusters."""
    x, q, cent = _grid_data(300, 8, 3, seed=2)
    _, a, t = _layout(x, cent, jnp.float32)
    mask = torch.zeros((q.shape[0], 128))
    mask[:, :3] = 1.0
    _, i = tsc.masked_scan(torch.from_numpy(q), t["emb"], t["emb_sq"], t["row_cluster"],
                           mask, 128, TILE)
    # tile 1 holds rows 256 .. 299 and 212 pad rows
    assert int(i.max()) < 300 and (i[1] >= 0).sum(-1).tolist() == [44] * q.shape[0]


@pytest.mark.parametrize(
    "kw,err",
    [({"k": 0}, ValueError), ({"k": 129}, ValueError), ({"tile": 100}, ValueError),
     ({"row_cluster": "f32"}, TypeError)],
)
def test_masked_scan_rejects_bad_args(kw, err):
    x, q, cent = _grid_data(300, 8, 3, seed=1)
    _, a, t = _layout(x, cent, jnp.float32)
    rc = t["row_cluster"].float() if kw.pop("row_cluster", None) else t["row_cluster"]
    args = dict(k=5, tile=TILE) | kw
    with pytest.raises(err):
        tsc.masked_scan(torch.from_numpy(q), t["emb"], t["emb_sq"], rc,
                        torch.zeros((q.shape[0], 128)), **args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_searcher_pallas_modes_match_jax(dtype):
    """``exact(mode="pallas")`` (K5) and ``search(mode="pallas")`` (K6 on a
    layout in file order) of the port against the JAX searcher's."""
    x, q, cent = _grid_data(3000, 16, 12, seed=9)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    js, _, _ = _layout(x, cent, jdt)
    index = index_from_reference(
        np.asarray(js.index.centroids), js.index.list_offsets, js.index.row_ids
    )
    ts = DeviceIvfSearcher(index, x, dtype=getattr(torch, dtype), row_tile=TILE,
                           device="cpu")
    assert not ts._row_cluster_sorted and not ts._use_local_mask(TILE, 8)
    assert_topk_match(tuple(map(_np, ts.exact(q, 10, "pallas"))),
                      tuple(map(_np, js.exact(q, 10, "pallas"))), q, squared=False)
    for nprobe in (1, 4):
        assert_topk_match(tuple(map(_np, ts.search(q, 10, nprobe, "pallas"))),
                          tuple(map(_np, js.search(q, 10, nprobe, "pallas"))), q,
                          squared=False)
    with pytest.raises(ValidationError):
        ts.exact(q, 129, "pallas")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, dtype, masked):
    x, q, cent = _grid_data(20_000, 64, 40, seed=6)
    _, _, t = _layout(x, cent, dtype)
    t = {k: None if v is None else v.to(cuda_device) for k, v in t.items()}
    qt = torch.from_numpy(q).to(cuda_device)
    qf = qt.to(t["emb"].dtype)
    if masked:
        mask = probe_mask(qt, t["centroids"], t["c_sq"], 4)
        args = (qf, t["emb"], t["emb_sq"], t["row_cluster"], mask, 30, TILE)
        got, want = tsc.masked_scan(*args), tsc.masked_scan_plain(*args)
    else:
        args = (qf, t["emb"], t["emb_sq"], 30, TILE)
        got, want = tsc.exact_scan(*args), tsc.exact_scan_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())


def _file_order(n, kc, tile, seed):
    """Rows' clusters in random order, pad rows of cluster kc, and a probe
    mask [B, kc_pad] of random clusters (none of them kc)."""
    rng = np.random.default_rng(seed)
    n_pad = -(-(n + 1) // tile) * tile
    rc = np.full(n_pad, kc, np.int32)
    rc[:n] = rng.integers(0, kc, n)
    return torch.from_numpy(rc), rng


@pytest.mark.parametrize(
    "n,kc,tile,batch,queries,nprobe",
    [(5000, 40, 256, 37, 64, 3), (5000, 40, 256, 130, 128, 2), (3000, 300, 64, 5, 64, 1),
     (20000, 1000, 8192, 200, 128, 8), (700, 1, 128, 3, 64, 1)],
)
def test_k6_scores_the_chunks_that_hold_a_probed_row(n, kc, tile, batch, queries, nprobe):
    """K6's skip rule: a block scores a chunk iff some row of it is of a
    cluster some query of the block probes, so every probed (query, row)
    pair lies in a scored chunk; without the table it scores every chunk."""
    rc, rng = _file_order(n, kc, tile, seed=n + kc)
    kc_pad = -(-(kc + 1) // 128) * 128
    mask = torch.zeros((batch, kc_pad))
    for b in range(batch):
        mask[b, torch.from_numpy(rng.choice(kc, min(nprobe, kc), replace=False))] = 1.0
    got = tsc.masked_scan_chunks(mask, rc, tile, queries)
    n_pad = rc.shape[0]
    nt, groups, chunks = n_pad // tile, -(-batch // queries), -(-tile // 128)
    assert got.shape == (nt, groups, chunks)
    probed = (mask > 0.5)[:, rc.long()]  # [B, n_pad]
    for g in range(groups):
        hit = probed[g * queries:(g + 1) * queries].any(0).numpy()
        for t in range(nt):
            for c in range(chunks):
                lo = t * tile + c * 128
                want = bool(hit[lo:min(lo + 128, (t + 1) * tile)].any())
                assert bool(got[t, g, c]) == want
    assert bool(tsc.masked_scan_chunks(mask, rc, tile, queries, table=False).all())


def test_k6_rule_is_k4s_on_a_sorted_layout():
    """On a cluster-sorted layout a row's slot in its tile's table names its
    cluster, so K6's rule and K4's (``scored_chunks``) pick the same chunks."""
    x, q, cent = _grid_data(6000, 16, 40, seed=9)
    rc = np.sort(((x[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)).astype(np.int32)
    tile, kc = 256, 40
    n_pad = -(-(len(rc) + 1) // tile) * tile
    row_cluster = np.full(n_pad, kc, np.int32)
    row_cluster[: len(rc)] = rc
    parts = row_cluster.reshape(-1, tile)
    uniq = [np.unique(p) for p in parts]
    tc = np.full((len(parts), max(u.size for u in uniq)), kc, np.int32)
    lcl = np.zeros(parts.shape, np.int32)
    for t, u in enumerate(uniq):
        tc[t, : u.size] = u
        lcl[t] = np.searchsorted(u, parts[t])
    qt = torch.from_numpy(q)
    cent_t = torch.from_numpy(cent)
    mask = probe_mask(qt, cent_t, (cent_t * cent_t).sum(1), 3)
    lmask = mask[:, torch.from_numpy(tc).long()].permute(1, 0, 2)
    for queries in (64, 128):
        k4 = tsc.scored_chunks(lmask > 0.5, torch.from_numpy(lcl.reshape(-1)), tile, queries)
        k6 = tsc.masked_scan_chunks(mask, torch.from_numpy(row_cluster), tile, queries)
        assert torch.equal(k4, k6)


@pytest.mark.parametrize(
    "batch,nt,queries,kc_pad,k,want",
    [
        (256, 980, 128, 1152, 10, 66),  # the main path's file on wgmma: one block an SM
        (1, 980, 128, 1152, 10, 132),
        (256, 980, 64, 1152, 10, 66),  # the fp32 patch: two blocks an SM
        (4096, 980, 128, 1152, 10, 4),
        (4096, 9768, 128, 4224, 10, 4),  # the 10M rung's 4096 clusters still fit
        (256, 3, 64, 1152, 10, 3),  # never more runs than tiles
        (256, 980, 128, 1152, 128, 0),  # k = 128 on wgmma: no room for the table
    ],
)
def test_k6_units_fill_one_wave(batch, nt, queries, kc_pad, k, want):
    backend = "wgmma" if queries == 128 else "fma"
    smem = tsc.score_tile.smem_bytes("K6", backend, queries, k, kc_pad // 32)
    assert tsc.k6_units(batch, nt, smem, queries) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k,batch", [(10, 3), (10, 130), (128, 70)])
def test_k6_equals_plain_and_counts_its_chunks_on_card(cuda_device, dtype, k, batch):
    """K6 with its probe table (and without it at k = 128 on wgmma) equals
    its plain version on grid data in file order, and its trace counters
    equal ``masked_scan_chunks``'."""
    x, _, cent = _grid_data(20_000, 64, 40, seed=8)
    _, _, t = _layout(x, cent, dtype)
    t = {key: None if v is None else v.to(cuda_device) for key, v in t.items()}
    rng = np.random.default_rng(batch)
    qt = torch.from_numpy(x[rng.integers(0, len(x), batch)] + 0.25).to(cuda_device)
    qf = qt.to(t["emb"].dtype)
    mask = probe_mask(qt, t["centroids"], t["c_sq"], 4)
    args = (qf, t["emb"], t["emb_sq"], t["row_cluster"], mask, k, TILE)
    _, queries, words, _ = tsc.masked_geometry("K6", qf, t["emb"], k, 128)
    profiling.clear_store()
    with profiling.tracing():
        got = tsc.masked_scan(*args)
    counts = profiling.read_store()["counters"]
    profiling.clear_store()
    want = tsc.masked_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    rule = tsc.masked_scan_chunks(mask, t["row_cluster"], TILE, queries, table=bool(words))
    assert [counts[key] for key in tsc.K6_COUNTERS] == [int(rule.any(2).sum()),
                                                         int(rule.sum())]
