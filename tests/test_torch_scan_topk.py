"""K4 (masked local scan), ``_refine`` and ``_final_merge`` in the torch
port against the JAX package.

The layout comes from a JAX ``DeviceIvfSearcher`` through
``convert.searcher_state_from_reference``; the JAX side runs its Pallas
kernel in interpret mode, the port its plain version on CPU tensors. The
data lies on a 1/4 grid with |x| <= 4, so every score is exact in f32 and
bf16 (bf16 storage is held to equal ids for that reason: real data with
neighbour margins below bf16's 2^-8 would select differently, which is why
searchers re-score in f32). Many distances tie. The JAX kernel extracts
each tile's minima in (distance, column) order and merges tiles
index-stably, so it keeps the lower id on ties as the port does: ids must
be equal, d² at rtol 1e-5 and atol 1e-5 * |q|^2.

The kernel scores only the chunks its queries probe. Which ones is a rule
on the probe table and the rows' slots that ``scored_chunks`` states in
plain torch; it is held here to its property on random and adversarial
layouts: every probed (query, row) pair lies in a scored chunk, and no chunk
is scored for nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqvector_tpu.index.ivf import IvfIndex as JIvfIndex
from pqvector_tpu.kernels import scan_topk as jsc
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch.convert import searcher_state_from_reference
from pqvector_tpu_torch.kernels import scan_topk as tsc
from pqvector_tpu_torch.utils import profiling
from pqvector_tpu_torch.kernels.probe import probe_mask
from test_torch_merge import SCAN_LIKE, scan_like_lists

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
    return arrays, searcher_state_from_reference(arrays, device="cpu")


def _canon(d, i):
    d = np.asarray(d, np.float64)
    i = np.asarray(i).astype(np.int64)
    fin = np.isfinite(d)
    d, i = np.where(fin, d, np.inf), np.where(fin, i, -1)
    order = np.lexsort((i, d), axis=-1)
    return np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)


def assert_topk_match(got, want, q):
    gd, gi = _canon(*got)
    wd, wi = _canon(*want)
    np.testing.assert_array_equal(gi, wi)
    scale = (np.asarray(q, np.float64) ** 2).sum(1).max()
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5 * scale)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("nprobe,k", [(1, 10), (3, 1), (5, 33), (12, 128)])
def test_masked_local_matches_jax(dtype, nprobe, k):
    x, q, cent = _grid_data(1500, 16, 12, seed=nprobe * 7 + k)
    a, t = _layout(x, cent, dtype)
    want = jsc.pallas_masked_local_topk(
        jnp.asarray(q), jnp.asarray(a["centroids"]), jnp.asarray(a["c_sq"]),
        jnp.asarray(a["local_cluster"]), jnp.asarray(a["tile_clusters"]),
        jnp.asarray(a["emb"]), jnp.asarray(a["emb_sq"]), jnp.int32(nprobe), k,
        max_probe=12, tile=TILE, cmax=a["tile_clusters"].shape[1], interpret=True,
        emb_ref=None if a["_emb_ref"] is None else jnp.asarray(a["_emb_ref"]),
    )
    got = tsc.masked_local_topk(
        torch.from_numpy(q), t["centroids"], t["c_sq"], t["local_cluster"],
        t["tile_clusters"], t["emb"], t["emb_sq"], nprobe, k, TILE,
        emb_ref=t["_emb_ref"],
    )
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q)


def test_masked_local_scan_per_tile_oracle():
    """Per tile: the (distance, id) top-k of the probed rows, empty slots
    (+3e38, -1) where a tile has fewer."""
    x, q, cent = _grid_data(700, 8, 6, seed=4)
    a, t = _layout(x, cent, jnp.float32)
    qt = torch.from_numpy(q)
    mask = probe_mask(qt, t["centroids"], t["c_sq"], 2)
    lmask = mask[:, t["tile_clusters"].long()].permute(1, 0, 2).contiguous()
    k = 20
    d, i = tsc.masked_local_scan(qt, t["emb"], t["emb_sq"], t["local_cluster"], lmask, k, TILE)
    emb, sq = a["emb"].astype(np.float64), a["emb_sq"].astype(np.float64)
    lcl = a["local_cluster"].astype(np.int64)
    for tile in range(emb.shape[0] // TILE):
        rows = np.arange(tile * TILE, (tile + 1) * TILE)
        part = sq[rows][None, :] - 2.0 * q.astype(np.float64) @ emb[rows].T
        probed = lmask[tile].numpy()[:, lcl[rows]] > 0.5
        part = np.where(probed & (sq[rows] < 1e38)[None, :], part, np.inf)
        order = np.lexsort((np.broadcast_to(rows, part.shape), part), axis=-1)[:, :k]
        best = np.take_along_axis(part, order, -1)
        want_i = np.where(np.isfinite(best), rows[order], -1)
        np.testing.assert_array_equal(i[tile].numpy(), want_i)
        np.testing.assert_allclose(
            np.where(want_i >= 0, d[tile].numpy(), 0.0), np.where(want_i >= 0, best, 0.0)
        )
        assert (d[tile].numpy()[want_i < 0] == np.float32(3.0e38)).all()


def _random_layout(rng, nt, tile, cmax, sort, pad_rows):
    """Slots of nt tiles of `tile` rows among cmax, sorted within a tile or
    not; the last `pad_rows` rows point at the last slot, which no query
    probes, as a searcher's pad rows do."""
    lcl = rng.integers(0, max(1, cmax - 1), (nt, tile))
    if sort:
        lcl = np.sort(lcl, axis=1)
    flat = lcl.reshape(-1)
    if pad_rows:
        flat[-pad_rows:] = cmax - 1
    return torch.from_numpy(flat.astype(np.int32))


# (tiles, tile, cmax, B, queries a block, probability of a probe, sorted slots, pad rows)
SKIP_CASES = [
    (6, 1024, 3, 256, 128, 0.01, True, 0),  # the served shape: few clusters a tile
    (6, 1024, 3, 256, 128, 0.01, False, 300),  # unsorted slots, pad chunks at the end
    (4, 1024, 300, 130, 128, 0.002, False, 0),  # cmax clusters in every tile
    (5, 256, 7, 37, 64, 0.05, True, 0),  # a block of 64 queries, B no multiple of it
    (9, 64, 4, 5, 64, 0.2, True, 10),  # a tile shorter than a chunk
    (3, 192, 5, 129, 128, 0.03, False, 0),  # a tile that is 1.5 chunks
    (2, 8192, 40, 16, 128, 0.01, True, 5000),  # 64 chunks a tile: two segments
    (4, 512, 6, 1, 128, 0.3, True, 0),  # one query
    (4, 512, 6, 64, 64, 0.0, True, 0),  # nothing probed
    (4, 512, 6, 64, 64, 1.0, False, 0),  # everything probed
]


@pytest.mark.parametrize("nt,tile,cmax,b,queries,p,sort,pad_rows", SKIP_CASES)
def test_skip_rule_scores_every_probed_pair(nt, tile, cmax, b, queries, p, sort, pad_rows):
    rng = np.random.default_rng(nt * tile + cmax + b)
    lcl = _random_layout(rng, nt, tile, cmax, sort, pad_rows)
    probe = torch.from_numpy(rng.random((nt, b, cmax)) < p)
    probe[:, :, cmax - 1] = False  # the pad slot's bit is never set
    scored = tsc.scored_chunks(probe, lcl, tile, queries)
    chunk = 128
    chunks = -(-tile // chunk)
    groups = -(-b // queries)
    assert scored.shape == (nt, groups, chunks) and scored.dtype == torch.bool
    # probed[t, b, r]: query b probes row r of tile t
    probed = probe.gather(2, lcl.view(nt, 1, tile).expand(nt, b, tile).long())
    want = torch.zeros((nt, groups, chunks), dtype=torch.bool)
    for t, q, r in probed.nonzero().tolist():
        want[t, q // queries, r // chunk] = True
    # every probed pair lies in a scored chunk, and each scored chunk holds one
    assert torch.equal(scored, want)
    if p == 0.0:
        assert not scored.any()
    if p == 1.0 and not pad_rows:
        assert scored.all()


def test_skip_rule_adversarial_single_pair():
    """One probed row in the last chunk of the last tile, for the last query
    of the second block: exactly that (tile, block, chunk) is scored."""
    nt, tile, cmax, b, queries = 3, 1024, 9, 200, 128
    lcl = torch.zeros(nt * tile, dtype=torch.int32)
    lcl[-1] = 8
    probe = torch.zeros((nt, b, cmax), dtype=torch.bool)
    probe[2, 199, 8] = True
    scored = tsc.scored_chunks(probe, lcl, tile, queries)
    assert scored.nonzero().tolist() == [[2, 1, 7]]
    # the same slot probed in a tile that holds no row of it scores nothing
    probe[:] = False
    probe[0, 0, 8] = True
    assert not tsc.scored_chunks(probe, lcl, tile, queries).any()


def test_k3s_probe_table_is_k4s_local_mask():
    """K4's local mask is the probe mask through the tile tables:
    lmask[t, b, slot] = mask[b, tile_clusters[t, slot]] (K3 keeps no such
    table: it reads the probed clusters' rows). A tile K4 scores holds a
    cluster some query probes."""
    x, q, cent = _grid_data(1500, 16, 12, seed=3)
    _, t = _layout(x, cent, jnp.float32)
    qt = torch.from_numpy(q)
    mask = probe_mask(qt, t["centroids"], t["c_sq"], 3)
    tc = t["tile_clusters"].long()
    lmask = mask[:, tc].permute(1, 0, 2).contiguous()
    nt, cmax = tc.shape
    for tile_id in range(nt):
        for slot in range(cmax):
            assert torch.equal(lmask[tile_id, :, slot], mask[:, tc[tile_id, slot]])
    scored = tsc.scored_chunks(lmask > 0.5, t["local_cluster"], TILE, 64)
    probed = (mask > 0.5).any(0)
    active = {tile_id for tile_id in range(nt) if probed[tc[tile_id]].any()}
    assert {int(i) for i in scored.any(2).any(1).nonzero().flatten()} <= active


def test_masked_geometry_picks_table_and_backend():
    emb = torch.zeros((1024, 128), dtype=torch.bfloat16)
    qf = torch.zeros((256, 128), dtype=torch.bfloat16)
    assert tsc.masked_geometry("K4", qf, emb, 10, 4) == ("wgmma", 128, 1, 112_736)
    assert tsc.masked_geometry("K4", qf, emb, 128, 4)[:3] == ("wgmma", 128, 0)
    assert tsc.masked_geometry("K4", qf[:64].float(), emb.float(), 10, 300)[:3] == ("fma", 64, 0)
    # the fp32 patch serves 64 queries a block whatever the batch
    assert tsc.masked_geometry("K4", qf[:, :100].contiguous(), emb[:, :100].contiguous(),
                               10, 40)[:3] == ("fma", 64, 2)
    assert tsc.masked_geometry("K4", qf.float(), emb.float(), 100, 4)[:3] == ("fma", 64, 1)


def test_stats_argument_is_checked():
    with pytest.raises(TypeError, match="stats"):
        tsc.check_stats(torch.zeros(3, dtype=torch.int32), torch.device("cpu"))
    with pytest.raises(TypeError, match="stats"):
        tsc.check_stats(torch.zeros(2, dtype=torch.int64), torch.device("cpu"))
    assert tsc.check_stats(None, torch.device("cpu")) == 0


def test_refine_matches_jax():
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    best_i = rng.integers(-1, 300, (4, 12)).astype(np.int32)
    best_d = rng.standard_normal((4, 12)).astype(np.float32)
    best_d[best_i < 0] = 3.0e38
    want = jsc._refine(jnp.asarray(q), jnp.asarray(emb), jnp.asarray(best_d), jnp.asarray(best_i))
    got = tsc._refine(torch.from_numpy(q), torch.from_numpy(emb),
                      torch.from_numpy(best_d), torch.from_numpy(best_i))
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q)
    # sentinel slots come back as +inf, after every real one
    np.testing.assert_array_equal(np.isinf(got[0].numpy()).sum(1), (best_i < 0).sum(1))


@pytest.mark.parametrize("k", [1, 4])
def test_final_merge_matches_jax(k):
    rng = np.random.default_rng(k)
    # integer distances: many ties, resolved to the lower id by both
    tile_d = rng.integers(0, 5, (6, 3, k)).astype(np.float32)
    tile_i = (np.arange(6)[:, None, None] * 100 + rng.integers(0, 100, (6, 3, k))).astype(np.int32)
    tile_d.sort(axis=-1)
    want = jsc._final_merge(jnp.asarray(tile_d), jnp.asarray(tile_i), k)
    got = tsc._final_merge(torch.from_numpy(tile_d), torch.from_numpy(tile_i), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("case", sorted(SCAN_LIKE))
def test_final_merge_ids_match_jax(case):
    """Ids and distances against the JAX package's merge, on lists laid out
    as the scans write them, with ties across tiles: the reference's top-k
    keeps the lower place in the [B, nt·k] block, which is the lower id
    there, as the port's (distance, id) order does. The one order they do
    not share is that of zeros: the reference's top-k puts -0.0 before
    +0.0, the port takes them as equal and keeps the lower id (a scan
    writes an exact zero distance as +0.0: |x|^2 - 2 q.x rounds to it). So
    the reference is given the lists with the zeros' sign cleared, and the
    port must return each winner's distance with the bits it was given.
    ``tests/test_torch_merge.py`` holds the kernel to this plain merge on
    the same lists."""
    d, i = scan_like_lists(case)
    k = d.shape[2]
    want = jsc._final_merge(jnp.asarray(np.where(d == 0, np.float32(0), d)), jnp.asarray(i), k)
    got = tsc._final_merge(torch.from_numpy(d), torch.from_numpy(i), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    bits = d.view(np.int32)
    for q in range(d.shape[1]):
        given = dict(zip(i[:, q].ravel().tolist(), bits[:, q].ravel().tolist()))
        real = got[1][q] >= 0
        assert got[0][q][real].view(torch.int32).tolist() == [
            given[j] for j in got[1][q][real].tolist()]
    if case == "signed zeros":
        assert bool((got[0] == 0).any()) and bool(torch.signbit(got[0][got[0] == 0]).any())


def _merge_lists(nt, b, kk, live):
    """[nt, b, kk] lists: ``live`` [nt, b] bool lists hold 1 .. kk ascending
    candidates, every other slot is empty (+3e38, -1)."""
    rng = np.random.default_rng(nt * b + kk)
    d = np.full((nt, b, kk), 3.0e38, np.float32)
    i = np.full((nt, b, kk), -1, np.int32)
    for t, q in zip(*np.nonzero(live)):
        n = int(rng.integers(1, kk + 1))
        d[t, q, :n] = np.sort(rng.integers(-3, 4, n)).astype(np.float32)
        i[t, q, :n] = t * 1000 + rng.permutation(1000)[:n]
    return torch.from_numpy(d), torch.from_numpy(i)


_MERGE_OK = _merge_lists(4, 3, 5, np.ones((4, 3), bool))


@pytest.mark.parametrize("lists,k,err", [
    ((_MERGE_OK[0].double(), _MERGE_OK[1]), 5, TypeError),  # f64 distances
    ((_MERGE_OK[0], _MERGE_OK[1].long()), 5, TypeError),  # i64 ids
    ((_MERGE_OK[0][0], _MERGE_OK[1][0]), 5, ValueError),  # [B, kk]: no tile axis
    ((_MERGE_OK[0], _MERGE_OK[1][:, :2]), 5, ValueError),  # shapes differ
    ((_MERGE_OK[0][:0], _MERGE_OK[1][:0]), 5, ValueError),  # no tiles
    (_MERGE_OK, 0, ValueError),
    (_MERGE_OK, 129, ValueError),
    ((_MERGE_OK[0].transpose(0, 1), _MERGE_OK[1].transpose(0, 1)), 5, ValueError),
])
def test_final_merge_refuses_what_the_kernel_cannot_take(lists, k, err):
    """The wrapper's checks hold on every device, before the plain version."""
    with pytest.raises(err):
        tsc._final_merge(*lists, k)


@pytest.mark.parametrize("nt,b,kk,case", [
    (40, 6, 10, "sparse"),  # a few lists of each query hold candidates
    (40, 6, 10, "empty queries"),  # queries 0 and 5 have none
    (12, 4, 16, "dense"),  # every list does, as K5 writes them
    (9, 3, 4, "none"),  # no query has a candidate
])
def test_merge_counts_rule(nt, b, kk, case):
    """``merge_counts``: the lists whose head is a candidate, and nt x B
    heads; the CPU merge stays ``select_lex`` over the [B, nt·kk] block."""
    rng = np.random.default_rng(nt + b)
    live = {"sparse": rng.random((nt, b)) < 0.1, "dense": np.ones((nt, b), bool),
            "none": np.zeros((nt, b), bool)}.get(case)
    if case == "empty queries":
        live = rng.random((nt, b)) < 0.3
        live[:, [0, 5]] = False
    d, i = _merge_lists(nt, b, kk, live)
    assert tsc.merge_counts(d) == (int(live.sum()), nt * b)
    got = tsc._final_merge(d, i, kk)
    want = tsc.select_lex(d.permute(1, 0, 2).reshape(b, -1), i.permute(1, 0, 2).reshape(b, -1),
                          kk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    empty = ~torch.from_numpy(live).any(0)
    assert (got[1][empty] == -1).all() and (got[0][empty] == tsc.POS_INF).all()


@pytest.mark.parametrize(
    "kw,err",
    [({"k": 0}, ValueError), ({"k": 129}, ValueError), ({"tile": 100}, ValueError)],
)
def test_scan_rejects_bad_shapes(kw, err):
    x, q, cent = _grid_data(300, 8, 3, seed=1)
    a, t = _layout(x, cent, jnp.float32)
    nt = t["emb"].shape[0] // TILE
    args = dict(k=5, tile=TILE) | kw
    lmask = torch.zeros((nt, q.shape[0], t["tile_clusters"].shape[1]))
    with pytest.raises(err):
        tsc.masked_local_scan(torch.from_numpy(q), t["emb"], t["emb_sq"],
                              t["local_cluster"], lmask, **args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    x, q, cent = _grid_data(20_000, 64, 40, seed=6)
    _, t = _layout(x, cent, dtype)
    t = {k: None if v is None else v.to(cuda_device) for k, v in t.items()}
    qt = torch.from_numpy(q).to(cuda_device)
    mask = probe_mask(qt, t["centroids"], t["c_sq"], 4)
    lmask = mask[:, t["tile_clusters"].long()].permute(1, 0, 2).contiguous()
    args = (qt.to(t["emb"].dtype), t["emb"], t["emb_sq"], t["local_cluster"], lmask, 30, TILE)
    got = tsc.masked_local_scan(*args)
    want = tsc.masked_local_scan_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nt,tile,cmax,b,k", [
    (6, 1024, 3, 256, 10),  # the served shape
    (4, 1024, 300, 130, 10),  # no probe table in shared memory: cmax above 256
    (5, 256, 7, 129, 128),  # k = 128: no room for a table on wgmma
    (3, 192, 5, 37, 7),
    (2, 8192, 40, 16, 10),  # two segments of 32 chunks
])
def test_kernel_counts_the_chunks_the_rule_scores(cuda_device, dtype, nt, tile, cmax, b, k):
    """Random slots and probes: K4 equals its plain version on grid data and
    its trace counters equal ``scored_chunks`` (whole tiles where no table
    fits)."""
    rng = np.random.default_rng(nt * tile + cmax)
    n_pad, d = nt * tile, 16
    emb = torch.from_numpy(rng.integers(-8, 9, (n_pad, d)).astype(np.float32) / 4).to(
        cuda_device).to(dtype)
    sq = (emb.float() ** 2).sum(1)
    qf = torch.from_numpy(rng.integers(-8, 9, (b, d)).astype(np.float32) / 4).to(
        cuda_device).to(dtype)
    lcl = _random_layout(rng, nt, tile, cmax, sort=False, pad_rows=0).to(cuda_device)
    lmask = torch.from_numpy((rng.random((nt, b, cmax)) < 0.02).astype(np.float32)).to(
        cuda_device)
    profiling.clear_store()
    with profiling.tracing():
        got = tsc.masked_local_scan(qf, emb, sq, lcl, lmask, k, tile)
    counts = profiling.read_store()["counters"]
    profiling.clear_store()
    want = tsc.masked_local_scan_plain(qf, emb, sq, lcl, lmask, k, tile)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    _, queries, words, _ = tsc.masked_geometry("K4", qf, emb, k, cmax)
    chunks = tsc.scored_chunks(lmask > 0.5, lcl, tile, queries)
    if not words:
        chunks = chunks.any(2, keepdim=True).expand(-1, -1, -(-tile // 128))
    assert [counts[key] for key in tsc.K4_COUNTERS] == [int(chunks.any(2).sum()),
                                                         int(chunks.sum())]
