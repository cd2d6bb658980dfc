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
from pqvector_tpu_torch.kernels.stream_topk import _probe_mask

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
        t["tile_clusters"], t["emb"], t["emb_sq"], nprobe, k, max_probe=12,
        tile=TILE, emb_ref=t["_emb_ref"],
    )
    assert_topk_match(tuple(map(_np, got)), tuple(map(_np, want)), q)


def test_masked_local_scan_per_tile_oracle():
    """Per tile: the (distance, id) top-k of the probed rows, empty slots
    (+3e38, -1) where a tile has fewer."""
    x, q, cent = _grid_data(700, 8, 6, seed=4)
    a, t = _layout(x, cent, jnp.float32)
    qt = torch.from_numpy(q)
    mask = _probe_mask(qt, t["centroids"], t["c_sq"], 2, 6, 128)
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
    mask = _probe_mask(qt, t["centroids"], t["c_sq"], 4, 64, 128)
    lmask = mask[:, t["tile_clusters"].long()].permute(1, 0, 2).contiguous()
    args = (qt.to(t["emb"].dtype), t["emb"], t["emb_sq"], t["local_cluster"], lmask, 30, TILE)
    got = tsc.masked_local_scan(*args)
    want = tsc.masked_local_scan_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
