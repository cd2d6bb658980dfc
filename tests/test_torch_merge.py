"""The cross-tile merge kernel (``csrc/merge.cu``) on the card, held to
``final_merge_plain`` (``select_lex`` over the [B, nt·kk] block, the chain
it replaced) bit for bit, distances by their bits, and its counters to
``merge_counts``: on K4's, K5's and K6's own lists and on crafted ones
(fewer candidates than k, ties across tiles, -0.0 beside +0.0, NaN tails,
every entry equal), and on the lists that ``test_torch_scan_topk.py`` holds
the plain merge to the JAX package's with (``SCAN_LIKE``). Imports no JAX, so that it runs on the card as it is:
``python -m pytest tests/test_torch_merge.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from pqvector_tpu_torch.kernels import _build
from pqvector_tpu_torch.kernels import scan_topk as sc
from pqvector_tpu_torch.utils import profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


def held(tile_d, tile_i, k):
    """The kernel's merge of the lists, after holding it, its launch count
    and its counters (the trace's, one traced call) to the plain versions."""
    before = _build.LAUNCHES["merge"]
    profiling.clear_store()
    with profiling.tracing():
        got = sc._final_merge(tile_d, tile_i, k)
    counters = profiling.read_store()["counters"]
    profiling.clear_store()
    assert _build.LAUNCHES["merge"] == before + 1
    want = sc.final_merge_plain(tile_d, tile_i, k)
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape == (tile_d.shape[1], min(k, tile_d.shape[0] *
                                                                  tile_d.shape[2]))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert (counters["merge.lists"], counters["merge.heads"]) == sc.merge_counts(tile_d)
    return got


def grid_rows(rng, n, d, device):
    """Rows on a 1/4 grid: exact scores, and many equal ones across tiles."""
    return torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(np.float32) / 4).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 100, 128])
@pytest.mark.parametrize("b", [1, 5, 256])
def test_merge_of_k4_lists(cuda_device, k, b):
    """K4's own lists: sparse probes, query 0 probing nothing, the last
    query a single slot (fewer candidates than k at k >= 10)."""
    rng = np.random.default_rng(k * 1000 + b)
    nt, tile, cmax, d = 48, 256, 6, 16
    emb = grid_rows(rng, nt * tile, d, cuda_device)
    sq = (emb * emb).sum(1)
    q = grid_rows(rng, b, d, cuda_device)
    lcl = torch.from_numpy(np.sort(rng.integers(0, cmax, (nt, tile)), axis=1).reshape(-1)
                           .astype(np.int32)).to(cuda_device)
    probe = rng.random((nt, b, cmax)) < 0.05
    probe[:, 0] = False
    probe[:, -1] = False
    probe[nt // 2, -1, 0] = b > 1
    lmask = torch.from_numpy(probe.astype(np.float32)).to(cuda_device)
    lists = sc.masked_local_scan(q, emb, sq, lcl, lmask, k, tile)
    got = held(*lists, k)
    assert (got[1][0] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,b", [(10, 5), (100, 256), (128, 37)])
def test_merge_of_k5_dense_lists(cuda_device, k, b):
    """K5's lists: every list full, so the running k-th key and the
    buffer's compaction do the work."""
    rng = np.random.default_rng(k + b)
    nt, tile, d = 40, 256, 16
    emb = grid_rows(rng, nt * tile, d, cuda_device)
    sq = (emb * emb).sum(1)
    lists = sc.exact_scan(grid_rows(rng, b, d, cuda_device), emb, sq, k, tile)
    assert (lists[0] < sc.POS_INF).all()
    held(*lists, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 100])
def test_merge_of_k6_lists(cuda_device, k):
    """K6's lists: rows in file order, each query probing a few clusters."""
    rng = np.random.default_rng(k)
    nt, tile, d, kc, b = 32, 256, 16, 50, 64
    emb = grid_rows(rng, nt * tile, d, cuda_device)
    sq = (emb * emb).sum(1)
    row_cluster = torch.from_numpy(rng.integers(0, kc, nt * tile).astype(np.int32)).to(
        cuda_device)
    mask = np.zeros((b, 128), np.float32)
    for qq in range(b):
        mask[qq, rng.choice(kc, 3, replace=False)] = 1.0
    lists = sc.masked_scan(grid_rows(rng, b, d, cuda_device), emb, sq, row_cluster,
                           torch.from_numpy(mask).to(cuda_device), k, tile)
    held(*lists, k)


def crafted(rng, nt, b, kk, fill, values, ids="distinct"):
    """Lists ascending in distance, each of 0 .. kk candidates (``fill``:
    the chance a list has any) drawn from ``values``, random ids (equal
    distances in no id order); ``ids="shared"`` draws them from 0 .. 3, so
    the same (distance, id) pair sits in several tiles."""
    d = np.full((nt, b, kk), 3.0e38, np.float32)
    i = np.full((nt, b, kk), -1, np.int32)
    for t in range(nt):
        for q in range(b):
            if rng.random() >= fill:
                continue
            n = int(rng.integers(1, kk + 1))
            v = np.asarray(values, np.float32)[rng.integers(0, len(values), n)]
            d[t, q, :n] = v[np.argsort(v, kind="stable")]
            i[t, q, :n] = rng.integers(0, 4 if ids == "shared" else 2**30, n)
    return d, i


@pytest.mark.cuda
@pytest.mark.parametrize("nt,b,kk,k,fill", [
    (5, 7, 10, 100, 0.5),  # fewer candidates than k everywhere
    (2, 3, 5, 20, 1.0),  # fewer slots than k: the output is nt * kk wide
    (300, 4, 10, 7, 0.03),  # sparse, k below the lists' length
    (200, 3, 128, 128, 1.0),  # dense and full: many compactions
])
def test_merge_of_crafted_lists_with_ties_and_signed_zeros(cuda_device, nt, b, kk, k, fill):
    rng = np.random.default_rng(nt * kk + k)
    d, i = crafted(rng, nt, b, kk, fill, [-1.0, -0.0, 0.0, 0.0, 2.0, 5.0])
    held(torch.from_numpy(d).to(cuda_device), torch.from_numpy(i).to(cuda_device), k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one distance", "shared ids", "nan tails"])
def test_merge_of_adversarial_lists(cuda_device, case):
    """Every entry at one distance (ties to the lower id, across
    compactions); the same (distance, id) in many tiles with -0.0 and +0.0
    (the block's order decides which bits come first); lists that end in a
    NaN, which sorts after every empty slot."""
    rng = np.random.default_rng(len(case))
    if case == "one distance":
        d, i = crafted(rng, 150, 3, 100, 1.0, [1.5])
        k = 100
    elif case == "shared ids":
        d, i = crafted(rng, 60, 5, 16, 0.7, [-0.0, 0.0], ids="shared")
        k = 64
    else:
        d, i = crafted(rng, 40, 4, 10, 0.15, [1.0, 2.0, 3.0])
        n = (d < 3.0e38).sum(-1)
        for t, q in zip(*np.nonzero((n > 0) & (rng.random(n.shape) < 0.5))):
            d[t, q, n[t, q] - 1] = np.nan
        k = 50  # more than most queries' candidates: empty slots fill the rest
    held(torch.from_numpy(d).to(cuda_device), torch.from_numpy(i).to(cuda_device), k)


#: Lists laid out as the scans write them, with ties across tiles and zeros
#: of both signs: (nt, B, kk, the chance a list has candidates, distances).
#: ``test_torch_scan_topk.py`` holds the plain merge's ids to the JAX
#: package's ``_final_merge`` on them (on the CPU); here the kernel is held
#: to the plain merge on the same lists.
SCAN_LIKE = {
    "ties across tiles": (60, 5, 10, 0.3, [-1.0, 0.5, 2.0]),
    "signed zeros": (40, 4, 8, 0.3, [-0.0, 0.0, 1.0]),
    "fewer candidates than k": (12, 3, 32, 0.2, [0.0, 1.0, 2.0]),
    "dense": (50, 3, 16, 1.0, [1.0, 2.0]),
}


def scan_like_lists(case):
    """``SCAN_LIKE[case]`` as numpy lists: tile t holds rows t * 1000 ..
    t * 1000 + 999, each list ascending in (distance, id) (numpy's order,
    -0.0 = +0.0), so a lower place in the [B, nt·kk] block among equal
    distances is a lower id."""
    nt, b, kk, fill, values = SCAN_LIKE[case]
    rng = np.random.default_rng(nt * kk)
    d = np.full((nt, b, kk), 3.0e38, np.float32)
    i = np.full((nt, b, kk), -1, np.int32)
    for t in range(nt):
        for q in range(b):
            if rng.random() >= fill:
                continue
            n = int(rng.integers(1, kk + 1))
            ids = t * 1000 + rng.choice(1000, n, replace=False)
            v = np.asarray(values, np.float32)[rng.integers(0, len(values), n)]
            order = np.lexsort((ids, v))
            d[t, q, :n], i[t, q, :n] = v[order], ids[order]
    return d, i


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCAN_LIKE))
def test_merge_of_scan_like_lists(cuda_device, case):
    d, i = scan_like_lists(case)
    held(torch.from_numpy(d).to(cuda_device), torch.from_numpy(i).to(cuda_device), d.shape[2])


@pytest.mark.cuda
def test_merge_counter_while_tracing(cuda_device):
    """With tracing on and no ``stats``, the trace's ``merge`` counter adds
    the plain rule's counts, one launch a call."""
    rng = np.random.default_rng(3)
    d, i = crafted(rng, 100, 8, 10, 0.2, [1.0, 2.0, 3.0])
    td, ti = torch.from_numpy(d).to(cuda_device), torch.from_numpy(i).to(cuda_device)
    profiling.clear_store()
    with profiling.tracing():
        for _ in range(3):
            sc._final_merge(td, ti, 10)
    counters = profiling.read_store()["counters"]
    lists, heads = sc.merge_counts(td)
    assert counters["merge.lists"] == 3 * lists and counters["merge.heads"] == 3 * heads
    profiling.clear_store()
