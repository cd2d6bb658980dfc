"""K7 and K8 on the score tile: the chunk schedule of a slab block, the
bins a thread keeps, and the launch geometry, in the index math of
``csrc/binscan.cu`` and ``csrc/score_tile.cuh``; on a card, each back end
(wgmma, the fp32 patch, the dp4a patch) against the plain key table.

Grid data (rows on a 1/4 grid, |x| <= 4) makes every f32 and bf16 sum
exact whatever its order, and int8 dot products are exact int32 sums, so
the kernel's key table must equal the plain version's bit for bit.
"""

import numpy as np
import pytest
import torch

from pqvector_tpu_torch.kernels import binscan as tbs
from pqvector_tpu_torch.kernels import score_tile
from pqvector_tpu_torch.query.device import _quantize_rows_i8


@pytest.mark.parametrize(
    "n_units,n_lg,expand,splits",
    [
        # K7: every tile of the array, n_units = nt
        (20, 4, 1, 1), (20, 4, 2, 3), (40, 4, 4, 7), (490, 16, 2, 4),
        (22, 4, 2, 5),  # a partial last tile group
        (9, 1, 4, 2),  # one lane group a tile
        (16, 2, 4, 50),  # more splits than a slab block has slots
        # K8: n_units = cap selected slots, fewer than the tiles
        (9, 2, 4, 1), (11, 2, 4, 3), (245, 16, 2, 8), (33, 16, 2, 2),
    ],
)
def test_chunk_schedule_scores_every_lane_group_once(n_units, n_lg, expand, splits):
    """Over the blocks of one query group, every (slot, lane group) pair is
    scored exactly once, by the block whose slab it folds into."""
    sched = tbs.chunk_schedule(n_units, n_lg, expand, splits)
    assert set(sched) == {(s, p) for s in range(expand * n_lg) for p in range(splits)}
    seen = []
    for (slab, _), chunks in sched.items():
        for slot, g3 in chunks:
            tg = slot // n_lg
            assert (slot + g3) % n_lg + (tg % expand) * n_lg == slab
            seen.append((slot, g3))
    assert sorted(seen) == [(s, g) for s in range(n_units) for g in range(n_lg)]
    sizes = [len(c) for c in sched.values()]
    per_slab = [sum(len(sched[(s, p)]) for p in range(splits)) for s in range(expand * n_lg)]
    for s in range(expand * n_lg):  # the splits of a slab are near-equal runs
        runs = [len(sched[(s, p)]) for p in range(splits)]
        assert max(runs) - min(runs) <= 1
    assert sum(sizes) == sum(per_slab) == n_units * n_lg


def _patch_positions(backend, queries):
    """(query, lane) of each accumulator position of each thread, from the
    tiles' accessors (score_tile.cuh: MmaTile, PatchLayout)."""
    out = []
    for tid in range(score_tile.THREADS):
        if backend == "wgmma":
            lane = tid & 31
            wq = 16 * (tid >> 5) + (lane >> 2)
            qs = [wq + 8 * jq for jq in range(2)]
            rows = [8 * g + 2 * (lane & 3) + l for g in range(16) for l in range(2)]
        else:
            tx, ty = tid & 15, tid >> 4
            nq = queries // 16
            qs = [4 * ty + jq if jq < 4 else 60 + 4 * ty + jq for jq in range(nq)]
            rows = [64 * g + 4 * tx + l for g in range(2) for l in range(4)]
        out += [(q, r) for r in rows for q in qs]
    return out


@pytest.mark.parametrize("backend,queries", [("wgmma", 128), ("fma", 128), ("fma", 64),
                                             ("dp4a", 128), ("dp4a", 64)])
def test_bins_cover_the_slab_once(backend, queries):
    """A thread's bins are its accumulator positions: over the block they
    are every (query, lane) bin of the slab exactly once, so one atomicMin
    per position folds the whole block."""
    pos = _patch_positions(backend, queries)
    assert sorted(pos) == [(q, r) for q in range(queries) for r in range(128)]


@pytest.mark.parametrize(
    "batch,backend,n_units,tile,expand,want",
    [
        (256, "wgmma", 490, 2048, 2, 4),  # the main path's file: two waves of one block an SM
        (1, "fma", 490, 2048, 2, 16),  # 64 queries a block: two an SM
        (1, "dp4a", 490, 2048, 2, 16),
        (4096, "wgmma", 490, 2048, 2, 1),  # already eight waves
        (256, "fma", 9, 256, 4, 3),  # never more splits than a slab block's slots
    ],
)
def test_splits_fill_about_two_waves(batch, backend, n_units, tile, expand, want):
    assert tbs.splits_for(batch, backend, n_units, tile, expand) == want
    queries = score_tile.block_queries(batch, backend)
    blocks = -(-batch // queries) * expand * (tile // 128) * want
    per_sm = 1 if queries == 128 else 2
    assert want == 1 or blocks <= 2 * score_tile.SM_COUNT * per_sm


@pytest.mark.parametrize("backend,queries", [("fma", 64), ("fma", 128), ("wgmma", 128),
                                             ("dp4a", 64), ("dp4a", 128)])
def test_shared_memory_of_the_binned_scan(backend, queries):
    """Three stages of the ring, the norms and the row scales of two chunks;
    one block an SM for 128 queries, two for 64."""
    smem = score_tile.smem_bytes("K7", backend, queries)
    stage = 2 * 128 * 128 if backend == "wgmma" else 16 * (132 + queries + 4) * 4
    assert smem == 1024 + 3 * stage + 4 * 128 * 4
    assert smem == score_tile.smem_bytes("K8", backend, queries)
    blocks = 1 if queries == 128 else 2
    assert blocks * (smem + 1024) <= score_tile.SMEM_PER_SM


def test_backend_follows_the_storage():
    x = torch.zeros((256, 72))
    codes, _ = _quantize_rows_i8(x)
    assert tbs.backend(codes, codes) == "dp4a"
    assert tbs.backend(x, x) == "fma"
    b = x.to(torch.bfloat16)
    assert tbs.backend(b, b) == "wgmma"
    b100 = torch.zeros((256, 100), dtype=torch.bfloat16)
    assert tbs.backend(b100, b100) == "fma"


def _grid_rows(n, d, tile, b, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, (17, d)).astype(np.float32) / 4
    x = base[rng.integers(0, 17, n)] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4
    n_pad = -(-(n + 1) // tile) * tile
    emb = np.zeros((n_pad, d), np.float32)
    emb[:n] = x
    sq = np.full(n_pad, 3.0e38, np.float32)
    sq[:n] = (x * x).sum(1)
    q = x[rng.integers(0, n, b)] + rng.integers(-1, 2, (b, d)).astype(np.float32) / 4
    return emb, sq, q


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,d,batch,want_backend",
    [
        ("bfloat16", 64, 37, "wgmma"), ("bfloat16", 128, 130, "wgmma"),
        ("bfloat16", 100, 20, "fma"), ("bfloat16", 100, 129, "fma"),
        ("float32", 40, 64, "fma"), ("float32", 96, 200, "fma"),
        ("int8", 33, 5, "dp4a"), ("int8", 200, 65, "dp4a"), ("int8", 128, 257, "dp4a"),
    ],
)
@pytest.mark.parametrize("select", [False, True])
def test_back_end_equals_plain_on_card(cuda_device, dtype, d, batch, want_backend, select):
    tile, expand = 256, 2
    emb, sq, q = _grid_rows(6000, d, tile, batch, seed=d + batch)
    e32 = torch.from_numpy(emb).to(cuda_device)
    sq_t = torch.from_numpy(sq).to(cuda_device)
    q_t = torch.from_numpy(q).to(cuda_device)
    scale = None
    if dtype == "int8":
        e, scale = _quantize_rows_i8(e32)
    else:
        e = e32.to(getattr(torch, dtype))
    assert tbs.backend(e, q_t.to(e.dtype) if scale is None else q_t) == want_backend
    if select:
        nt = e.shape[0] // tile
        sel = torch.from_numpy(np.random.default_rng(d).permutation(nt)[:9].astype(np.int32))
        args = (q_t, e, sq_t, sel.to(cuda_device), tile, expand, scale)
        got = tbs.binned_scan_select_keys(*args)
        want = tbs.binned_scan_select_keys_plain(*args)
    else:
        args = (q_t, e, sq_t, tile, expand, scale)
        got, want = tbs.binned_scan_keys(*args), tbs.binned_scan_keys_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
