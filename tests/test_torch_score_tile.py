"""The score tile shared by K9, K5, K4, K2 and K1 (``csrc/score_tile.cuh``,
``kernels/score_tile.py``): the rule on shapes that picks the back end, the
launch geometry and the dynamic shared memory as Python functions (for K2
also the split of the rows into runs, ``stream_topk.scan_units``; for K4 the
width of the probe table; K3's item tiles, ``stream_topk.item_scan_smem``,
on the card); the
wrappers on CPU tensors against the JAX package's ``pallas_tile_min`` and
``pallas_exact_topk`` in interpret mode at the shapes the 128 x 128 tile
makes awkward; and, on the card, the kernels against their plain versions
at the same shapes.

Tolerances. K9: ``max(d, 128) * 2^-21 * (|q|^2 + max |x|^2)``, the
certificate's envelope (``test_torch_tilemin.py``), because the matrix
products sum in other orders; pad-only tiles return their sentinel exactly.
K5: the rows lie on a 1/4 grid, so every score is exact and ids must be
equal, d² at rtol 1e-5 and atol 1e-5 * |q|^2
(``test_torch_scan_exact_masked.py``). On the card, grid data makes kernel
and plain version equal bit for bit on both back ends."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqvector_tpu.kernels import scan_topk as jsc
from pqvector_tpu.kernels.tilemin import pallas_tile_min
from pqvector_tpu_torch.kernels import _build, score_tile
from pqvector_tpu_torch.kernels import scan_topk as tsc
from pqvector_tpu_torch.kernels import stream_topk as tst
from pqvector_tpu_torch.kernels.tilemin import tile_min, tile_min_plain

BF16, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------- the rule


@pytest.mark.parametrize(
    "dtype,d,addresses,want",
    [
        (F32, 128, (0, 0), "fma"),  # f32 scores are IEEE fp32 FMA, always
        (F32, 8, (0, 0), "fma"),
        (BF16, 128, (0, 0), "wgmma"),
        (BF16, 96, (4096, 512), "wgmma"),
        (BF16, 8, (16, 32), "wgmma"),
        (BF16, 136, (0, 0), "wgmma"),
        (BF16, 100, (0, 0), "fma"),  # rows of 200 bytes are not 16-byte aligned
        (BF16, 3, (0, 0), "fma"),
        (BF16, 4, (0, 0), "fma"),
        (BF16, 128, (8, 0), "fma"),  # a view that starts off a 16-byte boundary
        (BF16, 128, (0, 2), "fma"),
        (torch.float16, 128, (0, 0), "fma"),
    ],
)
def test_pick_backend_is_a_rule_on_shapes(dtype, d, addresses, want):
    assert score_tile.pick_backend(dtype, d, *addresses) == want


@pytest.mark.parametrize("d", [1, 3, 8, 40, 72, 96, 100, 128, 136, 768, 1024, 4096])
def test_backend_follows_d_mod_8_for_bf16(d):
    assert score_tile.pick_backend(BF16, d, 0, 0) == ("wgmma" if d % 8 == 0 else "fma")
    assert score_tile.pick_backend(F32, d, 0, 0) == "fma"


@pytest.mark.parametrize(
    "batch,backend,want",
    [(1, "fma", 64), (64, "fma", 64), (65, "fma", 128), (256, "fma", 128),
     (1, "wgmma", 128), (64, "wgmma", 128), (257, "wgmma", 128)],
)
def test_block_queries(batch, backend, want):
    assert score_tile.block_queries(batch, backend) == want


@pytest.mark.parametrize(
    "batch,backend,units,want",
    [(256, "fma", 980, 1960), (257, "fma", 980, 2940), (1, "fma", 7, 7),
     (64, "wgmma", 10, 10), (129, "wgmma", 10, 20), (65, "fma", 3, 3)],
)
def test_grid_keeps_a_units_query_groups_together(batch, backend, units, want):
    assert score_tile.grid_blocks(batch, backend, units) == want


def test_stage_sizes_mirror_the_sources():
    assert score_tile.stage_bytes("wgmma", 128) == 32768
    assert score_tile.stage_bytes("fma", 128) == 16 * (132 + 132) * 4
    assert score_tile.stage_bytes("fma", 64) == 16 * (132 + 68) * 4
    assert score_tile.stages("K9", "wgmma") == score_tile.stages("K5", "fma") == 3
    assert score_tile.stages("K5", "wgmma") == score_tile.stages("K2", "wgmma") == 2
    assert score_tile.stages("K2", "fma") == score_tile.stages("K1", "fma") == 3
    src = (_build.CSRC / "score_tile.cuh").read_text()
    assert "kStageBytes = 2 * 128 * 128" in src and "kXS = kTR + 4" in src
    lists = (_build.CSRC / "topk_lists.cuh").read_text()
    assert f"kDumpStride = {score_tile.DUMP_STRIDE}" in lists
    assert "kTopkFmaStages = 3, kTopkMmaStages = 2" in lists
    assert "kAssignStages = 3" in (_build.CSRC / "assign.cu").read_text()


@pytest.mark.parametrize("backend,queries", [("fma", 64), ("fma", 128), ("wgmma", 128)])
def test_shared_memory_fits_for_every_k(backend, queries):
    """The size depends on k and the back end only: a stage holds a fixed
    number of dimensions, so every d the searcher accepts takes the same."""
    for kernel in ("K5", "K2"):
        sizes = [score_tile.smem_bytes(kernel, backend, queries, k) for k in range(1, 129)]
        assert sizes == sorted(sizes) and max(sizes) <= score_tile.SMEM_LIMIT
        assert score_tile.smem_bytes(kernel, backend, queries, 10) <= 113_000  # two at k = 10
    assert score_tile.smem_bytes("K9", backend, queries) <= 101_376  # two blocks per SM


def test_shared_memory_at_the_corner():
    """128 queries x k = 128 lists beside two wgmma stages: 512 bytes spare."""
    assert score_tile.smem_bytes("K5", "wgmma", 128, 128) == 231_936
    assert score_tile.smem_bytes("K2", "wgmma", 128, 128) == 231_936
    assert score_tile.SMEM_LIMIT == 232_448


# ---------------------------------------------------------------- K2 and K1


@pytest.mark.parametrize("k", range(1, 129))
def test_k2_shares_k5s_shared_memory_for_every_k(k):
    """K2's blocks hold the same ring, lists, dump and norms as K5's."""
    for backend, queries in (("fma", 64), ("fma", 128), ("wgmma", 128)):
        size = score_tile.smem_bytes("K2", backend, queries, k)
        assert size == score_tile.smem_bytes("K5", backend, queries, k)
        assert size <= score_tile.SMEM_LIMIT
        ring = score_tile.stages("K2", backend) * score_tile.stage_bytes(backend, queries)
        assert size == 1024 + ring + queries * (8 * k + 260) + 1024


def test_k1_shared_memory_leaves_room_for_two_blocks():
    assert score_tile.smem_bytes("K1", "fma", 128) == 1024 + 3 * 16896 + 1024
    assert 2 * score_tile.smem_bytes("K1", "fma", 128) <= score_tile.SMEM_LIMIT


@pytest.mark.parametrize(
    "chunks,batch,queries,want",
    [
        (7840, 256, 128, 131),  # 1M x 128 padded to 4096: 60 chunks a run, 262 blocks
        (7840, 1, 64, 262),  # 30 chunks a run
        (7840, 64, 64, 262),
        (7840, 65, 128, 262),
        (7840, 128, 128, 262),
        (7840, 4096, 128, 9),  # 32 query groups: 9 runs of 872 chunks
        (7840, 40_000, 128, 1),  # more groups than a wave: every block walks all rows
        (78144, 256, 128, 132),  # 10M rows
        (1, 256, 128, 1),
        (3, 1, 64, 3),  # never more runs than chunks
        (263, 1, 64, 263),
        (265, 1, 64, 133),  # two chunks a run
    ],
)
def test_scan_units_fills_about_one_wave(chunks, batch, queries, want):
    units = tst.scan_units(chunks, batch, queries)
    assert units == want
    groups = -(-batch // queries)
    per = -(-chunks // units)
    assert (units - 1) * per < chunks <= units * per  # no run is empty
    if groups <= 264 and chunks >= 264:
        assert 132 < units * groups <= 264 + groups


@pytest.mark.parametrize(
    "backend,queries,k,want",
    [("fma", 128, 10, 264), ("fma", 128, 29, 264), ("fma", 128, 30, 132),
     ("fma", 128, 128, 132), ("fma", 64, 100, 264), ("fma", 64, 114, 264),
     ("fma", 64, 115, 132), ("wgmma", 128, 10, 264), ("wgmma", 128, 14, 264),
     ("wgmma", 128, 15, 132), ("wgmma", 128, 100, 132)],
)
def test_wave_follows_the_shared_memory_of_k(backend, queries, k, want):
    """Two blocks an SM while their lists fit its shared memory, one beyond."""
    assert score_tile.wave_blocks(score_tile.smem_bytes("K2", backend, queries, k)) == want


@pytest.mark.parametrize(
    "chunks,batch,queries,wave,want",
    [(7840, 256, 128, 132, 66), (7840, 1, 64, 132, 131), (7840, 4096, 128, 132, 5),
     (100, 1, 64, 132, 100)],
)
def test_scan_units_at_large_k_fill_one_block_an_sm(chunks, batch, queries, wave, want):
    assert tst.scan_units(chunks, batch, queries, wave) == want


@pytest.mark.parametrize(
    "n_pad,units,want_run",
    [(1_003_520, 131, 7680), (1_003_520, 1, 1_003_520), (768, 1000, 128), (700, 3, 256),
     (64, 5, 128), (4096, 32, 128), (4096, 33, 128), (4096, 31, 256)],
)
def test_run_rows_are_whole_chunks_that_cover_the_array(n_pad, units, want_run):
    run = tst.run_rows(n_pad, units)
    assert run == want_run and run % score_tile.CHUNK_ROWS == 0
    launched = -(-n_pad // run)
    assert launched <= max(1, units) and (launched - 1) * run < n_pad <= launched * run


@pytest.mark.parametrize(
    "batch,dtype,d,k,blocks",
    [(256, F32, 128, 10, 262), (256, BF16, 128, 10, 262), (1, F32, 128, 10, 262),
     (1, BF16, 128, 10, 262), (13, BF16, 100, 10, 262), (64, F32, 3, 10, 262),
     (65, F32, 128, 10, 262), (4096, BF16, 96, 10, 288), (256, F32, 128, 100, 132),
     (256, BF16, 128, 100, 132), (1, F32, 128, 100, 262), (1, F32, 128, 128, 131)],
)
def test_k2_launch_geometry_at_the_main_shape(batch, dtype, d, k, blocks):
    """1M rows padded to 1,003,520: the blocks a K2 launch makes."""
    n_pad = 1_003_520
    backend = score_tile.pick_backend(dtype, d, 0, 0)
    queries = score_tile.block_queries(batch, backend)
    wave = score_tile.wave_blocks(score_tile.smem_bytes("K2", backend, queries, k))
    units = tst.scan_units(n_pad // 128, batch, queries, wave)
    run = tst.run_rows(n_pad, units)
    assert -(-n_pad // run) == units
    assert score_tile.grid_blocks(batch, backend, units) == blocks


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("k", range(1, 129))
def test_masked_kernels_shared_memory_fits_for_every_k(k):
    """K4 holds K5's block plus 64 bytes of flags and, where it fits, a
    probe table of one bit per slot: its width is ceil(cmax / 32) words up
    to 8, else 0 (the table is then read from device memory), and the
    launch is within the limit either way."""
    for backend, queries in (("fma", 64), ("fma", 128), ("wgmma", 128)):
        base = score_tile.smem_bytes("K5", backend, queries, k)
        for cmax in (1, 2, 32, 33, 150, 256, 257, 5000):
            words = score_tile.table_words(backend, queries, k, cmax)
            size = score_tile.smem_bytes("K4", backend, queries, k, words)
            assert size <= score_tile.SMEM_LIMIT
            assert words in (0, -(-cmax // 32)) and words <= score_tile.TABLE_WORDS_MAX
            if cmax > 32 * score_tile.TABLE_WORDS_MAX:
                assert words == 0
            if words:
                assert size == base + 64 + 1024 + 32 * words + 4 * queries * words
            else:
                assert size == base + 64
                fit = score_tile.smem_bytes("K4", backend, queries, k, -(-cmax // 32))
                assert cmax > 256 or fit > score_tile.SMEM_LIMIT


def test_masked_kernels_table_at_the_corners():
    """k = 128 at 128 queries on wgmma leaves 512 bytes: no table. The served
    shape (k = 10, a few clusters a tile) holds one word a query and two
    blocks on an SM."""
    assert score_tile.table_words("wgmma", 128, 128, 2) == 0
    assert score_tile.smem_bytes("K4", "wgmma", 128, 128, 0) == 231_936 + 64
    assert score_tile.table_words("fma", 128, 128, 2) == 1
    assert score_tile.table_words("wgmma", 128, 10, 4) == 1
    served = score_tile.smem_bytes("K4", "wgmma", 128, 10, 1)
    assert served == 112_736 and score_tile.wave_blocks(served) == 264
    assert score_tile.stages("K4", "wgmma") == 2
    assert score_tile.stages("K4", "fma") == 3
    # on the CUDA cores a block serves 64 queries whatever the batch: two fit an SM to k = 100
    assert score_tile.masked_block_queries("wgmma") == 128
    assert score_tile.masked_block_queries("fma") == 64
    at_100 = score_tile.smem_bytes("K4", "fma", 64, 100, 1)
    assert score_tile.wave_blocks(at_100) == 264
    assert score_tile.wave_blocks(score_tile.smem_bytes("K4", "wgmma", 128, 100, 1)) == 132


@pytest.mark.parametrize(
    "pairs,want",
    [
        (4096 * 4, 1),  # deep10m.search.b4096: ~4,000 items without a cut
        (256 * 4, 1),  # deep10m.search.b256
        (256 * 8, 1),  # sift1m.search.b256
        (256 * 16, 1),  # ref1024.search.b256
        (1023, 2),
        (512, 2),
        (256, 4),
        (129, 8),
        (8, 8),  # one query, nprobe 8: at most 8 segments a cluster
        (1, 8),
    ],
)
def test_masked_segments_give_the_card_about_a_thousand_items(pairs, want):
    segs = tst.masked_segments(pairs)
    assert segs == want
    assert 1 <= segs <= tst.MAX_SEGMENTS
    if segs < tst.MAX_SEGMENTS:
        assert pairs * segs >= 1024


@pytest.mark.parametrize("segs", [1, 2, 3, 8])
@pytest.mark.parametrize("rows", [0, 1, 128, 129, 640, 1000, 5000])
def test_segments_cut_a_cluster_into_whole_chunks_once(rows, segs):
    """A probed cluster's rows go to at most ``segs`` segments of whole
    128-row chunks (the last may end inside one), none empty, together every
    row once; a cluster with no rows gets one empty item."""
    offsets = torch.tensor([0, 300, 300 + rows, 300 + rows + 50], dtype=torch.int32)
    probe = torch.tensor([[1]], dtype=torch.int32)
    items, _ = tst.work_items_plain(offsets, probe, segs)
    spans = [(int(i[0]), int(i[1])) for i in items]
    parts = (int(items[0, 3]) >> 16) if len(items) else 0
    assert parts == len(spans) <= max(1, min(segs, -(-rows // 128)))
    assert [(int(i[3]) >> 8) & 0xFF for i in items] == list(range(parts))
    if rows == 0:
        assert spans == [(300, 300)]
        return
    assert spans[0][0] == 300 and spans[-1][1] == 300 + rows
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all((hi - lo) % 128 == 0 for lo, hi in spans[:-1])


# ---------------------------------------------------------------- K9 vs JAX


def _rows(n_pad, d, b, seed, pad, sentinel=np.inf):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    x[-pad:] = 0.0
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    sq[-pad:] = sentinel
    q = rng.standard_normal((b, d)).astype(np.float32)
    return x, sq, q


def _envelope(q, sq, d):
    return max(d, 128) * 2.0**-21 * ((q * q).sum(1).max() + sq[sq < 1e38].max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "tile,n_pad,d,b",
    [(128, 4096, 8, 129), (128, 4096, 96, 257), (128, 4096, 100, 37),
     (128, 4096, 136, 129), (1024, 8192, 72, 5), (2048, 8192, 40, 13)],
)
def test_tile_min_matches_jax_at_awkward_shapes(tile, n_pad, d, b, dtype):
    x, sq, q = _rows(n_pad, d, b, seed=tile + d + b, pad=tile + 9)
    want = np.asarray(pallas_tile_min(
        jnp.asarray(q), jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(sq), tile,
        interpret=True))
    got = tile_min(torch.from_numpy(q), torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(sq), tile).numpy()
    assert got.shape == (b, n_pad // tile)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got - want)[fin].max() <= _envelope(q, sq, d)
    assert np.isinf(got[:, -1]).all()  # the last tile is all pad rows


# ---------------------------------------------------------------- K5 vs JAX


def _grid(n, d, tile, nq, seed):
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


def _canon(d, i):
    d, i = np.asarray(d, np.float64), np.asarray(i).astype(np.int64)
    fin = np.isfinite(d)
    d, i = np.where(fin, d, np.inf), np.where(fin, i, -1)
    order = np.lexsort((i, d), axis=-1)
    return np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,tile,k,d,b",
    [(1500, 256, 10, 8, 129), (1500, 512, 10, 96, 257), (900, 256, 33, 100, 37),
     (1200, 256, 128, 136, 128), (5, 256, 9, 72, 5)],
)
def test_exact_topk_matches_jax_at_awkward_shapes(n, tile, k, d, b, dtype):
    emb, sq, q = _grid(n, d, tile, b, seed=n + k + d)
    want = jsc.pallas_exact_topk(
        jnp.asarray(q), jnp.asarray(emb, getattr(jnp, dtype)), jnp.asarray(sq), k,
        tile=tile, interpret=True)
    got = tsc.exact_topk(torch.from_numpy(q), torch.from_numpy(emb).to(getattr(torch, dtype)),
                         torch.from_numpy(sq), k, tile)
    gd, gi = _canon(got[0].numpy(), got[1].numpy())
    wd, wi = _canon(*want)
    np.testing.assert_array_equal(gi, wi)
    scale = (q.astype(np.float64) ** 2).sum(1).max()
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5 * scale)


def test_cpu_calls_launch_nothing():
    emb, sq, q = _grid(300, 8, 128, 3, seed=1)
    before = dict(_build.LAUNCHES)
    tsc.exact_scan(torch.from_numpy(q), torch.from_numpy(emb), torch.from_numpy(sq), 5, 128)
    tile_min(torch.from_numpy(q), torch.from_numpy(emb), torch.from_numpy(sq), 128)
    assert _build.LAUNCHES == before


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sources_and_python_agree_on_shared_memory(cuda_device):
    lib = _build.load()
    for backend, queries in (("fma", 64), ("fma", 128), ("wgmma", 128)):
        flag = int(backend == "wgmma")
        assert lib.pqv_tile_min_smem(flag, queries) == score_tile.smem_bytes(
            "K9", backend, queries)
        for k in (1, 10, 128):
            assert lib.pqv_exact_topk_smem(flag, queries, k) == score_tile.smem_bytes(
                "K5", backend, queries, k)
            assert lib.pqv_stream_exact_topk_smem(flag, queries, k) == score_tile.smem_bytes(
                "K2", backend, queries, k)
            for words in (0, 1, 8):
                want = score_tile.smem_bytes("K4", backend, queries, k, words)
                assert lib.pqv_masked_local_topk_smem(flag, queries, k, words) == want
            assert lib.pqv_stream_masked_topk_smem(flag, k) == tst.item_scan_smem(backend, k)
    assert lib.pqv_assign_smem() == score_tile.smem_bytes("K1", "fma", 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize(
    "tile,d,b", [(2, 8, 129), (16, 96, 257), (128, 100, 37), (1024, 136, 129),
                 (2048, 72, 64), (128, 128, 1)],
)
def test_tile_min_kernel_equals_plain_on_card(cuda_device, dtype, tile, d, b):
    n = 2 * tile + tile // 2 + 1
    emb, sq, q = _grid(n, d, tile, b, seed=tile + d)
    emb = np.concatenate([emb, np.zeros((tile, d), np.float32)])
    sq = np.concatenate([sq, np.full(tile, 3.0e38, np.float32)])
    sq[sq > 1e38] = np.inf
    args = (torch.from_numpy(q).to(cuda_device),
            torch.from_numpy(emb).to(cuda_device).to(dtype),
            torch.from_numpy(sq).to(cuda_device), tile)
    before = _build.LAUNCHES["K9"]
    got = tile_min(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K9"] == before + 1
    assert torch.equal(got, tile_min_plain(*args))
    assert bool(torch.isinf(got[:, -1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize(
    "n,tile,k,d,b",
    [(5000, 256, 128, 72, 128), (3000, 1024, 10, 96, 129), (3000, 1024, 10, 100, 257),
     (700, 64, 10, 8, 37), (5, 256, 9, 136, 5), (2000, 192, 7, 40, 13)],
)
def test_exact_scan_kernel_equals_plain_on_card(cuda_device, dtype, n, tile, k, d, b):
    emb, sq, q = _grid(n, d, tile, b, seed=n + tile + k)
    args = (torch.from_numpy(q).to(cuda_device).to(dtype),
            torch.from_numpy(emb).to(cuda_device).to(dtype),
            torch.from_numpy(sq).to(cuda_device), k, tile)
    before = _build.LAUNCHES["K5"]
    got = tsc.exact_scan(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K5"] == before + 1
    want = tsc.exact_scan_plain(*args)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
