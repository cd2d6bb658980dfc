"""The score tile shared by K9 and K5 (``csrc/score_tile.cuh``,
``kernels/score_tile.py``): the rule on shapes that picks the back end, the
launch geometry and the dynamic shared memory as Python functions; the
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
    assert score_tile.stages("K5", "wgmma") == 2
    src = (_build.CSRC / "score_tile.cuh").read_text()
    assert "kStageBytes = 2 * 128 * 128" in src and "kXS = kTR + 4" in src
    assert f"kDumpStride = {score_tile.DUMP_STRIDE}" in (_build.CSRC / "scan_topk.cu").read_text()


@pytest.mark.parametrize("backend,queries", [("fma", 64), ("fma", 128), ("wgmma", 128)])
def test_shared_memory_fits_for_every_k(backend, queries):
    """The size depends on k and the back end only: a stage holds a fixed
    number of dimensions, so every d the searcher accepts takes the same."""
    sizes = [score_tile.smem_bytes("K5", backend, queries, k) for k in range(1, 129)]
    assert sizes == sorted(sizes) and max(sizes) <= score_tile.SMEM_LIMIT
    assert score_tile.smem_bytes("K9", backend, queries) <= 101_376  # two blocks per SM
    assert score_tile.smem_bytes("K5", backend, queries, 10) <= 113_000  # two at k = 10


def test_shared_memory_at_the_corner():
    """128 queries x k = 128 lists beside two wgmma stages: 512 bytes spare."""
    assert score_tile.smem_bytes("K5", "wgmma", 128, 128) == 231_936
    assert score_tile.SMEM_LIMIT == 232_448


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
