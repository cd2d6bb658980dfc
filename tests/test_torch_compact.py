"""K10 and K11 (``pqvector_tpu_torch/kernels/compact.py``) against the JAX
package's ``pallas_tile_gather`` and ``pallas_tile_gather_dma`` in
interpret mode, and ``search(mode="compact")`` of both packages. The
gathers are copies: bit-equal. Search ids are equal, distances to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.kernels.compact import pallas_tile_gather, pallas_tile_gather_dma
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher
from pqvector_tpu_torch.convert import copy_searcher_knobs, index_from_reference
from pqvector_tpu_torch.kernels import _build
from pqvector_tpu_torch.kernels.compact import (
    dma_eligible,
    tile_gather,
    tile_gather_dma,
    tile_gather_plain,
)


def _arrays(nt, ctile, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nt * ctile, d)).astype(np.float32)
    sq = rng.standard_normal(nt * ctile).astype(np.float32)
    return x, sq


SELS = {
    "one": [5],
    "all": list(range(12)),
    "out_of_order": [7, 2, 11, 0, 3],
    "repeats": [3, 3, 0, 11, 3, 0],
}


@pytest.mark.parametrize("sel", SELS.values(), ids=SELS.keys())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "ctile,d",
    [(128, 96), (128, 128), (4, 3), (256, 16),
     # a tile's rows (f32; bf16 at half) just under and just over the
     # kernels' 16 KB items
     (4, 1023), (4, 1025)],
)
@pytest.mark.parametrize("port,ref", [(tile_gather, pallas_tile_gather),
                                      (tile_gather_dma, pallas_tile_gather_dma)],
                         ids=["K10", "K11"])
def test_gather_is_bit_equal_to_jax(port, ref, ctile, d, dtype, sel):
    x, sq = _arrays(12, ctile, d, seed=ctile + d)
    sel = np.asarray(sel, np.int32)
    want_e, want_s = ref(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(sq),
                         jnp.asarray(sel), ctile=ctile, cap=len(sel), interpret=True)
    emb = torch.from_numpy(x).to(getattr(torch, dtype))
    got_e, got_s = port(emb, torch.from_numpy(sq), torch.from_numpy(sel), ctile)
    assert got_e.shape == (len(sel) * ctile, d) and got_e.dtype == emb.dtype
    np.testing.assert_array_equal(got_e.float().numpy(),
                                  np.asarray(want_e.astype(jnp.float32)))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_dma_rule_on_shapes():
    """K11 takes tiles whose bytes are multiples of 16 in both arrays."""
    sq = torch.zeros(1024)
    assert dma_eligible(torch.zeros(1024, 96, dtype=torch.bfloat16), sq, 512)
    assert dma_eligible(torch.zeros(1024, 3), sq, 4)
    assert not dma_eligible(torch.zeros(1024, 3, dtype=torch.bfloat16), sq, 4)  # 24 B
    assert not dma_eligible(torch.zeros(1024, 8), sq, 2)  # norms: 8 B


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(ctile=100), ValueError),
        (dict(sel=torch.zeros(3, dtype=torch.int64)), TypeError),
        (dict(sel=torch.zeros(0, dtype=torch.int32)), TypeError),
        (dict(emb=torch.zeros(1024, 8, dtype=torch.float16)), TypeError),
        (dict(sq=torch.zeros(1000)), TypeError),
    ],
)
@pytest.mark.parametrize("fn", [tile_gather, tile_gather_dma], ids=["K10", "K11"])
def test_wrapper_rejects_bad_operands(fn, kw, err):
    emb = kw.get("emb", torch.zeros(1024, 8))
    sq = kw.get("sq", torch.zeros(1024))
    sel = kw.get("sel", torch.zeros(3, dtype=torch.int32))
    with pytest.raises(err):
        fn(emb, sq, sel, kw.get("ctile", 128))


def _searchers(n, d, kc, row_tile, dtype, sorted_, seed):
    rng = np.random.default_rng(seed)
    cent = rng.integers(-8, 9, (kc, d)).astype(np.float32) / 2
    x = (cent[rng.integers(0, kc, n)] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, 9)] + 0.05 * rng.standard_normal((9, d))).astype(np.float32)
    index = j_build_ivf_index(JEmbeddings(x, d), JIvfBuildConfig(n_clusters=kc, seed=0))
    js = JSearcher(index, x, dtype=getattr(jnp, dtype), row_tile=row_tile,
                   cluster_sorted=sorted_)
    ts = DeviceIvfSearcher(
        index_from_reference(np.asarray(index.centroids), index.list_offsets,
                             index.row_ids),
        x, dtype=getattr(torch, dtype), row_tile=row_tile, cluster_sorted=sorted_,
        device="cpu")
    copy_searcher_knobs(js, ts)
    return js, ts, q


@pytest.mark.parametrize("nprobe", [1, 3])
@pytest.mark.parametrize("sorted_", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_search_matches_jax(dtype, sorted_, nprobe):
    js, ts, q = _searchers(6000, 16, 24, 256, dtype, sorted_, seed=3)
    assert ts._compact_params(9, nprobe, 5)[:2] == js._compact_params(9, nprobe, 5)[:2]
    assert ts.compact_coverage(9, nprobe, 5) == js.compact_coverage(9, nprobe, 5)
    jd, ji = js.search(q, 5, nprobe, "compact")
    td, ti = ts.search(q, 5, nprobe, "compact")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


def test_compact_cap_overflow_drops_the_same_tiles():
    """A tight slack overflows the cap: both packages drop the least-probed
    tiles (ties to the lower tile id) and so return the same ids."""
    js, ts, q = _searchers(6000, 16, 24, 256, "float32", True, seed=4)
    js.compact_slack = 0.3
    copy_searcher_knobs(js, ts)
    ctile, cap, _ = ts._compact_params(9, 6, 5)
    assert cap < ts.emb.shape[0] // ctile
    assert ts.compact_coverage(9, 6, 5) < 1.0
    _, ji = js.search(q, 5, 6, "compact")
    _, ti = ts.search(q, 5, 6, "compact")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_cpu_call_launches_nothing():
    x, sq = _arrays(4, 128, 8, seed=0)
    before = dict(_build.LAUNCHES)
    sel = torch.tensor([1, 0], dtype=torch.int32)
    tile_gather(torch.from_numpy(x), torch.from_numpy(sq), sel, 128)
    tile_gather_dma(torch.from_numpy(x), torch.from_numpy(sq), sel, 128)
    assert _build.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "ctile,d",
    [(512, 96), (2048, 128), (4, 3), (1, 5),
     # a tile's rows (f32; bf16 at half) just over, just under and just over
     # two 32 KB, four and eight of the kernels' 16 KB items; norms just over
     # an item, two items and four
     (4, 2049), (4, 2047), (4, 4097), (4100, 4), (8196, 4), (16384, 3)],
)
def test_kernels_match_plain_on_card(cuda_device, ctile, d, dtype):
    x, sq = _arrays(40, ctile, d, seed=d)
    emb = torch.from_numpy(x).to(cuda_device).to(dtype)
    sqt = torch.from_numpy(sq).to(cuda_device)
    sels = ([39, 0, 7, 7, 3],  # out of order, a repeat
            [39],  # cap 1
            [7] * 40)  # one tile, cap times
    dma = int(dma_eligible(emb, sqt, ctile))
    for sel_list in sels:
        sel = torch.tensor(sel_list, dtype=torch.int32, device=cuda_device)
        want = tile_gather_plain(emb, sqt, sel, ctile)
        before = dict(_build.LAUNCHES)
        for fn in (tile_gather, tile_gather_dma):
            got = fn(emb, sqt, sel, ctile)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert _build.LAUNCHES["K11"] == before["K11"] + dma
        assert _build.LAUNCHES["K10"] == before["K10"] + 2 - dma
