"""K3's trace counter (``kernels/stream_topk.py``: ``K3_COUNTERS`` through
``profiling.device_counter``). On the CPU the plain scan runs and counts
nothing; on the card, while tracing is on, ``k3.tiles`` and ``k3.chunks``
are the (block, tile) and (block, chunk) pairs the skip rule
(``scan_topk.scored_chunks``) says K3 scores, and the scan's span carries
``k3.launches``."""

import numpy as np
import pytest
import torch

from pqvector_tpu_torch import DeviceIvfSearcher, IvfIndex
from pqvector_tpu_torch.kernels import scan_topk as tsc
from pqvector_tpu_torch.kernels import stream_topk as tst
from pqvector_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_store():
    profiling.clear_store()
    yield
    profiling.clear_store()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


def test_plain_k3_records_its_span_and_no_counter():
    rng = np.random.default_rng(0)
    n, d, clusters = 512, 8, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    assign = np.arange(n) % clusters
    cents = np.stack([x[assign == c].mean(0) for c in range(clusters)])
    searcher = DeviceIvfSearcher(IvfIndex.from_assignments(cents, assign), x,
                                 cluster_sorted=True, device="cpu", row_tile=128)
    with profiling.tracing():
        searcher.search(x[:5], 4, 2, mode="stream")
    st = profiling.read_store()
    scans = [s for s in st["spans"] if s["name"] == "search.scan"]
    assert len(scans) == 1 and scans[0]["counters"] == {}
    assert not any(key.startswith("k3.") for key in st["counters"])


def _operands(rng, device, dtype, nt, tile, cmax, b, p):
    """Grid rows and queries, each tile's ``cmax`` clusters of ``4 cmax``,
    rows' slots at random, and a [B, kc_pad] probe mask."""
    n_pad, d, kc = nt * tile, 16, 4 * cmax
    emb = torch.from_numpy(rng.integers(-8, 9, (n_pad, d)).astype(np.float32) / 4)
    qf = torch.from_numpy(rng.integers(-8, 9, (b, d)).astype(np.float32) / 4)
    lcl = torch.from_numpy(rng.integers(0, cmax, n_pad).astype(np.int32))
    tc = np.stack([np.sort(rng.choice(kc, cmax, replace=False)) for _ in range(nt)])
    kc_pad = -(-(kc + 1) // 128) * 128
    mask = (rng.random((b, kc_pad)) < p).astype(np.float32)
    mask[:, kc:] = 0.0
    tc, mask = torch.from_numpy(tc.astype(np.int32)), torch.from_numpy(mask)
    sched = tst._tile_schedule(mask, tc)
    emb = emb.to(device).to(dtype)
    return (qf.to(device).to(dtype), emb, (emb.float() ** 2).sum(1), lcl.to(device),
            tc.to(device), mask.to(device), sched.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nt,tile,cmax,b,k,p", [
    (40, 1024, 3, 4096, 10, 0.002),  # the K3 cell's shape: 32 blocks of 128 queries
    (12, 1024, 3, 256, 10, 0.01),
    (4, 1024, 300, 130, 10, 0.0005),  # no probe table in shared memory: cmax above 256
    (5, 256, 7, 129, 128, 0.02),  # k = 128: no room for a table on wgmma
    (2, 8192, 40, 16, 10, 0.01),  # two segments of 32 chunks
])
def test_the_trace_counter_equals_the_rule(cuda_device, dtype, nt, tile, cmax, b, k, p):
    rng = np.random.default_rng(nt * tile + cmax + b)
    args = _operands(rng, cuda_device, dtype, nt, tile, cmax, b, p)
    qf, emb, _, lcl, tc, mask, sched = args
    with profiling.tracing():
        got = tst.stream_masked_scan(*args, k, tile)
    want = tst.stream_masked_scan_plain(*args, k, tile)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    st = profiling.read_store()
    _, queries, words, _ = tsc.masked_geometry("K3", qf, emb, k, cmax)
    probe = mask[:, tc.long()].permute(1, 0, 2) > 0.5
    chunks = tsc.scored_chunks(probe, lcl, tile, queries)
    if not words:  # every chunk of every active tile, for every block
        groups, n_active = chunks.shape[1], int(sched[0])
        want_counts = [groups * n_active, groups * n_active * chunks.shape[2]]
    else:
        want_counts = [int(chunks.any(2).sum()), int(chunks.sum())]
    assert [st["counters"]["k3.tiles"], st["counters"]["k3.chunks"]] == want_counts
    scans = [s for s in st["spans"] if s["name"] == "search.scan"]
    assert [s["counters"] for s in scans] == [{"k3.launches": 1}]
