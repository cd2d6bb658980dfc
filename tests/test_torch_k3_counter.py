"""K3's trace counter (``kernels/stream_topk.py``: ``K3_COUNTERS`` through
``profiling.device_counter``). On the CPU the plain scan runs and counts
nothing; on the card, while tracing is on, ``k3.tiles`` and ``k3.chunks``
are the work items with rows and their (item, 128-row chunk) pairs that the
work list (``stream_topk.scored_items``) says K3 scores, and the scan's span
carries ``k3.launches``."""

import numpy as np
import pytest
import torch

from pqvector_tpu_torch import DeviceIvfSearcher, IvfIndex
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


def _operands(rng, device, dtype, nt, tile, cmax, b, nprobe):
    """Grid rows, ``nt`` x ``tile`` of them sorted over ``4 cmax`` clusters of
    random sizes, and ``nprobe`` distinct clusters a query."""
    n_pad, d, kc = nt * tile, 16, 4 * cmax
    emb = torch.from_numpy(rng.integers(-8, 9, (n_pad, d)).astype(np.float32) / 4)
    qf = torch.from_numpy(rng.integers(-8, 9, (b, d)).astype(np.float32) / 4)
    rc = np.sort(rng.integers(0, kc, n_pad)).astype(np.int32)
    offsets = tst.cluster_offsets(torch.from_numpy(rc), kc)
    probe = np.stack([rng.choice(kc, nprobe, replace=False) for _ in range(b)])
    probe = torch.from_numpy(probe.astype(np.int32))
    emb = emb.to(device).to(dtype)
    return (qf.to(device).to(dtype), emb, (emb.float() ** 2).sum(1), offsets.to(device),
            probe.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nt,tile,cmax,b,k,nprobe", [
    (40, 1024, 3, 4096, 10, 1),  # the old K3 cell's shape: 32 blocks of 128 queries
    (12, 1024, 3, 256, 10, 1),
    (4, 1024, 300, 130, 10, 1),  # 1,200 clusters, most of them probed by no query
    (5, 256, 7, 129, 128, 3),  # k = 128
    (2, 8192, 40, 16, 10, 3),  # few pairs: clusters cut into segments
    (40, 1024, 75, 4096, 10, 4),  # the K3 cell's batch and nprobe over 300 clusters
])
def test_the_trace_counter_equals_the_rule(cuda_device, dtype, nt, tile, cmax, b, k, nprobe):
    rng = np.random.default_rng(nt * tile + cmax + b)
    args = _operands(rng, cuda_device, dtype, nt, tile, cmax, b, nprobe)
    _, _, _, offsets, probe = args
    with profiling.tracing():
        got = tst.stream_masked_scan(*args, k)
    want = tst.stream_masked_scan_plain(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    st = profiling.read_store()
    segs = tst.masked_segments(b * nprobe)
    want_counts = list(tst.scored_items(offsets.cpu(), probe.cpu(), segs))
    assert [st["counters"]["k3.tiles"], st["counters"]["k3.chunks"]] == want_counts
    scans = [s for s in st["spans"] if s["name"] == "search.scan"]
    assert [s["counters"] for s in scans] == [{"k3.launches": 1}]
