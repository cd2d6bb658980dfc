"""K3's trace counter (``kernels/stream_topk.py``: ``K3_COUNTERS`` through
``profiling.device_counter``). On the CPU the plain scan runs and counts
nothing; on the card, while tracing is on, ``k3.tiles`` and ``k3.chunks``
are the work items with rows and their (item, 128-row chunk) pairs that the
work list (``stream_topk.scored_items``) says K3 scores, and the scan's span
carries ``k3.launches``. And ``search(auto)`` on a 1M-row sorted layout at
B = 4096, k = 100 takes K3 alone (no K4, no cross-tile merge) and gives the
plain scan's answer."""

import numpy as np
import pytest
import torch

from pqvector_tpu_torch import DeviceIvfSearcher, IvfIndex
from pqvector_tpu_torch.kernels import _build
from pqvector_tpu_torch.kernels import stream_topk as tst
from pqvector_tpu_torch.kernels.probe import probe_ids
from pqvector_tpu_torch.kernels.scan_topk import _refine
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


@pytest.mark.cuda
def test_auto_at_b4096_k100_takes_k3_and_equals_the_plain_scan(cuda_device):
    """1M x 128 grid rows from 1,024 modes, one cluster a mode, bf16 with
    the f32 copy: every score is exact, so K3 and the plain scan select the
    same rows. ``auto`` launches K3 once, and neither K4 nor the cross-tile
    merge whose [980, 4096, 100] lists fault."""
    n, d, modes, b, k, nprobe = 1_000_000, 128, 1024, 4096, 100, 8
    rng = np.random.default_rng(1024)
    cent = rng.integers(-8, 9, (modes, d)).astype(np.float32) / 4
    assign = rng.integers(0, modes, n)
    x = cent[assign] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4
    q = x[rng.integers(0, n, b)] + rng.integers(-1, 2, (b, d)).astype(np.float32) / 4
    s = DeviceIvfSearcher(IvfIndex.from_assignments(cent, assign), x, dtype=torch.bfloat16,
                          cluster_sorted=True, device=cuda_device)
    before = dict(_build.LAUNCHES)
    dist, ids = s.search(q, k, nprobe, mode="auto")
    torch.cuda.synchronize()
    assert [_build.LAUNCHES[key] - before.get(key, 0) for key in ("K3", "K4", "merge")] == [
        1, 0, 0]
    qt = torch.from_numpy(q).to(cuda_device)
    probe = probe_ids(qt, s.centroids, s.c_sq, nprobe)
    best = tst.stream_masked_scan_plain(qt.to(s.emb.dtype), s.emb, s._pallas_emb_sq(),
                                        s.cluster_offsets, probe, k)
    d2, rows = _refine(qt, s._ref(), *best)
    assert torch.equal(ids, s._map_ids(d2, rows))
    torch.testing.assert_close(dist, d2.sqrt(), rtol=0, atol=0)
    assert bool((ids >= 0).all())
