"""K3's work list (``kernels/stream_topk.py``: ``work_items_plain``, the rule
of ``csrc/stream_topk.cu``'s ``k3_plan_kernel``) against a numpy reference,
and K3's scan item by item (``scan_items_plain``: each item's own lists in
its queries' partial slots, then the merge) against the plain masked scan,
whatever the order of the items; the probe ids K3 takes, and the offsets
the searcher holds for it.

Rows lie on a 1/4 grid, so every score is exact and the two scans must
agree bit for bit. The layouts have empty clusters, clusters probed by more
queries than one item holds, clusters long enough to be cut into segments,
and probe ids out of range."""

import numpy as np
import pytest
import torch

from pqvector_tpu_torch import DeviceIvfSearcher, IvfIndex
from pqvector_tpu_torch.kernels import stream_topk as tst
from pqvector_tpu_torch.kernels.probe import mask_width, probe_ids, probe_mask

Q = tst.ITEM_QUERIES


def _layout(n, clusters, d, seed, empty=()):
    """Cluster-sorted grid rows; ``empty`` clusters get no row. ->
    (emb [n_pad, d], emb_sq with +3e38 pads, offsets [clusters + 1])."""
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(clusters), np.asarray(empty, int))
    lab = np.sort(rng.choice(keep, n))
    n_pad = -(-(n + 1) // 128) * 128
    emb = np.zeros((n_pad, d), np.float32)
    emb[:n] = rng.integers(-8, 9, (n, d)).astype(np.float32) / 4
    sq = np.full(n_pad, 3.0e38, np.float32)
    sq[:n] = (emb[:n] ** 2).sum(1)
    rc = np.full(n_pad, clusters, np.int32)
    rc[:n] = lab
    offsets = tst.cluster_offsets(torch.from_numpy(rc), clusters)
    return torch.from_numpy(emb), torch.from_numpy(sq), offsets


def _probe(rng, b, nprobe, clusters, hot=None):
    """Distinct ids a query; ``hot`` is probed by every query."""
    ids = np.stack([rng.choice(clusters, nprobe, replace=False) for _ in range(b)])
    if hot is not None:
        has = (ids == hot).any(1)
        ids[~has, 0] = hot
    return torch.from_numpy(ids.astype(np.int32))


def numpy_items(offsets, probe, segs):
    """The work list by loops: for each cluster in order (the sentinel last),
    its query groups in pair order, each cut into the same segments. ->
    [(first row, end row, segment, parts, pairs)]."""
    off = np.asarray(offsets, np.int64)
    c_count = off.size - 1
    flat = np.asarray(probe).reshape(-1)
    out = []
    for c in range(c_count + 1):
        pairs = [p for p, cl in enumerate(flat) if (cl if 0 <= cl < c_count else c_count) == c]
        if not pairs:
            continue
        begin, end = (off[c], off[c + 1]) if c < c_count else (0, 0)
        chunks = -(-(end - begin) // 128)
        if chunks:
            per = -(-chunks // min(segs, chunks))
            cuts = [(begin + s * per * 128, min(end, begin + (s + 1) * per * 128))
                    for s in range(-(-chunks // per))]
        else:
            cuts = [(begin, begin)]
        for g in range(0, len(pairs), Q):
            for s, (lo, hi) in enumerate(cuts):
                out.append((lo, hi, s, len(cuts), pairs[g : g + Q]))
    return out


def _torch_items(offsets, probe, segs):
    items, pairs = tst.work_items_plain(offsets, probe, segs)
    out = []
    for rb, re, pb, w in items.tolist():
        nq = w & 0xFF
        out.append((rb, re, (w >> 8) & 0xFF, w >> 16, pairs[pb : pb + nq].tolist()))
    return out


CASES = [  # rows, clusters, B, nprobe, segs, empty clusters
    (3000, 40, 1, 8, 8, ()),  # one query: every probed cluster cut into segments
    (3000, 40, 37, 3, 1, (5, 6)),
    (3000, 40, 37, 3, 3, (5, 6)),
    (20000, 12, 100, 2, 2, ()),  # long clusters, each probed by more than 16 queries
    (5000, 300, 4096, 4, 1, ()),  # the K3 cell's batch and nprobe
    (700, 64, 130, 5, 4, (0, 63)),
    (128, 3, 20, 3, 8, (1,)),  # clusters shorter than a chunk
]


@pytest.mark.parametrize("n,clusters,b,nprobe,segs,empty", CASES)
def test_work_list_matches_numpy(n, clusters, b, nprobe, segs, empty):
    rng = np.random.default_rng(n + b)
    _, _, offsets = _layout(n, clusters, 8, n + clusters, empty)
    probe = _probe(rng, b, nprobe, clusters)
    if empty:
        probe[0, 0] = empty[0]  # a query that probes a cluster with no rows
    want = numpy_items(offsets, probe, segs)
    assert _torch_items(offsets, probe, segs) == want
    # every (query, slot) pair is in one group of its cluster, in each segment
    seen = {}
    for lo, hi, s, parts, pairs in want:
        for p in pairs:
            seen.setdefault(p, []).append(s)
    assert sorted(seen) == list(range(b * nprobe))
    assert all(sorted(v) == list(range(len(v))) for v in seen.values())


@pytest.mark.parametrize("bad", [-1, 40, 1 << 30])
def test_ids_out_of_range_probe_no_rows(bad):
    _, _, offsets = _layout(3000, 40, 8, 3)
    probe = _probe(np.random.default_rng(1), 5, 3, 40)
    probe[2, 1] = bad
    items = _torch_items(offsets, probe, 2)
    sentinel = [it for it in items if 2 * 3 + 1 in it[4]]
    assert sentinel == [(0, 0, 0, 1, [7])]


def test_a_cluster_probed_by_every_query_takes_one_group_a_sixteen():
    _, _, offsets = _layout(6000, 20, 8, 4)
    probe = _probe(np.random.default_rng(2), 70, 3, 20, hot=7)
    items = [it for it in _torch_items(offsets, probe, 1)
             if it[0] == int(offsets[7]) and it[1] > it[0]]
    assert [len(it[4]) for it in items] == [16, 16, 16, 16, 6]
    assert sorted(p // 3 for it in items for p in it[4]) == list(range(70))


@pytest.mark.parametrize("n,clusters,b,nprobe,segs,empty", CASES)
@pytest.mark.parametrize("k", [1, 10, 128])
def test_items_scan_equals_the_plain_scan_in_any_order(n, clusters, b, nprobe, segs, empty, k):
    emb, sq, offsets = _layout(n, clusters, 8, n + clusters + k, empty)
    rng = np.random.default_rng(k + b)
    probe = _probe(rng, b, nprobe, clusters)
    if empty:
        probe[-1, -1] = empty[-1]
    qf = emb[torch.from_numpy(rng.integers(0, n, b))] + 0.25
    want = tst.stream_masked_scan_plain(qf, emb, sq, offsets, probe, k)
    n_items = tst.work_items_plain(offsets, probe, segs)[0].shape[0]
    for order in (None, rng.permutation(n_items)):
        got = tst.scan_items_plain(qf, emb, sq, offsets, probe, k, segs, order=order)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("n,clusters,b,nprobe,segs,empty", CASES)
def test_scored_items_count_the_items_with_rows_and_their_chunks(
        n, clusters, b, nprobe, segs, empty):
    _, _, offsets = _layout(n, clusters, 8, 5, empty)
    probe = _probe(np.random.default_rng(3), b, nprobe, clusters)
    want = numpy_items(offsets, probe, segs)
    with_rows = [hi - lo for lo, hi, *_ in want if hi > lo]
    assert tst.scored_items(offsets, probe, segs) == (
        len(with_rows), sum(-(-r // 128) for r in with_rows))


@pytest.mark.parametrize("nprobe", [1, 3, 12])
def test_probe_ids_are_the_probe_masks_bits(nprobe):
    rng = np.random.default_rng(nprobe)
    cents = torch.from_numpy(rng.integers(-8, 9, (16, 8)).astype(np.float32) / 4)
    q = torch.from_numpy(rng.integers(-8, 9, (9, 8)).astype(np.float32) / 4)
    c_sq = (cents * cents).sum(1)
    ids = probe_ids(q, cents, c_sq, nprobe)
    mask = probe_mask(q, cents, c_sq, nprobe)
    assert ids.dtype == torch.int32 and ids.shape == (9, nprobe) and ids.is_contiguous()
    assert mask.shape == (9, mask_width(16)) == (9, 128)
    want = torch.zeros_like(mask).scatter_(1, ids.long(), 1.0)
    assert torch.equal(want, mask)


@pytest.mark.parametrize("empty", [(), (0, 5, 6)])
def test_the_searcher_holds_k3s_offsets_and_builds_no_tile_table(empty):
    """A cluster-sorted searcher computes ``cluster_offsets`` once, at set-up;
    ``search(mode="stream")`` reads them and builds no tile table. A layout
    in file order holds none."""
    rng = np.random.default_rng(len(empty))
    n, d, clusters = 700, 8, 9
    x = rng.integers(-8, 9, (n, d)).astype(np.float32) / 4
    keep = np.setdiff1d(np.arange(clusters), np.asarray(empty, int))
    assign = rng.choice(keep, n)
    cents = np.stack([x[assign == c].mean(0) if (assign == c).any() else x[0]
                      for c in range(clusters)])
    index = IvfIndex.from_assignments(cents, assign)
    s = DeviceIvfSearcher(index, x, cluster_sorted=True, device="cpu", row_tile=128)
    rc = s.row_cluster.numpy()
    want = np.searchsorted(rc, np.arange(clusters + 1), side="left")
    assert s.cluster_offsets.dtype == torch.int32
    np.testing.assert_array_equal(s.cluster_offsets.numpy(), want)
    assert all(s.cluster_offsets[c] == s.cluster_offsets[c + 1] for c in empty)
    d_s, i_s = s.search(x[:7], 5, 3, mode="stream")
    assert s._tile_tables == {}
    d_m, i_m = s.search(x[:7], 5, 3, mode="masked")
    np.testing.assert_array_equal(i_s, i_m)
    file_order = DeviceIvfSearcher(index, x, device="cpu", row_tile=128)
    assert not file_order._row_cluster_sorted and file_order.cluster_offsets is None


def test_item_scan_fits_two_blocks_an_sm_up_to_k_128():
    for backend in ("wgmma", "fma"):
        assert 2 * (tst.item_scan_smem(backend, 128) + 1024) <= 233_472
