"""K2 and K3: streaming threshold top-k, exact and IVF-masked.

Counterpart of ``pqvector_tpu/kernels/stream_topk.py``:
``pallas_stream_exact_topk`` (K2) and ``pallas_stream_masked_topk`` (K3).
The scans are the hand-written kernels of ``csrc/stream_topk.cu`` on CUDA
tensors and the ``*_plain`` functions here on CPU tensors. K3's probe ids
(``probe.probe_ids``), the clusters' row offsets (``cluster_offsets``, held
by the searcher) and the f32 re-score are plain torch, as they are XLA code
outside the Pallas calls in the JAX package. K3 takes no tile schedule and
no tile tables: its work follows the probed clusters, not the tiles.

K2 splits the rows over ``units`` blocks per query group and merges their
partial lists in a second launch; the result does not depend on the split,
because every list orders on (distance, id). K2 runs on the score tile of
``csrc/score_tile.cuh`` (blocks of up to 128 queries, fp32 FMA or wgmma by
``score_tile.pick_backend``); its blocks also share one gate per query in
device memory, the smallest k-th entry any full list has reached, so rows
that can be in no global top-k are dropped everywhere: the partial lists
then depend on timing, the merged result does not. K3 scans by probed
cluster (``csrc/item_scan.cuh``): the device turns the batch's probe ids
into work items, each the rows of one cluster (or of one of its
``segments``) and the at most ``ITEM_QUERIES`` queries that probe it
(``work_items_plain`` is the rule), so a probed row is read once for each
such group; each query's lists go to the partial slot of its probe slot and
segment and are merged as K2's are.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _build, score_tile
from .scan_topk import (
    MAX_K,
    POS_INF,
    _refine,
    check_cuda_operands,
    check_scan_args,
    check_stats,
    empty_lists,
    final_merge_plain,
    merge_candidates,
    partial_scores,
)
from .probe import probe_ids

#: Rows per step of the plain scans: bounds their [B, rows] score block.
_PLAIN_ROWS = 65536
#: K3's trace counters (``profiling.device_counter``): the work items it
#: scored (those with rows) and their (item, 128-row chunk) pairs, as its
#: ``stats`` counts them (``scored_items``).
K3_COUNTERS = ("k3.tiles", "k3.chunks")
#: Queries of one K3 work item: the N of its wgmma (``csrc/item_scan.cuh``).
ITEM_QUERIES = 16
#: K3 cuts a probed cluster's rows into at most this many segments.
MAX_SEGMENTS = 8
#: Work items K3 aims at: a few for each of the ~400 blocks the card holds.
_ITEMS_WANTED = 1024


def scan_units(chunks: int, batch: int, queries: int = 128, wave: int = 264) -> int:
    """How many row runs K2 splits ``chunks`` 128-row chunks into for a batch
    served by blocks of ``queries`` queries: about one wave of blocks
    (``score_tile.wave_blocks``: 264 where two blocks fit an SM's shared
    memory, 132 at large k where one does), so at B = 1 .. 128 and small k
    there are 264 runs and at B = 256 half as many. More runs than a wave
    only add list fills and partial lists to merge. Never more runs than
    chunks, and none empty (the runs are ``ceil(chunks / units)`` chunks)."""
    groups = -(-batch // queries)
    want = max(1, min(chunks, -(-wave // groups)))
    return -(-chunks // -(-chunks // want))


def run_rows(n_pad: int, units: int) -> int:
    """Rows of one of ``units`` runs over ``n_pad`` rows: a multiple of 128."""
    chunks = -(-n_pad // score_tile.CHUNK_ROWS)
    return -(-chunks // max(1, min(units, chunks))) * score_tile.CHUNK_ROWS


def stream_exact_scan_plain(qf, emb, emb_sq, k):
    """Exact top-k by (distance, id) over every row, in plain torch."""
    best_d, best_i = empty_lists((qf.shape[0],), k, emb.device)
    for lo in range(0, emb.shape[0], _PLAIN_ROWS):
        hi = min(lo + _PLAIN_ROWS, emb.shape[0])
        part = partial_scores(qf, emb[lo:hi], emb_sq[lo:hi])
        ids = torch.arange(lo, hi, dtype=torch.int32, device=emb.device)
        best_d, best_i = merge_candidates(
            best_d, best_i, part, ids[None, :].expand_as(part), k
        )
    return best_d, best_i


def _stream_exact_cuda(qf, emb, emb_sq, k, units=None):
    """Launch K2. ``units`` overrides ``scan_units``' split of the rows (the
    result does not depend on it)."""
    check_cuda_operands(q=qf, emb=emb, emb_sq=emb_sq)
    lib = _build.load()
    n_pad, d = emb.shape
    b = qf.shape[0]
    backend = score_tile.pick_backend(emb.dtype, d, qf.data_ptr(), emb.data_ptr())
    if units is None:
        queries = score_tile.block_queries(b, backend)
        smem = score_tile.smem_bytes("K2", backend, queries, k)
        units = scan_units(
            -(-n_pad // score_tile.CHUNK_ROWS), b, queries, score_tile.wave_blocks(smem)
        )
    run = run_rows(n_pad, units)
    units = -(-n_pad // run)
    dev = emb.device
    part_d = torch.empty((units, b, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((units, b, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    gate = torch.empty((b,), dtype=torch.int32, device=dev)  # the kernel sets it
    rc = lib.pqv_stream_exact_topk(
        qf.data_ptr(), emb.data_ptr(), emb_sq.data_ptr(),
        b, d, n_pad, k, run, int(emb.dtype == torch.bfloat16),
        int(backend == "wgmma"),
        part_d.data_ptr(), part_i.data_ptr(), gate.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), _build.stream_ptr(),
    )
    _build.check(rc, "pqv_stream_exact_topk")
    _build.LAUNCHES["K2"] += 1
    return out_d, out_i


def stream_exact_scan(qf, emb, emb_sq, k: int, tile: int):
    """K2's scan: exact top-k selection -> ([B, k] f32 partial d², [B, k] i32).

    ``qf`` [B, d] in the storage dtype, ``emb`` [n_pad, d] f32 or bf16,
    ``emb_sq`` [n_pad] f32 with +3e38 on pad rows. Empty slots are
    (+3e38, -1). The kernel runs on the score tile of ``csrc/score_tile.cuh``:
    fp32 FMA for f32 storage, wgmma for bf16 storage with ``d % 8 == 0``
    (``score_tile.pick_backend``); its blocks own runs of rows, not tiles, so
    ``tile`` only has to divide ``n_pad``."""
    with profiling.span("search.scan"):
        check_scan_args(qf, emb, emb_sq, k, tile)
        if emb.device.type == "cpu":
            return stream_exact_scan_plain(qf, emb, emb_sq, k)
        return _stream_exact_cuda(qf, emb, emb_sq, k)


def stream_exact_topk(q, emb, emb_sq, k: int, tile: int, emb_ref=None):
    """Exact brute-force top-k (``pallas_stream_exact_topk``): K2, then the
    f32 re-score against ``emb_ref`` when given."""
    if k > MAX_K:
        raise ValueError(f"stream kernel supports k <= {MAX_K}")
    best_d, best_i = stream_exact_scan(q.to(emb.dtype), emb, emb_sq, k, tile)
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i)


def cluster_offsets(row_cluster, n_clusters: int):
    """[n_clusters + 1] int32: the first row of each cluster in a
    cluster-sorted layout (``row_cluster`` non-decreasing, pad rows
    ``n_clusters``), then the first pad row."""
    ids = torch.arange(n_clusters + 1, dtype=torch.int32, device=row_cluster.device)
    return torch.searchsorted(row_cluster, ids, out_int32=True)


def masked_segments(pairs: int) -> int:
    """How many segments K3 may cut a probed cluster's rows into for a batch
    of ``pairs`` (B x nprobe) probe ids: enough for about ``_ITEMS_WANTED``
    work items, so that a small batch still spreads over the card; none
    (1) from 1,024 pairs on."""
    return max(1, min(MAX_SEGMENTS, -(-_ITEMS_WANTED // max(1, pairs))))


def item_scan_smem(backend: str, k: int) -> int:
    """Dynamic shared memory of K3's scan (``csrc/item_scan.cuh``:
    ``item_scan_smem``): the alignment slack; three stages of 64 dimensions
    of 128 rows and ``ITEM_QUERIES`` queries in bf16 (``"wgmma"``), or of 16
    transposed f32 dimensions (``"fma"``); each query slot's list, two
    128-row dumps, its batch row and partial slot; the norms of two chunks."""
    rows = score_tile.CHUNK_ROWS
    if backend == "wgmma":
        stage = (rows + ITEM_QUERIES) * 128
    else:
        stage = 16 * (rows + 4 + ITEM_QUERIES) * 4
    return (1024 + 3 * stage + ITEM_QUERIES * (8 * k + 2 * (rows + 4) * 4 + 8)
            + 2 * rows * 4)


def work_items_plain(offsets, probe, segs: int):
    """K3's work list (``csrc/stream_topk.cu``: ``k3_plan_kernel``) in plain
    torch -> (items [n, 4] int32, pairs [B x nprobe] int32).

    Pair p is (query p // nprobe, probe slot p % nprobe); an id out of range
    goes to the sentinel cluster C, which has no rows. ``pairs`` lists the
    pairs cluster by cluster (here in order of p; the kernel's order within a
    cluster is its atomics'). A cluster with n pairs and r rows has ceil(n /
    ``ITEM_QUERIES``) query groups and its ceil(r / 128) chunks cut into
    ``parts`` segments of ``per`` chunks each (at most ``segs``, none empty;
    one, empty, where it has no rows); its items are (group, segment) in that
    order. An item is (first row, end row, its first pair's place in
    ``pairs``, nq | segment << 8 | parts << 16) with nq <= ``ITEM_QUERIES``
    pairs."""
    c_count = offsets.shape[0] - 1
    dev = offsets.device
    flat = probe.reshape(-1).long()
    cl = torch.where((flat >= 0) & (flat < c_count), flat, c_count)
    count = torch.bincount(cl, minlength=c_count + 1)
    pairs = torch.argsort(cl, stable=True).to(torch.int32)
    pstart = torch.cumsum(count, 0) - count
    off = offsets.long()
    none = torch.zeros(1, dtype=torch.long, device=dev)  # the sentinel's rows
    begin = torch.cat([off[:-1], none])
    end = torch.cat([off[1:], none])
    chunks = (end - begin + score_tile.CHUNK_ROWS - 1) // score_tile.CHUNK_ROWS
    cut = chunks.clamp(1, segs)
    per = (chunks + cut - 1) // cut  # chunks a segment: 0 where the cluster has no rows
    parts = torch.where(chunks > 0, (chunks + per - 1) // per.clamp(min=1), 1)
    groups = (count + ITEM_QUERIES - 1) // ITEM_QUERIES
    n_c = groups * parts
    cid = torch.repeat_interleave(torch.arange(c_count + 1, device=dev), n_c)
    local = torch.arange(cid.numel(), device=dev) - (torch.cumsum(n_c, 0) - n_c)[cid]
    g, s = local // parts[cid], local % parts[cid]
    step = per[cid] * score_tile.CHUNK_ROWS
    rb = torch.minimum(end[cid], begin[cid] + s * step)
    re = torch.minimum(end[cid], begin[cid] + (s + 1) * step)
    nq = torch.clamp(count[cid] - g * ITEM_QUERIES, max=ITEM_QUERIES)
    items = torch.stack([rb, re, pstart[cid] + g * ITEM_QUERIES,
                         nq | (s << 8) | (parts[cid] << 16)], dim=1)
    return items.to(torch.int32), pairs


def scored_items(offsets, probe, segs: int) -> tuple[int, int]:
    """K3's counters for a launch: (work items with rows, their (item,
    128-row chunk) pairs)."""
    items, _ = work_items_plain(offsets, probe, segs)
    rows = (items[:, 1] - items[:, 0]).long()
    chunks = (rows + score_tile.CHUNK_ROWS - 1) // score_tile.CHUNK_ROWS
    return int((rows > 0).sum()), int(chunks.sum())


def scan_items_plain(qf, emb, emb_sq, offsets, probe, k: int, segs: int, order=None):
    """What K3's launch computes, item by item in plain torch: each item's
    own top-k lists in its queries' partial slots [nprobe x segs, B, k], the
    empty slots (+3e38, -1), then merged under the (distance, id) order.
    ``order`` permutes the items (the kernel takes them in no fixed order)."""
    b, nprobe = probe.shape
    items, pairs = work_items_plain(offsets, probe, segs)
    part_d, part_i = empty_lists((nprobe * segs, b), k, emb.device)
    for it in (range(items.shape[0]) if order is None else order):
        rb, re, pb, w = (int(v) for v in items[it])
        nq, s = w & 0xFF, (w >> 8) & 0xFF
        p = pairs[pb : pb + nq].long()
        qb, slot = p // nprobe, p % nprobe * segs + s
        d, i = empty_lists((nq,), k, emb.device)
        if re > rb:
            part = partial_scores(qf[qb], emb[rb:re], emb_sq[rb:re])
            ids = torch.arange(rb, re, dtype=torch.int32, device=emb.device)
            d, i = merge_candidates(d, i, part, ids[None, :].expand_as(part), k)
        part_d[slot, qb], part_i[slot, qb] = d, i
    return final_merge_plain(part_d, part_i, k)


def stream_masked_scan_plain(qf, emb, emb_sq, offsets, probe, k):
    """IVF top-k by (distance, id) over the rows of each query's probed
    clusters, in plain torch: the rows in steps, each row's cluster from
    ``offsets``, the others' scores the +3e38 sentinel."""
    b = qf.shape[0]
    c_count = offsets.shape[0] - 1
    flat = probe.long()
    valid = (flat >= 0) & (flat < c_count)
    probed = torch.zeros((b, c_count + 1), dtype=torch.bool, device=emb.device)
    probed.scatter_(1, torch.where(valid, flat, c_count), True)
    probed[:, c_count] = False
    best_d, best_i = empty_lists((b,), k, emb.device)
    for lo in range(0, emb.shape[0], _PLAIN_ROWS):
        hi = min(lo + _PLAIN_ROWS, emb.shape[0])
        rows = torch.arange(lo, hi, dtype=torch.int32, device=emb.device)
        cl = torch.searchsorted(offsets, rows, right=True).long() - 1
        cl = torch.where((cl >= 0) & (cl < c_count), cl, c_count)
        part = partial_scores(qf, emb[lo:hi], emb_sq[lo:hi])
        part = torch.where(probed[:, cl], part, POS_INF)
        best_d, best_i = merge_candidates(
            best_d, best_i, part, rows[None, :].expand_as(part), k
        )
    return best_d, best_i


def _stream_masked_cuda(qf, emb, emb_sq, offsets, probe, k, segments=None):
    """Launch K3. ``segments`` overrides ``masked_segments`` (the result does
    not depend on it)."""
    check_cuda_operands(q=qf, emb=emb, emb_sq=emb_sq, offsets=offsets, probe=probe)
    lib = _build.load()
    n_pad, d = emb.shape
    b, nprobe = probe.shape
    c_count = offsets.shape[0] - 1
    backend = score_tile.pick_backend(emb.dtype, d, qf.data_ptr(), emb.data_ptr())
    segs = masked_segments(b * nprobe) if segments is None else segments
    groups = -(-b // ITEM_QUERIES)  # a query probes a cluster once
    bound = groups * (-(-n_pad // score_tile.CHUNK_ROWS) + c_count + 1)
    stats = profiling.device_counter("k3", K3_COUNTERS, emb.device, bound)
    dev = emb.device
    words = lib.pqv_stream_masked_topk_scratch(c_count, b * nprobe, segs)
    if words < 0:
        raise ValueError(f"K3's work list for B = {b}, nprobe = {nprobe} passes 2^31 words")
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    part_d = torch.empty((nprobe * segs, b, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nprobe * segs, b, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    gate = torch.empty((b,), dtype=torch.int32, device=dev)  # the kernels set it
    rc = lib.pqv_stream_masked_topk(
        qf.data_ptr(), emb.data_ptr(), emb_sq.data_ptr(), offsets.data_ptr(),
        probe.data_ptr(), b, d, k, c_count, nprobe, segs,
        int(emb.dtype == torch.bfloat16), int(backend == "wgmma"),
        check_stats(stats, dev), scratch.data_ptr(), part_d.data_ptr(),
        part_i.data_ptr(), gate.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        _build.stream_ptr(),
    )
    _build.check(rc, "pqv_stream_masked_topk")
    _build.LAUNCHES["K3"] += 1
    return out_d, out_i


def stream_masked_scan(qf, emb, emb_sq, offsets, probe, k: int):
    """K3's scan: masked top-k over the probed clusters -> ([B, k], [B, k]).

    Adds ``offsets`` [C + 1] int32 (``cluster_offsets``: cluster c's rows
    are offsets[c] .. offsets[c + 1] - 1 of the cluster-sorted ``emb``) and
    ``probe`` [B, nprobe] int32 cluster ids (``probe.probe_ids``; each
    query's distinct, out of range probes nothing). The kernels build the
    work list on the device and score each item's rows against its queries
    only, on the tiles of ``csrc/item_scan.cuh`` (fp32 FMA or wgmma by
    ``score_tile.pick_backend``); while tracing is on, the trace's ``k3``
    counter adds the items and chunks it scored (``scored_items``,
    ``K3_COUNTERS``)."""
    with profiling.span("search.scan"):
        check_scan_args(qf, emb, emb_sq, k, 1)  # any row may start an item
        if offsets.dtype != torch.int32 or offsets.dim() != 1 or offsets.shape[0] < 2:
            raise TypeError("offsets must be int32 [n_clusters + 1]")
        if probe.dtype != torch.int32 or probe.dim() != 2 or probe.shape[0] != qf.shape[0]:
            raise TypeError("probe must be int32 [B, nprobe]")
        if emb.device.type == "cpu":
            return stream_masked_scan_plain(qf, emb, emb_sq, offsets, probe, k)
        return _stream_masked_cuda(qf, emb, emb_sq, offsets, probe, k)


def stream_masked_topk(q, centroids, c_sq, offsets, emb, emb_sq, nprobe: int, k: int,
                       emb_ref=None):
    """IVF top-k over the probed clusters (``pallas_stream_masked_topk``):
    probe ids -> K3 -> re-score against ``emb_ref`` when given. ``offsets``
    (``cluster_offsets``) are the clusters' rows in the cluster-sorted
    layout."""
    if k > MAX_K:
        raise ValueError(f"stream kernel supports k <= {MAX_K}")
    with profiling.span("search.probe"):
        probe = probe_ids(q, centroids, c_sq, nprobe)
    best_d, best_i = stream_masked_scan(q.to(emb.dtype), emb, emb_sq, offsets, probe, k)
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i)
