"""K2 and K3: streaming threshold top-k, exact and IVF-masked.

Counterpart of ``pqvector_tpu/kernels/stream_topk.py``:
``pallas_stream_exact_topk`` (K2), ``pallas_stream_masked_topk`` (K3),
``_probe_mask`` and ``_tile_schedule``. The scans are the hand-written
kernels of ``csrc/stream_topk.cu`` on CUDA tensors and the ``*_plain``
functions here on CPU tensors. The probe mask, the tile schedule and the
f32 re-score are plain torch, as they are XLA code outside the Pallas calls
in the JAX package.

The kernels split the rows over ``units`` blocks per query group and merge
their partial lists in a second launch; the result does not depend on the
split, because every list orders on (distance, id). K2 runs on the score
tile of ``csrc/score_tile.cuh`` (blocks of up to 128 queries, fp32 FMA or
wgmma by ``score_tile.pick_backend``); its blocks also share one gate per
query in device memory, the smallest k-th entry any full list has reached,
so rows that can be in no global top-k are dropped everywhere: the partial
lists then depend on timing, the merged result does not. K3 is the same
stream over the active tiles of the device-side schedule, fed only with the
(query, row) pairs the query probes: a block skips a tile, a 128-row chunk
and a query that its probe table rules out (``scan_topk.scored_chunks``).
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
    masked_geometry,
    merge_candidates,
    partial_scores,
    select_lex,
)

#: Rows per step of the plain scans: bounds their [B, rows] score block.
_PLAIN_ROWS = 65536
#: K3's trace counters (``profiling.device_counter``): the (block, tile) and
#: (block, chunk) pairs it scored, as its ``stats`` counts them.
K3_COUNTERS = ("k3.tiles", "k3.chunks")


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


def masked_scan_units(nt: int, batch: int, queries: int = 128, wave: int = 264) -> int:
    """How many runs K3 splits the active tiles into for a batch served by
    blocks of ``queries`` queries: one wave of blocks
    (``score_tile.wave_blocks``) over the query groups, never more runs than
    tiles. The schedule lives on the device, so the host sizes the launch by
    ``nt``; run ``u`` of ``units`` takes the active tiles ``u, u + units, ...``
    (``masked_run_tiles``), which spreads a burst of heavy tiles over the
    runs and leaves no run empty while the active tiles are at least
    ``units``."""
    groups = -(-batch // queries)
    return max(1, min(nt, wave // groups))


def masked_run_tiles(unit: int, units: int, n_active: int) -> range:
    """Positions in the schedule's active list that run ``unit`` walks."""
    return range(unit, n_active, units)


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


def _probe_mask(q, centroids, c_sq, nprobe: int, max_probe: int, kc_pad: int):
    """[B, kc_pad] f32 probe mask: the first ``nprobe`` of the ``max_probe``
    nearest centroids (ties to the lower cluster id)."""
    b = q.shape[0]
    dist = c_sq[None, :] - 2.0 * (q @ centroids.T)
    ids = torch.arange(centroids.shape[0], dtype=torch.int32, device=q.device)
    _, probe = select_lex(dist, ids[None, :].expand_as(dist), max_probe)
    mask = torch.zeros((b, kc_pad), dtype=torch.float32, device=q.device)
    return mask.scatter_(1, probe[:, :nprobe].long(), 1.0)


def _tile_schedule(mask, tc):
    """Compacted schedule [nt + 1] i32: [n_active, active tiles..., pad].

    A tile is active iff any query's mask covers any of its clusters;
    padding repeats the last active tile."""
    nt = tc.shape[0]
    cluster_active = mask.amax(dim=0) > 0.0
    tile_active = cluster_active[tc.long()].any(dim=1).to(torch.int32)
    order = torch.argsort(1 - tile_active, stable=True).to(torch.int32)
    n_active = tile_active.sum(dtype=torch.int32)
    last = order[(n_active - 1).clamp_min(0).long()]
    steps = torch.arange(nt, dtype=torch.int32, device=mask.device)
    idxs = torch.where(steps < n_active, order, last)
    return torch.cat([n_active[None], idxs])


def stream_masked_scan_plain(qf, emb, emb_sq, local_cluster, tile_clusters, mask,
                             sched, k, tile):
    """IVF top-k over the scheduled active tiles, in plain torch."""
    b = qf.shape[0]
    n_active = int(sched[0])
    tiles = sched[1 : 1 + n_active].long()
    best_d, best_i = empty_lists((b,), k, emb.device)
    group = max(1, _PLAIN_ROWS // tile)
    offs = torch.arange(tile, device=emb.device)
    for g0 in range(0, n_active, group):
        tg = tiles[g0 : g0 + group]
        rows = (tg[:, None] * tile + offs[None, :]).reshape(-1)
        part = partial_scores(qf, emb[rows], emb_sq[rows])
        slots = local_cluster[rows].long()
        cluster = tile_clusters[tg.repeat_interleave(tile), slots].long()
        part = torch.where(mask[:, cluster] > 0.5, part, POS_INF)
        ids = rows.to(torch.int32)[None, :].expand_as(part)
        best_d, best_i = merge_candidates(best_d, best_i, part, ids, k)
    return best_d, best_i


def _stream_masked_cuda(qf, emb, emb_sq, local_cluster, tile_clusters, mask,
                        sched, k, tile, units=None, stats=None):
    """Launch K3. ``units`` overrides ``masked_scan_units``' split of the active
    tiles (the result does not depend on it); ``stats`` as for K4."""
    check_cuda_operands(
        q=qf, emb=emb, emb_sq=emb_sq, local_cluster=local_cluster,
        tile_clusters=tile_clusters, mask=mask, sched=sched,
    )
    lib = _build.load()
    n_pad, d = emb.shape
    b = qf.shape[0]
    cmax = tile_clusters.shape[1]
    nt = n_pad // tile
    backend, queries, words, smem = masked_geometry("K3", qf, emb, k, cmax)
    if stats is None and profiling.tracing_on():
        pairs = nt * -(-b // queries) * -(-tile // score_tile.CHUNK_ROWS)
        stats = profiling.device_counter("k3", K3_COUNTERS, emb.device, pairs)
    if units is None:
        units = masked_scan_units(nt, b, queries, score_tile.wave_blocks(smem))
    dev = emb.device
    part_d = torch.empty((units, b, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((units, b, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    gate = torch.empty((b,), dtype=torch.int32, device=dev)  # the kernel sets it
    rc = lib.pqv_stream_masked_topk(
        qf.data_ptr(), emb.data_ptr(), emb_sq.data_ptr(),
        local_cluster.data_ptr(), tile_clusters.data_ptr(), mask.data_ptr(),
        sched.data_ptr(), b, d, n_pad, k, tile, cmax,
        mask.shape[1], units, int(emb.dtype == torch.bfloat16),
        int(backend == "wgmma"), words, check_stats(stats, dev),
        part_d.data_ptr(), part_i.data_ptr(), gate.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), _build.stream_ptr(),
    )
    _build.check(rc, "pqv_stream_masked_topk")
    _build.LAUNCHES["K3"] += 1
    return out_d, out_i


def stream_masked_scan(qf, emb, emb_sq, local_cluster, tile_clusters, mask, sched,
                       k: int, tile: int, stats=None):
    """K3's scan: masked top-k over the active tiles -> ([B, k], [B, k]).

    Adds ``local_cluster`` [n_pad] int32, ``tile_clusters`` [nt, cmax]
    int32, the probe ``mask`` [B, kc_pad] f32 and ``sched`` [nt + 1] int32
    from ``_tile_schedule``; the kernel reads the schedule on the device. It
    runs on the score tile of ``csrc/score_tile.cuh`` (fp32 FMA or wgmma by
    ``score_tile.pick_backend``) with sorted lists, and K2's shared gate,
    carried across a block's run of active tiles; ``stats``
    (``scan_topk.check_stats``) counts the tiles and chunks it scored, on
    CUDA tensors only; without it, while tracing is on, the trace's ``k3``
    counter does (``profiling.device_counter``, ``K3_COUNTERS``)."""
    with profiling.span("search.scan"):
        check_scan_args(qf, emb, emb_sq, k, tile)
        nt = emb.shape[0] // tile
        if local_cluster.dtype != torch.int32 or local_cluster.shape != (emb.shape[0],):
            raise TypeError("local_cluster must be int32 [n_pad]")
        if (tile_clusters.dtype != torch.int32 or tile_clusters.dim() != 2
                or tile_clusters.shape[0] != nt or tile_clusters.shape[1] < 1):
            raise TypeError("tile_clusters must be int32 [nt, cmax]")
        if mask.dtype != torch.float32 or mask.shape[0] != qf.shape[0]:
            raise TypeError("mask must be float32 [B, kc_pad]")
        if sched.dtype != torch.int32 or sched.shape != (nt + 1,):
            raise TypeError("sched must be int32 [nt + 1]")
        if emb.device.type == "cpu":
            return stream_masked_scan_plain(
                qf, emb, emb_sq, local_cluster, tile_clusters, mask, sched, k, tile
            )
        return _stream_masked_cuda(
            qf, emb, emb_sq, local_cluster, tile_clusters, mask, sched, k, tile, stats=stats
        )


def stream_masked_topk(
    q, centroids, c_sq, local_cluster, tile_clusters, emb, emb_sq, nprobe: int,
    k: int, max_probe: int, tile: int, emb_ref=None,
):
    """IVF top-k over active tiles only (``pallas_stream_masked_topk``):
    probe mask -> tile schedule -> K3 -> re-score."""
    if k > MAX_K:
        raise ValueError(f"stream kernel supports k <= {MAX_K}")
    kc_pad = -(-(centroids.shape[0] + 1) // 128) * 128
    with profiling.span("search.probe"):
        mask = _probe_mask(q, centroids, c_sq, nprobe, max_probe, kc_pad)
        sched = _tile_schedule(mask, tile_clusters)
    best_d, best_i = stream_masked_scan(
        q.to(emb.dtype), emb, emb_sq, local_cluster, tile_clusters, mask, sched,
        k, tile,
    )
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i)
