"""K4, K5 and K6: per-tile top-k scans, plus the shared merge and re-score
steps.

Counterpart of ``pqvector_tpu/kernels/scan_topk.py``: ``_refine``,
``_final_merge``, ``pallas_masked_local_topk`` (K4, cluster-sorted layouts
with a per-tile local mask), ``pallas_exact_topk`` (K5) and
``pallas_masked_topk`` (K6, any layout, a global probe mask looked up
through each row's cluster id). The per-tile scans are the hand-written
kernels of ``csrc/scan_topk.cu`` on CUDA tensors (all three on the score
tile of ``csrc/score_tile.cuh``; K4 and K6 score only the chunks their
queries probe: ``scored_chunks``, ``masked_scan_chunks``) and the ``*_plain``
functions on CPU tensors. The cross-tile merge is the hand-written kernel
of ``csrc/merge.cu`` on CUDA tensors (``select_lex`` over the [B, nt·k]
block on CPU tensors). The probe mask (``probe.probe_mask``), K4's
``lmask`` gather and the f32 re-score are plain torch, as they are XLA code
outside the Pallas calls in the JAX package.

Every selection orders on (distance, id): ties go to the lower row id, since
``torch.topk`` promises no order among ties.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _build, score_tile
from .probe import probe_mask

POS_INF = 3.0e38  # pad and masked rows, as in the kernels
MAX_K = 128  # largest k a kernel's top-k list holds
#: K4's and K6's trace counters (``profiling.device_counter``): the
#: (block, tile) and (block, chunk) pairs a launch scored.
K4_COUNTERS = ("k4.tiles", "k4.chunks")
K6_COUNTERS = ("k6.tiles", "k6.chunks")
#: The merge kernel's counters: (query, tile) lists whose head is a
#: candidate (the only ones it may read past their head; it skips those
#: whose head is already past its running k-th key), and list heads it tested.
MERGE_COUNTERS = ("merge.lists", "merge.heads")


def select_lex(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The ``k`` smallest (distance, id) pairs of each row, ascending."""
    by_id = torch.argsort(ids, dim=-1, stable=True)
    d = d.gather(-1, by_id)
    ids = ids.gather(-1, by_id)
    by_d = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return d.gather(-1, by_d), ids.gather(-1, by_d)


def empty_lists(lead: tuple[int, ...], k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k lists with every slot empty: (+3e38, -1), as the kernels start."""
    return (
        torch.full(lead + (k,), POS_INF, dtype=torch.float32, device=device),
        torch.full(lead + (k,), -1, dtype=torch.int32, device=device),
    )


def partial_scores(qf: torch.Tensor, x: torch.Tensor, x_sq: torch.Tensor) -> torch.Tensor:
    """``|x|^2 - 2 q.x`` in f32 from storage-dtype operands ([B, T])."""
    return x_sq[None, :] - 2.0 * (qf.float() @ x.float().T)


def merge_candidates(best_d, best_i, part, ids, k):
    """Fold candidates into running lists; sentinel scores never enter."""
    valid = part < POS_INF
    part = torch.where(valid, part, POS_INF)
    ids = torch.where(valid, ids, -1)
    return select_lex(
        torch.cat([best_d, part], dim=-1), torch.cat([best_i, ids], dim=-1), k
    )


def check_scan_args(qf, emb, emb_sq, k: int, tile: int) -> None:
    """What every scan kernel takes: shapes, dtypes, one device."""
    if emb.dtype not in (torch.float32, torch.bfloat16) or qf.dtype != emb.dtype:
        raise TypeError("emb is float32 or bfloat16, and queries share its dtype")
    if emb_sq.dtype != torch.float32:
        raise TypeError("emb_sq must be float32")
    if qf.dim() != 2 or emb.dim() != 2 or qf.shape[1] != emb.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(qf.shape)}, emb {tuple(emb.shape)}")
    if emb_sq.shape != (emb.shape[0],):
        raise ValueError("emb_sq must be [n_pad]")
    if tile <= 0 or emb.shape[0] % tile:
        raise ValueError(f"n_pad {emb.shape[0]} is not a multiple of tile {tile}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the scan kernels take 1 <= k <= {MAX_K}, got {k}")
    if len({t.device for t in (qf, emb, emb_sq)}) != 1:
        raise ValueError("all operands must be on one device")


def check_cuda_operands(**tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not on the CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _tile_topk_plain(qf, emb, emb_sq, k, tile, probed=None):
    """Per-tile top-k in plain torch -> ([nt, B, k] f32, i32). ``probed(lo,
    hi, g)`` gives the [g, B, tile] bool probe test of rows lo .. hi."""
    n_pad = emb.shape[0]
    b = qf.shape[0]
    nt = n_pad // tile
    out_d = torch.empty((nt, b, k), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((nt, b, k), dtype=torch.int32, device=emb.device)
    group = max(1, 65536 // tile)
    for t0 in range(0, nt, group):
        g = min(group, nt - t0)
        lo, hi = t0 * tile, (t0 + g) * tile
        part = partial_scores(qf, emb[lo:hi], emb_sq[lo:hi])  # [B, g*tile]
        part = part.view(b, g, tile).transpose(0, 1)  # [g, B, tile]
        if probed is not None:
            part = torch.where(probed(lo, hi, g), part, POS_INF)
        ids = torch.arange(lo, hi, dtype=torch.int32, device=emb.device)
        ids = ids.view(g, 1, tile).expand(g, b, tile)
        best_d, best_i = empty_lists((g, b), k, emb.device)
        out_d[t0 : t0 + g], out_i[t0 : t0 + g] = merge_candidates(
            best_d, best_i, part, ids, k
        )
    return out_d, out_i


def masked_local_scan_plain(qf, emb, emb_sq, local_cluster, lmask, k, tile):
    """Per-tile masked top-k in plain torch -> ([nt, B, k] f32, i32)."""
    b = qf.shape[0]

    def probed(lo, hi, g):
        slots = local_cluster[lo:hi].view(g, 1, tile).expand(g, b, tile).long()
        t0 = lo // tile
        return lmask[t0 : t0 + g].gather(2, slots) > 0.5

    return _tile_topk_plain(qf, emb, emb_sq, k, tile, probed)


def scored_chunks(probe, local_cluster, tile: int, queries: int):
    """Which 128-row chunks K4 scores -> bool [nt, groups, chunks a tile]:
    the skip rule of ``csrc/topk_lists.cuh`` (``MaskedLists``) in plain
    torch. ``probe`` [nt, B, cmax] bool says which slots of each tile's
    cluster table each query probes (``lmask > 0.5``); a block owns
    ``queries`` consecutive queries. A block scores a chunk of a tile iff
    some row of the chunk has a slot that some query of the block probes; a
    tile none of whose chunks is scored is skipped whole. Every probed
    (query, row) pair therefore lies in a scored chunk. With no probe table
    in shared memory (``score_tile.table_words`` = 0) the kernel scores
    every chunk of a tile that has a scored chunk here."""
    nt, b, cmax = probe.shape
    groups = -(-b // queries)
    pad = torch.zeros((nt, groups * queries - b, cmax), dtype=torch.bool,
                      device=probe.device)
    union = torch.cat([probe, pad], dim=1).view(nt, groups, queries, cmax).any(dim=2)
    slots = local_cluster.view(nt, 1, tile).expand(nt, groups, tile).long()
    row_hit = union.gather(2, slots)  # [nt, groups, tile]
    chunks = -(-tile // score_tile.CHUNK_ROWS)
    row_hit = torch.nn.functional.pad(row_hit, (0, chunks * score_tile.CHUNK_ROWS - tile))
    return row_hit.view(nt, groups, chunks, score_tile.CHUNK_ROWS).any(dim=3)


def masked_scan_chunks(mask, row_cluster, tile: int, queries: int, table: bool = True):
    """Which 128-row chunks K6 scores -> bool [nt, groups, chunks a tile]:
    the skip rule of ``csrc/topk_lists.cuh`` (``ClusterLists``) in plain
    torch. A block owns ``queries`` consecutive queries of ``mask`` [B,
    kc_pad] and scores a chunk iff some row of it (``row_cluster`` [n_pad])
    is of a cluster some query of the block probes, so every probed (query,
    row) pair lies in a scored chunk. Without the probe table in shared
    memory (it does not fit: ``k6_units`` = 0) K6 runs K4's kernel, which
    scores every chunk."""
    b = mask.shape[0]
    nt = row_cluster.shape[0] // tile
    groups = -(-b // queries)
    chunks = -(-tile // score_tile.CHUNK_ROWS)
    if not table:
        return torch.ones((nt, groups, chunks), dtype=torch.bool, device=mask.device)
    pad = torch.zeros((groups * queries - b, mask.shape[1]), dtype=torch.bool,
                      device=mask.device)
    union = torch.cat([mask > 0.5, pad]).view(groups, queries, -1).any(dim=1)
    row_hit = union[:, row_cluster.long()].view(groups, nt, tile).transpose(0, 1)
    row_hit = torch.nn.functional.pad(row_hit, (0, chunks * score_tile.CHUNK_ROWS - tile))
    return row_hit.reshape(nt, groups, chunks, score_tile.CHUNK_ROWS).any(dim=3)


def k6_units(batch: int, nt: int, smem: int, queries: int) -> int:
    """Tile runs of a K6 launch with its probe table: about one wave of
    (run, query group) blocks at the blocks an SM holds (one for 128
    queries a block, two for 64, fewer where shared memory says so), no
    more runs than tiles; 0 where the table does not fit shared memory."""
    if smem > score_tile.SMEM_LIMIT:
        return 0
    per_sm = max(1, min(1 if queries == 128 else 2,
                        score_tile.SMEM_PER_SM // (smem + 1024)))
    groups = -(-batch // queries)
    return max(1, min(nt, score_tile.SM_COUNT * per_sm // groups))


def masked_geometry(kernel: str, qf, emb, k: int, cmax: int):
    """(back end, queries a block, probe-table words, dynamic shared memory)
    of a K4 or K6 launch on these operands (K6: ``cmax`` = kc_pad)."""
    backend = score_tile.pick_backend(
        emb.dtype, emb.shape[1], qf.data_ptr(), emb.data_ptr()
    )
    queries = score_tile.masked_block_queries(backend)
    if kernel == "K6":  # cmax = kc_pad: a bit a cluster, or no table where it does not fit
        words = cmax // 32
        if score_tile.smem_bytes(kernel, backend, queries, k, words) > score_tile.SMEM_LIMIT:
            words = 0
    else:
        words = score_tile.table_words(backend, queries, k, cmax)
    smem = score_tile.smem_bytes(kernel, backend, queries, k, words)
    return backend, queries, words, smem


def check_stats(stats, device) -> int:
    """The address of a launch's counters (0 for none: tracing is off), an
    int32 [2] tensor on the operands' device (``profiling.device_counter``)."""
    if stats is None:
        return 0
    if stats.dtype != torch.int32 or stats.shape != (2,) or stats.device != device:
        raise TypeError("stats must be int32 [2] on the operands' device")
    return stats.data_ptr()


def masked_local_scan(qf, emb, emb_sq, local_cluster, lmask, k: int, tile: int):
    """K4's scan: per-tile top-k of the probed rows -> ([nt, B, k], [nt, B, k]).

    ``qf`` [B, d] in the storage dtype, ``emb`` [n_pad, d], ``emb_sq``
    [n_pad] f32 (+3e38 on pad rows), ``local_cluster`` [n_pad] int32 (a row's
    slot in its tile's cluster table, below cmax), ``lmask`` [nt, B, cmax]
    f32. The kernel runs on the score tile of ``csrc/score_tile.cuh`` (fp32
    FMA or wgmma by ``score_tile.pick_backend``) and scores only the chunks
    that hold a row some query of the block probes (``scored_chunks``);
    while tracing is on, the trace's ``k4`` counter adds them
    (``profiling.device_counter``, ``K4_COUNTERS``)."""
    with profiling.span("search.scan"):
        check_scan_args(qf, emb, emb_sq, k, tile)
        nt = emb.shape[0] // tile
        if local_cluster.dtype != torch.int32 or local_cluster.shape != (emb.shape[0],):
            raise TypeError("local_cluster must be int32 [n_pad]")
        if (lmask.dtype != torch.float32 or lmask.dim() != 3 or lmask.shape[2] < 1
                or lmask.shape[:2] != (nt, qf.shape[0])):
            raise TypeError("lmask must be float32 [nt, B, cmax]")
        if emb.device.type == "cpu":
            return masked_local_scan_plain(qf, emb, emb_sq, local_cluster, lmask, k, tile)
        check_cuda_operands(
            q=qf, emb=emb, emb_sq=emb_sq, local_cluster=local_cluster, lmask=lmask
        )
        backend, queries, words, _ = masked_geometry("K4", qf, emb, k, lmask.shape[2])
        pairs = nt * -(-qf.shape[0] // queries) * -(-tile // score_tile.CHUNK_ROWS)
        stats = profiling.device_counter("k4", K4_COUNTERS, emb.device, pairs)
        return _launch_tile_topk(
            "K4", "pqv_masked_local_topk", qf, emb, emb_sq, k, tile,
            ptrs=(local_cluster, lmask), ints=(lmask.shape[2],),
            flags=(int(backend == "wgmma"), words, check_stats(stats, emb.device)),
        )


def exact_scan_plain(qf, emb, emb_sq, k, tile):
    """K5 in plain torch: every tile's top-k -> ([nt, B, k] f32, i32)."""
    return _tile_topk_plain(qf, emb, emb_sq, k, tile)


def _launch_tile_topk(name, fn, qf, emb, emb_sq, k, tile, ptrs=(), ints=(), flags=()):
    """Launch a per-tile scan kernel (K4, K5, K6) -> ([nt, B, k], [nt, B, k]).
    Their C entry points take (q, emb, emb_sq, *ptrs, B, d, n_pad, k, tile,
    *ints, is_bf16, *flags, out_d, out_i, stream)."""
    lib = _build.load()
    n_pad, d = emb.shape
    b = qf.shape[0]
    nt = n_pad // tile
    out_d = torch.empty((nt, b, k), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((nt, b, k), dtype=torch.int32, device=emb.device)
    rc = getattr(lib, fn)(
        qf.data_ptr(), emb.data_ptr(), emb_sq.data_ptr(),
        *(t.data_ptr() for t in ptrs), b, d, n_pad, k, tile, *ints,
        int(emb.dtype == torch.bfloat16), *flags, out_d.data_ptr(), out_i.data_ptr(),
        _build.stream_ptr(),
    )
    _build.check(rc, fn)
    _build.LAUNCHES[name] += 1
    return out_d, out_i


def exact_scan(qf, emb, emb_sq, k: int, tile: int):
    """K5's scan: each tile's exact top-k -> ([nt, B, k] f32 partial d²,
    [nt, B, k] i32), empty slots (+3e38, -1). Operands as for
    ``masked_local_scan``. The kernel runs on the score tile of
    ``csrc/score_tile.cuh``: fp32 FMA for f32 storage, wgmma for bf16 storage
    with ``d % 8 == 0`` (``score_tile.pick_backend``)."""
    with profiling.span("search.scan"):
        check_scan_args(qf, emb, emb_sq, k, tile)
        if emb.device.type == "cpu":
            return exact_scan_plain(qf, emb, emb_sq, k, tile)
        check_cuda_operands(q=qf, emb=emb, emb_sq=emb_sq)
        backend = score_tile.pick_backend(
            emb.dtype, emb.shape[1], qf.data_ptr(), emb.data_ptr()
        )
        return _launch_tile_topk(
            "K5", "pqv_exact_topk", qf, emb, emb_sq, k, tile,
            flags=(int(backend == "wgmma"),),
        )


def masked_scan_plain(qf, emb, emb_sq, row_cluster, mask, k, tile):
    """K6 in plain torch: each tile's top-k of the rows whose cluster the
    query probes -> ([nt, B, k] f32, i32)."""

    def probed(lo, hi, g):
        cl = row_cluster[lo:hi].long()
        return (mask[:, cl] > 0.5).view(-1, g, tile).transpose(0, 1)

    return _tile_topk_plain(qf, emb, emb_sq, k, tile, probed)


def masked_scan(qf, emb, emb_sq, row_cluster, mask, k: int, tile: int):
    """K6's scan: per-tile top-k under a global probe mask -> ([nt, B, k],
    [nt, B, k]). ``row_cluster`` [n_pad] int32 holds each row's cluster, kc
    on pad rows; ``mask`` [B, kc_pad] f32 with kc_pad > kc, slot kc unset.
    The kernel runs on the score tile (fp32 FMA or wgmma by
    ``score_tile.pick_backend``) with the block's queries' rows of the mask
    as a probe table in shared memory, a block walking a run of tiles
    (``k6_units``), or, where that table does not fit, K4's kernel reading
    the mask through the rows' cluster ids; it scores the chunks
    ``masked_scan_chunks`` picks, and while tracing is on the trace's ``k6``
    counter adds the (block, tile) and (block, chunk) pairs it scored
    (``profiling.device_counter``, ``K6_COUNTERS``)."""
    with profiling.span("search.scan"):
        check_scan_args(qf, emb, emb_sq, k, tile)
        if row_cluster.dtype != torch.int32 or row_cluster.shape != (emb.shape[0],):
            raise TypeError("row_cluster must be int32 [n_pad]")
        if mask.dtype != torch.float32 or mask.dim() != 2 or mask.shape[0] != qf.shape[0]:
            raise TypeError("mask must be float32 [B, kc_pad]")
        if emb.device.type == "cpu":
            return masked_scan_plain(qf, emb, emb_sq, row_cluster, mask, k, tile)
        if mask.shape[1] % 128:
            raise ValueError("mask's kc_pad must be a multiple of 128")
        check_cuda_operands(q=qf, emb=emb, emb_sq=emb_sq, row_cluster=row_cluster, mask=mask)
        backend, queries, words, smem = masked_geometry("K6", qf, emb, k, mask.shape[1])
        nt = emb.shape[0] // tile
        units = k6_units(qf.shape[0], nt, smem, queries) if words else 0
        pairs = nt * -(-qf.shape[0] // queries) * -(-tile // score_tile.CHUNK_ROWS)
        stats = profiling.device_counter("k6", K6_COUNTERS, emb.device, pairs)
        return _launch_tile_topk(
            "K6", "pqv_masked_topk", qf, emb, emb_sq, k, tile,
            ptrs=(row_cluster, mask), ints=(mask.shape[1],),
            flags=(int(backend == "wgmma"), units, check_stats(stats, emb.device)),
        )


def _refine(q, emb, best_d, best_i, out_k=None):
    """Direct-form f32 re-score of the winners, then an ascending sort under
    the (distance, id) order, trimmed to ``out_k``. Slots at or above the
    sentinel's half become +inf; NaNs become +inf."""
    with profiling.span("search.refine"):
        invalid = best_d >= POS_INF / 2
        x = emb[best_i.clamp_min(0).long()].float()
        diff = x - q[:, None, :]
        d2 = (diff * diff).sum(dim=-1)
        d2 = torch.where(invalid | torch.isnan(d2), torch.inf, d2)
        return select_lex(d2, best_i, out_k or d2.shape[1])


def final_merge_plain(tile_d, tile_i, k):
    """The cross-tile merge in plain torch: ``select_lex`` over the [B, nt·kk]
    block -> [B, min(k, nt·kk)]."""
    nt, b, kk = tile_d.shape
    all_d = tile_d.permute(1, 0, 2).reshape(b, nt * kk)
    all_i = tile_i.permute(1, 0, 2).reshape(b, nt * kk)
    return select_lex(all_d, all_i, k)


def merge_counts(tile_d) -> tuple[int, int]:
    """The merge kernel's counters (``MERGE_COUNTERS``) in plain torch: the
    lists whose head is below the 3e38 sentinel, and the nt x B heads."""
    return int((tile_d[:, :, 0] < POS_INF).sum()), tile_d.shape[0] * tile_d.shape[1]


def _final_merge(tile_d, tile_i, k):
    """[nt, B, kk] per-tile winners, each list ascending in distance ->
    [B, min(k, nt·kk)] global, ascending under the (distance, id) order,
    (+3e38, -1) where a query has fewer candidates. The kernel of
    ``csrc/merge.cu`` on CUDA tensors reads only the lists whose head is a
    candidate, and only up to the running k-th entry; it gives what
    ``final_merge_plain`` gives, bit for bit; while tracing is on it adds
    ``MERGE_COUNTERS`` to the trace's ``merge`` counter."""
    with profiling.span("search.merge"):
        if tile_d.dtype != torch.float32 or tile_i.dtype != torch.int32:
            raise TypeError("the merge takes float32 distances and int32 ids")
        if tile_d.dim() != 3 or tile_i.shape != tile_d.shape or 0 in tile_d.shape[::2]:
            raise ValueError(f"the merge takes two [nt, B, kk] lists, got "
                             f"{tuple(tile_d.shape)} and {tuple(tile_i.shape)}")
        nt, b, kk = tile_d.shape
        if not (1 <= k <= MAX_K and kk <= MAX_K):
            raise ValueError(f"the merge takes 1 <= k, kk <= {MAX_K}, got k {k}, kk {kk}")
        if not (tile_d.is_contiguous() and tile_i.is_contiguous()):
            raise ValueError("the merge's lists must be contiguous")
        if tile_i.device != tile_d.device:
            raise ValueError("the merge's lists must be on one device")
        if tile_d.device.type == "cpu":
            return final_merge_plain(tile_d, tile_i, k)
        check_cuda_operands(tile_d=tile_d, tile_i=tile_i)
        kout = min(k, nt * kk)
        out_d = torch.empty((b, kout), dtype=torch.float32, device=tile_d.device)
        out_i = torch.empty((b, kout), dtype=torch.int32, device=tile_d.device)
        stats = profiling.device_counter("merge", MERGE_COUNTERS, tile_d.device, nt * b)
        lib = _build.load()
        rc = lib.pqv_merge_lists(
            tile_d.data_ptr(), tile_i.data_ptr(), nt, b, kk, k,
            check_stats(stats, tile_d.device), out_d.data_ptr(), out_i.data_ptr(),
            _build.stream_ptr(),
        )
        _build.check(rc, "pqv_merge_lists")
        _build.LAUNCHES["merge"] += 1
        return out_d, out_i


def masked_local_topk(
    q, centroids, c_sq, local_cluster, tile_clusters, emb, emb_sq, nprobe: int,
    k: int, tile: int, emb_ref=None,
):
    """IVF top-k over a cluster-sorted layout (``pallas_masked_local_topk``):
    probe mask -> ``lmask`` gather -> K4 -> cross-tile merge -> re-score."""
    with profiling.span("search.probe"):
        mask = probe_mask(q, centroids, c_sq, nprobe)
        lmask = mask[:, tile_clusters.long()].permute(1, 0, 2).contiguous()
    tile_d, tile_i = masked_local_scan(
        q.to(emb.dtype), emb, emb_sq, local_cluster, lmask, k, tile
    )
    best_d, best_i = _final_merge(tile_d, tile_i, k)
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i)


def exact_topk(q, emb, emb_sq, k: int, tile: int, emb_ref=None):
    """Exact top-k (``pallas_exact_topk``): K5 -> cross-tile merge ->
    re-score against ``emb_ref`` when given."""
    tile_d, tile_i = exact_scan(q.to(emb.dtype), emb, emb_sq, k, tile)
    best_d, best_i = _final_merge(tile_d, tile_i, k)
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i)


def masked_topk(
    q, centroids, c_sq, row_cluster, emb, emb_sq, nprobe: int, k: int, tile: int,
    emb_ref=None,
):
    """IVF top-k on any layout (``pallas_masked_topk``): probe mask -> K6
    -> cross-tile merge -> re-score."""
    with profiling.span("search.probe"):
        mask = probe_mask(q, centroids, c_sq, nprobe)
    tile_d, tile_i = masked_scan(
        q.to(emb.dtype), emb, emb_sq, row_cluster, mask, k, tile
    )
    best_d, best_i = _final_merge(tile_d, tile_i, k)
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i)
