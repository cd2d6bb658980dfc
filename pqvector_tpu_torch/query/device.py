"""Device-resident batched exact and IVF search.

Counterpart of ``pqvector_tpu/query/device.py:DeviceIvfSearcher``. The
embedding matrix stays on one torch device (f32, or bf16 with an f32
re-score copy), padded to a multiple of ``row_tile`` with a sentinel row
``n`` whose squared norm is +inf, and optionally permuted into cluster order
so that each inverted list is a contiguous row range. Queries come in
batches; every public call returns (sqrt distances [B, k], original row ids
[B, k]) as tensors on the device, with id -1 and distance +inf in slots
beyond the candidate count.

Modes:

* exact: ``stream`` (K2), ``pallas`` (K5), ``xla`` (the JAX package's XLA
  scan, here in plain torch), ``binscan`` (K7), ``binscan8`` (K7 on int8
  codes), ``cert`` (the certified-exact two-pass scan: K9 tile minima, the
  best tiles gathered whole, a completeness certificate, and K2 as the
  fallback), ``approx`` (a chunked full scan with over-fetch and f32
  re-score) and ``auto``;
* search: ``pallas`` (K4 on cluster-sorted layouts while its local mask
  fits, K6 otherwise), ``stream`` (K3), ``gather`` (the JAX package's fused
  probe chain, in plain torch), ``masked`` (its masked full scan, in plain
  torch), ``approx`` (the masked scan with over-fetch extraction), the
  nprobe-free full scans ``scan``, ``cert``, ``binscan`` and ``binscan8``
  (K7), the probed-union modes ``compact`` (K10 gathers the active tiles,
  then the over-fetch extraction runs over that block), ``bincompact`` and
  ``bincompact8`` (K8), and ``auto``;
* both: the packed-key full scans ``xbin`` (binned min over up to 65,536
  bins), ``xbin8`` (the same on int8 codes) and ``tilescan`` (per-tile
  argmin), plain torch as they are plain XLA in the JAX package, and
  ``autoscan``, which ``scan_route`` resolves by the weather probe
  (``query/autotune.py:probe_weather``): ``scan`` (``approx`` on the exact
  paths) while the extraction keeps pace with the floor, ``binscan`` (K7)
  when it does not.

``exact_loop`` and ``search_loop`` repeat a call ``reps`` times; they take
the JAX package's loop catalogues, without ``gather``. Under
``loop_rescore`` (``_loop_defer_rescore``) a loop over a layout with an f32
copy may select 2k at storage precision in every repetition and re-score
only the last one's winners against the copy, as the JAX package's loops
do past 3/4 of the device memory.

Dynamic and spilled state, as in the JAX package: ``with_spill`` builds a
layout with the rows nearest a second centroid duplicated into it
(``query/spill.py``), ``delete_rows`` tombstones ids and ``append_rows``
keeps new rows in a delta buffer. The mode implementations (``_exact_impl``,
``_search_impl``) select over the static layout, at ``2k`` on a spilled
one; the public wrappers then run ``_finalize`` in plain torch on the
device: tombstone filter, exact delta scan and merge, id dedup, trim to k.

The JAX package extracts candidates in ``scan``, ``approx`` and ``compact``
with ``lax.approx_min_k``, an XLA operation that runs on the TPU's
PartialReduce hardware (and as an exact top-k on every other backend). The
card has no such unit, so here the extraction is an exact top-k by (value,
column): its selection recall is 1.0, which meets any ``recall_target``.
The over-fetch rule, the chunk scaffold and the f32 re-score are the JAX
package's.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..errors import ValidationError
from ..index.ivf import IvfIndex
from ..io.embed import read_index_from_parquet, read_index_metric
from ..io.reader import read_embedding_column
from ..kernels.binscan import (
    PROVENANCE_BITS_MAX,
    binned_scan,
    binned_scan_select,
    binscan_b_tile,
    provenance_bits,
    quantize_queries_i8,
)
from ..kernels import score_tile
from ..kernels.scan_topk import (
    MAX_K,
    _refine,
    exact_topk,
    masked_local_topk,
    masked_topk,
    select_lex,
)
from ..kernels.compact import tile_gather
from ..kernels.stream_topk import _probe_mask, stream_exact_topk, stream_masked_topk
from ..kernels.tilemin import tile_min

#: The JAX package's loop catalogues (``_search_loop_impl``,
#: ``_exact_loop_impl``). ``gather`` is not one: a loop that ran it would
#: time another path than the one it names.
_SEARCH_LOOP_MODES = frozenset({
    "auto", "stream", "pallas", "masked", "approx", "scan", "compact",
    "binscan", "bincompact", "xbin", "binscan8", "bincompact8", "tilescan",
    "cert", "xbin8",
})
_EXACT_LOOP_MODES = frozenset({
    "auto", "stream", "pallas", "xla", "approx", "binscan", "xbin", "binscan8",
    "tilescan", "cert", "xbin8",
})
#: One-shot candidate-scoring budget of ``cert``: the [B, m, tile, d] gather
#: of pass 2 stays one call while under this many bytes; beyond it the
#: scoring walks the selected tiles with a running top-k merge.
_CERT_FUSE_BUDGET = 2 << 30
#: Cap on the [B, chunk] f32 score block of the over-fetch modes.
_APPROX_BLOCK_CAP = 1 << 30
#: The scan kernels' tile: the rows one block of K4 and K5 owns, the unit of
#: K6's per-tile lists, the grain at which K3 and K4 skip unprobed work, and
#: the unit of the per-tile cluster tables. Shared memory does not depend on
#: it (the kernels stream 128-row chunks), so the tile is chosen for the grid
#: and the tables: 1024 rows is about one cluster at IVF-1024 over 1M rows, gives
#: about 1000 tiles there, and keeps a tile's table to a few clusters, one
#: 32-bit word a query in K3's and K4's shared memory.
_SCAN_TILE_CAP = 1024
#: Cap on K4's pre-gathered [nt, B, cmax] f32 local mask, as in the JAX
#: package; beyond it ``auto`` takes K3, which needs no such buffer.
_LOCAL_MASK_CAP = 256 << 20
#: ``auto``'s cost model on a layout in file order, fit to ``search``
#: through K6 and through ``gather`` timed on the H100 at 1M x 128 (B = 1 to
#: 256) and 10M x 96 (B = 1, 16, 256), PERF.md §5. K6: a fixed cost plus ms
#: per 1e9 (row, dimension, query slot) triples of the chunks it scores: a
#: block of 128 queries on wgmma (64 on the fp32 patch) walks the chunks
#: that hold a row of a cluster its queries probe, each chunk's share
#: ``_k6_chunk_share``. The fp32 patch's rate is the wgmma one times K6's
#: f32/bf16 kernel ratio at B = 256 (2.3); no f32 route was timed.
_K6_MS = 0.57
_K6_MS_PER_G = {"wgmma": 0.053, "fma": 0.12}
#: ``gather``: a fixed cost (the plain-torch probe chain's launches) plus ms
#: per 1e6 candidate rows (batch * nprobe * longest list).
_GATHER_MS = 8.0
_GATHER_MS_PER_M = 0.7


def _k6_chunk_share(queries: int, nprobe: int, n_clusters: int) -> float:
    """The share of 128-row chunks in file order that hold a row of a
    cluster some of ``queries`` queries probes, each probing ``nprobe`` of
    ``n_clusters`` at random: K6 scores those and skips the rest."""
    p = min(1.0, queries * nprobe / n_clusters)
    return 1.0 - (1.0 - p) ** 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _quantize_rows_i8(emb):
    """Symmetric per-row int8 quantization: (codes int8, scale f32), with
    x ~= scale[r] * codes[r]; zero rows (padding) get scale 1 and codes 0.
    The JAX package's rows and queries share one formula, and so do these."""
    return quantize_queries_i8(emb.float())


def _compact_select(
    q, centroids, c_sq, row_cluster, nprobe, max_probe, ctile, cap_tiles,
    tile_lo, tile_hi, max_cluster_tiles, n_pad,
):
    """Active-tile selection of the probed-union modes: probe the batch,
    rank tiles by popularity (the most-probed cluster in the tile), keep the
    top ``cap_tiles`` tile ids [cap] int32. Probes tie to the lower cluster
    id, tiles of equal popularity to the lower tile id, so a cap overflow
    drops the tiles fewest queries probed. Counts are integer adds."""
    kc = centroids.shape[0]
    nt = n_pad // ctile
    dist = c_sq[None, :] - 2.0 * (q @ centroids.T)
    cids = torch.arange(kc, dtype=torch.int32, device=q.device)
    _, probe = select_lex(dist, cids[None, :].expand_as(dist), max_probe)
    in_probe = (torch.arange(max_probe, device=q.device) < nprobe).to(torch.int32)
    counts = torch.zeros(kc + 1, dtype=torch.int32, device=q.device)
    counts.index_add_(0, probe.reshape(-1).long(),
                      in_probe.expand(probe.shape[0], -1).reshape(-1))
    counts[kc] = 0  # pad rows are never active
    if tile_lo is not None:
        # Cluster-sorted layout: cluster c spans tiles tile_lo[c] ..
        # tile_hi[c]; every (cluster, tile) pair at once.
        j = torch.arange(max_cluster_tiles, device=q.device)
        t = tile_lo.long()[:, None] + j[None, :]
        val = torch.where(t <= tile_hi.long()[:, None], counts[:kc, None], 0)
        tile_pop = torch.zeros(nt, dtype=torch.int32, device=q.device)
        tile_pop.scatter_reduce_(0, t.clamp(0, nt - 1).reshape(-1),
                                 val.reshape(-1), "amax")
    else:
        tile_pop = counts[row_cluster.long()].view(nt, ctile).amax(dim=1)
    key = torch.where(tile_pop > 0, -tile_pop, 1)
    order = torch.argsort(key, stable=True)
    return order[:cap_tiles].to(torch.int32)


def _exact_topk_impl(q, emb, emb_sq, k: int, tile: int, emb_ref=None):
    """Streaming exact top-k in plain torch: scan row tiles, merge into a
    running [B, kf] by (distance, id). On reduced-precision storage the
    merge keeps 2k and the f32 re-score picks the k best."""
    b = q.shape[0]
    n_pad = emb.shape[0]
    kf = k if emb_ref is None else min(2 * k, n_pad)
    qf = q.to(emb.dtype).float()
    best_d = torch.full((b, kf), torch.inf, device=q.device)
    best_i = torch.full((b, kf), -1, dtype=torch.int32, device=q.device)
    for lo in range(0, n_pad, tile):
        part = emb_sq[None, lo : lo + tile] - 2.0 * (qf @ emb[lo : lo + tile].float().T)
        ids = torch.arange(lo, lo + tile, dtype=torch.int32, device=q.device)
        best_d, best_i = select_lex(
            torch.cat([best_d, part], dim=1),
            torch.cat([best_i, ids[None, :].expand(b, -1)], dim=1),
            kf,
        )
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i, k)


def _ivf_topk_impl(q, centroids, c_sq, clusters, emb, emb_sq, k: int, nprobe: int,
                   tile: int, emb_ref=None):
    """Fused IVF probe in plain torch: nprobe nearest clusters -> gather of
    their padded lists in tiles -> running top-k by (distance, id)."""
    b = q.shape[0]
    kf = k if emb_ref is None else 2 * k
    lmax = clusters.shape[1]
    dist = c_sq[None, :] - 2.0 * (q @ centroids.T)
    cids = torch.arange(centroids.shape[0], dtype=torch.int32, device=q.device)
    _, probe = select_lex(dist, cids[None, :].expand_as(dist), nprobe)
    cand = clusters[probe.long()].reshape(b, nprobe * lmax)
    c_pad = _round_up(cand.shape[1], tile)
    if c_pad != cand.shape[1]:
        fill = torch.full((b, c_pad - cand.shape[1]), emb.shape[0] - 1,
                          dtype=cand.dtype, device=q.device)
        cand = torch.cat([cand, fill], dim=1)
    qf = q.to(emb.dtype).float()
    best_d = torch.full((b, kf), torch.inf, device=q.device)
    best_i = torch.full((b, kf), -1, dtype=torch.int32, device=q.device)
    for lo in range(0, c_pad, tile):
        ids_t = cand[:, lo : lo + tile]
        xt = emb[ids_t.long()].float()  # [B, tile, d] gather
        part = emb_sq[ids_t.long()] - 2.0 * torch.einsum("bd,btd->bt", qf, xt)
        best_d, best_i = select_lex(
            torch.cat([best_d, part], dim=1), torch.cat([best_i, ids_t], dim=1), kf
        )
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i, k)


def select_cols(d: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row of ``d`` [B, n] in ascending
    (value, column) order -> (values [B, k], columns [B, k] int32).

    ``torch.topk`` gives the k-th value; what lies below it is in, and of
    the entries equal to it the lowest columns fill the rest. So the result
    is that of a stable sort of every row, at the cost of a few passes."""
    b, n = d.shape
    k = min(k, n)
    thr = torch.topk(d, k, dim=1, largest=False).values[:, -1:]
    below = d < thr
    need = k - below.sum(dim=1, keepdim=True)
    at = d == thr
    take = below | (at & (at.cumsum(dim=1, dtype=torch.int32) <= need))
    cols = take.nonzero()[:, 1].view(b, k)  # ascending within a row
    vals = d.gather(1, cols)
    order = torch.argsort(vals, dim=1, stable=True)
    return vals.gather(1, order), cols.gather(1, order).to(torch.int32)


def _topk_min_wide(keys: torch.Tensor, m: int, chunk: int = 65536):
    """Ascending top-m of a value table, ties to the lower column, taken in
    blocks of at most ``chunk`` columns and merged -> (values [B, m],
    columns [B, m] int32). The blocks bound the selection's temporaries on
    a wide table (78k tiles at 10M rows)."""
    nt = keys.shape[1]
    m = min(m, nt)
    if nt <= chunk:
        return select_cols(keys, m)
    parts_v, parts_i = [], []
    for s in range(0, nt, chunk):
        v, i = select_cols(keys[:, s : s + chunk], m)
        parts_v.append(v)
        parts_i.append(i + s)
    return select_lex(torch.cat(parts_v, dim=1), torch.cat(parts_i, dim=1), m)


def _exact_cert_impl(
    q, emb, emb_sq, k: int, tile: int, fallback, m_tiles: int = 0, emb_ref=None,
    pass1_high: bool = False, pass1_storage: bool = False,
    diagnostic: bool = False, pass2_form: str = "auto",
):
    """Certified-exact full scan: tile-min lower bounds (K9), whole-tile
    refine, and a completeness certificate with an exact fallback.

    1. Pass 1 folds every ``tile``-row group of ``|x|^2 - 2 q.x`` to its
       minimum (K9), at reference precision (``emb_ref`` when held) or, with
       ``pass1_storage``, over the storage array. Each value bounds every
       row of its tile from below, up to arithmetic slack.
    2. The m best tiles per query (m = ``m_tiles`` or max(2k, 16)) are
       gathered whole, scored in direct-difference f32 and the winners
       re-scored.
    3. With T the (m+1)-th best tile minimum, no row of an unexamined tile
       beats T by more than the slack E = c (|q|^2 + max|x|^2), c =
       max(d, 128) 2^-21, plus 2^-13 for ``pass1_high`` and 2^-8 for a
       reduced-precision pass 1. If every query's k-th distance is at most
       T - E the result is the exact top-k. Otherwise ``fallback()`` runs
       the whole batch through the exact path. The branch reads one flag on
       the host (one synchronisation).

    ``pass1_high`` asks the TPU for a cheaper f32 product. The card's pass 1
    is IEEE fp32 FMA either way, at least as accurate as either setting, so
    the envelope holds; the wider slack is kept so that both packages
    certify the same queries. ``diagnostic`` returns (d2, ids, certified
    [B], margin [B]) and never falls back."""
    b, d = q.shape
    ref = emb_ref if emb_ref is not None else emb
    n_pad = ref.shape[0]
    nt = n_pad // tile
    m = min(m_tiles if m_tiles else max(2 * k, 16), nt)

    p1_src = emb if pass1_storage else ref
    binvals = tile_min(q, p1_src, emb_sq, tile, high=pass1_high)
    qsq = (q * q).sum(dim=1)
    vals, tidx = _topk_min_wide(binvals, m + 1 if m < nt else m)
    if m < nt:
        t_val = vals[:, m] + qsq  # the fold leaves out the rank-neutral |q|^2
        tidx = tidx[:, :m]

    kf = min(2 * k, m * tile) if emb_ref is not None else min(k, m * tile)
    ref3 = ref.view(nt, tile, d)
    sq3 = emb_sq.view(nt, tile)
    offs = torch.arange(tile, dtype=torch.int32, device=q.device)

    def tile_scores(tcol):  # [B, mm] tile ids -> rows, scores [B, mm * tile]
        mm = tcol.shape[1]
        cand = ref3[tcol.long()].float()  # [B, mm, tile, d], whole tiles
        diff = cand - q[:, None, None, :]
        part = (diff * diff).sum(dim=-1).reshape(b, mm * tile)
        x2 = sq3[tcol.long()].reshape(b, mm * tile)
        rows = (tcol[:, :, None] * tile + offs[None, None, :]).reshape(b, mm * tile)
        # pad rows of a partly padded tile are zeros and would score |q|^2
        return rows, torch.where(torch.isinf(x2), torch.inf, part)

    fused = b * m * tile * (d + 1) * 4 <= _CERT_FUSE_BUDGET
    if pass2_form != "auto":
        fused = pass2_form == "fused"
    if fused:
        rows, part = tile_scores(tidx)
        best_d, best_i = select_lex(part, rows, kf)
    else:
        best_d = torch.full((b, kf), torch.inf, device=q.device)
        best_i = torch.full((b, kf), -1, dtype=torch.int32, device=q.device)
        for j in range(m):
            rows, part = tile_scores(tidx[:, j : j + 1])
            best_d, best_i = select_lex(
                torch.cat([best_d, part], dim=1), torch.cat([best_i, rows], dim=1), kf
            )
    if kf < k:  # k exceeds the candidate width (tiny arrays)
        best_d = torch.cat(
            [best_d, torch.full((b, k - kf), torch.inf, device=q.device)], dim=1
        )
        best_i = torch.cat(
            [best_i, torch.full((b, k - kf), -1, dtype=torch.int32, device=q.device)],
            dim=1,
        )
    d2, ids = _refine(q, ref, best_d, best_i, k)
    if m >= nt:  # every tile examined: complete by construction
        if diagnostic:
            return (d2, ids, torch.ones(b, dtype=torch.bool, device=q.device),
                    torch.full((b,), torch.inf, device=q.device))
        return d2, ids

    max_sq = torch.where(torch.isfinite(emb_sq), emb_sq, 0.0).max()
    c_mm = max(d, 128) * 2.0**-21
    if pass1_high:
        c_mm += 2.0**-13
    if p1_src.dtype != torch.float32:
        c_mm += 2.0**-8  # covers |2 q.(x_f32 - x_stored)|
    margin = (t_val - c_mm * (qsq + max_sq)) - d2[:, k - 1]
    if diagnostic:
        return d2, ids, margin >= 0, margin
    if bool((margin >= 0).all()):
        return d2, ids
    return fallback()


def _approx_min_k_clamped(partial: torch.Tensor, k: int, recall_target: float):
    """The ``k`` smallest scores of each row and their columns, ascending by
    (value, column); a ``k`` beyond the width pads with (+inf, 0).

    The JAX package calls ``lax.approx_min_k`` here, whose ``recall_target``
    is the expected share of the true minima it returns. This selection is
    exact: its recall is 1.0, which meets every target, so the argument is
    accepted and not used."""
    del recall_target
    b, width = partial.shape
    vals, idx = select_cols(partial.float(), min(k, width))
    if idx.shape[1] < k:
        pad = k - idx.shape[1]
        vals = torch.cat([vals, torch.full((b, pad), torch.inf, device=vals.device)], dim=1)
        idx = torch.cat([idx, torch.zeros((b, pad), dtype=idx.dtype, device=idx.device)],
                        dim=1)
    return vals, idx


def _approx_scan(q, emb, chunk_topk, operands, k: int, chunk: int, out_k=None):
    """Chunked-scan scaffold of the over-fetch modes: ``chunk_topk(slices...,
    base)`` runs on every ``chunk`` rows of the per-row ``operands`` (and on
    the tail), the chunks' winners are merged by (score, id) and the best
    ``k`` re-scored against ``emb``."""
    n_pad = operands[0].shape[0]
    if n_pad <= chunk:
        best_d, best_i = chunk_topk(*operands, 0)
        return _refine(q, emb, best_d, best_i, out_k)
    parts_d, parts_i = [], []
    for lo in range(0, n_pad, chunk):
        cd, ci = chunk_topk(*(op[lo : lo + chunk] for op in operands), lo)
        parts_d.append(cd)
        parts_i.append(ci)
    all_d = torch.cat(parts_d, dim=1)
    best_d, best_i = select_lex(all_d, torch.cat(parts_i, dim=1), min(k, all_d.shape[1]))
    return _refine(q, emb, best_d, best_i, out_k)


def _fetch_width(k: int, overfetch: int) -> int:
    """Candidates fetched per chunk: ``overfetch`` when set, else
    max(4k, 64) for k <= 32 and 2k beyond."""
    if overfetch:
        return max(k, overfetch)
    return max(4 * k, 64) if k <= 32 else 2 * k


def _chunk_scores(qf, x, x2, score_dtype):
    """``|x|^2 - 2 q.x`` of a chunk in ``score_dtype``. The product is a
    plain matrix product outside any kernel, as in the JAX package: storage
    operands widened to f32 (bf16 products are then exact), f32 sums."""
    scores = (qf.float() @ x.float().T).to(score_dtype)
    return (x2[None, :] - 2.0 * scores.float()).to(score_dtype)


def _exact_approx_topk_impl(
    q, emb, emb_sq, k: int, chunk: int, recall_target: float,
    score_dtype=torch.float32, overfetch: int = 0, emb_ref=None,
):
    """Full scan with over-fetch extraction: every chunk yields its
    ``_fetch_width`` best rows, the merged winners are re-scored in f32
    and the best ``k`` returned. ``score_dtype=bfloat16`` rounds the
    selection scores to bf16 (winners are still re-scored in f32)."""
    qf = q.to(emb.dtype)
    k_fetch = _fetch_width(k, overfetch)

    def chunk_topk(x, x2, base):
        partial = _chunk_scores(qf, x, x2, score_dtype)
        vals, idx = _approx_min_k_clamped(partial, k_fetch, recall_target)
        return vals, base + idx

    return _approx_scan(
        q, emb if emb_ref is None else emb_ref, chunk_topk, (emb, emb_sq),
        k_fetch, chunk, out_k=k,
    )


# -- the packed-key scans (xbin, xbin8, tilescan) ---------------------------
# Plain torch, as they are plain XLA in the JAX package. Each score packs its
# f32 value (the non-negative IEEE bit pattern orders as an int32) with a
# provenance code in the low mantissa bits, and a grouped min over the int32
# keys selects. The epilogues keep the JAX package's operation order: the
# keys are the bits of the value, so a reordered sum moves them.


def _xbin_code_bits(n_pad: int, l_bins: int) -> int:
    """Low mantissa bits a packed ``xbin`` key spends on the tile code."""
    return max(1, (n_pad // l_bins - 1).bit_length())


def _xbin_bins(n_pad: int, k: int) -> int:
    """Bin count of ``xbin``, as in the JAX package: the largest 128-multiple
    divisor of ``n_pad`` up to 65,536 whose tile code fits the provenance
    budget (``PROVENANCE_BITS_MAX``), else the largest divisor of any size
    that does; 0 when that count is below k. More bins mean fewer collisions
    among the true top-k and fewer code bits a key."""
    cap = min(n_pad, 65536)
    best = 0
    for l_bins in range(128, cap + 1, 128):
        if n_pad % l_bins == 0 and _xbin_code_bits(n_pad, l_bins) <= PROVENANCE_BITS_MAX:
            best = l_bins
    if not best:
        for l_bins in range(cap, 0, -1):
            if n_pad % l_bins == 0 and _xbin_code_bits(n_pad, l_bins) <= PROVENANCE_BITS_MAX:
                best = l_bins
                break
    return best if 0 < k <= best else 0


#: Auto-chunk budget of ``xbin`` (bytes), the JAX package's knob under its
#: name: the scan stays one call while its [B, n_pad] f32 score block fits,
#: and walks groups of tiles beyond. Torch materializes every block, so the
#: budget bounds the block each step holds.
_XBIN_FUSE_BUDGET = int(os.environ.get("PQVECTOR_TPU_XBIN_FUSE_BUDGET", 2 << 30))


def _xbin_auto_chunk(b: int, n_pad: int, l_bins: int, chunk_groups: int) -> int:
    """Effective ``chunk_groups`` of ``_exact_xbin_impl``: > 0 explicit, -1
    one call, 0 auto (one call while [B, n_pad] f32 fits ``_XBIN_FUSE_BUDGET``,
    else steps of as many tile groups as the budget holds, at least one)."""
    if chunk_groups > 0:
        return int(chunk_groups)
    if chunk_groups < 0 or b * n_pad * 4 <= _XBIN_FUSE_BUDGET:
        return 0
    return max(1, _XBIN_FUSE_BUDGET // max(1, b * l_bins * 4))


def _pack(part: torch.Tensor, mask: int, code: torch.Tensor) -> torch.Tensor:
    """f32 values -> int32 keys: the value's bits under ``mask``, ``code`` in
    the bits below."""
    return (part.view(torch.int32) & mask) | code[None, :]


def _decode(key_w: torch.Tensor, mask: int) -> torch.Tensor:
    """The value part of packed keys as f32. A pad-only bin decodes to +inf
    (the code sits below the mantissa bits +inf leaves clear), which
    ``_refine`` marks missing."""
    return (key_w & mask).view(torch.float32)


def _checked_bins(rows: int, k: int, l_bins: int, what: str) -> int:
    """Bins of the packed-key binned scans over ``rows`` rows: ``l_bins``
    (the knob ``what``) checked, a divisor of the rows from k to 65,536 whose
    tile code fits the provenance budget, or ``_xbin_bins`` when 0."""
    if l_bins:
        if rows % l_bins or not (0 < k <= l_bins) or l_bins > 65536:
            raise ValidationError(
                f"{what}={l_bins} invalid: must divide the {rows} rows, "
                "satisfy k<=bins, and stay <= 65536"
            )
        if _xbin_code_bits(rows, l_bins) > PROVENANCE_BITS_MAX:
            raise ValidationError(
                f"{what}={l_bins} spends {_xbin_code_bits(rows, l_bins)} provenance "
                f"bits at {rows} rows (max {PROVENANCE_BITS_MAX}): too few value "
                "mantissa bits for reliable selection; use more bins"
            )
        return l_bins
    l_bins = _xbin_bins(rows, k)
    if not l_bins:
        raise ValidationError(f"xbin ineligible for {rows} rows, k={k}")
    return l_bins


def _group_steps(n_units: int, unit: int, groups: int):
    """Row ranges of ``groups`` units (clamped to the largest divisor of
    ``n_units`` not above it), or one range over every row when ``groups``
    is 0 or covers them all."""
    if not groups or groups >= n_units:
        return [(0, n_units * unit)]
    g = max(1, groups)
    while n_units % g:
        g -= 1
    step = g * unit
    return [(lo, lo + step) for lo in range(0, n_units * unit, step)]


def _bin_select(block_keys, nt: int, l_bins: int, chunk_groups: int, k_fetch: int,
                mask: int):
    """The binned scans' selection: ``block_keys(lo, hi)`` ([B, l_bins] bin
    keys of rows lo:hi) min-folded over ``_group_steps``, then the
    ``k_fetch`` smallest keys by (key, bin), as the JAX package's
    ``lax.top_k`` of the negated table -> (values [B, k_fetch] f32, rows
    [B, k_fetch] int32)."""
    binmins = None
    for lo, hi in _group_steps(nt, l_bins, chunk_groups):
        keys = block_keys(lo, hi)
        binmins = keys if binmins is None else torch.minimum(binmins, keys)
    key_w, bin_idx = _topk_min_wide(binmins, k_fetch)
    return _decode(key_w, mask), (key_w & ~mask) * l_bins + bin_idx


def _exact_xbin_impl(
    q, emb, emb_sq, k: int, l_bins: int, score_dtype=torch.float32,
    overfetch: int = 0, chunk_groups: int = 0, emb_ref=None,
):
    """Full scan with binned-min selection over ``l_bins`` bins (the JAX
    package's ``_exact_xbin_impl``): row r lands in bin ``r % l_bins`` with
    its tile code ``r // l_bins`` in the key's low bits; the key is the bits
    of ``|x|^2 - 2 q.x + |q|^2`` (``emb_sq`` +inf on pad rows). The
    ``max(2k, 32)`` (or ``overfetch``) smallest bin keys decode to rows,
    re-scored against ``emb_ref`` (or ``emb``). Selection misses only where
    two true neighbours share a bin. ``chunk_groups`` > 0 walks blocks of
    that many tile groups (a divisor of the tile count) with an INT32_MAX
    running min; the keys, and so the result, do not change."""
    b = q.shape[0]
    n_pad = emb.shape[0]
    nt = n_pad // l_bins
    mask = ~((1 << max(1, (nt - 1).bit_length())) - 1)
    qf = q.to(emb.dtype).float()
    qsq = (q * q).sum(dim=1)
    code = torch.arange(n_pad, dtype=torch.int32, device=q.device) // l_bins

    def block_keys(lo, hi):
        scores = (qf @ emb[lo:hi].float().T).to(score_dtype).float()
        # (x2 - 2 s) + |q|^2 in the JAX package's order: -2 s is exact
        part = scores.mul_(-2.0).add_(emb_sq[None, lo:hi]).add_(qsq[:, None])
        return _pack(part, mask, code[lo:hi]).view(b, -1, l_bins).amin(dim=1)

    k_fetch = min(max(k, overfetch) if overfetch else max(2 * k, 32), l_bins)
    val, rows = _bin_select(block_keys, nt, l_bins, chunk_groups, k_fetch, mask)
    return _refine(q, emb if emb_ref is None else emb_ref, val, rows, k)


def _int8_dots(qi: torch.Tensor, e8: torch.Tensor) -> torch.Tensor:
    """``qi @ e8.T`` of int8 codes as f32: the int32 sums of the JAX
    package's int8 product, converted. Products are at most 127^2, so f32
    sums are exact while d * 127^2 <= 2^24 and f64 ones beyond; either way
    the conversion rounds the exact integer once."""
    if qi.shape[1] * 127 * 127 <= 1 << 24:
        return qi.float() @ e8.float().T
    return (qi.double() @ e8.double().T).float()


def _exact_xbin8_impl(
    q, emb_i8, scale, emb_sq, emb_ref, k: int, l_bins: int, overfetch: int = 0,
    chunk_groups: int = 0,
):
    """``_exact_xbin_impl`` on per-row int8 codes (the JAX package's
    ``_exact_xbin8_impl``): the value is ``|x|^2 - 2 tq (sc dots) + |q|^2``
    clamped at 0, with exact int8 dot sums, the exact f32 ``emb_sq`` and the
    shared query quantizer; the winners are re-scored against ``emb_ref``.
    It fetches ``max(4k, 64)`` bins by default."""
    b = q.shape[0]
    n_pad = emb_i8.shape[0]
    nt = n_pad // l_bins
    mask = ~((1 << max(1, (nt - 1).bit_length())) - 1)
    qi, tq = quantize_queries_i8(q)
    qsq = (q * q).sum(dim=1)
    tq2 = 2.0 * tq[:, None]
    code = torch.arange(n_pad, dtype=torch.int32, device=q.device) // l_bins

    def block_keys(lo, hi):
        # x2 - (2 tq) (sc dots) + |q|^2 as XLA compiles the JAX expression:
        # the first two terms as one fused multiply-add (carried in f64,
        # where the product of two f32 values is exact), then + |q|^2
        t = _int8_dots(qi, emb_i8[lo:hi]).mul_(scale[None, lo:hi]).double()
        part = torch.addcmul(emb_sq[None, lo:hi].double(), t, tq2.double(), value=-1.0)
        part = part.float().add_(qsq[:, None]).clamp_min_(0.0)
        return _pack(part, mask, code[lo:hi]).view(b, -1, l_bins).amin(dim=1)

    k_fetch = min(max(k, overfetch) if overfetch else max(4 * k, 64), l_bins)
    val, rows = _bin_select(block_keys, nt, l_bins, chunk_groups, k_fetch, mask)
    return _refine(q, emb_ref, val, rows, k)


#: Auto-chunk budget of ``tilescan`` (bytes), the JAX package's knob under
#: its name: rows a step are sized so the [B, rows] f32 score block fits.
_TILESCAN_FUSE_BUDGET = int(os.environ.get("PQVECTOR_TPU_TILESCAN_FUSE_BUDGET", 2 << 30))


def _tilescan_auto_chunk(b: int, n_pad: int, tile: int, chunk_rows: int) -> int:
    """Effective rows a step of ``_tile_min_keys``: > 0 explicit, -1 one
    call, 0 auto by ``_TILESCAN_FUSE_BUDGET`` (a multiple of ``tile``)."""
    if chunk_rows > 0:
        return int(chunk_rows)
    if chunk_rows < 0 or b * n_pad * 4 <= _TILESCAN_FUSE_BUDGET:
        return 0
    return max(tile, (_TILESCAN_FUSE_BUDGET // max(1, b * 4)) // tile * tile)


def _tile_min_keys(q, emb, emb_sq, tile: int, chunk_rows: int = 0):
    """[B, n_pad / tile] per-tile min keys of ``tilescan``: the bits of
    ``|x|^2 + (-2q).x + |q|^2`` (the -2 folded into the query operand, as in
    the JAX package) with the row's offset in its tile in the low
    ``log2(tile)`` bits. Steps of rows (``_tilescan_steps``) stack their
    tables, tiles being independent."""
    b = q.shape[0]
    n_pad = emb.shape[0]
    low = (1 << max(1, (tile - 1).bit_length())) - 1
    qf2 = (-2.0 * q).to(emb.dtype).float()
    qsq = (q * q).sum(dim=1)
    off = torch.arange(n_pad, dtype=torch.int32, device=q.device) & low

    def block_mins(lo, hi):
        part = (qf2 @ emb[lo:hi].float().T).add_(emb_sq[None, lo:hi]).add_(qsq[:, None])
        return _pack(part, ~low, off[lo:hi]).view(b, -1, tile).amin(dim=2)

    steps = _tilescan_steps(b, n_pad, tile, chunk_rows)
    if len(steps) == 1:
        return block_mins(0, n_pad)
    return torch.cat([block_mins(lo, hi) for lo, hi in steps], dim=1)


def _tilescan_steps(b: int, n_pad: int, tile: int, chunk_rows: int):
    """Row ranges of ``_tile_min_keys``' steps: ``_tilescan_auto_chunk``'s
    rows lowered to a tile-multiple divisor of ``n_pad``, or one range."""
    step_rows = _tilescan_auto_chunk(b, n_pad, tile, chunk_rows)
    if not step_rows or step_rows >= n_pad:
        return [(0, n_pad)]
    sr = max(tile, step_rows // tile * tile)
    while n_pad % sr:
        sr -= tile
    return [(lo, lo + sr) for lo in range(0, n_pad, sr)]


def _exact_tilescan_impl(
    q, emb, emb_sq, k: int, tile: int, chunk_rows: int = 0, overfetch: int = 0,
    emb_ref=None,
):
    """Full scan with per-tile argmin selection (the JAX package's
    ``_exact_tilescan_impl``): each ``tile``-row group gives its best row
    (``_tile_min_keys``), the ``_fetch_width`` best tiles (at most the tile
    count) decode to rows and are re-scored against ``emb_ref`` (or
    ``emb``). Two true neighbours in one tile lose the farther for good, so
    it serves the original row order only."""
    nt = emb.shape[0] // tile
    low = (1 << max(1, (tile - 1).bit_length())) - 1
    binmins = _tile_min_keys(q, emb, emb_sq, tile, chunk_rows)
    key_w, tidx = _topk_min_wide(binmins, min(_fetch_width(k, overfetch), nt))
    rows = tidx * tile + (key_w & low)
    return _refine(q, emb if emb_ref is None else emb_ref, _decode(key_w, ~low), rows, k)


def _ivf_approx_masked_impl(
    q, centroids, c_sq, row_cluster, emb, emb_sq, nprobe: int, k: int,
    max_probe: int, chunk: int, recall_target: float,
    score_dtype=torch.float32, overfetch: int = 0, emb_ref=None,
):
    """Masked IVF scan with over-fetch extraction: ``_exact_approx_topk_impl``
    with the rows of unprobed clusters set to +inf."""
    qf = q.to(emb.dtype)
    # [B, kc + 1]: the extra slot takes the pad rows' cluster id, never set
    mask = _probe_mask(q, centroids, c_sq, nprobe, max_probe,
                       centroids.shape[0] + 1) > 0.5
    k_fetch = _fetch_width(k, overfetch)

    def chunk_topk(x, x2, cl, base):
        partial = _chunk_scores(qf, x, x2, score_dtype)
        partial = torch.where(mask[:, cl.long()], partial, torch.inf)
        vals, idx = _approx_min_k_clamped(partial, k_fetch, recall_target)
        return vals, base + idx

    return _approx_scan(
        q, emb if emb_ref is None else emb_ref, chunk_topk,
        (emb, emb_sq, row_cluster), k_fetch, chunk, out_k=k,
    )


def _ivf_compact_approx_impl(
    q, centroids, c_sq, row_cluster, emb, emb_sq, nprobe: int, k: int,
    max_probe: int, ctile: int, cap_tiles: int, chunk: int, recall_target: float,
    score_dtype=torch.float32, tile_lo=None, tile_hi=None,
    max_cluster_tiles: int = 0, emb_ref=None,
):
    """IVF by probed-union tile compaction: select the batch's active tiles
    (``_compact_select``), gather them into one block (K10), run the
    over-fetch extraction over that block, map the local ids back through
    ``sel`` and re-score against ``emb_ref`` when held. Candidates are the
    union of the batch's probed clusters plus the rows sharing a tile with
    them, capped at ``cap_tiles`` tiles (the least-probed are dropped)."""
    sel = _compact_select(
        q, centroids, c_sq, row_cluster, nprobe, max_probe, ctile, cap_tiles,
        tile_lo, tile_hi, max_cluster_tiles, emb.shape[0],
    )
    emb_c, sq_c = tile_gather(emb, emb_sq, sel, ctile)
    kf = k if emb_ref is None else 2 * k
    d2, lids = _exact_approx_topk_impl(
        q, emb_c, sq_c, kf, chunk=chunk, recall_target=recall_target,
        score_dtype=score_dtype,
    )
    gids = sel[(lids // ctile).long()] * ctile + lids % ctile
    ids = torch.where(lids >= 0, gids, -1)
    if emb_ref is None:
        return d2, ids
    return _refine(q, emb_ref, d2, ids, k)


def _ivf_masked_scan_impl(
    q, centroids, c_sq, row_cluster, emb, emb_sq, nprobe: int, k: int,
    max_probe: int, tile: int, emb_ref=None,
):
    """IVF top-k as a masked full scan in plain torch: every row tile is
    scored once for the whole batch, rows of unprobed clusters are set to
    +inf, and a running [B, kf] list is merged by (distance, id)."""
    b = q.shape[0]
    n_pad = emb.shape[0]
    kf = k if emb_ref is None else min(2 * k, n_pad)
    # [B, kc + 1]: the extra slot takes the pad rows' cluster id, never set
    mask = _probe_mask(q, centroids, c_sq, nprobe, max_probe,
                       centroids.shape[0] + 1) > 0.5
    qf = q.to(emb.dtype).float()
    best_d = torch.full((b, kf), torch.inf, device=q.device)
    best_i = torch.full((b, kf), -1, dtype=torch.int32, device=q.device)
    for lo in range(0, n_pad, tile):
        part = emb_sq[None, lo : lo + tile] - 2.0 * (qf @ emb[lo : lo + tile].float().T)
        part = torch.where(mask[:, row_cluster[lo : lo + tile].long()], part, torch.inf)
        ids = torch.arange(lo, lo + tile, dtype=torch.int32, device=q.device)
        best_d, best_i = select_lex(
            torch.cat([best_d, part], dim=1),
            torch.cat([best_i, ids[None, :].expand(b, -1)], dim=1),
            kf,
        )
    return _refine(q, emb if emb_ref is None else emb_ref, best_d, best_i, k)


def _dedup_topk(d, ids, k: int):
    """Collapse duplicate ids in an ascending-by-distance [B, m] candidate
    list down to the k nearest DISTINCT ids.

    Spilled layouts hold each row at most twice, so a top-2k selection
    always contains the true top-k distinct rows. Among equal ids the
    earlier (nearer) slot survives, by a stable argsort of the ids; invalid
    slots (id -1, distance inf) sort to the tail either way. The final pick
    is by (distance, position), as the JAX package's index-stable
    ``lax.top_k``."""
    m = ids.shape[1]
    if k >= m:
        return d, ids
    order = torch.argsort(ids, dim=1, stable=True)
    ids_s = ids.gather(1, order)
    dup_s = torch.zeros_like(ids_s, dtype=torch.bool)
    dup_s[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    dup = torch.empty_like(dup_s).scatter_(1, order, dup_s)
    d_m = torch.where(dup, torch.inf, d)
    idx = torch.argsort(d_m, dim=1, stable=True)[:, :k]
    return d_m.gather(1, idx), torch.where(dup, -1, ids).gather(1, idx)


def _finalize_impl(q, d, ids, deleted, delta, k: int, spill: bool):
    """Shared epilogue of dynamic and spilled searchers, in the JAX
    package's order: tombstone filter -> exact delta scan ([B, m] scores,
    the best ``min(k, m)``, square roots) -> ``[main, delta]`` sorted
    stably by distance -> spilled id dedup -> trim to k. ``deleted`` is the
    padded tombstone bitmap or None, ``delta`` (f32 rows [m, d] rounded to
    the storage dtype, squared norms [m] with +inf on empty and deleted
    slots, ids [m] with -1 on empty slots) or None. Plain torch, no host synchronisation."""
    if deleted is not None:
        hit = (ids >= 0) & deleted[ids.clamp(0, deleted.shape[0] - 1).long()]
        d = torch.where(hit, torch.inf, d)
        ids = torch.where(hit, -1, ids)
    if delta is not None:
        de, se, ge = delta
        dd2 = se[None, :] - 2.0 * (q @ de.T) + (q * q).sum(dim=1)[:, None]
        # (value, position) order as lax.top_k's; a sort needs no host sync
        vals, didx = torch.sort(dd2, dim=1, stable=True)
        vals, didx = vals[:, : min(k, de.shape[0])], didx[:, : min(k, de.shape[0])]
        dead = torch.isinf(vals)
        dd = torch.where(dead, torch.inf, vals.clamp_min(0.0).sqrt())
        dgi = torch.where(dead, -1, ge[didx.long()])
        d = torch.cat([d, dd], dim=1)
        ids = torch.cat([ids, dgi.to(ids.dtype)], dim=1)
    # JAX merges a one-row +inf sentinel when there is no delta; it sorts
    # after every real slot, so leaving it out changes no result.
    order = torch.argsort(d, dim=1, stable=True)
    d, ids = d.gather(1, order), ids.gather(1, order)
    if spill:
        return _dedup_topk(d, ids, k)
    return d[:, :k], ids[:, :k]


class DeviceIvfSearcher:
    """Device-resident searcher over one embedding matrix + its IVF index."""

    #: Safety factor on the predicted probed-union tile count (mode
    #: "bincompact"): overflow drops the least-probed tiles.
    compact_slack: float = 1.35

    def __init__(
        self,
        index: IvfIndex,
        embeddings: np.ndarray,
        dtype: torch.dtype = torch.float32,
        row_tile: int = 2048,
        metric: str = "l2",
        cluster_sorted: bool = False,
        rescore_dtype="auto",
        device: str | torch.device | None = None,
    ):
        """``dtype``: storage, float32 or bfloat16. ``rescore_dtype``:
        "auto" keeps a full f32 copy beside bf16 storage, against which the
        winners are re-scored (selection runs at storage precision); None
        opts out. ``cluster_sorted`` permutes rows into cluster order; ids
        are mapped back to the original rows."""
        if metric not in ("l2", "cosine"):
            raise ValidationError(f"Unsupported metric '{metric}'")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValidationError(f"Unsupported storage dtype {dtype}")
        self.metric = metric
        self.device = resolve_device(device)
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if metric == "cosine":
            from ..index.metrics import normalize_rows

            embeddings = normalize_rows(embeddings)

        self._gid: np.ndarray | None = None
        # True when the resident layout holds duplicate rows (spilled
        # multi-assignment, ``with_spill``): public searches then select 2k
        # and dedup by original id. The SQL engine reads it to bound its
        # resident fetch.
        self._spill_dups = False
        if cluster_sorted and not np.array_equal(
            index.row_ids, np.arange(index.total_rows, dtype=index.row_ids.dtype)
        ):
            order = np.asarray(index.row_ids, dtype=np.int64)
            self._gid = order.astype(np.int32)
            embeddings = np.ascontiguousarray(embeddings[order])
            index = IvfIndex(
                dim=index.dim,
                n_clusters=index.n_clusters,
                centroids=index.centroids,
                list_offsets=index.list_offsets,
                row_ids=np.arange(index.total_rows, dtype=np.uint32),
            )
        n, d = embeddings.shape
        if d != index.dim:
            raise ValidationError(
                f"Embedding dim {d} does not match index dim {index.dim}"
            )
        self.index = index
        self.n = n
        self.dim = d
        self.row_tile = row_tile
        # Selection recall asked of the over-fetch modes ("scan", "approx",
        # "compact"). The selection here is exact, so any target is met
        # (see _approx_min_k_clamped); kept so both packages take one knob.
        self.approx_recall_target = 0.99
        # Their selection-score dtype: bfloat16 rounds the scores (winners
        # are re-scored in f32 either way).
        self.approx_score_dtype = torch.float32
        # Their fetch width per chunk (0 = max(4k, 64) for k <= 32, else 2k).
        self.scan_overfetch = 0
        # mode="cert": rows per tile (0 = 128, shrunk while k exceeds the
        # tile count), tiles gathered whole per query (0 = max(2k, 16)),
        # pass-1 precision ("highest", "high": both IEEE fp32 on the card,
        # "high" keeps the JAX package's wider slack; "storage": pass 1 over
        # the bf16 storage, slack + 2^-8) and pass-2 form ("auto", "fused",
        # "scan"). Results are exact for every setting; the knobs move how
        # often the exact fallback runs.
        self.tilescan_tile = 0
        self.cert_fetch_tiles = 0
        self.cert_pass1 = "highest"
        self.cert_pass2 = "auto"
        # mode="xbin"/"xbin8": bins (0 = _xbin_bins) and tile groups a step
        # (0 = auto by _XBIN_FUSE_BUDGET, -1 = one call); mode="tilescan":
        # rows a step (0 = auto by _TILESCAN_FUSE_BUDGET, -1 = one call) over
        # tiles of ``tilescan_tile`` rows (0 = 128, shrunk while k exceeds the
        # tile count).
        self.xbin_bins = 0
        self.xbin_chunk_groups = 0
        self.tilescan_chunk_rows = 0
        # The loops' re-score against the f32 copy: "body" in every
        # repetition, "defer" once after the last (which then selects 2k at
        # storage precision), "auto" defers past 3/4 of the device memory.
        self.loop_rescore = "auto"
        # mode="autoscan": how long one weather report holds, and the prober
        # (None = query/autotune.py:probe_weather).
        self.weather_ttl_s = 300.0
        self.weather_prober = None
        self._weather: tuple | None = None  # (monotonic time, report)
        self._hold_ref = False  # set while a deferred loop's body runs

        n_pad = _round_up(n + 1, row_tile)  # +1 sentinel row
        emb = np.zeros((n_pad, d), dtype=np.float32)
        emb[:n] = embeddings
        sq = np.full(n_pad, np.inf, dtype=np.float32)
        sq[:n] = np.einsum("nd,nd->n", embeddings, embeddings)
        self._sentinel = n  # any padded id points here (inf norm)

        dev = self.device
        self._emb_ref = None
        if rescore_dtype is not None and dtype != torch.float32:
            self._emb_ref = torch.from_numpy(emb).to(dev)
            self.emb = self._emb_ref.to(dtype)
        else:
            self.emb = torch.from_numpy(emb).to(dev, dtype)
        self._gid_dev = None if self._gid is None else torch.from_numpy(self._gid).to(dev)
        self._emb_sq_pallas = None  # lazy: finite-sentinel copy for kernels
        self._emb_i8 = None  # lazy: (codes, scale) for the int8 modes
        self._emb_i8_scale = None
        # (ctile, cap, nprobe, batch) of the last calibrate_bincompact
        self._bincompact_calibrated: tuple[int, int, int, int] | None = None
        self._tile_range_cache: dict[int, tuple] = {}
        # Dynamic updates (tombstone deletes, delta-buffer appends), merged
        # and filtered in _finalize. The SQL engine refuses its resident
        # path when they are set.
        self._id_domain = n  # original-id space; grows with appends
        self._deleted_host: np.ndarray | None = None  # bool over id domain
        self._deleted_dev = None
        self._delta: tuple | None = None  # (emb [m,d], sq [m], ids [m])
        self._delta_host: list[np.ndarray] = []
        self.emb_sq = torch.from_numpy(sq).to(dev)
        self.centroids = torch.from_numpy(np.array(index.centroids, np.float32)).to(dev)
        self.c_sq = (self.centroids * self.centroids).sum(dim=1)

        sizes = index.cluster_sizes()
        lmax = max(1, int(sizes.max()))
        table = np.full((index.n_clusters, lmax), self._sentinel, dtype=np.int32)
        for c in range(index.n_clusters):
            rows = index.cluster_rows(c)
            table[c, : rows.size] = rows
        self.clusters = torch.from_numpy(table).to(dev)

        # Per-row cluster id; pad rows use the extra slot (n_clusters) that
        # is never set in a probe mask.
        row_cluster = np.full(n_pad, index.n_clusters, dtype=np.int32)
        row_cluster[index.row_ids] = np.repeat(
            np.arange(index.n_clusters, dtype=np.int32), sizes
        )
        self.row_cluster = torch.from_numpy(row_cluster).to(dev)
        self._row_cluster_host = row_cluster
        self._row_cluster_sorted = bool(np.all(np.diff(row_cluster) >= 0))
        self._tile_tables: dict[int, tuple[torch.Tensor, torch.Tensor, int]] = {}
        self._cmax_cache: dict[int, int] = {}

    @classmethod
    def from_parquet(
        cls,
        path: str | os.PathLike,
        dtype: torch.dtype = torch.float32,
        row_tile: int = 2048,
        spill: float = 0.0,
        assign_dtype: torch.dtype = torch.float32,
        rescore_dtype="auto",
        cluster_sorted: bool = False,
        device: str | torch.device | None = None,
    ) -> "DeviceIvfSearcher":
        """Resident searcher from an indexed Parquet file. ``spill`` > 0
        builds the spilled multi-assignment layout (see ``with_spill``, which
        implies ``cluster_sorted``), the knob that
        ``Session.device_searcher(name, spill=...)`` forwards. The searcher
        carries the file's provenance (``source_path``, ``source_column``
        and ``source_key`` = (size, mtime in ns), (-1, -1) where the file
        cannot be stat'ed), by which a caller can reject a searcher built
        before a re-index."""
        index, column = read_index_from_parquet(path)
        emb = read_embedding_column(path, column)
        kwargs = dict(dtype=dtype, row_tile=row_tile, metric=read_index_metric(path),
                      rescore_dtype=rescore_dtype, device=device)
        if spill:
            searcher = cls.with_spill(index, emb.data, spill=spill,
                                      assign_dtype=assign_dtype, **kwargs)
        else:
            searcher = cls(index, emb.data, cluster_sorted=cluster_sorted, **kwargs)
        searcher.source_path = os.fspath(path)
        searcher.source_column = column.name
        try:
            st = os.stat(path)
            searcher.source_key = (st.st_size, st.st_mtime_ns)
        except OSError:
            searcher.source_key = (-1, -1)
        return searcher

    # ------------------------------------------------------------------

    def _check_queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValidationError(
                f"Query dimension mismatch: expected {self.dim}, got {tuple(q.shape)}"
            )
        if self.metric == "cosine":
            norms = (q * q).sum(dim=1, keepdim=True).sqrt()
            q = q / norms.clamp_min(1e-30)
        return q.contiguous()

    def _scan_tile(self) -> int:
        """Rows per scan-kernel tile: the largest divisor of ``row_tile``
        that is at most 1024 (see ``_SCAN_TILE_CAP``). It divides the padded
        row count because ``row_tile`` does."""
        tile = self.row_tile
        while tile > _SCAN_TILE_CAP and tile % 2 == 0:
            tile //= 2
        return tile

    def _can_stream_masked(self, k: int) -> bool:
        """K3 needs the per-tile cluster tables of a sorted layout and k that
        fits a kernel's top-k list. Its probe mask lives in device memory,
        so unlike the TPU kernel it has no batch cap."""
        return self._row_cluster_sorted and k <= MAX_K

    def _use_local_mask(self, tile: int, batch: int) -> bool:
        """K4 needs sorted cluster ids and a bounded [nt, B, cmax] local mask."""
        if not self._row_cluster_sorted:
            return False
        nt = self.emb.shape[0] // tile
        return nt * batch * self._cmax_for_tile(tile) * 4 <= _LOCAL_MASK_CAP

    def _cmax_for_tile(self, tile: int) -> int:
        """Distinct clusters of the fullest tile, without building the table:
        for sorted ids it is run boundaries within a tile + 1. The TPU's
        128-lane floor does not apply."""
        cached = self._tile_tables.get(tile)
        if cached is not None:
            return cached[2]
        if tile not in self._cmax_cache:
            parts = self._row_cluster_host.reshape(-1, tile)
            self._cmax_cache[tile] = int((np.diff(parts, axis=1) != 0).sum(axis=1).max()) + 1
        return self._cmax_cache[tile]

    def _max_probe_bucket(self, nprobe: int) -> int:
        """Power-of-two max_probe bucket (floor 128), as in the JAX package;
        the mask keeps the first nprobe of them either way."""
        max_probe = 1
        while max_probe < nprobe:
            max_probe *= 2
        return min(max(max_probe, min(128, self.index.n_clusters)),
                   self.index.n_clusters)

    def _tile_cluster_table(self, tile: int):
        """(local_cluster [n_pad] i32, tile_clusters [nt, cmax] i32, cmax):
        each tile's distinct clusters, and each row's slot among them. Pad
        slots hold the sentinel cluster n_clusters, whose mask bit is never
        set."""
        if tile not in self._tile_tables:
            rc = self._row_cluster_host
            nt = rc.size // tile
            parts = rc.reshape(nt, tile)
            uniques = [np.unique(parts[t]) for t in range(nt)]
            cmax = max(u.size for u in uniques)
            tc = np.full((nt, cmax), self.index.n_clusters, dtype=np.int32)
            lcl = np.empty((nt, tile), dtype=np.int32)
            for t, u in enumerate(uniques):
                tc[t, : u.size] = u
                lcl[t] = np.searchsorted(u, parts[t])
            self._tile_tables[tile] = (
                torch.from_numpy(lcl.reshape(-1)).to(self.device),
                torch.from_numpy(tc).to(self.device),
                cmax,
            )
        return self._tile_tables[tile]

    def _pallas_emb_sq(self) -> torch.Tensor:
        """Squared norms with the kernels' finite +3e38 pad sentinel."""
        if self._emb_sq_pallas is None:
            self._emb_sq_pallas = torch.where(
                torch.isinf(self.emb_sq), 3.0e38, self.emb_sq
            )
        return self._emb_sq_pallas

    def _ref(self):
        """Full-precision re-score rows, or None when ``self.emb`` already
        is the reference (f32 storage / re-score opt-out) or a deferred
        loop's body holds the reference back (``_loop_defer_rescore``)."""
        return None if self._hold_ref else self._emb_ref

    def _i8_ref(self):
        """The rows the int8 modes re-score against: the f32 copy where one
        is held and not held back, else the storage rows."""
        ref = self._ref()
        return self.emb if ref is None else ref

    def _ref_or_emb(self):
        """The array exact re-scores run against."""
        return self._emb_ref if self._emb_ref is not None else self.emb

    def _xbin8_arrays(self):
        """Lazy per-row int8 codes and scales of the resident rows for the
        int8 modes (+25% of the f32 residency). They quantize from the f32
        reference when one is held: int8 from bf16-rounded rows would stack
        both errors."""
        if self._emb_i8 is None:
            self._emb_i8, self._emb_i8_scale = _quantize_rows_i8(self._ref_or_emb())
        return self._emb_i8, self._emb_i8_scale

    # -- binned-min scan geometry (the JAX package's rules, so that one
    #    searcher has the same bins, and so the same recall, in both) ------

    def _binscan_vmem_ok(self, tile: int, expand: int = 1, esize: int | None = None) -> bool:
        """Whether the JAX kernel's working-set model admits this tile with
        a query block of at least 256 (``binscan_b_tile``). ``esize``
        overrides the element size (1 for the int8 modes)."""
        if esize is None:
            esize = self.emb.element_size()
        return binscan_b_tile(tile, self.dim, esize, expand) >= 256

    def _binscan_expand(self, tile: int, cap: int | None = None,
                        esize: int | None = None) -> int:
        """Largest bin expansion (bins = expand * tile): bounded by the
        tiles (or the selected cap) covering every slab block and by the
        working-set model."""
        n_lg = tile // 128
        nt = int(self.emb.shape[0]) // tile if cap is None else int(cap)
        for e in (4, 2):
            if nt >= e * n_lg and self._binscan_vmem_ok(tile, expand=e, esize=esize):
                return e
        return 1

    def _binscan_tile(self, esize: int | None = None) -> int:
        """Largest lane-aligned tile dividing the padded rows that the
        working-set model admits: bins = tile, and cross-tile bin
        collisions are the modes' only recall loss."""
        n_pad = int(self.emb.shape[0])
        for t in (2048, 1024, 512, 256, 128):
            if n_pad % t == 0 and self._binscan_vmem_ok(t, esize=esize):
                return t
        raise ValidationError(
            f"padded row count {n_pad} is not lane-aligned for binscan"
        )

    def can_binscan(self, k: int = 10, esize: int | None = None) -> bool:
        """Whether the binned-min scan takes this array and k (bins and the
        provenance budget). ``esize=1`` gates ``binscan8``."""
        k = self._spill_k(k)  # spilled searches select 2k for the dedup
        try:
            t = self._binscan_tile(esize=esize)
        except ValidationError:
            return False
        nt = int(self.emb.shape[0]) // t
        return k <= t and provenance_bits(nt, t) <= PROVENANCE_BITS_MAX

    def _binscan(self, q, k: int, int8: bool):
        esize = 1 if int8 else None
        tile = self._binscan_tile(esize=esize)
        e8, sc = self._xbin8_arrays() if int8 else (self.emb, None)
        try:
            return binned_scan(
                q, e8, self._pallas_emb_sq(), k, tile=tile,
                expand=self._binscan_expand(tile, esize=esize), scale=sc,
                emb_ref=self._i8_ref() if int8 else self._ref(),
            )
        except ValueError as exc:
            raise ValidationError(str(exc)) from exc

    # -- probed-union selection (bincompact) ------------------------------

    def _compact_probe_bucket(self, nprobe: int) -> int:
        """Power-of-two probe bucket for the probed-union modes (floor 8)."""
        p = 8
        while p < nprobe:
            p *= 2
        return min(p, self.index.n_clusters)

    def _compact_tile_ranges(self, ctile: int):
        """(tile_lo, tile_hi [kc] int32 on the device, max_cluster_tiles)
        for a cluster-sorted layout, or (None, None, 0). An empty cluster
        covers its start tile, as in the JAX package."""
        if not self._row_cluster_sorted:
            return None, None, 0
        if ctile not in self._tile_range_cache:
            rc = self._row_cluster_host
            kc = self.index.n_clusters
            nt = self.emb.shape[0] // ctile
            offsets = np.searchsorted(rc, np.arange(kc + 1), side="left")
            lo = (offsets[:-1] // ctile).astype(np.int32)
            hi = ((np.maximum(offsets[1:], offsets[:-1] + 1) - 1) // ctile).astype(np.int32)
            hi = np.minimum(hi, nt - 1)
            span = int((hi - lo + 1).max()) if kc else 0
            self._tile_range_cache[ctile] = (
                torch.from_numpy(lo).to(self.device),
                torch.from_numpy(hi).to(self.device),
                span,
            )
        return self._tile_range_cache[ctile]

    def calibrate_bincompact(self, queries, nprobe: int, k: int = 10,
                             slack: float = 1.15, bucket: int = 128,
                             esize: int | None = None):
        """Pin the bincompact tile budget to the probed-union size MEASURED
        on a representative batch (host numpy), with ``slack`` headroom,
        rounded up to ``bucket`` tiles. Returns (ctile, cap), or (0, 0) when
        ineligible (unsorted layout, provenance budget). The point applies
        only to searches at or below this (nprobe, batch); clear it with
        ``self._bincompact_calibrated = None``."""
        self._bincompact_calibrated = None
        if not self._row_cluster_sorted:
            return (0, 0)
        k = self._spill_k(k)  # spilled searches run the impls at 2k
        q = np.asarray(
            queries.cpu() if isinstance(queries, torch.Tensor) else queries, np.float32
        )
        if q.ndim == 1:
            q = q[None, :]
        nprobe = min(max(1, nprobe), self.index.n_clusters)
        cent = np.asarray(self.index.centroids, np.float32)
        d2 = np.einsum("kd,kd->k", cent, cent)[None, :] - 2.0 * (q @ cent.T)
        kp = min(nprobe, cent.shape[0])
        probe = (
            np.argpartition(d2, kp - 1, axis=1)[:, :kp]
            if kp < cent.shape[0]
            else np.broadcast_to(np.arange(cent.shape[0]), d2.shape)
        )
        active = np.unique(probe)
        n_pad = int(self.emb.shape[0])
        for ctile in (2048, 1024, 512):
            if n_pad % ctile or k > ctile:
                continue
            if not self._binscan_vmem_ok(ctile, esize=esize):
                continue
            nt = n_pad // ctile
            lo_t, hi_t, _ = self._compact_tile_ranges(ctile)
            lo = lo_t.cpu().numpy()[active]
            hi = hi_t.cpu().numpy()[active]
            # active tiles by interval stabbing (a shared tile counts once)
            mark = np.zeros(nt + 1, np.int64)
            np.add.at(mark, lo, 1)
            np.add.at(mark, hi + 1, -1)
            n_active = int((np.cumsum(mark[:-1]) > 0).sum())
            cap = int(-(-(n_active * slack) // bucket) * bucket)
            cap = max(1, min(nt, cap))
            # a measured cap may use the full packed-key budget
            if provenance_bits(cap, ctile) <= PROVENANCE_BITS_MAX:
                self._bincompact_calibrated = (ctile, cap, nprobe, q.shape[0])
                return (ctile, cap)
        return (0, 0)

    def _compact_bin_params(self, batch: int, nprobe: int, k: int,
                            esize: int | None = None):
        """(ctile, cap_tiles) for bincompact, or (0, 0). A calibration
        applies within its operating point; otherwise the expected distinct
        probed clusters (birthday bound over batch * nprobe draws) x tiles
        per cluster x ``compact_slack``, kept one provenance bit under the
        budget because the cap is predicted, not measured."""
        cal = self._bincompact_calibrated
        if cal and k <= cal[0] and nprobe <= cal[2] and batch <= cal[3] \
                and self._binscan_vmem_ok(cal[0], esize=esize):
            return cal[0], cal[1]
        n_pad = int(self.emb.shape[0])
        kc = max(self.index.n_clusters, 1)
        draws = batch * nprobe
        expected = kc * (1.0 - (1.0 - 1.0 / kc) ** draws)
        for ctile in (2048, 1024, 512):
            if n_pad % ctile or k > ctile:
                continue
            if not self._binscan_vmem_ok(ctile, esize=esize):
                continue
            nt = n_pad // ctile
            tiles_per = (self.n / kc) / ctile + 1.0
            cap = int(min(nt, -(-expected * tiles_per * self.compact_slack // 1)))
            cap = max(cap, 1)
            if provenance_bits(cap, ctile) <= PROVENANCE_BITS_MAX - 1:
                return ctile, cap
        return 0, 0

    def bincompact_coverage(self, batch: int, nprobe: int, k: int = 10,
                            esize: int | None = None) -> float:
        """Fraction of the row tiles bincompact would read (cap / nt), 1.0
        when ineligible."""
        ctile, cap = self._compact_bin_params(batch, nprobe, self._spill_k(k),
                                              esize=esize)
        if not ctile:
            return 1.0
        return cap / max(int(self.emb.shape[0]) // ctile, 1)

    def _bincompact(self, q, k: int, nprobe: int, int8: bool):
        esize = 1 if int8 else None
        ctile, cap = self._compact_bin_params(q.shape[0], nprobe, k, esize=esize)
        if not ctile:
            raise ValidationError(
                f"bincompact{'8' if int8 else ''} ineligible for this shape "
                "(provenance bits or tile alignment)"
            )
        tlo, thi, span = self._compact_tile_ranges(ctile)
        sel = _compact_select(
            q, self.centroids, self.c_sq, self.row_cluster, nprobe,
            self._compact_probe_bucket(nprobe), ctile, cap, tlo, thi, span,
            int(self.emb.shape[0]),
        )
        e8, sc = self._xbin8_arrays() if int8 else (self.emb, None)
        try:
            return binned_scan_select(
                q, e8, self._pallas_emb_sq(), sel, k, tile=ctile,
                expand=self._binscan_expand(ctile, cap=cap, esize=esize), scale=sc,
                emb_ref=self._i8_ref() if int8 else self._ref(),
            )
        except ValueError as exc:
            raise ValidationError(str(exc)) from exc

    # -- certified-exact scan (cert) ---------------------------------------

    def _cert_pass1_mode(self) -> tuple[bool, bool]:
        """The ``cert_pass1`` knob as (pass1_high, pass1_storage)."""
        if self.cert_pass1 not in ("highest", "high", "storage"):
            raise ValidationError(
                f"cert_pass1 must be 'highest', 'high' or 'storage', "
                f"got {self.cert_pass1!r}"
            )
        return self.cert_pass1 == "high", self.cert_pass1 == "storage"

    def _cert_tile_checked(self, k: int, what: str = "cert") -> int:
        """Rows per tile of ``cert`` (and of ``tilescan``, named by
        ``what``): ``tilescan_tile``, or 128 shrunk while k exceeds the tile
        count. A cluster-sorted layout is fine for ``cert``: the selected
        tiles are gathered whole, so neighbours that share a tile all
        become candidates."""
        n_pad = int(self.emb.shape[0])
        t = int(self.tilescan_tile)
        if not t:
            t = min(n_pad & -n_pad, 128)
            while t > 2 and k > n_pad // t:
                t //= 2
        if t < 2 or n_pad % t or (t & (t - 1)):
            raise ValidationError(
                f"{what} tile={t} invalid for n_pad={n_pad}: must be a "
                "power of two >= 2 dividing the padded row count"
            )
        return t

    def can_cert(self, k: int = 10) -> bool:
        """Whether the certified-exact scan takes this array and k."""
        try:
            self._cert_tile_checked(self._spill_k(k))
        except ValidationError:
            return False
        return True

    def _exact_fallback(self, q, k: int):
        """The exact path ``cert`` falls back to: K2 while k fits a kernel's
        list, the plain scan beyond. It scans the f32 reference where one
        is held, so a refused certificate still returns the f32-exact
        top-k (the JAX package re-runs at storage precision with a 2k
        shortlist, which is exact only up to bf16 selection)."""
        src = self._ref_or_emb()
        if k <= MAX_K:
            return stream_exact_topk(
                q, src, self._pallas_emb_sq(), k, tile=self._scan_tile()
            )
        return _exact_topk_impl(q, src, self.emb_sq, k, self.row_tile)

    def _cert(self, q, k: int, diagnostic: bool = False):
        p1h, p1s = self._cert_pass1_mode()
        if self.cert_pass2 not in ("auto", "fused", "scan"):
            raise ValidationError(
                f"cert_pass2 must be 'auto', 'fused' or 'scan', got {self.cert_pass2!r}"
            )
        return _exact_cert_impl(
            q, self.emb, self.emb_sq, k, tile=self._cert_tile_checked(k),
            fallback=lambda: self._exact_fallback(q, k),
            m_tiles=self.cert_fetch_tiles, emb_ref=self._ref(),
            pass1_high=p1h, pass1_storage=p1s, diagnostic=diagnostic,
            pass2_form=self.cert_pass2,
        )

    def cert_probe(self, queries, k: int = 10):
        """Certificate diagnosis for the current cert knobs: the cert
        pipeline without its fallback -> (certified fraction, margins [B] as
        numpy). A margin >= 0 means the query's certificate holds; the
        margins say how much room, in squared-distance units, the data's
        tile-min gaps leave over the arithmetic slack."""
        q = self._check_queries(queries)
        _, _, okq, margin = self._cert(q, self._spill_k(k), diagnostic=True)
        return float(okq.float().mean()), margin.cpu().numpy()

    # -- packed-key scans (xbin, xbin8, tilescan) ---------------------------

    def can_xbin(self, k: int = 10) -> bool:
        """Whether ``xbin``/``xbin8`` take this array and k: a bin count that
        divides the padded rows, holds k and fits the provenance budget
        (``_xbin_bins``)."""
        return _xbin_bins(int(self.emb.shape[0]), self._spill_k(k)) > 0

    def can_tilescan(self, k: int = 10) -> bool:
        """Whether ``tilescan`` takes this array and k
        (``_tilescan_tile_checked``)."""
        try:
            self._tilescan_tile_checked(self._spill_k(k))
        except ValidationError:
            return False
        return True

    def _tilescan_tile_checked(self, k: int) -> int:
        """Rows per tile of ``tilescan``: ``cert``'s tile rule, refused on a
        cluster-sorted layout (a tile keeps only its best row, and sorted
        rows put a cluster's neighbours in one tile, where the others are
        lost for good), beyond the provenance budget and where k exceeds the
        tile count."""
        if self._row_cluster_sorted:
            raise ValidationError(
                "tilescan is ineligible on cluster-sorted layouts: "
                "contiguous same-cluster neighbors fall into one tile and "
                "only the tile argmin survives; use binscan/scan instead"
            )
        n_pad = int(self.emb.shape[0])
        t = self._cert_tile_checked(k, what="tilescan")
        if (t - 1).bit_length() > PROVENANCE_BITS_MAX:
            raise ValidationError(
                f"tilescan tile={t} spends {(t - 1).bit_length()} "
                f"provenance bits (max {PROVENANCE_BITS_MAX}): too few "
                "value mantissa bits for reliable selection"
            )
        if not 0 < k <= n_pad // t:
            raise ValidationError(
                f"tilescan ineligible: k={k} exceeds the {n_pad // t} "
                "tiles (each contributes one candidate)"
            )
        return t

    def _xbin_bins_checked(self, k: int) -> int:
        """Bins of ``xbin``/``xbin8``: ``xbin_bins`` checked, or
        ``_xbin_bins`` (``_checked_bins``)."""
        return _checked_bins(int(self.emb.shape[0]), k, int(self.xbin_bins), "xbin_bins")

    def _xbin(self, q, k: int, int8: bool):
        l_bins = self._xbin_bins_checked(k)
        chunk = _xbin_auto_chunk(q.shape[0], int(self.emb.shape[0]), l_bins,
                                 self.xbin_chunk_groups)
        if int8:
            e8, sc = self._xbin8_arrays()
            return _exact_xbin8_impl(
                q, e8, sc, self.emb_sq, self._i8_ref(), k, l_bins,
                overfetch=self.scan_overfetch, chunk_groups=chunk,
            )
        return _exact_xbin_impl(
            q, self.emb, self.emb_sq, k, l_bins, score_dtype=self.approx_score_dtype,
            overfetch=self.scan_overfetch, chunk_groups=chunk, emb_ref=self._ref(),
        )

    def _tilescan(self, q, k: int):
        return _exact_tilescan_impl(
            q, self.emb, self.emb_sq, k, tile=self._tilescan_tile_checked(k),
            chunk_rows=self.tilescan_chunk_rows, overfetch=self.scan_overfetch,
            emb_ref=self._ref(),
        )

    # -- the loops' re-score --------------------------------------------------

    def _hbm_bytes(self) -> int:
        """Device memory the loops' re-score policy reasons against:
        ``PQVECTOR_TPU_HBM_GB`` GiB when set, else the card's total memory
        (fixed per card; reading it needs no synchronisation), else the JAX
        package's default of 16 GiB (the CPU)."""
        env = os.environ.get("PQVECTOR_TPU_HBM_GB")
        if env:
            return int(float(env) * 2**30)
        if self.device.type == "cuda":
            return int(torch.cuda.get_device_properties(self.device).total_memory)
        return 16 * 2**30

    def _loop_defer_rescore(self) -> bool:
        """Whether ``search_loop``/``exact_loop`` hold the f32 copy out of
        their repetitions (``loop_rescore``): each then selects 2k at
        storage precision and only the last one's winners are re-scored
        against the copy. ``auto`` defers where the storage, the copy and a
        second copy of each (the JAX package's loop carries them) pass 3/4
        of the device memory, as the JAX package decides."""
        if self._emb_ref is None:
            return False
        if self.loop_rescore != "auto":
            if self.loop_rescore not in ("body", "defer"):
                raise ValidationError("loop_rescore must be 'auto', 'body' or 'defer'")
            return self.loop_rescore == "defer"
        n_pad, d = int(self.emb.shape[0]), int(self.emb.shape[1])
        live = 2 * n_pad * d * (4 + self.emb.dtype.itemsize)
        return live > 0.75 * self._hbm_bytes()

    # -- the weather-routed scan (autoscan) ----------------------------------

    def scan_route(self, queries, k: int = 10, *, budget_s: float = 1.0,
                   force: bool = False) -> str:
        """The mode ``autoscan`` resolves to: ``scan`` while the weather
        report (``probe_weather`` on at most 256 of the queries, or
        ``weather_prober``) is healthy, ``binscan`` (K7) while it reports
        degraded; ``scan`` always where binscan cannot serve the shape. A
        report holds for ``weather_ttl_s`` seconds; ``force`` probes anew."""
        if not self.can_binscan(k):
            return "scan"
        now = time.monotonic()
        if force or self._weather is None or now - self._weather[0] > self.weather_ttl_s:
            prober = self.weather_prober
            if prober is None:
                from .autotune import probe_weather as prober
            q = queries if isinstance(queries, torch.Tensor) else np.asarray(
                queries, np.float32)
            rep = prober(self, q[: min(256, len(q))], k, budget_s=budget_s)
            self._weather = (now, rep)
        return "binscan" if self._weather[1].degraded else "scan"

    # -- over-fetch modes (scan, approx, compact) --------------------------

    def _approx_chunk(self, batch: int) -> int:
        """Rows per score chunk of the over-fetch modes: 64 row tiles,
        lowered in steps of a row tile until the [B, chunk] f32 score block
        stays within 1 GiB. The card has no fused extraction that would
        keep the block out of device memory, so the chunk is always
        bounded; the selection is exact, so the chunking changes no
        result."""
        chunk = min(int(self.emb.shape[0]), 64 * self.row_tile)
        while chunk > self.row_tile and batch * chunk * 4 > _APPROX_BLOCK_CAP:
            chunk -= self.row_tile
        return chunk

    def _compact_params(self, batch: int, nprobe: int, k: int) -> tuple[int, int, int]:
        """(ctile, cap_tiles, chunk) of ``compact``. ctile: the largest
        power of two up to 512 dividing ``row_tile``. cap: the expected
        distinct probed clusters (birthday bound over batch * nprobe draws)
        x tiles per cluster x ``compact_slack``, clamped to the tile count.
        chunk: the compacted block (64k rows at k > 32, as in the JAX
        package), bounded like ``_approx_chunk``."""
        ctile = self.row_tile
        for cand in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
            if self.row_tile % cand == 0:
                ctile = cand
                break
        nt = int(self.emb.shape[0]) // ctile
        kc = max(self.index.n_clusters, 1)
        expected = kc * (1.0 - (1.0 - 1.0 / kc) ** (batch * nprobe))
        tiles_per = (self.n / kc) / ctile + 1.0
        cap = int(min(nt, -(-expected * tiles_per * self.compact_slack // 1)))
        cap = max(cap, 1)
        rows_c = cap * ctile
        chunk = min(rows_c, 65536) if k > 32 else rows_c
        bound = max(ctile, _APPROX_BLOCK_CAP // (4 * batch) // ctile * ctile)
        return ctile, cap, min(chunk, bound)

    def compact_coverage(self, batch: int, nprobe: int, k: int = 10) -> float:
        """Fraction of the row tiles ``compact`` gathers (cap / nt)."""
        ctile, cap, _ = self._compact_params(batch, nprobe, self._spill_k(k))
        return cap / max(int(self.emb.shape[0]) // ctile, 1)

    def _compact(self, q, k: int, nprobe: int):
        ctile, cap, chunk = self._compact_params(q.shape[0], nprobe, k)
        tlo, thi, span = self._compact_tile_ranges(ctile)
        return _ivf_compact_approx_impl(
            q, self.centroids, self.c_sq, self.row_cluster, self.emb, self.emb_sq,
            nprobe, k, max_probe=self._compact_probe_bucket(nprobe), ctile=ctile,
            cap_tiles=cap, chunk=chunk, recall_target=self.approx_recall_target,
            score_dtype=self.approx_score_dtype, tile_lo=tlo, tile_hi=thi,
            max_cluster_tiles=span, emb_ref=self._ref(),
        )

    def _scan(self, q, k: int):
        return _exact_approx_topk_impl(
            q, self.emb, self.emb_sq, k, chunk=self._approx_chunk(q.shape[0]),
            recall_target=self.approx_recall_target,
            score_dtype=self.approx_score_dtype, overfetch=self.scan_overfetch,
            emb_ref=self._ref(),
        )

    def _map_ids(self, d2, ids):
        invalid = torch.isinf(d2) | (ids >= self.n) | (ids < 0)
        if self._gid_dev is not None:
            ids = self._gid_dev[ids.clamp(0, self.n - 1).long()]
        return torch.where(invalid, -1, ids)

    # ------------------------------------------------------------------

    def _exact_impl(self, queries, k: int, mode: str = "auto"):
        """Exact brute-force top-k over the static layout -> (sqrt distances
        [B, k], ids [B, k]).

        ``auto`` takes K2 (``stream``) for k <= 128, the most a kernel's
        top-k list holds, and the plain torch scan (``xla``) beyond. Unlike
        the TPU, where the unrolled extraction passes capped the kernel at
        k <= 32, the card's kernel inserts into a list in shared memory, so
        its cost grows with the inserts and not with k. ``pallas`` takes K5
        (per-tile lists, then a cross-tile merge); ``binscan``/``binscan8``
        the binned-min scan K7, whose selection misses only on cross-tile
        bin collisions. ``cert`` is the certified-exact two-pass scan (K9,
        see ``_exact_cert_impl``), exact like ``stream``; ``approx`` the
        chunked scan with over-fetch and f32 re-score; ``xbin``, ``xbin8`` and
        ``tilescan`` the packed-key scans in plain torch
        (``_exact_xbin_impl``, ``_exact_xbin8_impl``,
        ``_exact_tilescan_impl``)."""
        q = self._check_queries(queries)
        d2, ids = self._exact_raw(q, k, mode)
        return d2.sqrt(), self._map_ids(d2, ids)

    def _exact_raw(self, q, k: int, mode: str):
        """``_exact_impl`` on checked queries, before the square roots and
        the id map -> (d2 [B, k], layout ids [B, k])."""
        if k <= 0:
            raise ValidationError("k must be > 0")
        if mode == "auto":
            mode = "stream" if k <= MAX_K else "xla"
        if mode in ("stream", "pallas"):
            if k > MAX_K:
                raise ValidationError(f"{mode} mode needs k <= {MAX_K}")
            run = stream_exact_topk if mode == "stream" else exact_topk
            d2, ids = run(
                q, self.emb, self._pallas_emb_sq(), k, tile=self._scan_tile(),
                emb_ref=self._ref(),
            )
        elif mode == "xla":
            d2, ids = _exact_topk_impl(
                q, self.emb, self.emb_sq, k, self.row_tile, emb_ref=self._ref()
            )
        elif mode in ("binscan", "binscan8"):
            d2, ids = self._binscan(q, k, int8=mode == "binscan8")
        elif mode == "cert":
            d2, ids = self._cert(q, k)
        elif mode == "approx":
            d2, ids = self._scan(q, k)
        elif mode in ("xbin", "xbin8"):
            d2, ids = self._xbin(q, k, int8=mode == "xbin8")
        elif mode == "tilescan":
            d2, ids = self._tilescan(q, k)
        else:
            raise ValidationError(f"Unknown exact mode '{mode}'")
        return d2, ids

    def _unsorted_auto(self, batch: int, nprobe: int) -> str:
        """``auto``'s route on a layout in file order: K6 (``pallas``) or
        ``gather``, whichever the cost model fit on the H100 predicts is
        faster. K6's cost grows with the rows of the chunks it scores times
        the padded batch, the gather's with its candidate rows."""
        backend = score_tile.pick_backend(self.emb.dtype, self.dim)
        queries = score_tile.masked_block_queries(backend)
        share = _k6_chunk_share(min(batch, queries), nprobe, self.index.n_clusters)
        triples = int(self.emb.shape[0]) * self.dim * _round_up(batch, queries) * share
        k6_ms = _K6_MS + _K6_MS_PER_G[backend] * triples / 1e9
        cand = batch * nprobe * int(self.clusters.shape[1])
        gather_ms = _GATHER_MS + _GATHER_MS_PER_M * cand / 1e6
        return "pallas" if k6_ms <= gather_ms else "gather"

    def _search_impl(self, queries, k: int, nprobe: int, mode: str = "auto"):
        """IVF top-k over the static layout -> (sqrt distances [B, k], ids
        [B, k]).

        ``auto`` on a cluster-sorted layout with k <= 128 takes K4
        (``pallas``) while its [nt, B, cmax] local mask stays within 256 MB,
        and K3 (``stream``) beyond: K3 builds the probe test from the
        [B, kc_pad] mask and scans only the active tiles. On a layout in
        file order with k <= 128 it takes K6 (``pallas``) or ``gather`` by
        the rule of ``_unsorted_auto``, measured on the card; k > 128 takes
        ``gather``. ``pallas`` runs K4 where its local mask fits and K6
        (global probe mask, any layout) otherwise. ``binscan``/``binscan8``
        ignore nprobe and scan every row (K7); ``bincompact``/``bincompact8``
        scan the batch's probed-union tiles, capped (K8). ``masked`` is the
        masked full scan in plain torch and ``approx`` the same scan with
        over-fetch extraction; ``compact`` gathers the probed-union tiles
        (K10) and extracts over that block; ``scan``, ``cert``, ``xbin``,
        ``xbin8`` and ``tilescan`` ignore nprobe: the over-fetch full scan,
        the certified-exact scan (K9) and the packed-key scans."""
        q = self._check_queries(queries)
        d2, ids = self._search_raw(q, k, nprobe, mode)
        return d2.sqrt(), self._map_ids(d2, ids)

    def _search_raw(self, q, k: int, nprobe: int, mode: str):
        """``_search_impl`` on checked queries, before the square roots and
        the id map -> (d2 [B, k], layout ids [B, k])."""
        if k <= 0:
            raise ValidationError("k must be > 0")
        if nprobe <= 0:
            raise ValidationError("nprobe must be > 0")
        nprobe = min(nprobe, self.index.n_clusters)
        tile = self._scan_tile()
        if mode == "auto":
            if k > MAX_K:
                mode = "gather"
            elif self._can_stream_masked(k):
                mode = "pallas" if self._use_local_mask(tile, q.shape[0]) else "stream"
            else:
                mode = self._unsorted_auto(q.shape[0], nprobe)

        if mode == "stream" or (mode == "pallas" and self._use_local_mask(tile, q.shape[0])):
            if not self._can_stream_masked(k):
                raise ValidationError(
                    f"{mode} mode needs a cluster-sorted layout and k <= {MAX_K}"
                )
            lcl, tc, _ = self._tile_cluster_table(tile)
            run = masked_local_topk if mode == "pallas" else stream_masked_topk
            d2, ids = run(
                q, self.centroids, self.c_sq, lcl, tc, self.emb,
                self._pallas_emb_sq(), nprobe, k,
                max_probe=self._max_probe_bucket(nprobe), tile=tile,
                emb_ref=self._ref(),
            )
        elif mode == "pallas":
            if k > MAX_K:
                raise ValidationError(f"pallas mode needs k <= {MAX_K}")
            d2, ids = masked_topk(
                q, self.centroids, self.c_sq, self.row_cluster, self.emb,
                self._pallas_emb_sq(), nprobe, k,
                max_probe=self._max_probe_bucket(nprobe), tile=tile,
                emb_ref=self._ref(),
            )
        elif mode == "gather":
            d2, ids = _ivf_topk_impl(
                q, self.centroids, self.c_sq, self.clusters, self.emb,
                self.emb_sq, k, nprobe, min(self.row_tile, 2048),
                emb_ref=self._ref(),
            )
        elif mode in ("binscan", "binscan8"):
            d2, ids = self._binscan(q, k, int8=mode == "binscan8")
        elif mode in ("bincompact", "bincompact8"):
            d2, ids = self._bincompact(q, k, nprobe, int8=mode == "bincompact8")
        elif mode == "masked":
            d2, ids = _ivf_masked_scan_impl(
                q, self.centroids, self.c_sq, self.row_cluster, self.emb,
                self.emb_sq, nprobe, k, max_probe=self._max_probe_bucket(nprobe),
                tile=self.row_tile, emb_ref=self._ref(),
            )
        elif mode == "approx":
            d2, ids = _ivf_approx_masked_impl(
                q, self.centroids, self.c_sq, self.row_cluster, self.emb,
                self.emb_sq, nprobe, k, max_probe=self._max_probe_bucket(nprobe),
                chunk=self._approx_chunk(q.shape[0]),
                recall_target=self.approx_recall_target,
                score_dtype=self.approx_score_dtype,
                overfetch=self.scan_overfetch, emb_ref=self._ref(),
            )
        elif mode == "compact":
            d2, ids = self._compact(q, k, nprobe)
        elif mode == "scan":
            d2, ids = self._scan(q, k)
        elif mode == "cert":
            d2, ids = self._cert(q, k)
        elif mode in ("xbin", "xbin8"):
            d2, ids = self._xbin(q, k, int8=mode == "xbin8")
        elif mode == "tilescan":
            d2, ids = self._tilescan(q, k)
        else:
            raise ValidationError(f"Unknown search mode '{mode}'")
        return d2, ids

    def _search_loop_impl(self, queries, k: int, nprobe: int, reps: int = 16,
                          mode: str = "auto"):
        """``reps`` IVF searches of the same batch over the static layout,
        one after the other on the current stream -> the last repetition's
        result. The JAX package chains the repetitions inside one dispatch
        to hide its dispatch latency; here each is a plain call. The modes
        are the JAX loop's catalogue: not ``gather``, which has no chained
        loop there, so that a loop never times another path than the one
        it names. The re-score follows ``_loop_defer_rescore``."""
        if reps <= 0:
            raise ValidationError("reps must be > 0")
        if mode not in _SEARCH_LOOP_MODES:
            raise ValidationError(f"Unknown search_loop mode '{mode}'")
        return self._loop(queries, k, reps, mode,
                          lambda q, kk: self._search_raw(q, kk, nprobe, mode))

    def _exact_loop_impl(self, queries, k: int, reps: int = 16, mode: str = "auto"):
        """``reps`` exact scans of the same batch -> the last one's result."""
        if reps <= 0:
            raise ValidationError("reps must be > 0")
        if mode not in _EXACT_LOOP_MODES:
            raise ValidationError(f"Unknown exact_loop mode '{mode}'")
        return self._loop(queries, k, reps, mode,
                          lambda q, kk: self._exact_raw(q, kk, mode))

    def _loop(self, queries, k: int, reps: int, mode: str, run):
        """``run(q, k)`` ``reps`` times -> the last result, finished. Where
        ``_loop_defer_rescore`` holds, every repetition selects
        ``min(2k, n_pad)`` with the f32 copy held back (``_ref`` gives None,
        so each re-scores against the storage rows) and the last one's
        winners are re-scored once against the copy, as the JAX package's
        loops do (``_refine_and_sort`` after its ``lax.scan``)."""
        q = self._check_queries(queries)
        if k <= 0:
            raise ValidationError("k must be > 0")
        defer_k = 0
        if self._loop_defer_rescore():
            if mode == "cert":
                raise ValidationError(
                    "mode='cert' needs the f32 reference inside the loop "
                    "body, but this array is in the deferred-re-score regime; "
                    "use another mode or a single-call exact/search(mode='cert')"
                )
            defer_k, k = k, min(2 * k, int(self.emb.shape[0]))
        self._hold_ref = bool(defer_k)
        try:
            for _ in range(reps):
                d2, ids = run(q, k)
        finally:
            self._hold_ref = False
        if defer_k:
            d2, ids = _refine(q, self._emb_ref, d2, ids, defer_k)
        return d2.sqrt(), self._map_ids(d2, ids)

    # ------------------------------------------------------------------
    # Public entry points. The impls select over the static layout; the
    # wrappers finalize: tombstone filter, delta-buffer merge, spilled id
    # dedup (the impls select 2k on spilled layouts), trim to k.
    # ------------------------------------------------------------------

    def _spill_k(self, k: int) -> int:
        return 2 * k if self._spill_dups and k > 0 else k

    def _plain(self) -> bool:
        return (
            not self._spill_dups
            and self._deleted_dev is None
            and self._delta is None
        )

    def _autoscan(self, queries, k: int, mode: str, exact_path: bool) -> str:
        """``mode``, with ``autoscan`` resolved by ``scan_route`` (``scan`` is
        ``approx`` on the exact paths)."""
        if mode != "autoscan":
            return mode
        mode = self.scan_route(queries, k)
        return "approx" if exact_path and mode == "scan" else mode

    def exact(self, queries, k: int, mode: str = "auto"):
        """Exact brute-force top-k (see ``_exact_impl`` for the modes)."""
        mode = self._autoscan(queries, k, mode, exact_path=True)
        d, ids = self._exact_impl(queries, self._spill_k(k), mode)
        return (d, ids) if self._plain() else self._finalize(queries, d, ids, k)

    def search(self, queries, k: int, nprobe: int, mode: str = "auto"):
        """IVF top-k (see ``_search_impl`` for the mode catalogue)."""
        mode = self._autoscan(queries, k, mode, exact_path=False)
        d, ids = self._search_impl(queries, self._spill_k(k), nprobe, mode)
        return (d, ids) if self._plain() else self._finalize(queries, d, ids, k)

    def search_loop(self, queries, k: int, nprobe: int, reps: int = 16,
                    mode: str = "auto"):
        """``reps`` IVF searches of the same batch (see ``_search_loop_impl``)."""
        mode = self._autoscan(queries, k, mode, exact_path=False)
        d, ids = self._search_loop_impl(queries, self._spill_k(k), nprobe,
                                        reps=reps, mode=mode)
        return (d, ids) if self._plain() else self._finalize(queries, d, ids, k)

    def exact_loop(self, queries, k: int, reps: int = 16, mode: str = "auto"):
        """``reps`` exact scans of the same batch."""
        mode = self._autoscan(queries, k, mode, exact_path=True)
        d, ids = self._exact_loop_impl(queries, self._spill_k(k), reps=reps, mode=mode)
        return (d, ids) if self._plain() else self._finalize(queries, d, ids, k)

    # ------------------------------------------------------------------
    # Dynamic updates: tombstone deletes + delta-buffer appends. The main
    # layout stays static; deletes exclude rows at the selection (squared
    # norm -> inf) and at the output (id filter), appends live in a side
    # buffer scanned exactly and merged at finalize: the classic main +
    # memtable design. The reference's file-embedded index supports
    # neither without a rebuild.
    # ------------------------------------------------------------------

    def delete_rows(self, row_ids) -> None:
        """Tombstone ``row_ids`` (original or appended ids): they stop
        appearing in any mode's results."""
        ids = np.unique(np.asarray(row_ids, np.int64).reshape(-1))
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self._id_domain:
            raise ValidationError(
                f"delete_rows ids must be in [0, {self._id_domain})"
            )
        if self._deleted_host is None:
            self._deleted_host = np.zeros(self._id_domain, bool)
        elif self._deleted_host.size < self._id_domain:
            grown = np.zeros(self._id_domain, bool)
            grown[: self._deleted_host.size] = self._deleted_host
            self._deleted_host = grown
        self._deleted_host[ids] = True
        self._ship_deleted()
        # Main-layout positions of every copy (spilled rows have two).
        main_ids = ids[ids < (self._gid.max() + 1 if self._gid is not None
                              else self.n)]
        if self._gid is not None:
            pos = np.flatnonzero(np.isin(self._gid, main_ids))
        else:
            pos = main_ids[main_ids < self.n]
        if pos.size:
            self.emb_sq = self.emb_sq.index_fill(
                0, torch.from_numpy(pos.astype(np.int64)).to(self.device), torch.inf
            )
            # The kernels' finite +3e38 copy is the only cache derived from
            # the norms (the tile tables, tile ranges, cmax and the
            # bincompact calibration follow the cluster layout, and the
            # int8 codes hold no norms): a stale copy would let a deleted
            # row take a selection slot that _finalize then empties.
            self._emb_sq_pallas = None
        # Delta-buffer copies.
        if self._delta is not None:
            de, se, ge = self._delta
            dpos = np.flatnonzero(np.isin(ge.cpu().numpy(), ids))
            if dpos.size:
                se = se.index_fill(0, torch.from_numpy(dpos).to(self.device), torch.inf)
                self._delta = (de, se, ge)

    @staticmethod
    def _bucket(n: int, floor: int = 256) -> int:
        cap = floor
        while cap < n:
            cap *= 2
        return cap

    def _ship_deleted(self) -> None:
        """Upload the tombstone bitmap padded to a power of two covering the
        WHOLE id domain: shapes stay stable between appends, and an appended
        id never clip-aliases into a smaller bitmap."""
        padded = np.zeros(self._bucket(self._id_domain), bool)
        padded[: self._deleted_host.size] = self._deleted_host
        self._deleted_dev = torch.from_numpy(padded).to(self.device)

    def append_rows(self, embeddings) -> np.ndarray:
        """Append new rows to the delta buffer; returns their ids (the id
        space continues past the original rows). Deltas are scanned EXACTLY
        (one [B, m] product at finalize), so appended rows have recall 1.0;
        fold them into the main index with a rebuild when the buffer grows
        large."""
        x = np.ascontiguousarray(embeddings, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValidationError(
                f"append_rows expects [m, {self.dim}] embeddings"
            )
        if self.metric == "cosine":
            from ..index.metrics import normalize_rows

            x = normalize_rows(x)
        new_ids = np.arange(
            self._id_domain, self._id_domain + len(x), dtype=np.int32
        )
        self._id_domain += len(x)
        self._delta_host.append(x)
        total = sum(len(a) for a in self._delta_host)
        # Power-of-two capacity with an inf-norm / -1-id tail: shapes change
        # only when the bucket grows (stable shapes for a later CUDA graph),
        # and the upload below is the only per-append transfer.
        cap = self._bucket(total)
        all_x = np.zeros((cap, self.dim), np.float32)
        np.concatenate(self._delta_host, out=all_x[:total])
        sq = np.full(cap, np.inf, np.float32)
        sq[:total] = np.einsum("md,md->m", all_x[:total], all_x[:total])
        first_id = self._id_domain - total
        gids = np.full(cap, -1, np.int32)
        gids[:total] = np.arange(first_id, self._id_domain, dtype=np.int32)
        # Keep earlier tombstones on re-materialization, and the device
        # bitmap sized for the grown id domain.
        if self._deleted_host is not None:
            dead = np.zeros(total, bool)
            upto = min(self._deleted_host.size - first_id, total)
            if upto > 0:
                dead[:upto] = self._deleted_host[first_id : first_id + upto]
            sq[:total][dead] = np.inf
            self._ship_deleted()
        dev = self.device
        self._delta = (
            # rounded to the storage dtype as the JAX package stores them,
            # held in f32 so that _finalize converts nothing per call
            torch.from_numpy(all_x).to(dev, self.emb.dtype).float(),
            torch.from_numpy(sq).to(dev),
            torch.from_numpy(gids).to(dev),
        )
        return new_ids

    def _finalize(self, queries, d, ids, k: int):
        """Tombstone filter -> delta merge -> spilled dedup -> trim
        (``_finalize_impl``), on the device."""
        return _finalize_impl(
            self._check_queries(queries), d, ids, self._deleted_dev, self._delta,
            k, self._spill_dups,
        )

    @classmethod
    def with_spill(
        cls,
        index: IvfIndex,
        embeddings: np.ndarray,
        spill: float = 0.2,
        assign_block: int = 65536,
        assign_dtype: torch.dtype = torch.float32,
        **kwargs,
    ) -> "DeviceIvfSearcher":
        """Resident searcher over a SPILLED layout: the ``spill`` fraction of
        rows with the smallest runner-up margin is duplicated into their
        runner-up cluster (``query/spill.py``), lifting probe recall at
        unchanged nprobe. The runner-up pass runs on the searcher's
        ``device`` in ``assign_dtype``.

        The file format is untouched: the spill is a runtime structure built
        from the standard index at load. Costs: device memory and probed
        traffic grow by about ``spill``; the impls select 2k for the dedup,
        so a kernel's k <= 128 becomes k <= 64. ``cluster_sorted`` is
        implied (the extended layout is sorted)."""
        from .spill import build_spilled_layout

        kwargs.pop("cluster_sorted", None)
        device = resolve_device(kwargs.pop("device", None))
        if kwargs.get("metric") == "cosine":
            # Runner-up margins must be computed in the search metric; the
            # constructor's own normalization is idempotent over this.
            from ..index.metrics import normalize_rows

            embeddings = normalize_rows(np.asarray(embeddings, np.float32))
        ext_index, ext_emb, gid = build_spilled_layout(
            index, embeddings, spill, block=assign_block,
            assign_dtype=assign_dtype, device=device,
        )
        searcher = cls(ext_index, ext_emb, device=device, **kwargs)
        searcher._gid = gid
        searcher._gid_dev = torch.from_numpy(gid).to(device)
        searcher._spill_dups = True
        # The public id space is the ORIGINAL rows, not the extended layout
        # (appends and deletes address original ids).
        searcher._id_domain = int(gid.max()) + 1 if gid.size else 0
        return searcher
