"""Device-resident batched exact and IVF search.

Counterpart of ``pqvector_tpu/query/device.py:DeviceIvfSearcher``. The
embedding matrix stays on one torch device (f32, or bf16 with an f32
re-score copy), padded to a multiple of ``row_tile`` with a sentinel row
``n`` whose squared norm is +inf, and optionally permuted into cluster order
so that each inverted list is a contiguous row range. Queries come in
batches; every public call returns (sqrt distances [B, k], original row ids
[B, k]) as tensors on the device, with id -1 and distance +inf in slots
beyond the candidate count.

Modes ported so far:

* exact: ``stream`` (K2), ``pallas`` (K5), ``xla`` (the JAX package's XLA
  scan, here in plain torch), ``binscan`` (K7), ``binscan8`` (K7 on int8
  codes) and ``auto``;
* search: ``pallas`` (K4 on cluster-sorted layouts while its local mask
  fits, K6 otherwise), ``stream`` (K3), ``gather`` (the JAX package's fused
  probe chain, in plain torch), the nprobe-free full scans ``binscan`` and
  ``binscan8`` (K7), the probed-union scans ``bincompact`` and
  ``bincompact8`` (K8), and ``auto``.

Every other mode of the JAX package raises ``ValidationError``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

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
from ..kernels.scan_topk import (
    MAX_K,
    QUERY_BLOCK,
    _refine,
    exact_topk,
    masked_local_topk,
    masked_topk,
    select_lex,
)
from ..kernels.stream_topk import stream_exact_topk, stream_masked_topk

#: Modes of the JAX package that this package does not run yet.
_EXACT_NOT_PORTED = frozenset(
    {"approx", "xbin", "xbin8", "tilescan", "cert", "autoscan"}
)
_SEARCH_NOT_PORTED = frozenset(
    {"masked", "approx", "compact", "scan", "xbin", "xbin8", "tilescan",
     "cert", "autoscan"}
)
#: The scan kernels' tile: the rows one block owns and the unit of the
#: per-tile cluster tables. The kernels stream 64-row chunks through a
#: fixed 41 KB of shared memory whatever the tile (csrc/common.cuh), so the
#: tile is chosen for the grid, not for memory: 1024 rows gives about 1000
#: tiles at 1M rows (K4 then launches nt * B/16 blocks, dozens of waves on
#: 132 SMs) while K3 still skips work at a grain of 1024 rows.
_SCAN_TILE_CAP = 1024
#: Cap on K4's pre-gathered [nt, B, cmax] f32 local mask, as in the JAX
#: package; beyond it ``auto`` takes K3, which needs no such buffer.
_LOCAL_MASK_CAP = 256 << 20
#: ``auto``'s cost model on a layout in file order, fit to K6 and
#: ``gather`` timed on the H100 at 1M x 128 and 10M x 96 (PERF.md).
#: K6 scores every resident row for each 16-query block: ms per 1e9
#: (row, query slot, dimension) triples.
_K6_MS_PER_G = 0.28
#: ``gather``: a fixed cost (the plain-torch probe chain's launches) plus ms
#: per 1e6 candidate rows (batch * nprobe * longest list).
_GATHER_MS = 4.4
_GATHER_MS_PER_M = 1.1


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
        device: str | torch.device = "cpu",
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
        self.device = torch.device(device)
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if metric == "cosine":
            from ..index.metrics import normalize_rows

            embeddings = normalize_rows(embeddings)

        self._gid: np.ndarray | None = None
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
        self.emb_sq = torch.from_numpy(sq).to(dev)
        self.centroids = torch.from_numpy(np.asarray(index.centroids)).to(dev)
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
        rescore_dtype="auto",
        cluster_sorted: bool = False,
        device: str | torch.device = "cpu",
    ) -> "DeviceIvfSearcher":
        """Resident searcher from an indexed Parquet file."""
        index, column = read_index_from_parquet(path)
        emb = read_embedding_column(path, column)
        return cls(
            index,
            emb.data,
            dtype=dtype,
            row_tile=row_tile,
            metric=read_index_metric(path),
            cluster_sorted=cluster_sorted,
            rescore_dtype=rescore_dtype,
            device=device,
        )

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
        is the reference (f32 storage / re-score opt-out)."""
        return self._emb_ref

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
                emb_ref=self._ref_or_emb() if int8 else self._ref(),
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
        ctile, cap = self._compact_bin_params(batch, nprobe, k, esize=esize)
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
                emb_ref=self._ref_or_emb() if int8 else self._ref(),
            )
        except ValueError as exc:
            raise ValidationError(str(exc)) from exc

    def _map_ids(self, d2, ids):
        invalid = torch.isinf(d2) | (ids >= self.n) | (ids < 0)
        if self._gid_dev is not None:
            ids = self._gid_dev[ids.clamp(0, self.n - 1).long()]
        return torch.where(invalid, -1, ids)

    # ------------------------------------------------------------------

    def exact(self, queries, k: int, mode: str = "auto"):
        """Exact brute-force top-k -> (sqrt distances [B, k], ids [B, k]).

        ``auto`` takes K2 (``stream``) for k <= 128, the most a kernel's
        top-k list holds, and the plain torch scan (``xla``) beyond. Unlike
        the TPU, where the unrolled extraction passes capped the kernel at
        k <= 32, the card's kernel inserts into a list in shared memory, so
        its cost grows with the inserts and not with k. ``pallas`` takes K5
        (per-tile lists, then a cross-tile merge); ``binscan``/``binscan8``
        the binned-min scan K7, whose selection misses only on cross-tile
        bin collisions."""
        q = self._check_queries(queries)
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
        elif mode in _EXACT_NOT_PORTED:
            raise ValidationError(f"exact mode '{mode}' is not ported yet")
        else:
            raise ValidationError(f"Unknown exact mode '{mode}'")
        return d2.sqrt(), self._map_ids(d2, ids)

    def _unsorted_auto(self, batch: int, nprobe: int) -> str:
        """``auto``'s route on a layout in file order: K6 (``pallas``) or
        ``gather``, whichever the cost model fit on the H100 predicts is
        faster. K6's cost grows with the resident rows times the padded
        batch, the gather's with its candidate rows."""
        slots = _round_up(batch, QUERY_BLOCK)
        k6_ms = _K6_MS_PER_G * int(self.emb.shape[0]) * self.dim * slots / 1e9
        cand = batch * nprobe * int(self.clusters.shape[1])
        gather_ms = _GATHER_MS + _GATHER_MS_PER_M * cand / 1e6
        return "pallas" if k6_ms <= gather_ms else "gather"

    def search(self, queries, k: int, nprobe: int, mode: str = "auto"):
        """IVF top-k -> (sqrt distances [B, k], ids [B, k]).

        ``auto`` on a cluster-sorted layout with k <= 128 takes K4
        (``pallas``) while its [nt, B, cmax] local mask stays within 256 MB,
        and K3 (``stream``) beyond: K3 builds the probe test from the
        [B, kc_pad] mask and scans only the active tiles. On a layout in
        file order with k <= 128 it takes K6 (``pallas``) or ``gather`` by
        the rule of ``_unsorted_auto``, measured on the card; k > 128 takes
        ``gather``. ``pallas`` runs K4 where its local mask fits and K6
        (global probe mask, any layout) otherwise. ``binscan``/``binscan8``
        ignore nprobe and scan every row (K7); ``bincompact``/``bincompact8``
        scan the batch's probed-union tiles, capped (K8)."""
        q = self._check_queries(queries)
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
        elif mode in _SEARCH_NOT_PORTED:
            raise ValidationError(f"search mode '{mode}' is not ported yet")
        else:
            raise ValidationError(f"Unknown search mode '{mode}'")
        return d2.sqrt(), self._map_ids(d2, ids)
