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

* exact: ``stream`` (K2), ``xla`` (the JAX package's XLA scan, here in
  plain torch) and ``auto``;
* search: ``pallas`` (K4, cluster-sorted layouts), ``stream`` (K3),
  ``gather`` (the JAX package's fused probe chain, in plain torch) and
  ``auto``.

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
from ..kernels.scan_topk import MAX_K, _refine, masked_local_topk, select_lex
from ..kernels.stream_topk import stream_exact_topk, stream_masked_topk

#: Modes of the JAX package that this package does not run yet.
_EXACT_NOT_PORTED = frozenset(
    {"pallas", "approx", "binscan", "binscan8", "xbin", "xbin8", "tilescan",
     "cert", "autoscan"}
)
_SEARCH_NOT_PORTED = frozenset(
    {"masked", "approx", "compact", "bincompact", "bincompact8", "scan",
     "binscan", "binscan8", "xbin", "xbin8", "tilescan", "cert", "autoscan"}
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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
        its cost grows with the inserts and not with k."""
        q = self._check_queries(queries)
        if k <= 0:
            raise ValidationError("k must be > 0")
        if mode == "auto":
            mode = "stream" if k <= MAX_K else "xla"
        if mode == "stream":
            if k > MAX_K:
                raise ValidationError(f"stream mode needs k <= {MAX_K}")
            d2, ids = stream_exact_topk(
                q, self.emb, self._pallas_emb_sq(), k, tile=self._scan_tile(),
                emb_ref=self._ref(),
            )
        elif mode == "xla":
            d2, ids = _exact_topk_impl(
                q, self.emb, self.emb_sq, k, self.row_tile, emb_ref=self._ref()
            )
        elif mode in _EXACT_NOT_PORTED:
            raise ValidationError(f"exact mode '{mode}' is not ported yet")
        else:
            raise ValidationError(f"Unknown exact mode '{mode}'")
        return d2.sqrt(), self._map_ids(d2, ids)

    def search(self, queries, k: int, nprobe: int, mode: str = "auto"):
        """IVF top-k -> (sqrt distances [B, k], ids [B, k]).

        ``auto`` on a cluster-sorted layout with k <= 128 takes K4
        (``pallas``) while its [nt, B, cmax] local mask stays within 256 MB,
        and K3 (``stream``) beyond: K3 builds the probe test from the
        [B, kc_pad] mask and scans only the active tiles. On an unsorted
        layout (or k > 128) it takes ``gather``, the JAX package's own route
        off the TPU; the TPU's kernel there (K6) is not ported yet."""
        q = self._check_queries(queries)
        if k <= 0:
            raise ValidationError("k must be > 0")
        if nprobe <= 0:
            raise ValidationError("nprobe must be > 0")
        nprobe = min(nprobe, self.index.n_clusters)
        if mode == "auto":
            if self._can_stream_masked(k):
                tile = self._scan_tile()
                mode = "pallas" if self._use_local_mask(tile, q.shape[0]) else "stream"
            else:
                mode = "gather"

        if mode in ("stream", "pallas"):
            if not self._can_stream_masked(k):
                raise ValidationError(
                    f"{mode} mode needs a cluster-sorted layout and k <= {MAX_K}"
                    + (" (K6, the unsorted pallas kernel, is not ported yet)"
                       if mode == "pallas" else "")
                )
            tile = self._scan_tile()
            lcl, tc, _ = self._tile_cluster_table(tile)
            if mode == "pallas" and not self._use_local_mask(tile, q.shape[0]):
                raise ValidationError(
                    "pallas mode's local mask exceeds its cap; the global-mask "
                    "kernel (K6) is not ported yet: use mode='stream'"
                )
            run = masked_local_topk if mode == "pallas" else stream_masked_topk
            d2, ids = run(
                q, self.centroids, self.c_sq, lcl, tc, self.emb,
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
        elif mode in _SEARCH_NOT_PORTED:
            raise ValidationError(f"search mode '{mode}' is not ported yet")
        else:
            raise ValidationError(f"Unknown search mode '{mode}'")
        return d2.sqrt(), self._map_ids(d2, ids)
