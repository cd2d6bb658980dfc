"""Batched search with rows sharded over a mesh and a merged top-k.

Counterpart of ``pqvector_tpu/dist/search.py``. Each shard holds a block of
rows on its device and runs one of the port's single-device top-k paths over
it: K2 (``DistributedExactSearcher``), the plain-torch gather chain
(``search``), K3 (``search_fused``, ``search_loop`` and the cluster-axis
searcher), the exact-selection full scan (``search_scan``), the packed-key
binned scans in plain torch (``search_xbin``, ``search_xbin8``), K7
(``search_binscan``, ``search_binscan8``) or K8 (``search_bincompact``). Its
winners get global ids (and an f32 re-score against the shard's f32 rows
where the searcher keeps them beside reduced-precision storage); then
``all_gather`` stacks every shard's [B, k] on the mesh's first device, and
one stable sort on distance over [B, n_shards * k] merges them: equal
distances keep shard order, then slot order, as the JAX package's
``jnp.argsort(stable=True)`` does. Every shard is launched before the host
reads anything; the merged result is read once. ``search_scan`` is the one
path whose shard work reads the device (the exact selection's
``nonzero``), as are ``search_xbin`` and ``search_xbin8``, whose bin
selection is the same.

Public calls take and return numpy, as in the JAX package: distances are
square roots, and an empty slot is (+inf, -1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ValidationError
from ..index.ivf import IvfIndex
from ..kernels.binscan import (
    PROVENANCE_BITS_MAX,
    binned_scan,
    binned_scan_select,
    binscan_b_tile,
    provenance_bits,
)
from ..kernels.scan_topk import MAX_K, POS_INF, _refine, select_lex
from ..kernels.stream_topk import stream_exact_scan, stream_masked_topk
from ..query.device import (
    _checked_bins,
    _exact_approx_topk_impl,
    _exact_topk_impl,
    _exact_xbin8_impl,
    _exact_xbin_impl,
    _ivf_topk_impl,
    _quantize_rows_i8,
    _round_up,
    _xbin_auto_chunk,
    _xbin_bins,
)
from .mesh import (
    CLUSTER_AXIS,
    DATA_AXIS,
    Mesh,
    all_gather,
    device_count,
    device_scope,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_rows,
)


def _max_probe_bucket(nprobe: int, n_clusters: int) -> int:
    """Power-of-two probe bucket, floored at min(128, n_clusters) and
    capped at n_clusters, as in the JAX package."""
    max_probe = 1
    while max_probe < nprobe:
        max_probe *= 2
    return min(max(max_probe, min(128, n_clusters)), n_clusters)


def _merge_gathered(best_d, best_i):
    """[n_shards, B, k] gathered results -> final [B, k]: a stable sort on
    distance over the shard-major slots."""
    n_dev, b, k = best_d.shape
    all_d = best_d.permute(1, 0, 2).reshape(b, n_dev * k)
    all_i = best_i.permute(1, 0, 2).reshape(b, n_dev * k)
    order = torch.argsort(all_d, dim=1, stable=True)[:, :k]
    return all_d.gather(1, order), all_i.gather(1, order)


def _check_queries(queries, dim: int) -> np.ndarray:
    q = np.asarray(queries, dtype=np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2 or q.shape[1] != dim:
        raise ValidationError(
            f"Query dimension mismatch: expected {dim}, got {q.shape[-1]}"
        )
    return np.ascontiguousarray(q)


def _check_dtype(dtype):
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValidationError(f"Unsupported storage dtype {dtype}")
    return dtype if dtype is not None else torch.float32


def _store(emb_flat: np.ndarray, mesh: Mesh, dtype, rescore_dtype):
    """(storage shards, f32 re-score shards or None): reduced-precision
    storage keeps the f32 rows beside it unless ``rescore_dtype`` is None."""
    f32 = shard_rows(emb_flat, mesh)
    if dtype == torch.float32:
        return f32, None
    return [t.to(dtype) for t in f32], (f32 if rescore_dtype is not None else None)


def _sharded_topk(searcher, queries, shard_fn, reps: int | None = None,
                  rescore: bool = True):
    """The skeleton every sharded search runs.

    ``shard_fn(s, q)`` -> (d2 [B, k], local ids [B, k]) runs shard ``s``'s
    top-k under its device, on ``q`` replicated there. Local ids map through
    the shard's global-id table ``searcher.gids[s]`` (-1 on pad rows); where
    the searcher holds f32 rows beside reduced storage (``_emb_ref``) and
    ``rescore`` is set, each shard re-scores its own winners in direct
    difference form before the gather, so the merge ranks f32 distances.
    ``reps`` repeats the search, each repetition's queries taking a zero
    link to the last result. -> numpy (sqrt distances, ids)."""
    mesh = searcher.mesh
    if reps is not None and reps <= 0:
        raise ValidationError("reps must be > 0")
    q0 = torch.from_numpy(_check_queries(queries, searcher.dim))
    refs = searcher._emb_ref if rescore else None
    qs = replicate(q0, mesh)
    for rep in range(reps or 1):
        if rep:
            link = torch.where(torch.isfinite(d2[:, :1]), d2[:, :1], 0.0)
            qs = replicate(qs[0].to(link.device) + 0.0 * link, mesh)
        d_parts, i_parts = [], []
        for s, dev in enumerate(mesh.devices):
            with device_scope(dev):
                q = qs[s]
                d2_s, lids = shard_fn(s, q)
                valid = lids >= 0
                safe = lids.clamp(0, searcher.gids[s].shape[0] - 1).long()
                if refs is not None:
                    diff = refs[s][safe] - q[:, None, :]
                    d2_s = torch.where(valid, (diff * diff).sum(dim=-1), torch.inf)
                gids = torch.where(valid, searcher.gids[s][safe], -1)
                d_parts.append(torch.where(gids < 0, torch.inf, d2_s))
                i_parts.append(gids)
        d2, ids = _merge_gathered(all_gather(d_parts, mesh), all_gather(i_parts, mesh))
    d2 = d2.cpu().numpy()
    ids = ids.cpu().numpy()
    ids = np.where(np.isinf(d2) | (ids >= searcher.n), -1, ids)
    return np.sqrt(d2), ids


class DistributedExactSearcher:
    """Row-sharded exact brute-force top-k over a mesh: K2 on each shard."""

    def __init__(
        self,
        embeddings: np.ndarray,
        mesh: Mesh | None = None,
        row_tile: int = 1024,
        dtype: torch.dtype | None = None,
        rescore_dtype="auto",
    ):
        """``dtype=torch.bfloat16`` stores the rows reduced;
        ``rescore_dtype="auto"`` then keeps each shard's f32 rows beside
        them, the selection fetches 2k at storage precision and the f32
        re-score keeps the k best (``None`` opts out)."""
        dtype = _check_dtype(dtype)
        self.mesh = mesh or make_mesh()
        n_dev = self.mesh.size
        embeddings = np.asarray(embeddings, dtype=np.float32)
        n, d = embeddings.shape
        self.n = n
        self.dim = d
        self.row_tile = row_tile

        per_dev = _round_up(-(-n // n_dev), row_tile)
        n_pad = per_dev * n_dev
        emb = np.zeros((n_pad, d), dtype=np.float32)
        emb[:n] = embeddings
        # pad rows carry the kernels' finite sentinel (inf poisons 0 * inf)
        sq = np.full(n_pad, POS_INF, dtype=np.float32)
        sq[:n] = np.einsum("nd,nd->n", embeddings, embeddings)
        gid = np.arange(n_pad, dtype=np.int64)
        gid[n:] = -1
        self.emb, self._emb_ref = _store(emb, self.mesh, dtype, rescore_dtype)
        self.emb_sq = shard_rows(sq, self.mesh)
        self.gids = shard_rows(gid.astype(np.int32), self.mesh)
        self._per_dev = per_dev

    def search(self, queries: np.ndarray, k: int):
        """Exact top-k: per shard K2 (the plain scan ``_exact_topk_impl``
        where the fetch exceeds a kernel's list), merged across shards."""
        ref = self._emb_ref
        tile = self.row_tile

        def shard_fn(s, q):
            emb, sq = self.emb[s], self.emb_sq[s]
            src = emb if ref is None else ref[s]
            kf = k if ref is None else min(2 * k, emb.shape[0])
            if kf > MAX_K:
                return _exact_topk_impl(
                    q, emb, sq, k, tile, emb_ref=None if ref is None else ref[s]
                )
            d2, ids = stream_exact_scan(q.to(emb.dtype), emb, sq, kf, tile)
            return _refine(q, src, d2, ids, k)

        return _sharded_topk(self, queries, shard_fn, rescore=False)


def _tile_tables(rc_blocks: np.ndarray, tile: int, kc: int):
    """Per-shard tile tables of K3 over cluster-sorted blocks [n_shards,
    rows]: (tile_clusters [n_shards, nt, cmax] int32, each tile's distinct
    clusters padded with the sentinel ``kc``; local_cluster [n_shards, rows]
    int32, each row's slot among them; cmax, shared by the shards). The JAX
    package pads cmax to 128 lanes; the card's kernel takes it as it is."""
    n_dev, rows = rc_blocks.shape
    nt = rows // tile
    parts = rc_blocks.reshape(n_dev, nt, tile)
    cmax = int((np.diff(parts, axis=2) != 0).sum(axis=2).max()) + 1
    tc = np.full((n_dev, nt, cmax), kc, np.int32)
    lcl = np.empty((n_dev, nt, tile), np.int32)
    for s in range(n_dev):
        for t in range(nt):
            u = np.unique(parts[s, t])
            tc[s, t, : u.size] = u
            lcl[s, t] = np.searchsorted(u, parts[s, t])
    return tc, lcl.reshape(n_dev, rows), cmax


def _greedy_owner(sizes: np.ndarray, bins: int):
    """Clusters to ``bins`` owners, largest first, each to the least loaded
    -> (owner [kc], load [bins])."""
    order = np.argsort(sizes)[::-1]
    owner = np.zeros(sizes.size, dtype=np.int64)
    load = np.zeros(bins, dtype=np.int64)
    for c in order:
        dev = int(np.argmin(load))
        owner[c] = dev
        load[dev] += int(sizes[c])
    return owner, load


class DistributedIvfSearcher:
    """Cluster-sharded IVF top-k over a mesh.

    Clusters are greedily balanced across shards by population; each shard
    holds a dense, cluster-sorted block of its clusters' rows, a full
    ``[kc, lmax]`` cluster table (clusters it does not own are all
    sentinel) and K3's tile tables. A query probes the replicated centroids
    on every shard; each shard searches the probed clusters it owns and the
    shards' top-k sets are gathered and merged."""

    def __init__(
        self,
        index: IvfIndex,
        embeddings: np.ndarray,
        mesh: Mesh | None = None,
        tile: int = 1024,
        orig_ids: np.ndarray | None = None,
        dtype: torch.dtype | None = None,
        rescore_dtype="auto",
    ):
        """``orig_ids`` (spilled layouts, ``query/spill.py``) maps each row
        of ``embeddings`` to the original row it copies; searches then
        return original ids and dedup (a row's two copies may sit on two
        shards). ``dtype=torch.bfloat16`` stores the rows reduced, with
        each shard's f32 rows kept for the pre-merge re-score unless
        ``rescore_dtype`` is None."""
        dtype = _check_dtype(dtype)
        self._spill_dups = orig_ids is not None
        self.mesh = mesh or make_mesh()
        n_dev = self.mesh.size
        embeddings = np.asarray(embeddings, dtype=np.float32)
        n, d = embeddings.shape
        if d != index.dim:
            raise ValidationError(
                f"Embedding dim {d} does not match index dim {index.dim}"
            )
        self.index = index
        self.n = n
        self.dim = d
        self.tile = tile
        kc = index.n_clusters

        sizes = index.cluster_sizes()
        owner, load = _greedy_owner(sizes, n_dev)
        rows_per_dev = int(load.max()) if n else 0
        rows_per_dev = max(_round_up(max(rows_per_dev, 1) + 1, tile), tile)
        lmax = max(1, int(sizes.max())) if kc else 1

        emb_blocks = np.zeros((n_dev, rows_per_dev, d), dtype=np.float32)
        sq_blocks = np.full((n_dev, rows_per_dev), np.inf, dtype=np.float32)
        gid_blocks = np.full((n_dev, rows_per_dev), -1, dtype=np.int32)
        tables = np.full((n_dev, kc, lmax), rows_per_dev - 1, dtype=np.int32)
        # filled in ascending cluster order, so each block is cluster-sorted
        rc_blocks = np.full((n_dev, rows_per_dev), kc, np.int32)
        fill = np.zeros(n_dev, dtype=np.int64)
        for c in range(kc):
            dev = int(owner[c])
            rows = index.cluster_rows(c)
            start = int(fill[dev])
            count = rows.size
            if count:
                x = embeddings[rows]
                emb_blocks[dev, start : start + count] = x
                sq_blocks[dev, start : start + count] = np.einsum("nd,nd->n", x, x)
                gid_blocks[dev, start : start + count] = (
                    orig_ids[rows] if orig_ids is not None else rows
                )
                rc_blocks[dev, start : start + count] = c
                tables[dev, c, :count] = np.arange(start, start + count)
            fill[dev] += count
        # the last row of every block stays a sentinel (inf norm, id -1)

        tc, lcl, cmax = _tile_tables(rc_blocks, tile, kc)
        self._cmax = cmax
        self._nt_local = rows_per_dev // tile
        self._tc_host = tc
        self._rows_per_dev = rows_per_dev

        mesh = self.mesh
        self.emb, self._emb_ref = _store(
            emb_blocks.reshape(n_dev * rows_per_dev, d), mesh, dtype, rescore_dtype
        )
        self.emb_sq = shard_rows(sq_blocks.reshape(-1), mesh)
        self.emb_sq_pallas = shard_rows(
            np.where(np.isinf(sq_blocks), POS_INF, sq_blocks).reshape(-1), mesh
        )
        self.gids = shard_rows(gid_blocks.reshape(-1), mesh)
        self.tables = shard_rows(tables.reshape(n_dev * kc, lmax), mesh)
        self.lcl = shard_rows(lcl.reshape(-1), mesh)
        self.tc = shard_rows(tc.reshape(n_dev * self._nt_local, cmax), mesh)
        cent = np.asarray(index.centroids, np.float32)
        self.centroids = replicate(cent, mesh)
        self.c_sq = replicate(np.einsum("kd,kd->k", cent, cent), mesh)
        self._emb_i8 = None  # lazy per-shard int8 codes for search_binscan8
        self._emb_i8_scale = None
        self._bincompact_calibrated = None
        # Dynamic updates: the host copy of the global-id layout (a delete
        # needs the positions), a tombstone bitmap over the id domain and a
        # small append buffer merged on the host side of the numpy API.
        self._gids_host = gid_blocks.reshape(-1).copy()
        self._id_domain = int(
            (orig_ids.max() + 1) if (orig_ids is not None and len(orig_ids)) else n
        )
        self._deleted_host = None
        self._delta_host: list = []
        self._delta = None  # (x [m, d] f32, sq [m], gid [m]) host numpy

    @classmethod
    def with_spill(
        cls,
        index: IvfIndex,
        embeddings: np.ndarray,
        spill: float = 0.2,
        mesh: Mesh | None = None,
        tile: int = 1024,
        assign_block: int = 65536,
        assign_dtype: torch.dtype = torch.float32,
        dtype: torch.dtype | None = None,
        rescore_dtype="auto",
    ) -> "DistributedIvfSearcher":
        """Searcher over a spilled layout (``query/spill.py``, built on the
        mesh's first device): the ``spill`` fraction of rows nearest a
        second centroid is copied into that cluster before the shard
        balance; searches select 2k and dedup by original id."""
        from ..query.spill import build_spilled_layout

        mesh = mesh or make_mesh()
        ext_index, ext_emb, gid = build_spilled_layout(
            index, embeddings, spill, block=assign_block,
            assign_dtype=assign_dtype, device=mesh.devices[0],
        )
        return cls(ext_index, ext_emb, mesh=mesh, tile=tile, orig_ids=gid,
                   dtype=dtype, rescore_dtype=rescore_dtype)

    def _max_probe_bucket(self, nprobe: int) -> int:
        return _max_probe_bucket(nprobe, self.index.n_clusters)

    def _nprobe(self, nprobe: int) -> int:
        return min(max(1, nprobe), self.index.n_clusters)

    # -- the mode implementations over the static layout -------------------

    def _search_impl(self, queries, k: int, nprobe: int):
        """The gather chain per shard (``_ivf_topk_impl``, plain torch)."""
        nprobe = self._nprobe(nprobe)
        tile = min(self.tile, self._rows_per_dev)

        def shard_fn(s, q):
            return _ivf_topk_impl(
                q, self.centroids[s], self.c_sq[s], self.tables[s], self.emb[s],
                self.emb_sq[s], k, nprobe, tile,
            )

        return _sharded_topk(self, queries, shard_fn)

    def _fused(self, queries, k: int, nprobe: int, reps: int | None):
        """K3 per shard over its cluster-sorted block: tiles whose clusters
        no query probes are skipped."""
        nprobe = self._nprobe(nprobe)
        max_probe = self._max_probe_bucket(nprobe)

        def shard_fn(s, q):
            return stream_masked_topk(
                q, self.centroids[s], self.c_sq[s], self.lcl[s], self.tc[s],
                self.emb[s], self.emb_sq_pallas[s], nprobe, k,
                max_probe=max_probe, tile=self.tile,
            )

        return _sharded_topk(self, queries, shard_fn, reps)

    def _search_scan_impl(self, queries, k: int, reps: int | None = None,
                          recall_target: float = 0.99, overfetch: int = 0):
        """The over-fetch full scan per shard (``_exact_approx_topk_impl``,
        whose selection is exact where the JAX package's is approximate).
        Shards are cluster-sorted, so chunks shrink to 64k rows at k > 32,
        as in the JAX package."""
        chunk = min(self._rows_per_dev, 65536 if k > 32 else 64 * 4096)

        def shard_fn(s, q):
            return _exact_approx_topk_impl(
                q, self.emb[s], self.emb_sq[s], k=k, chunk=chunk,
                recall_target=recall_target, overfetch=overfetch,
            )

        return _sharded_topk(self, queries, shard_fn, reps)

    def can_xbin(self, k: int = 10) -> bool:
        """Whether ``search_xbin``/``search_xbin8`` take k: ``_xbin_bins`` on
        the per-shard rows."""
        if self._spill_dups:
            k = 2 * k  # spilled searches select 2k for the id dedup
        return _xbin_bins(self._rows_per_dev, k) > 0

    def _xbin_geometry(self, queries, k: int, l_bins: int, chunk_groups: int):
        """(bins, tile groups a step) of the sharded packed-key scans, each
        shard binning its own rows: ``_checked_bins`` of ``l_bins`` and
        ``_xbin_auto_chunk`` of ``chunk_groups`` on the per-shard rows."""
        l_bins = _checked_bins(self._rows_per_dev, k, l_bins, "l_bins")
        b = int(np.shape(queries)[0]) if np.ndim(queries) > 1 else 1
        return l_bins, _xbin_auto_chunk(b, self._rows_per_dev, l_bins, chunk_groups)

    def _search_xbin_impl(self, queries, k: int, reps: int | None = None,
                          l_bins: int = 0, chunk_groups: int = 0):
        """``_exact_xbin_impl`` per shard over its rows (+inf pad norms), its
        winners re-scored against the shard's storage rows (then its f32
        rows, where held) before the merge."""
        l_bins, chunk = self._xbin_geometry(queries, k, l_bins, chunk_groups)

        def shard_fn(s, q):
            return _exact_xbin_impl(q, self.emb[s], self.emb_sq[s], k, l_bins,
                                    chunk_groups=chunk)

        return _sharded_topk(self, queries, shard_fn, reps)

    def _search_xbin8_impl(self, queries, k: int, reps: int | None = None,
                           l_bins: int = 0, chunk_groups: int = 0):
        """``_exact_xbin8_impl`` per shard over its int8 codes, its winners
        re-scored against the shard's storage rows (then its f32 rows, where
        held) before the merge."""
        l_bins, chunk = self._xbin_geometry(queries, k, l_bins, chunk_groups)
        e8, sc = self._xbin8_arrays()

        def shard_fn(s, q):
            return _exact_xbin8_impl(q, e8[s], sc[s], self.emb_sq[s], self.emb[s], k,
                                     l_bins, chunk_groups=chunk)

        return _sharded_topk(self, queries, shard_fn, reps)

    def _binscan_tile(self, esize: int | None = None) -> int:
        """Largest lane-aligned tile dividing the per-shard rows whose
        working set the JAX kernel's model admits (a query block of at least
        256, ``binscan_b_tile``). ``esize=1`` sizes the int8 form."""
        rows = self._rows_per_dev
        if esize is None:
            esize = self.emb[0].element_size()
        for t in (1024, 512, 256, 128):
            if rows % t == 0 and binscan_b_tile(t, self.dim, esize) >= 256:
                return t
        raise ValidationError(
            f"shard row count {rows} has no lane-aligned binscan tile that "
            f"fits at d={self.dim}"
        )

    def can_binscan(self, k: int = 10, esize: int | None = None) -> bool:
        """Bin-count and provenance-bit eligibility on the per-shard rows
        (``esize=1`` for binscan8)."""
        try:
            t = self._binscan_tile(esize=esize)
        except ValidationError:
            return False
        if self._spill_dups:
            k = 2 * k  # spilled searches select 2k for the id dedup
        nt = self._rows_per_dev // t
        return k <= t and provenance_bits(nt, t) <= PROVENANCE_BITS_MAX

    def _xbin8_arrays(self):
        """Lazy per-shard int8 codes and scales of the storage rows (the int8
        scans: ``search_binscan8`` and ``search_xbin8``)."""
        if self._emb_i8 is None:
            codes, scales = [], []
            for s, dev in enumerate(self.mesh.devices):
                with device_scope(dev):
                    c, sc = _quantize_rows_i8(self.emb[s])
                codes.append(c)
                scales.append(sc)
            self._emb_i8, self._emb_i8_scale = codes, scales
        return self._emb_i8, self._emb_i8_scale

    def _search_binscan_impl(self, queries, k: int, reps: int | None = None):
        """K7 per shard over its block."""
        if not self.can_binscan(k):
            raise ValidationError(
                "binscan ineligible for this shard shape/k (bin and "
                "provenance limits, kernels/binscan.py)"
            )
        tile = self._binscan_tile()

        def shard_fn(s, q):
            return binned_scan(q, self.emb[s], self.emb_sq_pallas[s], k, tile=tile)

        return _sharded_topk(self, queries, shard_fn, reps)

    def _search_binscan8_impl(self, queries, k: int, reps: int | None = None):
        """K7 per shard over its int8 codes; winners re-scored against the
        shard's storage rows."""
        if not self.can_binscan(k, esize=1):
            raise ValidationError(
                "binscan8 ineligible for this shard shape/k (bin and "
                "provenance limits, kernels/binscan.py)"
            )
        tile = self._binscan_tile(esize=1)
        e8, sc = self._xbin8_arrays()

        def shard_fn(s, q):
            return binned_scan(
                q, e8[s], self.emb_sq_pallas[s], k, tile=tile, scale=sc[s],
                emb_ref=self.emb[s],
            )

        return _sharded_topk(self, queries, shard_fn, reps)

    def calibrate_bincompact(
        self,
        queries: np.ndarray,
        nprobe: int,
        k: int = 10,
        slack: float = 1.15,
        bucket: int = 16,
    ) -> int:
        """Pin the per-shard bincompact tile budget to the measured
        probed-union size: each shard's probed tiles for the sample (host
        numpy), the largest over the shards (every shard runs one cap),
        times ``slack``, rounded up to ``bucket``. Returns the cap (0 if
        ineligible); later ``search_bincompact(cap=None)`` calls at or
        below this batch and nprobe use it. Clear with
        ``self._bincompact_calibrated = None``."""
        self._bincompact_calibrated = None
        if self._spill_dups:
            k = 2 * k  # spilled searches run the impls at 2k
        if k > self.tile:
            return 0
        q = _check_queries(queries, self.dim)
        nprobe = self._nprobe(nprobe)
        cent = np.asarray(self.index.centroids, np.float32)
        d2 = np.einsum("kd,kd->k", cent, cent)[None, :] - 2.0 * (q @ cent.T)
        kp = min(nprobe, cent.shape[0])
        probe = (
            np.argpartition(d2, kp - 1, axis=1)[:, :kp]
            if kp < cent.shape[0]
            else np.broadcast_to(np.arange(cent.shape[0]), d2.shape)
        )
        probed = np.unique(probe)
        # pad slots hold the sentinel cluster (kc), never probed
        active_per_dev = np.isin(self._tc_host, probed).any(axis=2).sum(axis=1)
        cap = int(-(-(int(active_per_dev.max()) * slack) // bucket) * bucket)
        cap = max(1, min(self._nt_local, cap))
        if provenance_bits(cap, self.tile) > PROVENANCE_BITS_MAX:
            return 0
        self._bincompact_calibrated = (cap, nprobe, q.shape[0])
        return cap

    def _bincompact_cap(self, batch: int, nprobe: int, slack: float = 1.3) -> int:
        """Per-shard selected-tile budget: the expected probed-union
        coverage of the batch (birthday bound), divided across the shards,
        with ``slack`` headroom; every shard runs the same cap."""
        kc = max(self.index.n_clusters, 1)
        draws = batch * nprobe
        expected = kc * (1.0 - (1.0 - 1.0 / kc) ** draws)
        tiles_per = (self.n / kc) / self.tile + 1.0
        cap = int(min(self._nt_local,
                      -(-expected * tiles_per * slack / self.mesh.size // 1)))
        return max(cap, 1)

    def _search_bincompact_impl(self, queries, k: int, nprobe: int,
                                reps: int | None = None, cap: int | None = None):
        """Per shard: tile popularity over the batch's probes, the ``cap``
        most probed tiles of its block, then K8 over them."""
        nprobe = self._nprobe(nprobe)
        q_np = np.asarray(queries)
        b = q_np.shape[0] if q_np.ndim > 1 else 1
        if cap is None:
            cal = self._bincompact_calibrated
            if cal and nprobe <= cal[1] and b <= cal[2]:
                cap = cal[0]
            else:
                cap = self._bincompact_cap(b, nprobe)
        else:
            cap = max(1, min(int(cap), self._nt_local))
        tile = self.tile
        if k > tile:
            raise ValidationError(f"bincompact requires k <= tile ({tile})")

        def shard_fn(s, q):
            sel = self._bincompact_sel(s, q, nprobe, cap)
            return binned_scan_select(
                q, self.emb[s], self.emb_sq_pallas[s], sel, k, tile=tile
            )

        return _sharded_topk(self, queries, shard_fn, reps)

    def _bincompact_sel(self, s: int, q: torch.Tensor, nprobe: int, cap: int):
        """Shard ``s``'s tiles for K8 (``sel`` [cap] int32): its tiles
        ordered by popularity, the most queries of ``q`` (on the shard's
        device) that probe one of their clusters, ties in tile order."""
        kc = self.index.n_clusters
        max_probe = self._max_probe_bucket(nprobe)
        dist = self.c_sq[s][None, :] - 2.0 * (q @ self.centroids[s].T)
        cids = torch.arange(kc, dtype=torch.int32, device=q.device)
        _, probe = select_lex(dist, cids[None, :].expand_as(dist), max_probe)
        in_probe = (torch.arange(max_probe, device=q.device) < nprobe).to(torch.int32)
        counts = torch.zeros(kc + 1, dtype=torch.int32, device=q.device)
        counts.index_add_(0, probe.reshape(-1).long(),
                          in_probe.expand(probe.shape[0], -1).reshape(-1))
        counts[kc] = 0
        tile_pop = counts[self.tc[s].long()].amax(dim=1)
        order = torch.argsort(torch.where(tile_pop > 0, -tile_pop, 1), stable=True)
        return order[:cap].to(torch.int32)

    # -- public entry points -----------------------------------------------

    def _spill_dedup(self, fn, queries, k: int, *args):
        """Run a mode implementation and finalize. Under an f32 re-score
        copy each shard fetches 2k (its storage-precision selection can
        misrank inside bf16's 2^-8), and a spilled layout fetches twice
        that and drops duplicate ids; the fetch is not clipped to a
        kernel's list, which raises beyond it."""
        fetch = 2 * k if self._emb_ref is not None else k
        if not self._spill_dups:
            d, ids = fn(queries, fetch, *args)
            d, ids = d[:, :k], ids[:, :k]
        else:
            from ..query.spill import dedup_topk_np

            d, ids = fn(queries, 2 * fetch, *args)
            d, ids = dedup_topk_np(d, ids, k)
        return self._finalize_dyn(queries, d, ids, k)

    def search(self, queries: np.ndarray, k: int, nprobe: int):
        """The gather chain per shard (plain torch)."""
        return self._spill_dedup(self._search_impl, queries, k, nprobe)

    def search_fused(self, queries: np.ndarray, k: int, nprobe: int):
        """K3 per shard (ids match ``search``)."""
        return self._spill_dedup(self._fused, queries, k, nprobe, None)

    def search_loop(self, queries: np.ndarray, k: int, nprobe: int, reps: int = 16):
        """``reps`` fused searches of the batch -> the last one's result."""
        return self._spill_dedup(self._fused, queries, k, nprobe, reps)

    def search_scan(self, queries: np.ndarray, k: int, reps: int | None = None,
                    recall_target: float = 0.99, overfetch: int = 0):
        """The over-fetch full scan per shard."""
        return self._spill_dedup(self._search_scan_impl, queries, k, reps,
                                 recall_target, overfetch)

    def search_xbin(self, queries, k: int, reps: int | None = None, l_bins: int = 0,
                    chunk_groups: int = 0):
        """The binned-min scan per shard (``_search_xbin_impl``); ``l_bins``
        and ``chunk_groups`` are the single searcher's ``xbin_bins`` and
        ``xbin_chunk_groups``, applied per shard."""
        return self._spill_dedup(self._search_xbin_impl, queries, k, reps, l_bins,
                                 chunk_groups)

    def search_xbin8(self, queries, k: int, reps: int | None = None, l_bins: int = 0,
                     chunk_groups: int = 0):
        """The int8 binned-min scan per shard (``_search_xbin8_impl``)."""
        return self._spill_dedup(self._search_xbin8_impl, queries, k, reps, l_bins,
                                 chunk_groups)

    def search_binscan(self, queries: np.ndarray, k: int, reps: int | None = None):
        """K7 per shard over every row."""
        return self._spill_dedup(self._search_binscan_impl, queries, k, reps)

    def search_binscan8(self, queries: np.ndarray, k: int, reps: int | None = None):
        """K7 per shard over int8 codes, exact re-score."""
        return self._spill_dedup(self._search_binscan8_impl, queries, k, reps)

    def search_bincompact(self, queries: np.ndarray, k: int, nprobe: int,
                          reps: int | None = None, cap: int | None = None):
        """K8 per shard over its most probed tiles."""
        return self._spill_dedup(self._search_bincompact_impl, queries, k, nprobe,
                                 reps, cap)

    # -- dynamic updates ------------------------------------------------------
    # The sharded layout stays static: a delete writes +inf (and the
    # kernels' 3e38) into the norms of every copy on its shard, so no
    # selection picks it; appends live in a host buffer scored exactly and
    # merged at the numpy boundary, where every search's result arrives.

    def delete_rows(self, row_ids) -> None:
        """Tombstone ``row_ids`` (original or appended ids) on every shard
        that holds a copy."""
        ids = np.unique(np.asarray(row_ids, np.int64).reshape(-1))
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self._id_domain:
            raise ValidationError(f"delete_rows ids must be in [0, {self._id_domain})")
        if self._deleted_host is None or self._deleted_host.size < self._id_domain:
            grown = np.zeros(self._id_domain, bool)
            if self._deleted_host is not None:
                grown[: self._deleted_host.size] = self._deleted_host
            self._deleted_host = grown
        self._deleted_host[ids] = True
        pos = np.flatnonzero(np.isin(self._gids_host, ids))
        rows = self._rows_per_dev
        for s, dev in enumerate(self.mesh.devices):
            local = pos[(pos >= s * rows) & (pos < (s + 1) * rows)] - s * rows
            if local.size:
                with device_scope(dev):
                    p = torch.from_numpy(local).to(dev)
                    self.emb_sq[s][p] = torch.inf
                    self.emb_sq_pallas[s][p] = POS_INF
        if self._delta is not None:
            dx, dsq, dgid = self._delta
            self._delta = (dx, np.where(np.isin(dgid, ids), np.inf, dsq), dgid)

    def append_rows(self, embeddings: np.ndarray) -> np.ndarray:
        """Append rows to the host delta buffer; returns their ids (the id
        space continues past the original rows). Deltas are scored exactly
        at merge time, so appended rows have recall 1.0."""
        x = np.ascontiguousarray(embeddings, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValidationError(f"append_rows expects [m, {self.dim}] embeddings")
        new_ids = np.arange(self._id_domain, self._id_domain + len(x), dtype=np.int32)
        self._id_domain += len(x)
        self._delta_host.append((x, new_ids))
        xs = np.concatenate([a for a, _ in self._delta_host])
        gs = np.concatenate([g for _, g in self._delta_host])
        sq = np.einsum("md,md->m", xs, xs)
        if self._deleted_host is not None:  # earlier tombstones survive
            cov = gs < self._deleted_host.size
            sq[cov] = np.where(self._deleted_host[gs[cov]], np.inf, sq[cov])
        self._delta = (xs, sq, gs)
        return new_ids

    def _finalize_dyn(self, queries, d, ids, k: int):
        """Tombstone filter + exact delta merge on the merged host results
        (distances arrive as square roots; the merge is monotonic)."""
        if self._deleted_host is None and self._delta is None:
            return d, ids
        q = _check_queries(queries, self.dim)
        d, ids = d.copy(), ids.copy()
        if self._deleted_host is not None:
            bm = self._deleted_host
            safe = np.clip(ids, 0, bm.size - 1)
            dead = (ids >= 0) & (ids < bm.size) & bm[safe]
            d[dead] = np.inf
            ids[dead] = -1
        if self._delta is not None:
            dx, dsq, dgid = self._delta
            sc = dsq[None, :] - 2.0 * (q @ dx.T) + np.einsum("bd,bd->b", q, q)[:, None]
            sc = np.where(np.isinf(dsq)[None, :], np.inf, np.sqrt(np.maximum(sc, 0.0)))
            all_d = np.concatenate([d, sc], axis=1)
            all_i = np.concatenate([ids, np.broadcast_to(dgid[None, :], sc.shape)], axis=1)
            order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
            d = np.take_along_axis(all_d, order, axis=1)
            ids = np.take_along_axis(all_i, order, axis=1)
            ids = np.where(np.isinf(d), -1, ids)
        return d[:, :k], ids[:, :k]


class DistributedClusterIvfSearcher:
    """IVF search over a 2-D ``(data, cluster)`` mesh: K3 per slot.

    Clusters are greedily partitioned across the ``cluster`` axis (each
    group owns whole clusters); within a group the cluster-sorted rows are
    split across the ``data`` axis. A query's probes therefore fan out over
    the cluster groups, each scoring only the probed clusters it owns, and
    hot clusters are split ``data`` ways. Every slot's top-k is gathered
    (over both axes, slot ``r * C + g``) and merged."""

    def __init__(
        self,
        index: IvfIndex,
        embeddings: np.ndarray,
        mesh: Mesh | None = None,
        data: int | None = None,
        cluster: int | None = None,
        tile: int = 1024,
        orig_ids: np.ndarray | None = None,
    ):
        self._spill_dups = orig_ids is not None
        if mesh is None:
            n_dev = device_count()
            cluster = cluster or max(1, n_dev // (data or 1))
            data = data or max(1, n_dev // cluster)
            mesh = make_mesh_2d(data, cluster)
        self.mesh = mesh
        shape = dict(zip(mesh.axis_names, mesh.shape))
        R, C = shape[DATA_AXIS], shape[CLUSTER_AXIS]
        self._R, self._C = R, C

        embeddings = np.asarray(embeddings, dtype=np.float32)
        n, d = embeddings.shape
        if d != index.dim:
            raise ValidationError(
                f"Embedding dim {d} does not match index dim {index.dim}"
            )
        self.index = index
        self.n = n
        self.dim = d
        self.tile = tile
        self._emb_ref = None
        kc = index.n_clusters

        sizes = index.cluster_sizes()
        group_of, load = _greedy_owner(sizes, C)
        # each of a group's R slots holds at most per_dev - 1 rows, so the
        # last row of every slot stays a pad (sentinel) row
        max_load = int(load.max()) if n else 0
        per_dev = max(_round_up(-(-max_load // R) + 1, tile), tile)
        n_slots = R * C
        emb_blocks = np.zeros((n_slots, per_dev, d), dtype=np.float32)
        sq_blocks = np.full((n_slots, per_dev), np.inf, dtype=np.float32)
        gid_blocks = np.full((n_slots, per_dev), -1, dtype=np.int32)
        rc_blocks = np.full((n_slots, per_dev), kc, np.int32)
        cap = per_dev - 1
        for g in range(C):
            mine = [c for c in range(kc) if group_of[c] == g]
            rows_g = np.concatenate(
                [index.cluster_rows(c) for c in mine] or [np.empty(0, np.int64)]
            ).astype(np.int64)
            cids_g = np.concatenate(
                [np.full(index.cluster_rows(c).size, c, np.int32) for c in mine]
                or [np.empty(0, np.int32)]
            )
            for r in range(R):
                part = slice(r * cap, min((r + 1) * cap, rows_g.size))
                rows_p = rows_g[part]
                if rows_p.size == 0:
                    continue
                slot = r * C + g
                x = embeddings[rows_p]
                emb_blocks[slot, : rows_p.size] = x
                sq_blocks[slot, : rows_p.size] = np.einsum("nd,nd->n", x, x)
                gid_blocks[slot, : rows_p.size] = (
                    orig_ids[rows_p] if orig_ids is not None else rows_p
                )
                rc_blocks[slot, : rows_p.size] = cids_g[part]

        tc, lcl, cmax = _tile_tables(rc_blocks, tile, kc)
        self._cmax = cmax
        self._per_dev = per_dev
        nt_local = per_dev // tile
        self.emb = shard_rows(emb_blocks.reshape(n_slots * per_dev, d), mesh)
        self.emb_sq_pallas = shard_rows(
            np.where(np.isinf(sq_blocks), POS_INF, sq_blocks).reshape(-1), mesh
        )
        self.gids = shard_rows(gid_blocks.reshape(-1), mesh)
        self.lcl = shard_rows(lcl.reshape(-1), mesh)
        self.tc = shard_rows(tc.reshape(n_slots * nt_local, cmax), mesh)
        cent = np.asarray(index.centroids, np.float32)
        self.centroids = replicate(cent, mesh)
        self.c_sq = replicate(np.einsum("kd,kd->k", cent, cent), mesh)

    @classmethod
    def with_spill(
        cls,
        index: IvfIndex,
        embeddings: np.ndarray,
        spill: float = 0.2,
        assign_block: int = 65536,
        assign_dtype: torch.dtype = torch.float32,
        **kwargs,
    ) -> "DistributedClusterIvfSearcher":
        """2-D-mesh searcher over a spilled layout (``query/spill.py``),
        built on the first device of ``kwargs["mesh"]`` (or of the card)."""
        from ..query.spill import build_spilled_layout

        mesh = kwargs.get("mesh")
        ext_index, ext_emb, gid = build_spilled_layout(
            index, embeddings, spill, block=assign_block, assign_dtype=assign_dtype,
            device=mesh.devices[0] if mesh is not None else None,
        )
        return cls(ext_index, ext_emb, orig_ids=gid, **kwargs)

    def _max_probe_bucket(self, nprobe: int) -> int:
        return _max_probe_bucket(nprobe, self.index.n_clusters)

    def _body(self, queries, k: int, nprobe: int, reps: int | None):
        nprobe = min(max(1, nprobe), self.index.n_clusters)
        max_probe = self._max_probe_bucket(nprobe)

        def shard_fn(s, q):
            return stream_masked_topk(
                q, self.centroids[s], self.c_sq[s], self.lcl[s], self.tc[s],
                self.emb[s], self.emb_sq_pallas[s], nprobe, k,
                max_probe=max_probe, tile=self.tile,
            )

        return _sharded_topk(self, queries, shard_fn, reps)

    def _spill_dedup(self, fn, queries, k: int, *args):
        if not self._spill_dups:
            return fn(queries, k, *args)
        from ..query.spill import dedup_topk_np

        d, ids = fn(queries, 2 * k, *args)
        return dedup_topk_np(d, ids, k)

    def search(self, queries: np.ndarray, k: int, nprobe: int):
        """K3 per slot over the 2-D mesh."""
        return self._spill_dedup(self._body, queries, k, nprobe, None)

    def search_loop(self, queries: np.ndarray, k: int, nprobe: int, reps: int = 16):
        """``reps`` searches of the batch -> the last one's result."""
        return self._spill_dedup(self._body, queries, k, nprobe, reps)
