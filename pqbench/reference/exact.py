"""Exact top-k over the rows of chosen clusters, the IVF probe, and exact
brute-force top-k over all rows, pruned by cluster radii.

Rows live in cluster order (``Layout``). A query's candidates are the rows
of the clusters listed for it; scores are f32 ``|x|^2 - 2 q.x`` (TF32 off)
for the selection, and the selected rows are scored again in f64 in the
direct form ``sum((x - q)^2)``. The exact search starts from the probed
clusters and then scans every cluster that the triangle inequality cannot
rule out: a row of cluster c lies at least ``|q - c| - r_c`` from q, where
``r_c`` is the largest distance of a row of c from its centroid.
"""

from __future__ import annotations

import numpy as np
import torch

from . import no_tf32

#: Relative slack on the pruning bound, far above f64 rounding.
PRUNE_SLACK = 1e-6


class Layout:
    """Rows sorted by cluster, with what the searches below need.

    ``rows`` [n, d] f32 in the original order, ``assign`` [n] the cluster of
    each row, ``centroids`` [kc, d] f32, all on one device."""

    def __init__(self, rows: torch.Tensor, assign: torch.Tensor, centroids: torch.Tensor,
                 chunk: int = 1 << 16):
        no_tf32()
        n = rows.shape[0]
        kc = centroids.shape[0]
        assign = assign.to(torch.int64)
        order = torch.argsort(assign, stable=True)
        self.n = n
        self.order = order  # sorted position -> original row id
        self.inv = torch.empty_like(order)
        self.inv[order] = torch.arange(n, device=order.device)
        self.xs = rows.index_select(0, order)
        self.sq = (self.xs * self.xs).sum(dim=1)
        counts = torch.bincount(assign, minlength=kc)
        self.offsets = np.concatenate([[0], np.cumsum(counts.cpu().numpy())]).astype(np.int64)
        self.sizes = counts.cpu().numpy().astype(np.int64)
        self.centroids = centroids.float()
        self.c64 = centroids.double()
        self.radii = torch.zeros(kc, dtype=torch.float64, device=rows.device)
        cl = assign[order]
        for lo in range(0, n, chunk):
            diff = self.xs[lo : lo + chunk].double() - self.c64[cl[lo : lo + chunk]]
            dist = (diff * diff).sum(dim=1).sqrt()
            self.radii.scatter_reduce_(0, cl[lo : lo + chunk], dist, reduce="amax")

    def centroid_d2(self, q: torch.Tensor) -> torch.Tensor:
        """[Q, kc] f64 squared distances of the queries to the centroids."""
        q64 = q.double()
        d2 = (q64 * q64).sum(dim=1)[:, None] + (self.c64 * self.c64).sum(dim=1)[None, :]
        return (d2 - 2.0 * (q64 @ self.c64.T)).clamp_min(0.0)

    def probe(self, q: torch.Tensor, m: int):
        """The m nearest clusters of each query, ascending, ties to the
        lower cluster id -> (clusters [Q, m] int64, sorted f64 squared
        distances [Q, kc])."""
        d2 = self.centroid_d2(q)
        vals, order = torch.sort(d2, dim=1, stable=True)
        return order[:, :m], vals

    def direct_d2(self, q: torch.Tensor, pos: torch.Tensor, chunk: int = 256) -> torch.Tensor:
        """f64 direct-form squared distances of queries [Q, d] to the rows at
        sorted positions ``pos`` [Q, m] (-1 = none -> +inf)."""
        out = torch.empty(pos.shape, dtype=torch.float64, device=q.device)
        for lo in range(0, q.shape[0], chunk):
            p = pos[lo : lo + chunk]
            x = self.xs[p.clamp_min(0)].double()
            diff = x - q[lo : lo + chunk, None, :].double()
            d2 = (diff * diff).sum(dim=2)
            out[lo : lo + chunk] = torch.where(p >= 0, d2, torch.inf)
        return out


def select_in_clusters(xs: torch.Tensor, sq: torch.Tensor, offsets: np.ndarray,
                       q: torch.Tensor, qc: torch.Tensor, k: int) -> torch.Tensor:
    """Sorted positions [Q, k] of the k rows with the least f32 score
    ``sq - 2 q.x`` among the rows of each query's clusters ``qc`` [Q, m]
    (-1 = no cluster); -1 where a query has fewer than k candidates.

    Work is grouped by cluster: one product of a cluster's rows with the
    queries that list it, its best k a query, then the best k of each
    query's lists."""
    nq, m = qc.shape
    flat = qc.reshape(-1)
    pair = torch.nonzero(flat >= 0).squeeze(1)
    fc = flat[pair]
    by_cluster = torch.argsort(fc, stable=True)
    pair, fc = pair[by_cluster], fc[by_cluster]
    clusters, counts = torch.unique_consecutive(fc, return_counts=True)
    best_s = torch.full((nq * m, k), torch.inf, dtype=torch.float32, device=q.device)
    best_p = torch.full((nq * m, k), -1, dtype=torch.int64, device=q.device)
    start = 0
    for c, cnt in zip(clusters.tolist(), counts.tolist()):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        if hi > lo:
            ps = pair[start : start + cnt]
            s = sq[None, lo:hi] - 2.0 * (q[ps // m] @ xs[lo:hi].T)
            kk = min(k, hi - lo)
            vals, idx = torch.topk(s, kk, dim=1, largest=False, sorted=True)
            best_s[ps, :kk] = vals
            best_p[ps, :kk] = idx + lo
        start += cnt
    best_s = best_s.view(nq, m * k)
    _, j = torch.topk(best_s, k, dim=1, largest=False, sorted=True)
    pos = best_p.view(nq, m * k).gather(1, j)
    return torch.where(torch.isinf(best_s.gather(1, j)), -1, pos)


def _rank(layout: Layout, q: torch.Tensor, pos: torch.Tensor, k: int):
    """Score the positions again in f64 and order them by (distance, original
    id) -> (f64 squared distances [Q, k], sorted positions [Q, k])."""
    d2 = layout.direct_d2(q, pos)
    ids = torch.where(pos >= 0, layout.order[pos.clamp_min(0)], torch.iinfo(torch.int64).max)
    by_id = torch.argsort(ids, dim=1, stable=True)
    d2, pos = d2.gather(1, by_id), pos.gather(1, by_id)
    by_d = torch.argsort(d2, dim=1, stable=True)[:, :k]
    return d2.gather(1, by_d), pos.gather(1, by_d)


def topk_in_clusters(layout: Layout, q: torch.Tensor, qc: torch.Tensor, k: int):
    """Exact top-k among the rows of each query's clusters -> (f64 squared
    distances [Q, k] ascending, sorted positions [Q, k])."""
    no_tf32()
    pos = select_in_clusters(layout.xs, layout.sq, layout.offsets, q, qc, k)
    return _rank(layout, q, pos, k)


def exact_topk(layout: Layout, q: torch.Tensor, k: int, start: torch.Tensor,
               first=None):
    """Exact top-k over all rows -> (f64 squared distances [Q, k], sorted
    positions [Q, k]). ``start`` [Q, m] are clusters scanned first (the
    probe), ``first`` their result if already known. Then every cluster not
    yet scanned whose lower bound ``|q - c| - r_c`` is within the k-th
    distance is scanned: adding rows only lowers the k-th distance, so one
    such round is enough."""
    d2, pos = first if first is not None else topk_in_clusters(layout, q, start, k)
    dk = d2[:, k - 1].sqrt()
    lb = layout.centroid_d2(q).sqrt() - layout.radii[None, :]
    need = lb <= dk[:, None] * (1.0 + PRUNE_SLACK)
    need.scatter_(1, start, False)
    m = int(need.sum(dim=1).max()) if need.numel() else 0
    if m == 0:
        return d2, pos
    flag, cl = torch.sort(need.to(torch.int8), dim=1, descending=True, stable=True)
    extra = torch.where(flag[:, :m] > 0, cl[:, :m], -1)
    pose = select_in_clusters(layout.xs, layout.sq, layout.offsets, q, extra, k)
    return _rank(layout, q, torch.cat([pos, pose], dim=1), k)
