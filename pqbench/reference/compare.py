"""The numbers that decide ``correct``, and their judgement against limits.

Search (per returned slot of the compared calls):

* ``dist_err``: the largest gap between a returned distance and the f64
  distance of the returned row to its query, over the query's k-th exact
  distance among its probed rows. It covers the f32 re-score and the map
  from the cluster-sorted layout back to row ids: a wrong id, a missing
  answer, a repeated row or a non-finite distance reads +inf.
* ``select_gap``: the largest gap, slot by slot, between the f64 distances
  of the returned rows and the exact top-k among the rows of the probed
  clusters, over the same k-th distance. It covers the probe (which
  clusters) and the scan's selection among their rows. Queries whose
  ``nprobe``-th and next centroid lie within ``AMBIGUOUS`` of each other
  could rightly probe either, and are left out of it (and counted).

Build (per build of the window):

* ``payload_faults``: a count, limit 0. Builds whose payload is missing or
  malformed or disagrees with the footer, rows that no list or two lists
  hold or ids out of range, centroids that are not finite or of the wrong
  shape, and values of the file's rows that differ from the rows written.
* ``assign_excess``: the largest amount by which the f64 squared distance
  of a row to its listed centroid exceeds that to its nearest centroid,
  over ``|x|^2 + |c|^2``. It covers the rows uploaded and the assignment.
* ``kmeans_excess``: the f64 k-means objective of the payload (the mean
  squared distance of each row to its listed centroid) over that of the
  reference's own k-means of the same rows (``kmeans.train``: the same
  sample size, iterations and seed), less 1. It covers the training: a
  build that skips Lloyd's iterations, keeps the k-means++ seeds or trains
  on too few rows lists every row under its nearest centroid all the same,
  and reads far above the limit here.
"""

from __future__ import annotations

import math

import torch

from .exact import Layout, topk_in_clusters

#: Relative gap between the nprobe-th and the next centroid's squared
#: distance under which a query's probe is ambiguous.
AMBIGUOUS = 1e-5


def search_numbers(layout: Layout, q: torch.Tensor, got_d: torch.Tensor,
                   got_ids: torch.Tensor, k: int, nprobe: int):
    """-> (numbers, probed result (f64 d2, positions), probe clusters)."""
    probe, cd2 = layout.probe(q, nprobe)
    ref_d2, ref_pos = topk_in_clusters(layout, q, probe, k)
    rk = ref_d2[:, k - 1].sqrt()
    ids = got_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < layout.n) & torch.isfinite(got_d)
    pos = torch.where(ok, layout.inv[ids.clamp(0, layout.n - 1)], -1)
    srt = torch.sort(torch.where(ok, ids, -1 - torch.arange(k, device=ids.device)), dim=1)[0]
    dup = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    d_ref = layout.direct_d2(q, pos).sqrt()
    bad = ~ok | dup[:, None]
    err = ((got_d.double() - d_ref).abs() / rk[:, None]).masked_fill(bad, math.inf)
    gap = ((d_ref - ref_d2.sqrt()).abs() / rk[:, None]).masked_fill(bad, math.inf)
    gcol = min(nprobe, cd2.shape[1] - 1)
    ambiguous = (cd2[:, gcol] - cd2[:, nprobe - 1]) <= AMBIGUOUS * cd2[:, nprobe - 1]
    if gcol < nprobe:  # every cluster probed: nothing to choose
        ambiguous[:] = False
    numbers = {
        "dist_err": _max(err),
        "select_gap": _max(gap[~ambiguous]),
    }
    info = {"queries": int(q.shape[0]), "ambiguous_probes": int(ambiguous.sum())}
    return numbers, info, (ref_d2, ref_pos), probe


def objective(rows: torch.Tensor, centroids: torch.Tensor, block: int = 1 << 16) -> float:
    """The f64 k-means objective: the mean squared distance of each row
    ([n, d], on the device) to its nearest centroid."""
    c64 = centroids.to(rows.device).double()
    c_sq = (c64 * c64).sum(dim=1)
    total = 0.0
    for lo in range(0, rows.shape[0], block):
        x = rows[lo : lo + block].double()
        d2 = (x * x).sum(dim=1)[:, None] + c_sq[None, :] - 2.0 * (x @ c64.T)
        total += float(d2.min(dim=1)[0].clamp_min(0.0).sum())
    return total / rows.shape[0]


def build_numbers(rows: torch.Tensor, payload: dict, ref_objective: float,
                  block: int = 1 << 16):
    """-> (payload_faults, assign_excess, kmeans_excess) of one build's
    payload against the rows the benchmark wrote ([n, d] f32, original
    order, on the device) and the reference's k-means objective of them."""
    n, d = rows.shape
    dev = rows.device
    cents = torch.as_tensor(payload["centroids"], device=dev)
    kc = cents.shape[0]
    ids = torch.as_tensor(payload["row_ids"], device=dev)
    faults = 0
    if payload["dim"] != d or not bool(torch.isfinite(cents).all()):
        return 1 + n, math.inf, math.inf
    inside = (ids >= 0) & (ids < n)
    faults += int((~inside).sum())
    counts = torch.bincount(ids[inside], minlength=n)
    faults += int((counts != 1).sum())
    if faults:
        return faults, math.inf, math.inf
    cl = torch.repeat_interleave(torch.arange(kc, device=dev),
                                 torch.as_tensor(payload["sizes"], device=dev))
    listed = torch.empty(n, dtype=torch.int64, device=dev)
    listed[ids] = cl
    c64 = cents.double()
    c_sq = (c64 * c64).sum(dim=1)
    worst = total = 0.0
    for lo in range(0, n, block):
        x = rows[lo : lo + block].double()
        x_sq = (x * x).sum(dim=1)
        d2 = x_sq[:, None] + c_sq[None, :] - 2.0 * (x @ c64.T)
        best, arg = d2.min(dim=1)
        mine = d2.gather(1, listed[lo : lo + block, None]).squeeze(1)
        excess = (mine - best) / (x_sq + c_sq[arg])
        worst = max(worst, float(excess.max()))
        total += float(mine.clamp_min(0.0).sum())
    return 0, worst, total / n / ref_objective - 1.0


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def judge(numbers: dict, limits: dict):
    """-> (all within their limits, [(name, value, limit)]). A number with no
    limit, or a NaN, fails."""
    rows = []
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        passed = limit is not None and not math.isnan(value) and value <= limit
        ok &= passed
        rows.append((name, value, limit))
    return ok, rows
