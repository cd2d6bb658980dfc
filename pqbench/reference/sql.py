"""The plain reference of the SQL top-k semantics, and the numbers that
decide ``correct`` for an SQL cell.

``SELECT id, array_distance(embedding, [q]) AS dist FROM t [WHERE id >=
min_id] ORDER BY dist LIMIT k`` over a file indexed IVF with ``nprobe``
probed clusters (pq-vector ``src/df_vector/tests.rs:151-241``: the predicate
applies after candidate pruning) answers the k rows nearest the query among
the rows of its ``nprobe`` nearest clusters that pass the predicate, in
distance order, ties to the lower id; fewer than k only where fewer pass.
The reference works from the file's own rows and its embedded index
(``payload.py``), in f64. The index is the program's, so the reference
checks it: each row's nearest centroid is recomputed in f64 from the file's
rows and centroids, and a row the index lists elsewhere is a fault (below).
The file's ``id`` column is its row number.

Per returned row of the judged calls:

* ``dist_err``: the largest gap between a returned ``dist`` and the f64
  distance of the returned row to its query, over the query's last expected
  distance (the k-th, or the last where fewer rows pass). A missing row, a
  wrong, repeated or predicate-failing id or a non-finite distance reads +inf.
* ``select_gap``: the largest gap, slot by slot, between the f64 distances
  of the returned rows and the reference's answer, over the same distance;
  queries whose ``nprobe``-th and next centroid lie within ``AMBIGUOUS`` of
  each other could rightly probe either, and are left out of it.
* ``sql_faults``: a count, limit 0: each returned row that fails the
  predicate, each repeated or out-of-range id, each returned ``dist`` that
  is not ``array_distance`` of its row (off by more than ``DIST_FAULT`` of
  it) or that breaks the ascending order, and each call whose row count is
  not min(k, passing probed rows); and, once a run, the index's faults:
  each row it lists other than once and each id out of range or, where
  there are none, one for any row listed away from its f64 nearest
  centroid by more than ``ASSIGN_TIE``.

``recall_at_k``: the share of the exact top-k over all rows that pass the
predicate that the calls returned.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import no_tf32
from .compare import AMBIGUOUS, build_numbers
from .exact import Layout, _rank, exact_topk

#: A returned ``dist`` further than this share of the f64 distance from
#: its row's is not that row's ``array_distance`` (f32 rounding is ~1e-7).
DIST_FAULT = 1e-3

#: A row listed in a cluster whose f64 squared distance exceeds its nearest
#: centroid's by more than this share of ``|x|^2 + |c|^2`` (``compare.py``'s
#: ``assign_excess``) is a fault; within it, a near tie. The build scores
#: ``|c|^2 - 2 x.c`` in f32 (or bf16 screened, then f32), whose rounding grows
#: with that scale (~1e-7 of it).
ASSIGN_TIE = 1e-5


def probed_topk(layout: Layout, x64: torch.Tensor, sq64: torch.Tensor, q: torch.Tensor,
                probe: torch.Tensor, k: int):
    """Exact top-k in f64 among the rows of each query's probed clusters
    ``probe`` [Q, m] -> (f64 squared distances [Q, k] ascending, sorted
    positions [Q, k], -1 = none), ties to the lower original id. ``x64``,
    ``sq64``: the layout's rows and their squared norms in f64."""
    nq, m = probe.shape
    q64 = q.double()
    best_s = torch.full((nq, m, k), math.inf, dtype=torch.float64, device=q.device)
    best_p = torch.full((nq, m, k), -1, dtype=torch.int64, device=q.device)
    for c in torch.unique(probe).tolist():
        lo, hi = int(layout.offsets[c]), int(layout.offsets[c + 1])
        if hi == lo:
            continue
        qi, slot = torch.nonzero(probe == c, as_tuple=True)
        s = sq64[None, lo:hi] - 2.0 * (q64[qi] @ x64[lo:hi].T)
        kk = min(k, hi - lo)
        vals, idx = torch.topk(s, kk, dim=1, largest=False, sorted=True)
        best_s[qi, slot, :kk] = vals
        best_p[qi, slot, :kk] = idx + lo
    flat_s, flat_p = best_s.view(nq, m * k), best_p.view(nq, m * k)
    _, j = torch.topk(flat_s, min(2 * k, m * k), dim=1, largest=False, sorted=True)
    # 2k by score, then (distance, id) in the direct form: a tie at the k-th
    # score keeps its lower id.
    return _rank(layout, q, flat_p.gather(1, j), k)


class SqlReference:
    """The file's rows ``rows`` [n, d] f32 (on the judging device, row
    order), its ``id`` column, and its embedded index ``payload``
    (``payload.read_payload``); ``min_id``: the predicate ``id >= min_id``."""

    def __init__(self, rows: torch.Tensor, ids: np.ndarray, payload: dict, min_id: int):
        no_tf32()
        n = rows.shape[0]
        if not np.array_equal(np.asarray(ids), np.arange(n)):
            raise ValueError("the file's id column is not its row number")
        dev = rows.device
        cents = torch.as_tensor(payload["centroids"], device=dev)
        listing, excess, _ = build_numbers(rows, payload, 1.0)
        self.index_faults = listing if listing else int(excess > ASSIGN_TIE)
        ids = torch.as_tensor(payload["row_ids"], device=dev)
        inside = (ids >= 0) & (ids < n)
        lists = torch.repeat_interleave(torch.arange(cents.shape[0], device=dev),
                                        torch.as_tensor(payload["sizes"], device=dev))
        assign = torch.zeros(n, dtype=torch.int64, device=dev)  # unlisted: a fault above
        assign[ids[inside]] = lists[inside]
        self.n, self.min_id = n, int(min_id)
        self.all = Layout(rows, assign, cents)
        keep = torch.arange(n, device=dev) >= self.min_id
        self.sub = Layout(rows[keep], assign[keep], cents)
        self.sub_ids = torch.nonzero(keep).squeeze(1)  # subset position -> id
        self._x64 = {}

    def _side(self, filtered: bool):
        layout = self.sub if filtered else self.all
        if filtered not in self._x64:
            x64 = layout.xs.double()
            self._x64[filtered] = (x64, (x64 * x64).sum(dim=1))
        to_id = self.sub_ids if filtered else None
        return layout, self._x64[filtered], to_id

    def answer(self, q: torch.Tensor, filtered: bool, k: int, nprobe: int):
        """The reference's answer -> (f64 squared distances [Q, k], ids
        [Q, k] (-1 none), passing probed rows [Q], probe clusters, sorted
        centroid squared distances, layout positions)."""
        layout, (x64, sq64), to_id = self._side(filtered)
        probe, cd2 = layout.probe(q, nprobe)
        d2, pos = probed_topk(layout, x64, sq64, q, probe, k)
        ids = torch.where(pos >= 0, layout.order[pos.clamp_min(0)], -1)
        if to_id is not None:
            ids = torch.where(ids >= 0, to_id[ids.clamp_min(0)], -1)
        passing = torch.as_tensor(layout.sizes, device=q.device)[probe].sum(dim=1)
        return d2, ids, passing, probe, cd2, pos

    def judge(self, q: torch.Tensor, filtered: np.ndarray, got: list, k: int, nprobe: int):
        """Judge the calls: ``q`` [Q, d] f32 queries, ``filtered`` [Q] which
        carried the predicate, ``got`` [(ids, dist)] the returned columns of
        each -> (numbers, info, recall_at_k)."""
        no_tf32()
        filtered = np.asarray(filtered, dtype=bool)
        worst = {"dist_err": 0.0, "select_gap": 0.0}
        faults, ambiguous = self.index_faults, 0
        hits = total = 0
        for side in (False, True):
            which = np.flatnonzero(filtered == side)
            if which.size == 0:
                continue
            qs = q[torch.as_tensor(which, device=q.device)]
            d2, ref_ids, passing, probe, cd2, pos = self.answer(qs, side, k, nprobe)
            f, err, gap, amb = self._numbers(qs, side, [got[i] for i in which], d2,
                                             passing, cd2, k, nprobe)
            faults += f
            ambiguous += amb
            worst["dist_err"] = max(worst["dist_err"], err)
            worst["select_gap"] = max(worst["select_gap"], gap)
            truth = self._exact(qs, side, k, probe, (d2, pos))
            h, t = _hits(truth, [got[i][0] for i in which], k)
            hits, total = hits + h, total + t
        numbers = {**worst, "sql_faults": float(faults)}
        info = {"calls": len(got), "filtered": int(filtered.sum()), "ambiguous_probes": ambiguous,
                "index_faults": self.index_faults}
        return numbers, info, hits / max(total, 1)

    def _exact(self, q, filtered, k, probe, first):
        """Exact top-k ids over every row that passes the predicate."""
        layout, _, to_id = self._side(filtered)
        _, pos = exact_topk(layout, q, k, probe, first)
        ids = torch.where(pos >= 0, layout.order[pos.clamp_min(0)], -1)
        if to_id is not None:
            ids = torch.where(ids >= 0, to_id[ids.clamp_min(0)], -1)
        return ids.cpu().numpy()

    def _numbers(self, q, filtered, got, ref_d2, passing, cd2, k, nprobe):
        dev = q.device
        nq = q.shape[0]
        want = torch.clamp(passing, max=k)
        got_ids = torch.full((nq, k), -1, dtype=torch.int64)
        got_d = torch.full((nq, k), math.nan, dtype=torch.float64)
        faults = 0
        for i, (ids, dist) in enumerate(got):
            m = len(ids)
            faults += int(m != int(want[i]))
            got_ids[i, : min(m, k)] = torch.from_numpy(np.array(ids[:k], dtype=np.int64))
            got_d[i, : min(m, k)] = torch.from_numpy(np.array(dist[:k], dtype=np.float64))
        got_ids, got_d = got_ids.to(dev), got_d.to(dev)
        slot = torch.arange(k, device=dev)[None, :]
        present = got_ids >= 0
        in_range = present & (got_ids < self.n)
        srt = torch.sort(torch.where(present, got_ids, -1 - slot), dim=1)[0]
        dup = torch.zeros_like(present)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        dups = int(dup.sum())
        fails = present & in_range & (got_ids < self.min_id) if filtered else present & False
        pos = self.all.inv[got_ids.clamp(0, self.n - 1)]
        d_row = self.all.direct_d2(q, torch.where(in_range, pos, -1)).sqrt()
        off = ~torch.isfinite(got_d) | ((got_d - d_row).abs() > DIST_FAULT * d_row)
        unordered = present[:, 1:] & (got_d[:, 1:] < got_d[:, :-1])
        faults += (int((present & ~in_range).sum()) + dups + int(fails.sum())
                   + int((in_range & off).sum()) + int(unordered.sum()))
        rows_dup = torch.zeros(nq, dtype=torch.bool, device=dev)
        rows_dup |= dup.any(dim=1)
        expected = slot < want[:, None]
        bad = expected & (~in_range | fails | rows_dup[:, None] | ~torch.isfinite(got_d))
        last = (want - 1).clamp_min(0)[:, None]
        rk = ref_d2.gather(1, last).squeeze(1).sqrt().clamp_min(1e-30)[:, None]
        err = ((got_d - d_row).abs() / rk).masked_fill(bad, math.inf)
        gap = ((d_row - ref_d2.sqrt()).abs() / rk).masked_fill(bad, math.inf)
        gcol = min(nprobe, cd2.shape[1] - 1)
        amb = (cd2[:, gcol] - cd2[:, nprobe - 1]) <= AMBIGUOUS * cd2[:, nprobe - 1]
        if gcol < nprobe:  # every cluster probed: nothing to choose
            amb[:] = False
        err, gap = err[expected], gap[expected & ~amb[:, None]]
        return (faults, float(err.max()) if err.numel() else 0.0,
                float(gap.max()) if gap.numel() else 0.0, int(amb.sum()))


def _hits(truth: np.ndarray, got: list, k: int) -> tuple[int, int]:
    """Truth ids found among the returned ones, and truth ids in all."""
    hits = total = 0
    for row, ids in zip(truth, got):
        want = row[row >= 0]
        hits += int(np.isin(want, np.asarray(ids[:k], dtype=np.int64)).sum())
        total += want.size
    return hits, total
