"""Scan access plans and the candidate budget cursor (component #15 in
SURVEY.md §2, pq-vector src/df_vector/access.rs)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ScanFile:
    """One file of a Parquet scan (access.rs:22-28)."""

    object_path: str
    file_size: int


@dataclasses.dataclass
class FileEntry:
    """Per-file row-group row counts + candidate rows (access.rs:15-20)."""

    object_path: str
    row_groups: list[int]
    candidates: np.ndarray


@dataclasses.dataclass
class RowGroupSelection:
    """Which rows of one row group to read. ``rows`` holds *group-local*
    sorted unique row indices; ``None`` means read all rows."""

    scan_all: bool = False
    rows: np.ndarray | None = None

    @property
    def skip(self) -> bool:
        return not self.scan_all and (self.rows is None or self.rows.size == 0)


@dataclasses.dataclass
class ParquetAccessPlan:
    """Per-row-group access decisions for one file (ParquetAccessPlan analog,
    access.rs:123-159)."""

    groups: list[RowGroupSelection]

    @classmethod
    def new_none(cls, n_groups: int) -> "ParquetAccessPlan":
        return cls([RowGroupSelection() for _ in range(n_groups)])

    def selected_row_count(self) -> int:
        total = 0
        for g in self.groups:
            if g.rows is not None:
                total += int(g.rows.size)
        return total


def access_plan_for_rows(row_groups: list[int], rows: np.ndarray) -> ParquetAccessPlan:
    """Map global row ids to per-row-group local selections; untouched groups
    are skipped (access.rs:123-159)."""
    n_groups = len(row_groups)
    if rows.size == 0:
        return ParquetAccessPlan.new_none(n_groups)
    starts = np.concatenate([[0], np.cumsum(np.asarray(row_groups, dtype=np.int64))])
    rows = np.asarray(rows, dtype=np.int64)
    # Candidate ids beyond the file's rows mean a corrupt/stale index payload;
    # report that instead of silently mapping them into the last group (same
    # bounds discipline as io/pages.py read_rows and query/selective.py).
    if rows.size and (rows.min() < 0 or rows.max() >= starts[-1]):
        from ..errors import ExecutionError

        raise ExecutionError(
            f"Candidate row id {int(rows.max())} out of bounds for file with "
            f"{int(starts[-1])} rows (corrupt or stale index payload?)"
        )
    group_of = np.searchsorted(starts, rows, side="right") - 1
    plan = ParquetAccessPlan.new_none(n_groups)
    for g in np.unique(group_of):
        local = rows[group_of == g] - starts[g]
        local = np.unique(local)  # sort + dedup (access.rs:151-152)
        plan.groups[int(g)] = RowGroupSelection(rows=local)
    return plan


def build_access_plans(
    files: list[FileEntry], selections: dict[str, np.ndarray]
) -> dict[str, ParquetAccessPlan]:
    """One access plan per file (access.rs:107-121)."""
    plans: dict[str, ParquetAccessPlan] = {}
    for entry in files:
        rows = selections.get(entry.object_path, np.empty(0, dtype=np.int64))
        plans[entry.object_path] = access_plan_for_rows(entry.row_groups, rows)
    return plans


class CandidateCursor:
    """Round-robin candidate budget across files (access.rs:193-243): take the
    first ``batch_size`` candidates fairly, one per file per turn."""

    def __init__(self, file_count: int):
        self._candidates: list[np.ndarray] = [
            np.empty(0, dtype=np.int64) for _ in range(file_count)
        ]
        self._positions = [0] * file_count
        self._round_robin = 0

    def add_candidates(self, idx: int, candidates: np.ndarray) -> None:
        if 0 <= idx < len(self._candidates):
            self._candidates[idx] = np.asarray(candidates, dtype=np.int64)

    def take_per_file(self, batch_size: int) -> list[np.ndarray]:
        """Vectorized fair take: the same candidate SET :meth:`next_batch`
        would select, returned as one array per file (the JAX package
        measured the per-tuple Python loop at ~25 ms for 16k candidates on
        its host). Round-robin means file ``i``
        contributes ``min(count_i, r [+1])`` candidates — its first ones in
        order — where ``r`` is the number of full rounds that fit."""
        n_files = len(self._candidates)
        counts = np.array(
            [
                c.size - p
                for c, p in zip(self._candidates, self._positions)
            ],
            dtype=np.int64,
        )
        total = int(counts.sum())
        n = min(batch_size, total) if batch_size > 0 else 0
        if n <= 0:
            return [np.empty(0, dtype=np.int64) for _ in range(n_files)]
        # Largest r with sum(min(counts, r)) <= n.
        lo, hi = 0, int(counts.max())
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if int(np.minimum(counts, mid).sum()) <= n:
                lo = mid
            else:
                hi = mid - 1
        take = np.minimum(counts, lo)
        rem = n - int(take.sum())
        if rem > 0:
            # One extra candidate for the first `rem` unexhausted files in
            # cyclic order from the round-robin pointer.
            order = (self._round_robin + np.arange(n_files)) % n_files
            eligible = order[counts[order] > lo][:rem]
            take[eligible] += 1
        out = []
        for i, k in enumerate(take):
            pos = self._positions[i]
            out.append(self._candidates[i][pos : pos + int(k)])
            self._positions[i] = pos + int(k)
        return out

    def next_batch(self, batch_size: int) -> list[tuple[int, int]]:
        if batch_size <= 0 or not self._candidates:
            return []
        file_count = len(self._candidates)
        output: list[tuple[int, int]] = []
        idx = self._round_robin
        while len(output) < batch_size:
            progressed = False
            for _ in range(file_count):
                file_idx = idx % file_count
                idx += 1
                pos = self._positions[file_idx]
                if pos < self._candidates[file_idx].size:
                    output.append((file_idx, int(self._candidates[file_idx][pos])))
                    self._positions[file_idx] = pos + 1
                    progressed = True
                    if len(output) >= batch_size:
                        break
            if not progressed:
                break
        self._round_robin = idx % file_count
        return output
