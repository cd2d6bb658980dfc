"""VectorTopKExec: the indexed top-k operator.

Component #17 in SURVEY.md §2 (pq-vector src/df_vector/exec.rs). Two
children: the index scan (candidate row ids) and the original scan subtree
(scan + any FilterExec). Execution (exec.rs:279-293):

1. collect candidates per file from the index child,
2. per-file row-group row counts from footers (:157-205),
3. ``max_candidates`` budget via round-robin cursor (:219-239),
4. attach access plans to the scan child and execute it — **FilterExec stays
   in the child, so predicates apply after candidate pruning** (the semantic
   pinned by pq-vector src/df_vector/tests.rs:151-241),
5. top-k over the fetched rows, keeping *entire rows*; distances recomputed
   from the fetched vector column (List/FixedSizeList/LargeList of f32/f64,
   dim-mismatch rows skipped, :494-550); results are **squared-L2** ordered
   ascending (sqrt only exists in the standalone API).

Metrics: ``embeddings_fetched`` (SUMMARY), ``batches_fetched`` (DEV)
(:405-427). Extension: when candidate counts are large the distance
re-scoring runs as one torch expression on the session's device instead of
the host loop, and a session-cached resident searcher can stand in for the
index child (``_try_resident``).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import torch

from .._device import resolve_device
from ..errors import ExecutionError, FormatError, PlanError
from .access import (
    CandidateCursor,
    FileEntry,

    build_access_plans,
)
from .index_exec import INDEX_PATH_COL, INDEX_ROW_ID_COL, VectorIndexScanExec
from .options import VectorTopKOptions
from .physical import (
    STAT_FAILED,
    ExecutionPlan,
    FilterExec,
    ParquetScanExec,
    TaskContext,
    cache_put,
    file_cache_key,
    store_cache_key,
)

_DEVICE_THRESHOLD = 16384  # rows; below this the host path wins on latency

#: Resident filter-escalation cap on the device-side k fetch, the JAX
#: package's (there each distinct k is a fresh compile and a very large-k
#: top-k is slow); past the cap the host path serves the query, so both
#: packages take the same path for the same query.
RESIDENT_K_CAP = 16384


def _walk(plan: ExecutionPlan):
    yield plan
    for child in plan.children():
        yield from _walk(child)


def gather_parquet_scans(plan: ExecutionPlan) -> list[ParquetScanExec]:
    return [n for n in _walk(plan) if isinstance(n, ParquetScanExec)]


def gather_single_parquet_scan(plan: ExecutionPlan) -> ParquetScanExec | None:
    """Exactly-one-scan requirement (access.rs:35-44)."""
    scans = gather_parquet_scans(plan)
    return scans[0] if len(scans) == 1 else None


def rewrite_with_access_plans(
    plan: ExecutionPlan, access_plans: dict
) -> ExecutionPlan:
    """Clone the subtree with access plans attached to the scan
    (access.rs:65-105)."""
    if isinstance(plan, ParquetScanExec):
        return plan.with_access_plans(access_plans)
    children = plan.children()
    if not children:
        return plan
    new_children = [rewrite_with_access_plans(c, access_plans) for c in children]
    return plan.with_new_children(new_children)


class VectorTopKExec(ExecutionPlan):
    name = "VectorTopKExec"
    tree_name = "vector_topk"

    def __init__(
        self,
        index_plan: ExecutionPlan,
        scan_plan: ExecutionPlan,
        vector_column: str,
        query: np.ndarray,
        k: int,
        options: VectorTopKOptions,
    ):
        super().__init__()
        self.index_plan = index_plan
        self.scan_plan = scan_plan
        self.vector_column = vector_column
        self.query = np.asarray(query, dtype=np.float32).reshape(-1)
        self.k = k
        self.options = options
        self._embeddings_fetched = self.metrics.counter("embeddings_fetched")
        self._batches_fetched = self.metrics.counter(
            "batches_fetched", self.metrics.DEV
        )
        self._resident_candidates = self.metrics.counter(
            "resident_candidates", self.metrics.DEV
        )

    @classmethod
    def try_new(
        cls,
        scan_plan: ExecutionPlan,
        vector_column: str,
        query: np.ndarray,
        k: int,
        options: VectorTopKOptions,
    ) -> "VectorTopKExec":
        scan = gather_single_parquet_scan(scan_plan)
        if scan is None:
            raise PlanError("VectorTopKExec requires a single parquet scan input")
        index_plan = VectorIndexScanExec(
            list(scan.files), vector_column, query, options
        )
        return cls(index_plan, scan_plan, vector_column, query, k, options)

    def children(self) -> list[ExecutionPlan]:
        return [self.index_plan, self.scan_plan]

    def with_new_children(self, children: list[ExecutionPlan]) -> "VectorTopKExec":
        index_plan, scan_plan = children
        return VectorTopKExec(
            index_plan, scan_plan, self.vector_column, self.query, self.k, self.options
        )

    def schema(self) -> pa.Schema:
        return self.scan_plan.schema()

    # ------------------------------------------------------------------

    def execute(self, context: TaskContext) -> pa.Table:
        from ..utils.profiling import stage

        with stage("vector_topk.resident"):
            table = self._try_resident(context)
        if table is None:
            with stage("vector_topk.collect_candidates"):
                candidates = self._collect_candidates(context)
            with stage("vector_topk.file_metadata"):
                file_entries = self._files_with_candidates(context, candidates)
            with stage("vector_topk.fetch_and_topk"):
                table = self._execute_with_candidates(file_entries, context)
        self.metrics.output_rows.add(table.num_rows)
        return table

    def _try_resident(self, context: TaskContext) -> pa.Table | None:
        """Serve candidates from a session-cached device-resident searcher.

        Serving extension: when every scanned file has a resident
        ``DeviceIvfSearcher`` (Session.device_searcher), candidate ids come
        from device IVF searches over the same probe sets instead of footer
        probing + candidate-page reads — the per-query I/O drops from
        O(nprobe * cluster) pages to the k winners. Results are IDENTICAL
        to the host path: the devices return the distance top-k' of exactly
        the rows the index children would emit (multi-file sets merge to
        the union top-k' by device distance), downstream fetch/filter/top-k
        is unchanged, and under a FilterExec the candidate count escalates
        (k' x4) until k survivors or the probed sets are exhausted; any
        parity hazard (missing searcher, max_candidates truncation, column
        or dim mismatch) falls back to the host path. Returns None to fall
        back.
        """
        if not context.resident or self.options.max_candidates is not None:
            return None
        scan = gather_single_parquet_scan(self.scan_plan)
        if scan is None or not scan.files:
            return None
        # EVERY scanned file must have a fresh resident searcher (a partial
        # set would change which files contribute candidates vs the host
        # path). Per-file device top-k' sets are merged by distance into the
        # union top-k' — identical candidates to a host index child probing
        # each file, then pruned to the k' globally-nearest.
        searchers: list[tuple[str, object]] = []
        for file in scan.files:
            path = file.object_path
            searcher = context.resident.get(path)
            if searcher is None:
                return None
            if getattr(searcher, "source_column", None) != self.vector_column:
                return None
            if searcher.metric != "l2":
                return None  # engine distance semantics are (squared) L2
            if searcher.dim != self.query.size:
                return None  # host path skips the file (dim-mismatch)
            # Parity guards: the device must rank exactly what the host
            # would. Reduced-precision storage perturbs selection (~2^-8)
            # UNLESS the searcher holds an f32 re-score reference (the
            # default, rescore_dtype="auto"): the gather mode then widens
            # its merge to 2k and re-scores against f32, so returned ids
            # and distances are f32-exact over the probed set — host
            # parity at half the residency. A searcher built before a
            # re-index/rewrite ranks against stale data (source_key
            # check below).
            if searcher.emb.dtype != torch.float32 and (
                getattr(searcher, "_emb_ref", None) is None
            ):
                return None
            if searcher._delta is not None or (
                searcher._deleted_dev is not None
            ):
                # Dynamic runtime state (append/delete) is not in the file:
                # appended ids don't exist as file rows (the candidate
                # fetch would read out of range) and SQL projects columns
                # appends don't carry. SQL serves FILE contents; the host
                # path does that correctly.
                return None
            fkey = file_cache_key(path)
            if fkey == STAT_FAILED or getattr(
                searcher, "source_key", None
            ) != fkey:
                return None
            searchers.append((path, searcher))

        from ..utils.profiling import stage

        has_filter = any(
            isinstance(node, FilterExec) for node in _walk(self.scan_plan)
        )
        k_fetch = self.k if not has_filter else max(4 * self.k, self.k + 64)
        k_cap = min(RESIDENT_K_CAP, max(s.n for _, s in searchers))
        if any(s._spill_dups for _, s in searchers):
            # Spilled searchers select 2k internally for the id dedup;
            # halve the escalation ceiling so the device-side top-k
            # stays within the cap the comment above justifies.
            k_cap = max(1, k_cap // 2)
        while True:
            per_file: list[tuple[str, np.ndarray, np.ndarray]] = []
            exhausted = True
            total = 0
            k_eff = min(k_fetch, k_cap)
            with stage("vector_topk.resident.device_search"):
                for path, searcher in searchers:
                    k_f = min(k_eff, searcher.n)
                    dist, ids = searcher.search(
                        self.query[None, :], k_f, self.options.nprobe,
                        mode="gather",
                    )
                    # .cpu() first: np.asarray of a CUDA tensor raises.
                    dist = dist[0].cpu().numpy()
                    ids = ids[0].cpu().numpy()
                    keep = ids >= 0
                    dist, ids = dist[keep], ids[keep].astype(np.int64)
                    exhausted &= ids.size < k_f or k_f >= searcher.n
                    total += ids.size
                    per_file.append((path, dist, ids))
            if total == 0:
                return None
            if len(per_file) == 1:
                candidates = {per_file[0][0]: per_file[0][2]}
            else:
                # Union top-k_eff across files by device distance. When the
                # probed sets are exhausted, keep the WHOLE union (the host
                # path would emit every probed candidate).
                all_d = np.concatenate([d for _, d, _ in per_file])
                order = np.argsort(all_d, kind="stable")
                if not exhausted:
                    order = order[:k_eff]
                sel = np.zeros(all_d.size, dtype=bool)
                sel[order] = True
                candidates = {}
                off = 0
                for path, d, ids in per_file:
                    take = ids[sel[off : off + ids.size]]
                    off += ids.size
                    if take.size:
                        candidates[path] = take
                total = sum(v.size for v in candidates.values())
            with stage("vector_topk.resident.fetch_and_topk"):
                file_entries = self._files_with_candidates(context, candidates)
                table = self._execute_with_candidates(file_entries, context)
            if table.num_rows >= self.k or exhausted:
                self._resident_candidates.add(total)
                return table
            if k_eff >= k_cap:
                return None  # filter too selective for the device path
            k_fetch *= 4

    def _collect_candidates(self, context: TaskContext) -> dict[str, np.ndarray]:
        """Index child -> {path: row ids} (exec.rs:108-155)."""
        batch = self.index_plan.execute(context)
        paths = batch.column(INDEX_PATH_COL).to_numpy(zero_copy_only=False)
        rows = batch.column(INDEX_ROW_ID_COL).to_numpy(zero_copy_only=False)
        selections: dict[str, np.ndarray] = {}
        for path in np.unique(paths):
            selections[str(path)] = rows[paths == path].astype(np.int64)
        return selections

    def _files_with_candidates(
        self, context: TaskContext, candidates: dict[str, np.ndarray]
    ) -> list[FileEntry]:
        """Row-group row counts per scan file (exec.rs:157-205)."""
        scan = gather_single_parquet_scan(self.scan_plan)
        if scan is None:
            raise PlanError("VectorTopKExec requires a single parquet scan input")
        remaining = dict(candidates)
        entries: list[FileEntry] = []
        for file in scan.files:
            key = (
                file.object_path,
                store_cache_key(context.object_store, file.object_path),
            )
            row_groups = context.meta_cache.get(key)
            if row_groups is None:
                # Footer thrift parse through the object store (the
                # reference's row-count reads are store-range reads too,
                # exec.rs:157-205) — no local file access.
                from ..io.pages import (
                    parse_parquet_metadata,
                    read_footer_via_store,
                )

                store = context.object_store
                path = file.object_path
                try:
                    meta = read_footer_via_store(store, path)
                    _, rgs = parse_parquet_metadata(meta)
                except FormatError as exc:
                    raise ExecutionError(str(exc)) from exc
                except Exception as exc:
                    raise ExecutionError(
                        f"Failed to read parquet metadata from '{path}': {exc}"
                    ) from exc
                row_groups = [rg.num_rows for rg in rgs]
                cache_put(context.meta_cache, key, row_groups)
            rows = remaining.pop(file.object_path, np.empty(0, dtype=np.int64))
            entries.append(
                FileEntry(
                    object_path=file.object_path,
                    row_groups=row_groups,
                    candidates=rows,
                )
            )
        if remaining:
            raise ExecutionError(
                "VectorIndexScanExec produced candidates for unknown files"
            )
        return entries

    def _execute_with_candidates(
        self, file_entries: list[FileEntry], context: TaskContext
    ) -> pa.Table:
        """Budget -> access plans -> child scan -> top-k (exec.rs:207-245)."""
        if not file_entries:
            raise PlanError("VectorTopKExec requires at least one indexed parquet file")

        total_candidates = sum(e.candidates.size for e in file_entries)
        max_candidates = (
            self.options.max_candidates
            if self.options.max_candidates is not None
            else total_candidates
        )
        target = min(max_candidates, total_candidates)

        cursor = CandidateCursor(len(file_entries))
        for idx, entry in enumerate(file_entries):
            cursor.add_candidates(idx, entry.candidates)
        per_file = cursor.take_per_file(target)

        selections_np = {
            file_entries[i].object_path: rows
            for i, rows in enumerate(per_file)
            if rows.size
        }

        access_plans = build_access_plans(file_entries, selections_np)
        plan = rewrite_with_access_plans(self.scan_plan, access_plans)
        table = plan.execute(context)
        return self._topk_from_table(table, context.device)

    # ------------------------------------------------------------------

    def _topk_from_table(self, table: pa.Table, device=None) -> pa.Table:
        """Heap-equivalent top-k over full rows (exec.rs:257-277, 457-492)."""
        self._batches_fetched.add(max(1, table.column(0).num_chunks) if table.num_columns else 1)
        self._embeddings_fetched.add(table.num_rows)

        if self.vector_column not in table.column_names:
            raise PlanError(
                f"Vector column '{self.vector_column}' not found in schema"
            )
        distances = self._compute_distances(table, device)
        valid = ~np.isnan(distances)
        idx = np.flatnonzero(valid)
        if idx.size == 0:
            return self.schema().empty_table()
        order = idx[np.argsort(distances[idx], kind="stable")][: self.k]
        return table.take(pa.array(order))

    def _compute_distances(self, table: pa.Table, device=None) -> np.ndarray:
        """Squared L2 per row; NaN for dim-mismatch / null rows
        (exec.rs:494-550). Large row sets run on ``device`` (``None``: the
        card) when ``options.use_device`` is set."""
        col = table.column(self.vector_column)
        typ = col.type
        if not (
            pa.types.is_list(typ)
            or pa.types.is_large_list(typ)
            or pa.types.is_fixed_size_list(typ)
        ):
            raise PlanError("Vector column must be list or fixed-size list")
        value_type = typ.value_type
        if value_type not in (pa.float32(), pa.float64()):
            raise PlanError("Vector column must be Float32 or Float64 list")

        q = self.query
        dim = q.size
        out = np.full(table.num_rows, np.nan, dtype=np.float64)
        base = 0
        for chunk in col.chunks:
            n = len(chunk)
            if n == 0:
                continue
            valid_mask = np.ones(n, dtype=bool)
            if chunk.null_count:
                valid_mask = np.asarray(chunk.is_valid())
            if pa.types.is_fixed_size_list(typ):
                lengths = np.full(n, typ.list_size, dtype=np.int64)
                # chunk.flatten() drops null slots, which would misalign every
                # later row against starts = i*list_size; the raw values
                # buffer keeps null slots in place (their garbage values are
                # excluded via valid_mask below).
                flat = chunk.values.slice(
                    chunk.offset * typ.list_size, n * typ.list_size
                )
                starts = np.arange(n, dtype=np.int64) * typ.list_size
            else:
                offsets = np.asarray(chunk.offsets)
                lengths = np.diff(offsets)
                first = int(offsets[0])
                flat = chunk.values.slice(first, int(offsets[-1]) - first)
                starts = (offsets[:-1] - first).astype(np.int64)
            vals = flat.to_numpy(zero_copy_only=False).astype(np.float32, copy=False)
            ok = valid_mask & (lengths == dim)
            rows = np.flatnonzero(ok)
            if rows.size:
                gather = starts[rows][:, None] + np.arange(dim)[None, :]
                mat = vals[gather]
                if self.options.use_device and rows.size >= _DEVICE_THRESHOLD:
                    out[base + rows] = _device_sqdist(mat, q, device)
                else:
                    diff = mat - q[None, :]
                    out[base + rows] = np.einsum("nd,nd->n", diff, diff)
            base += n
        return out

    def tree_lines(self) -> list[str]:
        lines = [
            f"k={self.k}",
            f"column={self.vector_column}",
            f"query_dim={self.query.size}",
            f"nprobe={self.options.nprobe}",
        ]
        if self.options.max_candidates is not None:
            lines.append(f"max_candidates={self.options.max_candidates}")
        lines.append(
            f"embeddings_fetched={self.metrics.value('embeddings_fetched')}"
        )
        lines.append(f"batches_fetched={self.metrics.value('batches_fetched')}")
        return lines

    def display_line(self) -> str:
        return f"VectorTopKExec: k={self.k}"


def _device_sqdist(mat: np.ndarray, q: np.ndarray, device) -> np.ndarray:
    """One device pass over a large candidate set -> float64 on the host."""
    device = resolve_device(device)
    x = torch.from_numpy(mat).to(device)
    diff = x - torch.from_numpy(q).to(device)[None, :]
    return (diff * diff).sum(dim=1).cpu().numpy().astype(np.float64)
