"""Physical plan operators for the SQL-style engine.

A deliberately thin analog of the DataFusion physical-plan surface the
reference builds on: ``DataSourceExec`` (Parquet scan with per-file access
plans), ``FilterExec``, ``SortExec`` (with ``fetch``), ``GlobalLimitExec`` /
``LocalLimitExec``, ``SortPreservingMergeExec``, ``ProjectionExec``. The
VectorTopK rewrite rule pattern-matches these exact shapes
(pq-vector src/df_vector/physical.rs:32-113), so the planner emits the
same tree structures DataFusion would.

Execution is pull-based and materializing (each node returns one Arrow
table); the data volumes on the engine's host path are candidate-sized by
design — bulk work belongs to the device operators.
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ..errors import PlanError
from .access import ParquetAccessPlan, ScanFile
from .expr import PhysicalExpr
from .metrics import MetricsSet
from .object_store import DEFAULT_STORE, ObjectStore


class ExecutionPlan:
    """Base operator."""

    name: str = "ExecutionPlan"
    tree_name: str = "execution_plan"

    def __init__(self) -> None:
        self.metrics = MetricsSet()

    def children(self) -> list["ExecutionPlan"]:
        return []

    def with_new_children(self, children: list["ExecutionPlan"]) -> "ExecutionPlan":
        if children:
            raise PlanError(f"{self.name} does not accept children")
        return self

    def schema(self) -> pa.Schema:
        raise NotImplementedError

    def execute(self, context: "TaskContext") -> pa.Table:
        raise NotImplementedError

    # Display ---------------------------------------------------------
    def display_line(self) -> str:
        return self.name

    def tree_lines(self) -> list[str]:
        """Extra key=value lines for the tree render."""
        return []


#: Sentinel returned by :func:`file_cache_key` when stat fails. Staleness
#: guards must treat it as NEVER matching (two failed stats say nothing
#: about the file being unchanged).
STAT_FAILED = (-1, -1)


def file_cache_key(path: str):
    """(size, mtime_ns) identity for session caches: size alone misses
    same-size rewrites; mtime alone misses fast successive writes."""
    try:
        st = os.stat(path)
        return (st.st_size, st.st_mtime_ns)
    except OSError:
        return STAT_FAILED


def store_cache_key(store, path: str):
    """Cache identity for files that may live in a non-local store: local
    stat when possible, store size otherwise (never the STAT_FAILED
    sentinel, which must not collide across rewrites)."""
    key = file_cache_key(path)
    if key == STAT_FAILED and store is not None:
        try:
            return ("head", store.head(path))
        except Exception:
            return STAT_FAILED
    return key


def cache_put(cache: dict, key, value, limit: int = 512) -> None:
    """Insert with a blunt size bound (session caches hold open pf handles
    and decoded row-group columns; unbounded growth leaks fds/memory)."""
    if len(cache) > limit:
        cache.clear()
    cache[key] = value


class TaskContext:
    """Execution context: object store + session-level knobs.

    ``resident`` maps file paths to device-resident ``DeviceIvfSearcher``s
    the session has cached (Session.device_searcher); VectorTopKExec serves
    candidates from the device instead of probing footers + reading
    candidate pages when the scanned file has one (serving extension —
    the reference's SQL path is disk-only). ``device`` is the session's
    torch device: the resident searchers live there and the large-candidate
    re-score (``VectorTopKOptions.use_device``) runs there.
    """

    def __init__(
        self,
        object_store: ObjectStore = DEFAULT_STORE,
        resident: dict | None = None,
        meta_cache: dict | None = None,
        index_cache: dict | None = None,
        device=None,
    ):
        self.object_store = object_store
        self.device = device
        self.resident = resident or {}
        # Session-shared caches keyed by (path, file_size): per-query footer
        # metadata parses (~4 MB thrift at 1M rows) and index payload decodes
        # dominate warm SQL latency otherwise. In-place re-index grows the
        # file, so the size key self-invalidates.
        self.meta_cache = meta_cache if meta_cache is not None else {}
        self.index_cache = index_cache if index_cache is not None else {}


class ParquetScanExec(ExecutionPlan):
    """DataSourceExec + ParquetSource analog: scan one or more Parquet files,
    optionally restricted by per-file access plans (row-group/row
    selections attached by the TopK rewrite, access.rs:65-105)."""

    name = "DataSourceExec"
    tree_name = "data_source"

    def __init__(
        self,
        files: list[ScanFile],
        schema: pa.Schema,
        projection: list[str] | None = None,
        access_plans: dict[str, ParquetAccessPlan] | None = None,
    ):
        super().__init__()
        self.files = files
        self._schema = schema
        self.projection = projection
        self.access_plans = access_plans or {}
        # Pages decoded by the page-exact selective path (0 when the
        # row-group fallback served the scan); the reference's analog is the
        # row-selection-driven page pruning inside its rewritten scan
        # (pq-vector src/df_vector/access.rs:161-176).
        self._pages_read = self.metrics.counter("pages_read")

    def schema(self) -> pa.Schema:
        if self.projection is None:
            return self._schema
        return pa.schema([self._schema.field(c) for c in self.projection])

    def with_access_plans(
        self, access_plans: dict[str, ParquetAccessPlan]
    ) -> "ParquetScanExec":
        clone = ParquetScanExec(
            self.files, self._schema, self.projection, access_plans
        )
        # The TopK operator executes the rewritten clone and discards it
        # (exec.py:_execute_with_candidates); sharing the metrics set keeps
        # pages_read/output_rows visible on the displayed plan, like the
        # reference's metrics surfacing through its rewritten scan.
        clone.metrics = self.metrics
        clone._pages_read = self._pages_read
        return clone

    def execute(self, context: TaskContext) -> pa.Table:
        tables: list[pa.Table] = []
        with self.metrics.elapsed_compute.timer():
            for file in self.files:
                plan = self.access_plans.get(file.object_path)
                tables.append(
                    self._read_file(file.object_path, plan, context)
                )
        if not tables:
            return self.schema().empty_table()
        table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        self.metrics.output_rows.add(table.num_rows)
        return table

    def _read_file(
        self,
        path: str,
        plan: ParquetAccessPlan | None,
        context: TaskContext | None = None,
    ) -> pa.Table:
        # Footer parses dominate warm per-query latency (pyarrow thrift for
        # pf, our own compact-protocol parse inside PageSelectiveReader), so
        # open handles are cached session-wide keyed by (path, size) — the
        # in-place index append grows the file, invalidating the key.
        store = context.object_store if context is not None else None
        cache = context.meta_cache if context is not None else None
        fkey = store_cache_key(store, path)
        pf = None if cache is None else cache.get(("pf", path, fkey))
        if pf is None:
            from .object_store import open_parquet

            pf = open_parquet(store, path)
            if cache is not None:
                cache_put(cache, ("pf", path, fkey), pf)
        columns = self.projection
        if plan is None:
            table = pf.read(columns=columns)
            return _strip_metadata(table)
        selected = [
            (g, sel) for g, sel in enumerate(plan.groups) if not sel.skip
        ]
        if selected and all(
            sel.rows is not None and not sel.scan_all for _, sel in selected
        ):
            table = self._read_selected_pages(pf, path, selected, context)
            if table is not None:
                return _strip_metadata(table)
        parts: list[pa.Table] = []
        for group_idx, sel in selected:
            tbl = pf.read_row_group(group_idx, columns=columns)
            if not sel.scan_all and sel.rows is not None:
                tbl = tbl.take(pa.array(sel.rows))
            parts.append(tbl)
        if not parts:
            return _strip_metadata(pf.schema_arrow.empty_table() if columns is None else self.schema().empty_table())
        return _strip_metadata(pa.concat_tables(parts))

    def _read_selected_pages(
        self, pf: pq.ParquetFile, path: str, selected,
        context: TaskContext | None = None,
    ) -> pa.Table | None:
        """Decode only the selected rows' PAGES for float32-valued columns.

        The reference attaches RowSelections so its rewritten scan decodes
        only selected rows — on the 1-vector-per-page layout its writer
        forces, that is page-exact I/O
        (pq-vector src/df_vector/access.rs:161-176,
        src/ivf/parquet.rs:324-326). Here every float32 list/flat column is
        served by the page-exact reader (io/pages.py) when the file carries
        an offset index; other columns fall back to row-group reads + take.
        Returns None when the page path can't serve any projected column.
        """
        from ..errors import ExecutionError as _ExecErr
        from ..errors import FormatError as _FmtErr
        from ..io.pages import PageSelectiveReader
        from ..types import EmbeddingColumn

        names = self.projection
        if names is None:
            names = [f.name for f in pf.schema_arrow]
        starts = np.concatenate(
            [
                [0],
                np.cumsum(
                    [
                        pf.metadata.row_group(i).num_rows
                        for i in range(pf.metadata.num_row_groups)
                    ]
                ),
            ]
        )
        global_rows = np.concatenate(
            [starts[g] + np.asarray(sel.rows, np.int64) for g, sel in selected]
        )

        arrays: dict[str, pa.Array] = {}
        pages_total = 0
        store = context.object_store if context is not None else None
        cache = context.meta_cache if context is not None else None
        fkey = store_cache_key(store, path)
        for name in names:
            typ = pf.schema_arrow.field(name).type
            if not _page_path_type(typ):
                continue
            rkey = ("psr", path, fkey, name)
            try:
                reader = None if cache is None else cache.get(rkey)
                if reader is None:
                    reader = PageSelectiveReader(
                        path, EmbeddingColumn(name), store=store
                    )
                    if cache is not None:
                        cache_put(cache, rkey, reader)
                if not reader.supports_page_reads:
                    continue
                vals, lens, pages = reader.read_rows_ragged(global_rows)
            except (_ExecErr, _FmtErr):
                continue  # dict pages / nulls / etc: row-group fallback
            arr = _rebuild_float_array(typ, vals, lens)
            if arr is None:
                continue
            arrays[name] = arr
            pages_total += pages
        if not arrays:
            return None

        fallback = [n for n in names if n not in arrays]
        if fallback:
            # Non-float32 columns (ints, strings) fall back to row-group
            # decodes + take; the decoded columns are cached per row group
            # (tiny: e.g. 0.5 MB per 64k-row int64 group) so repeated
            # serving queries pay only the take().
            parts = []
            for g, sel in selected:
                gkey = ("rg", path, fkey, g, tuple(fallback))
                tbl = None if cache is None else cache.get(gkey)
                if tbl is None:
                    tbl = pf.read_row_group(g, columns=fallback)
                    # Cache only modest groups: fallback covers ALL
                    # non-float32 columns — a wide string column on a big
                    # table would pin gigabytes with no eviction.
                    if cache is not None and tbl.nbytes <= (8 << 20):
                        cache_put(cache, gkey, tbl)
                parts.append(tbl.take(pa.array(sel.rows)))
            fb = pa.concat_tables(parts)
            for n in fallback:
                arrays[n] = fb.column(n)
        self._pages_read.add(pages_total)
        return pa.table({n: arrays[n] for n in names})

    def tree_lines(self) -> list[str]:
        # Only surfaced when the page-exact path actually ran, so plans
        # served by the row-group fallback render exactly as before.
        if self._pages_read.value:
            return [f"pages_read={self._pages_read.value}"]
        return []


def _strip_metadata(table: pa.Table) -> pa.Table:
    return table.replace_schema_metadata(None)


def _page_path_type(typ: pa.DataType) -> bool:
    """Columns the page-exact reader can serve losslessly: float32 values
    only (the page decoder narrows f64 -> f32, fine for index *building* but
    not for returning SQL results)."""
    if pa.types.is_float32(typ):
        return True
    if (
        pa.types.is_list(typ)
        or pa.types.is_large_list(typ)
        or pa.types.is_fixed_size_list(typ)
    ):
        return typ.value_type == pa.float32()
    return False


def _rebuild_float_array(
    typ: pa.DataType, vals: np.ndarray, lens: np.ndarray
) -> pa.Array | None:
    values = pa.array(vals, pa.float32())
    if pa.types.is_float32(typ):
        if lens.size and not np.all(lens == 1):
            return None
        return values
    if pa.types.is_fixed_size_list(typ):
        if lens.size and not np.all(lens == typ.list_size):
            return None
        return pa.FixedSizeListArray.from_arrays(values, typ.list_size)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    if pa.types.is_large_list(typ):
        return pa.LargeListArray.from_arrays(
            pa.array(offsets, pa.int64()), values
        )
    return pa.ListArray.from_arrays(pa.array(offsets, pa.int32()), values)


class FilterExec(ExecutionPlan):
    """Row filter (predicates evaluate *after* candidate pruning when nested
    under VectorTopKExec — the reference semantic proved by
    pq-vector src/df_vector/tests.rs:151-241)."""

    name = "FilterExec"
    tree_name = "filter"

    def __init__(self, predicate: PhysicalExpr, input_plan: ExecutionPlan):
        super().__init__()
        self.predicate = predicate
        self.input = input_plan

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children: list[ExecutionPlan]) -> "FilterExec":
        (child,) = children
        return FilterExec(self.predicate, child)

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def execute(self, context: TaskContext) -> pa.Table:
        table = self.input.execute(context)
        with self.metrics.elapsed_compute.timer():
            mask = np.asarray(self.predicate.evaluate(table), dtype=bool)
            out = table.filter(pa.array(mask))
        self.metrics.output_rows.add(out.num_rows)
        return out

    def display_line(self) -> str:
        return f"FilterExec: {self.predicate}"

    def tree_lines(self) -> list[str]:
        return [f"predicate={self.predicate}"]


class SortExpr:
    """One sort key (PhysicalSortExpr analog)."""

    def __init__(self, expr: PhysicalExpr, descending: bool = False):
        self.expr = expr
        self.descending = descending

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SortExpr)
            and str(self.expr) == str(other.expr)
            and self.descending == other.descending
        )

    def __str__(self) -> str:
        return f"{self.expr} {'DESC' if self.descending else 'ASC'}"


class SortExec(ExecutionPlan):
    name = "SortExec"
    tree_name = "sort"

    def __init__(
        self,
        exprs: list[SortExpr],
        input_plan: ExecutionPlan,
        fetch: int | None = None,
        preserve_partitioning: bool = False,
    ):
        super().__init__()
        self.exprs = exprs
        self.input = input_plan
        self.fetch = fetch
        self.preserve_partitioning = preserve_partitioning

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children: list[ExecutionPlan]) -> "SortExec":
        (child,) = children
        return SortExec(self.exprs, child, self.fetch, self.preserve_partitioning)

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def execute(self, context: TaskContext) -> pa.Table:
        table = self.input.execute(context)
        with self.metrics.elapsed_compute.timer():
            keys = [np.asarray(e.expr.evaluate(table), dtype=np.float64) for e in self.exprs]
            # NaNs sort last (DataFusion nulls-last default for ASC).
            order = np.lexsort(
                tuple(
                    (-k if e.descending else k)
                    for k, e in zip(reversed(keys), reversed(self.exprs))
                )
            )
            if self.fetch is not None:
                order = order[: self.fetch]
            out = table.take(pa.array(order))
        self.metrics.output_rows.add(out.num_rows)
        return out

    def display_line(self) -> str:
        fetch = f", fetch={self.fetch}" if self.fetch is not None else ""
        return f"SortExec: [{', '.join(str(e) for e in self.exprs)}]{fetch}"


class GlobalLimitExec(ExecutionPlan):
    name = "GlobalLimitExec"
    tree_name = "global_limit"

    def __init__(self, input_plan: ExecutionPlan, skip: int = 0, fetch: int | None = None):
        super().__init__()
        self.input = input_plan
        self.skip = skip
        self.fetch = fetch

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children: list[ExecutionPlan]) -> "GlobalLimitExec":
        (child,) = children
        return GlobalLimitExec(child, self.skip, self.fetch)

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def execute(self, context: TaskContext) -> pa.Table:
        table = self.input.execute(context)
        table = table.slice(self.skip)
        if self.fetch is not None:
            table = table.slice(0, self.fetch)
        self.metrics.output_rows.add(table.num_rows)
        return table

    def display_line(self) -> str:
        return f"GlobalLimitExec: skip={self.skip}, fetch={self.fetch}"


class LocalLimitExec(ExecutionPlan):
    name = "LocalLimitExec"
    tree_name = "local_limit"

    def __init__(self, input_plan: ExecutionPlan, fetch: int):
        super().__init__()
        self.input = input_plan
        self.fetch = fetch

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children: list[ExecutionPlan]) -> "LocalLimitExec":
        (child,) = children
        return LocalLimitExec(child, self.fetch)

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def execute(self, context: TaskContext) -> pa.Table:
        table = self.input.execute(context).slice(0, self.fetch)
        self.metrics.output_rows.add(table.num_rows)
        return table

    def display_line(self) -> str:
        return f"LocalLimitExec: fetch={self.fetch}"


class SortPreservingMergeExec(ExecutionPlan):
    name = "SortPreservingMergeExec"
    tree_name = "sort_preserving_merge"

    def __init__(self, exprs: list[SortExpr], input_plan: ExecutionPlan, fetch: int | None = None):
        super().__init__()
        self.exprs = exprs
        self.input = input_plan
        self.fetch = fetch

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children: list[ExecutionPlan]) -> "SortPreservingMergeExec":
        (child,) = children
        return SortPreservingMergeExec(self.exprs, child, self.fetch)

    def schema(self) -> pa.Schema:
        return self.input.schema()

    def execute(self, context: TaskContext) -> pa.Table:
        # Single-partition engine: input is already sorted; apply fetch.
        table = self.input.execute(context)
        if self.fetch is not None:
            table = table.slice(0, self.fetch)
        self.metrics.output_rows.add(table.num_rows)
        return table

    def display_line(self) -> str:
        return f"SortPreservingMergeExec: [{', '.join(str(e) for e in self.exprs)}]"


class ProjectionExec(ExecutionPlan):
    name = "ProjectionExec"
    tree_name = "projection"

    def __init__(
        self,
        exprs: list[tuple[PhysicalExpr, str]],
        input_plan: ExecutionPlan,
    ):
        super().__init__()
        self.exprs = exprs
        self.input = input_plan

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children: list[ExecutionPlan]) -> "ProjectionExec":
        (child,) = children
        return ProjectionExec(self.exprs, child)

    def schema(self) -> pa.Schema:
        input_schema = self.input.schema()
        fields = []
        for expr, name in self.exprs:
            from .expr import Column

            if isinstance(expr, Column) and expr.name in input_schema.names:
                fields.append(pa.field(name, input_schema.field(expr.name).type))
            else:
                fields.append(pa.field(name, pa.float64()))
        return pa.schema(fields)

    def execute(self, context: TaskContext) -> pa.Table:
        from .expr import Column

        table = self.input.execute(context)
        arrays = []
        names = []
        for expr, name in self.exprs:
            if isinstance(expr, Column):
                arrays.append(table.column(expr.name))
            else:
                arrays.append(pa.array(expr.evaluate(table)))
            names.append(name)
        out = pa.Table.from_arrays(arrays, names=names)
        self.metrics.output_rows.add(out.num_rows)
        return out

    def display_line(self) -> str:
        return (
            "ProjectionExec: "
            + ", ".join(name for _, name in self.exprs)
        )


def display_tree(plan: ExecutionPlan, indent: int = 0) -> str:
    """Indented plan display (DisplayableExecutionPlan analog)."""
    lines = [" " * indent + plan.display_line()]
    for child in plan.children():
        lines.append(display_tree(child, indent + 2))
    return "\n".join(lines)


def tree_render(plan: ExecutionPlan) -> str:
    """TreeRender analog: boxed nodes with key=value detail lines including
    metric values (the reference snapshot-tests this format,
    pq-vector src/df_vector/exec.rs:302-331). We use a simpler
    indented format but with the same content."""
    out: list[str] = []

    def visit(node: ExecutionPlan, depth: int) -> None:
        pad = "  " * depth
        out.append(f"{pad}{node.tree_name}")
        for line in node.tree_lines():
            out.append(f"{pad}  {line}")
        for child in node.children():
            visit(child, depth + 1)

    visit(plan, 0)
    return "\n".join(out)
