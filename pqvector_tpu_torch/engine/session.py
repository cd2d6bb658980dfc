"""Session + planner: the SessionContext analog (components #13/#14 glue).

The reference wires its rewrite into DataFusion via extension traits that
also force ``execution.parquet.skip_metadata = false`` so the index KV
metadata survives into scans (pq-vector src/df_vector/session.rs:11-35).
Here the engine owns its scans and the index operator reads footers through
the object store directly, so no such toggle is needed; ``Session`` simply
registers tables, parses SQL, lowers to the physical plan shapes the rule
matches, and runs registered optimizer rules.
"""

from __future__ import annotations

import dataclasses
import os

import pyarrow as pa
import torch

from .._device import resolve_device
from ..errors import PlanError
from .access import ScanFile
from .expr import Column, PhysicalExpr
from .object_store import DEFAULT_STORE, ObjectStore
from .options import VectorTopKOptions
from .physical import (
    ExecutionPlan,
    FilterExec,
    GlobalLimitExec,
    ParquetScanExec,
    ProjectionExec,
    SortExec,
    SortExpr,
    TaskContext,
    display_tree,
    tree_render,
)
from .rule import VectorTopKPhysicalOptimizerRule
from .sql import SelectStatement, parse_sql


class _Table:
    def __init__(self, paths: list[str], schema: pa.Schema):
        self.paths = paths
        self.schema = schema


class Session:
    """SQL session over registered Parquet files.

    ``Session(options)`` registers the VectorTopK rewrite (the
    ``PqVectorSessionBuilderExt::with_pq_vector`` analog, session.rs:24-35);
    pass ``enable_vector_topk=False`` for a plain exact-scan session (the
    bench's ground-truth configuration). ``device``: where the session's
    resident searchers live and its large re-scores run; ``None`` is the
    CUDA card (``RuntimeError`` without one), ``"cpu"`` the plain versions.
    """

    def __init__(
        self,
        options: VectorTopKOptions | None = None,
        enable_vector_topk: bool = True,
        object_store: ObjectStore = DEFAULT_STORE,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.options = options or VectorTopKOptions()
        self.object_store = object_store
        self._tables: dict[str, _Table] = {}
        self._searchers: dict = {}
        self._meta_cache: dict = {}
        self._index_cache: dict = {}
        self._rules = []
        if enable_vector_topk:
            self._rules.append(VectorTopKPhysicalOptimizerRule(self.options))

    # ------------------------------------------------------------------

    def register_parquet(self, name: str, path: str | os.PathLike | list) -> None:
        paths = [os.fspath(p) for p in (path if isinstance(path, (list, tuple)) else [path])]
        if not paths:
            raise PlanError("register_parquet requires at least one file")
        from .object_store import open_parquet

        schema = open_parquet(self.object_store, paths[0]).schema_arrow
        self._tables[name] = _Table(paths, schema)

    def sql(self, query: str) -> "DataFrame":
        return DataFrame(self, parse_sql(query))

    def device_searcher(self, name: str, **kwargs):
        """Device-resident batched searcher(s) for a registered table
        (serving extension). Cached per (table, file); built on the
        session's device unless ``device`` is given.

        Single-file tables return the searcher; multi-file tables build one
        resident searcher PER file (the SQL resident path merges per-file
        device top-k sets by distance — exec.py _try_resident) and return
        the list.
        """
        table = self._tables.get(name)
        if table is None:
            raise PlanError(f"Table '{name}' is not registered")
        searchers = []
        # kwargs are part of the identity: device_searcher("t", spill=0.2)
        # after a plain device_searcher("t") must build the spilled
        # searcher, not silently serve the cached unspilled one.
        kw_key = tuple(sorted((k, repr(v)) for k, v in kwargs.items()))
        for path in table.paths:
            cache_key = (name, path, kw_key)
            cached = self._searchers.get(cache_key)
            if cached is not None:
                from .physical import STAT_FAILED, file_cache_key

                fkey = file_cache_key(path)
                if (
                    fkey == STAT_FAILED
                    or getattr(cached, "source_key", None) != fkey
                ):
                    cached = None  # re-indexed/rewritten/unstatable: rebuild
            if cached is None:
                from ..query.device import DeviceIvfSearcher

                build_kw = dict(kwargs)
                build_kw.setdefault("device", self.device)
                cached = DeviceIvfSearcher.from_parquet(path, **build_kw)
                self._searchers[cache_key] = cached
            searchers.append(cached)
        return searchers[0] if len(searchers) == 1 else searchers

    def task_context(self) -> TaskContext:
        # Later registrations win per path (dict insertion order): a user
        # who re-built a file's searcher with new kwargs serves with it.
        resident = {
            path: searcher
            for (name, path, _kw), searcher in self._searchers.items()
        }
        return TaskContext(
            object_store=self.object_store,
            resident=resident,
            meta_cache=self._meta_cache,
            index_cache=self._index_cache,
            device=self.device,
        )

    # Planner ----------------------------------------------------------

    def plan_statement(self, stmt: SelectStatement) -> ExecutionPlan:
        table = self._tables.get(stmt.table)
        if table is None:
            raise PlanError(f"Table '{stmt.table}' is not registered")

        # ORDER BY may reference select-list aliases (SQL scoping rule);
        # resolve them to the aliased expressions before planning.
        alias_map = {
            item.alias: item.expr
            for item in stmt.projections
            if item.alias is not None
        }
        if alias_map and stmt.order_by:
            stmt = dataclasses.replace(
                stmt,
                order_by=[
                    dataclasses.replace(o, expr=_resolve_aliases(o.expr, alias_map))
                    for o in stmt.order_by
                ],
            )

        has_star = any(item.star for item in stmt.projections)
        needed: list[str] | None
        if has_star:
            needed = None
        else:
            cols: list[str] = []
            for item in stmt.projections:
                _collect_columns(item.expr, cols)
            if stmt.predicate is not None:
                _collect_columns(stmt.predicate, cols)
            for order in stmt.order_by:
                _collect_columns(order.expr, cols)
            known = set(table.schema.names)
            needed = [c for c in dict.fromkeys(cols) if c in known]
            missing = [c for c in cols if c not in known]
            if missing:
                raise PlanError(f"Column '{missing[0]}' not found")

        files = [
            ScanFile(object_path=p, file_size=self.object_store.head(p))
            for p in table.paths
        ]
        plan: ExecutionPlan = ParquetScanExec(files, table.schema, projection=needed)

        if stmt.predicate is not None:
            plan = FilterExec(stmt.predicate, plan)

        if stmt.order_by:
            sort_exprs = [
                SortExpr(item.expr, descending=item.descending)
                for item in stmt.order_by
            ]
            fetch = None
            if stmt.limit is not None:
                fetch = stmt.limit + stmt.offset
            plan = SortExec(sort_exprs, plan, fetch=fetch)

        if stmt.limit is not None or stmt.offset:
            plan = GlobalLimitExec(plan, skip=stmt.offset, fetch=stmt.limit)

        # Final projection (after limit, like DataFusion's output projection).
        proj: list[tuple[PhysicalExpr, str]] = []
        for item in stmt.projections:
            if item.star:
                for name in (needed or table.schema.names):
                    proj.append((Column(name), name))
            else:
                name = item.alias or str(item.expr)
                proj.append((item.expr, name))
        plan = ProjectionExec(proj, plan)
        return plan

    def optimize(self, plan: ExecutionPlan) -> ExecutionPlan:
        for rule in self._rules:
            plan = rule.optimize(plan)
        return plan


class DataFrame:
    """Lazy query handle (DataFusion DataFrame analog)."""

    def __init__(self, session: Session, statement: SelectStatement):
        self._session = session
        self._statement = statement
        self._plan: ExecutionPlan | None = None

    def physical_plan(self) -> ExecutionPlan:
        if self._plan is None:
            logical = self._session.plan_statement(self._statement)
            self._plan = self._session.optimize(logical)
        return self._plan

    def collect(self) -> pa.Table:
        return self.physical_plan().execute(self._session.task_context())

    def to_pandas(self):
        return self.collect().to_pandas()

    def explain(self) -> str:
        return display_tree(self.physical_plan())

    def explain_tree(self) -> str:
        """Tree render with metric values (run after collect() for counts)."""
        return tree_render(self.physical_plan())


def _collect_columns(expr: PhysicalExpr, out: list[str]) -> None:
    if isinstance(expr, Column):
        out.append(expr.name)
    for child in expr.children():
        _collect_columns(child, out)


def _resolve_aliases(expr: PhysicalExpr, alias_map: dict) -> PhysicalExpr:
    if isinstance(expr, Column) and expr.name in alias_map:
        return alias_map[expr.name]
    return expr
