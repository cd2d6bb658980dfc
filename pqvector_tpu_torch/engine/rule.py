"""Physical optimizer rule rewriting TopK sorts into VectorTopKExec.

Component #14 in SURVEY.md §2 (pq-vector src/df_vector/physical.rs).
Matches four plan shapes, with the reference's exact safety conditions:

1. ``SortPreservingMergeExec(SortExec)`` — same single sort key, sort has
   ``preserve_partitioning``, no offset above (physical.rs:37-53)
2. ``GlobalLimitExec(SortExec)`` — ``skip == 0`` (physical.rs:55-68)
3. ``LocalLimitExec(SortExec)`` (physical.rs:70-81)
4. bare ``SortExec`` with ``fetch`` — no offset above (physical.rs:83-88)

Requirements: exactly one ASC sort key (:139-145) whose expression is
``array_distance(column, literal-vector)`` after cast stripping (:198-229),
exactly one Parquet scan under the sort with a nonzero file count (:149-159),
``k = min(sort.fetch, limit.fetch)`` (:161-169). Any ``skip > 0`` above
disables the rewrite (:59-63).

Note on shapes 1 and 3: our planner (engine/session.py:plan_statement) is
single-partition and only ever emits ``SortExec``/``GlobalLimitExec``, so the
``SortPreservingMergeExec`` and ``LocalLimitExec`` branches fire only on
hand-constructed plans (tests/test_rule_shapes.py). They are kept for parity
bookkeeping with the reference's four shapes and so externally-built plans
(or a future multi-partition planner) rewrite identically.
"""

from __future__ import annotations

from .exec import VectorTopKExec, gather_single_parquet_scan
from .expr import extract_array_distance
from .options import VectorTopKOptions
from .physical import (
    ExecutionPlan,
    GlobalLimitExec,
    LocalLimitExec,
    SortExec,
    SortPreservingMergeExec,
)


class VectorTopKPhysicalOptimizerRule:
    """Rewrites ORDER BY array_distance(...) LIMIT k into VectorTopKExec."""

    name = "vector_topk_physical"

    def __init__(self, options: VectorTopKOptions):
        self.options = options

    def optimize(self, plan: ExecutionPlan) -> ExecutionPlan:
        return self._rewrite(plan, has_offset=False)

    # ------------------------------------------------------------------

    def _rewrite(self, plan: ExecutionPlan, has_offset: bool) -> ExecutionPlan:
        if isinstance(plan, SortPreservingMergeExec):
            inner = plan.input
            if (
                not has_offset
                and isinstance(inner, SortExec)
                and len(plan.exprs) == 1
                and len(inner.exprs) == 1
                and plan.exprs[0] == inner.exprs[0]
                and inner.preserve_partitioning
            ):
                topk = self._build_topk(inner, plan.fetch, from_merge=True)
                if topk is not None:
                    return topk
            return self._rewrite_children(plan, has_offset)

        if isinstance(plan, GlobalLimitExec):
            if plan.skip == 0 and isinstance(plan.input, SortExec):
                topk = self._build_topk(plan.input, plan.fetch)
                if topk is not None:
                    return topk
            return self._rewrite_children(plan, has_offset or plan.skip > 0)

        if isinstance(plan, LocalLimitExec):
            if isinstance(plan.input, SortExec):
                topk = self._build_topk(plan.input, plan.fetch)
                if topk is not None:
                    return topk
            return self._rewrite_children(plan, has_offset)

        if isinstance(plan, SortExec) and not has_offset:
            topk = self._build_topk(plan, None)
            if topk is not None:
                return topk

        return self._rewrite_children(plan, has_offset)

    def _rewrite_children(self, plan: ExecutionPlan, has_offset: bool) -> ExecutionPlan:
        children = plan.children()
        if not children:
            return plan
        new_children = [self._rewrite(c, has_offset) for c in children]
        if all(a is b for a, b in zip(children, new_children)):
            return plan
        return plan.with_new_children(new_children)

    def _build_topk(
        self, sort: SortExec, limit_fetch: int | None, from_merge: bool = False
    ) -> ExecutionPlan | None:
        if not from_merge and sort.preserve_partitioning:
            return None  # physical.rs:120-123
        if len(sort.exprs) != 1:
            return None
        sort_expr = sort.exprs[0]
        if sort_expr.descending:
            return None
        match = extract_array_distance(sort_expr.expr)
        if match is None:
            return None
        column, query = match
        scan = gather_single_parquet_scan(sort.input)
        if scan is None or not scan.files:
            return None
        if limit_fetch is not None:
            k = min(sort.fetch, limit_fetch) if sort.fetch is not None else limit_fetch
        else:
            if sort.fetch is None:
                return None
            k = sort.fetch
        return VectorTopKExec.try_new(
            sort.input, column, query, k, self.options
        )
