"""Physical expression tree for the SQL-style engine.

Stands in for DataFusion's ``PhysicalExpr`` as used by the reference rewrite
rule (pq-vector src/df_vector/physical.rs:198-243 and expr.rs:8-15):
columns, literals, casts (which the matcher strips), comparisons/boolean
logic for predicates, and the ``array_distance`` scalar function.

Evaluation is vectorized over Arrow tables (numpy under the hood) — this is
the host-side slow path used by the unindexed fallback; the indexed path
routes distance work to the device instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import pyarrow as pa


from ..errors import PlanError


class PhysicalExpr:
    """Base class. ``evaluate`` returns a numpy array (len == table rows)."""

    def evaluate(self, table: pa.Table) -> np.ndarray:
        raise NotImplementedError

    def children(self) -> list["PhysicalExpr"]:
        return []


@dataclasses.dataclass(frozen=True)
class Column(PhysicalExpr):
    name: str

    def evaluate(self, table: pa.Table) -> np.ndarray:
        if self.name not in table.column_names:
            raise PlanError(f"Column '{self.name}' not found")
        col = table.column(self.name)
        return np.asarray(col.to_pylist(), dtype=object) if _is_nested(col.type) else col.to_numpy(zero_copy_only=False)

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class Literal(PhysicalExpr):
    value: Any

    def evaluate(self, table: pa.Table) -> np.ndarray:
        return np.full(table.num_rows, self.value, dtype=object if isinstance(self.value, (list, tuple, str)) else None)

    def __str__(self) -> str:
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class Cast(PhysicalExpr):
    """CastExpr analog — stripped by the rewrite matcher
    (physical.rs:216-229)."""

    expr: PhysicalExpr
    target: str = ""

    def evaluate(self, table: pa.Table) -> np.ndarray:
        return self.expr.evaluate(table)

    def children(self) -> list[PhysicalExpr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"CAST({self.expr})"


@dataclasses.dataclass(frozen=True)
class TryCast(Cast):
    def __str__(self) -> str:
        return f"TRY_CAST({self.expr})"


_CMP_OPS = {
    "=": lambda a, b: a == b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


@dataclasses.dataclass(frozen=True)
class BinaryExpr(PhysicalExpr):
    op: str
    left: PhysicalExpr
    right: PhysicalExpr

    def evaluate(self, table: pa.Table) -> np.ndarray:
        if self.op in ("AND", "OR"):
            lv = self.left.evaluate(table).astype(bool)
            rv = self.right.evaluate(table).astype(bool)
            return lv & rv if self.op == "AND" else lv | rv
        if self.op in _CMP_OPS:
            lv = self.left.evaluate(table)
            rv = self.right.evaluate(table)
            return _CMP_OPS[self.op](lv, rv)
        if self.op in ("+", "-", "*", "/"):
            lv = self.left.evaluate(table).astype(np.float64)
            rv = self.right.evaluate(table).astype(np.float64)
            if self.op == "+":
                return lv + rv
            if self.op == "-":
                return lv - rv
            if self.op == "*":
                return lv * rv
            return lv / rv
        raise PlanError(f"Unsupported operator '{self.op}'")

    def children(self) -> list[PhysicalExpr]:
        return [self.left, self.right]

    def __str__(self) -> str:
        return f"{self.left} {self.op} {self.right}"


@dataclasses.dataclass(frozen=True)
class NotExpr(PhysicalExpr):
    expr: PhysicalExpr

    def evaluate(self, table: pa.Table) -> np.ndarray:
        return ~self.expr.evaluate(table).astype(bool)

    def children(self) -> list[PhysicalExpr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"NOT {self.expr}"


@dataclasses.dataclass(frozen=True)
class ScalarFunction(PhysicalExpr):
    """Scalar function call; ``array_distance`` is the one the rewrite rule
    matches (physical.rs:200-203)."""

    name: str
    args: tuple[PhysicalExpr, ...]

    def evaluate(self, table: pa.Table) -> np.ndarray:
        if self.name == "array_distance":
            return _eval_array_distance(self, table)
        if self.name == "sqrt":
            return np.sqrt(self.args[0].evaluate(table).astype(np.float64))
        raise PlanError(f"Unsupported function '{self.name}'")

    def children(self) -> list[PhysicalExpr]:
        return list(self.args)

    def __str__(self) -> str:
        return f"{self.name}({', '.join(str(a) for a in self.args)})"


def _is_nested(typ: pa.DataType) -> bool:
    return pa.types.is_list(typ) or pa.types.is_large_list(typ) or pa.types.is_fixed_size_list(typ)


def _eval_array_distance(fn: ScalarFunction, table: pa.Table) -> np.ndarray:
    if len(fn.args) != 2:
        raise PlanError("array_distance takes exactly two arguments")
    col_expr = strip_casts(fn.args[0])
    lit_expr = strip_casts(fn.args[1])
    if isinstance(col_expr, Literal) and isinstance(lit_expr, Column):
        col_expr, lit_expr = lit_expr, col_expr
    if not isinstance(col_expr, Column) or not isinstance(lit_expr, Literal):
        raise PlanError("array_distance requires a column and a literal vector")
    query = literal_to_f32_vector(lit_expr)
    if query is None:
        raise PlanError("array_distance literal must be a float vector")
    if col_expr.name not in table.column_names:
        raise PlanError(f"Column '{col_expr.name}' not found")

    # Vectorized over Arrow buffers: uniform-dim valid rows get one einsum;
    # null / dim-mismatch rows stay NaN (the skip semantic, exec.rs:527,538).
    dim = query.size
    out = np.full(table.num_rows, np.nan, dtype=np.float64)
    base = 0
    for chunk in table.column(col_expr.name).chunks:
        n = len(chunk)
        if n == 0:
            continue
        valid = np.ones(n, dtype=bool)
        if chunk.null_count:
            valid = np.asarray(chunk.is_valid())
        if isinstance(chunk, pa.FixedSizeListArray):
            lengths = np.full(n, chunk.type.list_size, dtype=np.int64)
            flat = chunk.flatten()
            starts = np.arange(n, dtype=np.int64) * chunk.type.list_size
        elif isinstance(chunk, (pa.ListArray, pa.LargeListArray)):
            offsets = np.asarray(chunk.offsets)
            lengths = np.diff(offsets)
            first = int(offsets[0])
            flat = chunk.values.slice(first, int(offsets[-1]) - first)
            starts = (offsets[:-1] - first).astype(np.int64)
        else:
            raise PlanError("Vector column must be list or fixed-size list")
        vals = flat.to_numpy(zero_copy_only=False).astype(np.float32, copy=False)
        ok = valid & (lengths == dim)
        rows = np.flatnonzero(ok)
        if rows.size:
            gather = starts[rows][:, None] + np.arange(dim)[None, :]
            mat = vals[gather]
            diff = mat - query[None, :]
            # DataFusion's array_distance returns the euclidean (sqrt)
            # distance.
            out[base + rows] = np.sqrt(np.einsum("nd,nd->n", diff, diff))
        base += n
    return out


def strip_casts(expr: PhysicalExpr) -> PhysicalExpr:
    """Strip Cast/TryCast wrappers (physical.rs:216-229)."""
    while isinstance(expr, Cast):
        expr = expr.expr
    return expr


def literal_to_f32_vector(lit: Literal) -> np.ndarray | None:
    """``scalar_to_f32_list`` analog (pq-vector src/df_vector/expr.rs:8-15):
    a list literal of floats -> float32 vector, else None."""
    value = lit.value
    if not isinstance(value, (list, tuple, np.ndarray)):
        return None
    try:
        arr = np.asarray(value, dtype=np.float32)
    except (TypeError, ValueError):
        return None
    if arr.ndim != 1 or arr.size == 0:
        return None
    return arr


def extract_array_distance(expr: PhysicalExpr) -> tuple[str, np.ndarray] | None:
    """Match ``array_distance(column, literal-vector)`` after stripping casts
    on the call and both arguments, either argument order
    (physical.rs:198-214)."""
    expr = strip_casts(expr)
    if not isinstance(expr, ScalarFunction) or expr.name != "array_distance":
        return None
    if len(expr.args) != 2:
        return None
    left = strip_casts(expr.args[0])
    right = strip_casts(expr.args[1])

    def col_of(e):
        e = strip_casts(e)
        return e.name if isinstance(e, Column) else None

    def lit_of(e):
        e = strip_casts(e)
        return e if isinstance(e, Literal) else None

    column, literal = col_of(left), lit_of(right)
    if column is None or literal is None:
        column, literal = col_of(right), lit_of(left)
        if column is None or literal is None:
            return None
    vector = literal_to_f32_vector(literal)
    if vector is None:
        return None
    return column, vector
