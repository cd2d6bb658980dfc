"""Minimal SQL front-end for the vector-search engine.

The reference rides DataFusion's full SQL stack; the capability that matters
for parity is the shape the rewrite rule fires on
(pq-vector src/df_vector/tests.rs:76-81)::

    SELECT cols FROM t [WHERE pred]
    ORDER BY array_distance(vec_col, [..literal..]) [ASC|DESC]
    [LIMIT k] [OFFSET m]

This recursive-descent parser supports exactly that surface (plus arithmetic,
boolean predicates, casts, column/``*`` projections and aliases) and lowers to
the logical plan in ``plan.py``.
"""

from __future__ import annotations

import dataclasses
import re

from ..errors import PlanError
from .expr import BinaryExpr, Cast, Column, Literal, NotExpr, PhysicalExpr, ScalarFunction

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<string>'(?:[^']|'')*')
  | (?P<op><=|>=|!=|<>|==|[=<>+\-*/(),\[\]\.])
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "SELECT",
    "FROM",
    "WHERE",
    "ORDER",
    "BY",
    "LIMIT",
    "OFFSET",
    "ASC",
    "DESC",
    "AND",
    "OR",
    "NOT",
    "AS",
    "CAST",
    "TRUE",
    "FALSE",
}


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # "number" | "ident" | "string" | "op" | "keyword"
    value: str


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise PlanError(f"Unexpected character {sql[pos]!r} at position {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        value = m.group()
        kind = m.lastgroup
        if kind == "ident" and value.upper() in _KEYWORDS:
            tokens.append(Token("keyword", value.upper()))
        else:
            tokens.append(Token(kind, value))
    return tokens


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: PhysicalExpr
    alias: str | None = None
    star: bool = False


@dataclasses.dataclass(frozen=True)
class OrderItem:
    expr: PhysicalExpr
    descending: bool = False


@dataclasses.dataclass(frozen=True)
class SelectStatement:
    projections: list[SelectItem]
    table: str
    predicate: PhysicalExpr | None
    order_by: list[OrderItem]
    limit: int | None
    offset: int


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.pos = 0

    # ------------------------------------------------------------------
    def peek(self) -> Token | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> Token:
        tok = self.peek()
        if tok is None:
            raise PlanError("Unexpected end of SQL input")
        self.pos += 1
        return tok

    def accept(self, kind: str, value: str | None = None) -> Token | None:
        tok = self.peek()
        if tok and tok.kind == kind and (value is None or tok.value == value):
            self.pos += 1
            return tok
        return None

    def expect(self, kind: str, value: str | None = None) -> Token:
        tok = self.accept(kind, value)
        if tok is None:
            got = self.peek()
            raise PlanError(
                f"Expected {value or kind}, got {got.value if got else 'end of input'}"
            )
        return tok

    # ------------------------------------------------------------------
    def parse_statement(self) -> SelectStatement:
        self.expect("keyword", "SELECT")
        projections = self.parse_select_list()
        self.expect("keyword", "FROM")
        table = self.expect("ident").value
        predicate = None
        if self.accept("keyword", "WHERE"):
            predicate = self.parse_expr()
        order_by: list[OrderItem] = []
        if self.accept("keyword", "ORDER"):
            self.expect("keyword", "BY")
            while True:
                expr = self.parse_expr()
                descending = False
                if self.accept("keyword", "DESC"):
                    descending = True
                else:
                    self.accept("keyword", "ASC")
                order_by.append(OrderItem(expr, descending))
                if not self.accept("op", ","):
                    break
        limit = None
        offset = 0
        # Accept LIMIT/OFFSET in either order, like DataFusion's SQL dialect.
        for _ in range(2):
            if self.accept("keyword", "LIMIT"):
                limit = int(self.expect("number").value)
            elif self.accept("keyword", "OFFSET"):
                offset = int(self.expect("number").value)
        if self.peek() is not None:
            raise PlanError(f"Unexpected trailing token {self.peek().value!r}")
        return SelectStatement(projections, table, predicate, order_by, limit, offset)

    def parse_select_list(self) -> list[SelectItem]:
        items: list[SelectItem] = []
        while True:
            if self.accept("op", "*"):
                items.append(SelectItem(Column("*"), star=True))
            else:
                expr = self.parse_expr()
                alias = None
                if self.accept("keyword", "AS"):
                    alias = self.expect("ident").value
                items.append(SelectItem(expr, alias))
            if not self.accept("op", ","):
                return items

    # Expression grammar ------------------------------------------------
    def parse_expr(self) -> PhysicalExpr:
        return self.parse_or()

    def parse_or(self) -> PhysicalExpr:
        left = self.parse_and()
        while self.accept("keyword", "OR"):
            left = BinaryExpr("OR", left, self.parse_and())
        return left

    def parse_and(self) -> PhysicalExpr:
        left = self.parse_not()
        while self.accept("keyword", "AND"):
            left = BinaryExpr("AND", left, self.parse_not())
        return left

    def parse_not(self) -> PhysicalExpr:
        if self.accept("keyword", "NOT"):
            return NotExpr(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> PhysicalExpr:
        left = self.parse_additive()
        tok = self.peek()
        if tok and tok.kind == "op" and tok.value in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            right = self.parse_additive()
            return BinaryExpr(tok.value, left, right)
        return left

    def parse_additive(self) -> PhysicalExpr:
        left = self.parse_multiplicative()
        while True:
            tok = self.peek()
            if tok and tok.kind == "op" and tok.value in ("+", "-"):
                self.next()
                left = BinaryExpr(tok.value, left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> PhysicalExpr:
        left = self.parse_unary()
        while True:
            tok = self.peek()
            if tok and tok.kind == "op" and tok.value in ("*", "/"):
                self.next()
                left = BinaryExpr(tok.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> PhysicalExpr:
        if self.accept("op", "-"):
            inner = self.parse_unary()
            if isinstance(inner, Literal) and isinstance(inner.value, (int, float)):
                return Literal(-inner.value)
            return BinaryExpr("-", Literal(0), inner)
        return self.parse_primary()

    def parse_primary(self) -> PhysicalExpr:
        tok = self.peek()
        if tok is None:
            raise PlanError("Unexpected end of SQL input")
        if tok.kind == "number":
            self.next()
            text = tok.value
            return Literal(float(text) if any(c in text for c in ".eE") else int(text))
        if tok.kind == "string":
            self.next()
            return Literal(tok.value[1:-1].replace("''", "'"))
        if tok.kind == "keyword" and tok.value in ("TRUE", "FALSE"):
            self.next()
            return Literal(tok.value == "TRUE")
        if tok.kind == "keyword" and tok.value == "CAST":
            self.next()
            self.expect("op", "(")
            inner = self.parse_expr()
            self.expect("keyword", "AS")
            target = self.expect("ident").value
            self.expect("op", ")")
            return Cast(inner, target)
        if tok.kind == "op" and tok.value == "(":
            self.next()
            inner = self.parse_expr()
            self.expect("op", ")")
            return inner
        if tok.kind == "op" and tok.value == "[":
            self.next()
            values: list[float] = []
            if not self.accept("op", "]"):
                while True:
                    item = self.parse_expr()
                    if not isinstance(item, Literal) or not isinstance(
                        item.value, (int, float)
                    ):
                        raise PlanError("Array literals must contain numbers")
                    values.append(float(item.value))
                    if self.accept("op", "]"):
                        break
                    self.expect("op", ",")
            return Literal(values)
        if tok.kind == "ident":
            self.next()
            if self.accept("op", "("):
                args: list[PhysicalExpr] = []
                if not self.accept("op", ")"):
                    while True:
                        args.append(self.parse_expr())
                        if self.accept("op", ")"):
                            break
                        self.expect("op", ",")
                return ScalarFunction(tok.value.lower(), tuple(args))
            return Column(tok.value)
        raise PlanError(f"Unexpected token {tok.value!r}")


def parse_sql(sql: str) -> SelectStatement:
    return Parser(sql).parse_statement()
