"""Fluent plan-builder DSL used by benchmarks, examples and tests.

    q = (Q.scan("books")
          .join(Q.scan("reviews"), "books.book_id", "reviews.book_id")
          .where(col("reviews.rating") >= 3)
          .sem_filter("{books.description} is about AI?")
          .sem_filter("{reviews.text} is a positive review?")
          .select("books.title", "reviews.text"))
    plan = q.build()

Semantic templates reference qualified columns with ``{table.col}``; the
referenced columns (and hence ``ref(SF)``) are parsed from the template.
"""
from __future__ import annotations

import re
from typing import Iterable, Optional

from .plan import (
    Aggregate,
    BoolOp,
    Cmp,
    Col,
    Const,
    CrossJoin,
    Expr,
    Filter,
    Join,
    Limit,
    Node,
    Project,
    Scan,
    SemanticFilter,
    SemanticJoin,
    SemanticProject,
    Sort,
)

_TEMPLATE_COL = re.compile(r"\{([A-Za-z_][\w]*\.[A-Za-z_][\w]*)\}")


def template_columns(phi: str) -> list[str]:
    return list(dict.fromkeys(_TEMPLATE_COL.findall(phi)))


# -- expression sugar ---------------------------------------------------------


class _ColProxy:
    def __init__(self, name: str):
        self._c = Col(name)

    def __ge__(self, o):
        return Cmp(">=", self._c, _wrap(o))

    def __gt__(self, o):
        return Cmp(">", self._c, _wrap(o))

    def __le__(self, o):
        return Cmp("<=", self._c, _wrap(o))

    def __lt__(self, o):
        return Cmp("<", self._c, _wrap(o))

    def __eq__(self, o):  # type: ignore[override]
        return Cmp("==", self._c, _wrap(o))

    def __ne__(self, o):  # type: ignore[override]
        return Cmp("!=", self._c, _wrap(o))

    def isin(self, values: Iterable):
        return Cmp("in", self._c, tuple(values))

    def between(self, lo, hi):
        return Cmp("between", self._c, (lo, hi))


def _wrap(v):
    return v if isinstance(v, Expr) else Const(v)


def col(name: str) -> _ColProxy:
    return _ColProxy(name)


def and_(*args: Expr) -> Expr:
    return BoolOp("and", tuple(args))


def or_(*args: Expr) -> Expr:
    return BoolOp("or", tuple(args))


def not_(a: Expr) -> Expr:
    return BoolOp("not", (a,))


# -- builder -----------------------------------------------------------------


class Q:
    def __init__(self, node: Node):
        self.node = node

    # constructors
    @staticmethod
    def scan(table: str) -> "Q":
        return Q(Scan(table=table))

    # relational ops
    def where(self, pred: Expr, selectivity: Optional[float] = None) -> "Q":
        from .plan import split_conjuncts

        node = self.node
        for p in split_conjuncts(pred):
            node = Filter(children=[node], pred=p,
                          selectivity_hint=selectivity)
        return Q(node)

    def join(self, other: "Q", left_key: str, right_key: str) -> "Q":
        return Q(Join(children=[self.node, other.node], left_key=left_key,
                      right_key=right_key))

    def cross(self, other: "Q") -> "Q":
        return Q(CrossJoin(children=[self.node, other.node]))

    def select(self, *cols: str) -> "Q":
        return Q(Project(children=[self.node], cols=list(cols)))

    def group_by(self, keys: Iterable[str],
                 aggs: Iterable[tuple[str, str, str]]) -> "Q":
        return Q(Aggregate(children=[self.node], group_by=list(keys),
                           aggs=list(aggs)))

    def limit(self, n: int) -> "Q":
        return Q(Limit(children=[self.node], n=n))

    def order_by(self, *keys: tuple[str, bool]) -> "Q":
        return Q(Sort(children=[self.node], keys=list(keys)))

    # semantic ops
    def sem_filter(self, phi: str, selectivity: Optional[float] = None) -> "Q":
        return Q(SemanticFilter(children=[self.node], phi=phi,
                                ref_cols=template_columns(phi),
                                selectivity_hint=selectivity))

    def sem_join(self, other: "Q", phi: str) -> "Q":
        return Q(SemanticJoin(children=[self.node, other.node], phi=phi,
                              ref_cols=template_columns(phi)))

    def sem_project(self, phi: str, out_col: str, dtype: str = "int") -> "Q":
        return Q(SemanticProject(children=[self.node], phi=phi,
                                 ref_cols=template_columns(phi),
                                 out_col=out_col, out_dtype=dtype))

    def build(self) -> Node:
        return self.node
