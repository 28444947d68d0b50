"""Logical plan IR for hybrid semantic-relational queries (paper §2.2).

A hybrid query plan is a rooted tree whose nodes are either relational
operators (Scan, Filter, Project, Join, CrossJoin, Aggregate, Limit, Union)
or semantic operators (SemanticFilter, SemanticJoin, SemanticProject).

Columns are fully qualified strings ``"table.col"``; ``ref_tables`` of a
semantic operator is derived from its referenced columns, matching the
paper's ``ref(SF_i)``.

The tree is mutable (rewrites swap nodes in place) but cheap to deep-copy;
optimizer passes always copy before mutating so callers keep the original.
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

# ---------------------------------------------------------------------------
# Relational predicate expressions (for σ). Small AST so pushdown can reason
# about referenced tables and the executor can evaluate on column arrays.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    def columns(self) -> set[str]:
        raise NotImplementedError


@dataclass(frozen=True)
class Col(Expr):
    name: str  # qualified "table.col"

    def columns(self) -> set[str]:
        return {self.name}

    def __repr__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Const(Expr):
    value: object

    def columns(self) -> set[str]:
        return set()

    def __repr__(self) -> str:
        return repr(self.value)


@dataclass(frozen=True)
class Cmp(Expr):
    """Comparison: op in {'==','!=','<','<=','>','>=','in','between'}."""

    op: str
    left: Expr
    right: object  # Expr | tuple for 'in'/'between'

    def columns(self) -> set[str]:
        cols = set(self.left.columns())
        if isinstance(self.right, Expr):
            cols |= self.right.columns()
        return cols

    def __repr__(self) -> str:
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class BoolOp(Expr):
    op: str  # 'and' | 'or' | 'not'
    args: tuple[Expr, ...]

    def columns(self) -> set[str]:
        out: set[str] = set()
        for a in self.args:
            out |= a.columns()
        return out

    def __repr__(self) -> str:
        if self.op == "not":
            return f"(not {self.args[0]})"
        return "(" + f" {self.op} ".join(map(repr, self.args)) + ")"


def split_conjuncts(e: Expr) -> list[Expr]:
    """Split a conjunctive predicate into minimal units (paper §5: 'we split
    hybrid WHERE clauses into minimal units')."""
    if isinstance(e, BoolOp) and e.op == "and":
        out: list[Expr] = []
        for a in e.args:
            out.extend(split_conjuncts(a))
        return out
    return [e]


def tables_of(cols: Sequence[str]) -> frozenset[str]:
    return frozenset(c.split(".", 1)[0] for c in cols)


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------

_node_counter = itertools.count()


@dataclass
class Node:
    children: list["Node"] = field(default_factory=list)
    # Unique id survives deep-copies (copied nodes keep ids) so optimizer
    # passes can anchor semantic filters to positions across tree copies.
    nid: int = field(default_factory=lambda: next(_node_counter))

    # -- classification -----------------------------------------------------
    @property
    def is_semantic(self) -> bool:
        return isinstance(
            self, (SemanticFilter, SemanticJoin, SemanticProject))

    @property
    def is_blocking(self) -> bool:
        """Blocking operators stop semantic-filter movement (paper Thm 4.1:
        LIMIT / UNION / aggregation are not swap-safe)."""
        return isinstance(self, (Aggregate, Limit, Union, Sort))

    # -- structure helpers ---------------------------------------------------
    def walk(self) -> Iterator["Node"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def parent_of(self, target: "Node") -> Optional["Node"]:
        for node in self.walk():
            if any(c is target for c in node.children):
                return node
        return None

    def find(self, nid: int) -> Optional["Node"]:
        for node in self.walk():
            if node.nid == nid:
                return node
        return None

    def base_tables(self) -> frozenset[str]:
        """tab(u): base tables in the subtree (paper §4.2)."""
        out: set[str] = set()
        for node in self.walk():
            if isinstance(node, Scan):
                out.add(node.table)
        return frozenset(out)

    def clone(self) -> "Node":
        return copy.deepcopy(self)

    # -- output columns ------------------------------------------------------
    def output_columns(self, catalog: "Catalog") -> list[str]:
        raise NotImplementedError

    def label(self) -> str:
        return type(self).__name__

    def pretty(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.label()]
        for c in self.children:
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)


@dataclass
class Scan(Node):
    table: str = ""

    def output_columns(self, catalog):
        return [f"{self.table}.{c}" for c in catalog.columns(self.table)]

    def label(self):
        return f"Scan({self.table})"


@dataclass
class Filter(Node):
    """Relational filter σ."""

    pred: Expr = None  # type: ignore[assignment]
    selectivity_hint: Optional[float] = None

    def output_columns(self, catalog):
        return self.children[0].output_columns(catalog)

    def label(self):
        return f"σ[{self.pred}]"


@dataclass
class Project(Node):
    """Relational projection π (column pruning; retains listed columns)."""

    cols: list[str] = field(default_factory=list)

    def output_columns(self, catalog):
        return list(self.cols)

    def label(self):
        return f"π[{', '.join(self.cols)}]"


@dataclass
class Join(Node):
    """Inner equi-join on left_key == right_key (qualified columns).

    ``physical`` is the cost-selected physical operator
    (``core/cost.py::select_physical_joins``): ``"hash"`` (device
    open-addressing build + probe), ``"sort_merge"`` (discounted when
    the build side arrives grouped by the key) or ``"host"`` (the host
    searchsorted oracle). ``None`` leaves the choice to the executor's
    runtime heuristic; the executor also downgrades to the host path
    whenever the key dtypes require it, whatever is annotated here."""

    left_key: str = ""
    right_key: str = ""
    physical: Optional[str] = None

    def output_columns(self, catalog):
        return (
            self.children[0].output_columns(catalog)
            + self.children[1].output_columns(catalog)
        )

    def label(self):
        return f"⋈[{self.left_key}={self.right_key}]"


@dataclass
class CrossJoin(Node):
    """Cartesian product ×, produced by SJ decomposition (paper §3.2)."""

    def output_columns(self, catalog):
        return (
            self.children[0].output_columns(catalog)
            + self.children[1].output_columns(catalog)
        )

    def label(self):
        return "×"


@dataclass
class Aggregate(Node):
    """γ: group-by + aggregates. Blocking for SF movement."""

    group_by: list[str] = field(default_factory=list)
    aggs: list[tuple[str, str, str]] = field(default_factory=list)
    # each agg: (func, qualified_col_or_'*', out_name)

    def output_columns(self, catalog):
        return list(self.group_by) + [f"agg.{name}"
                                      for _, _, name in self.aggs]

    def label(self):
        return f"γ[{self.group_by}; {[a[2] for a in self.aggs]}]"


@dataclass
class Limit(Node):
    n: int = 0

    def output_columns(self, catalog):
        return self.children[0].output_columns(catalog)

    def label(self):
        return f"Limit({self.n})"


@dataclass
class Sort(Node):
    """ORDER BY. Treated as blocking (swapping an SF past a LIMIT-feeding
    sort changes results; a pure sort would be safe but we keep the paper's
    conservative non-swappable set)."""

    keys: list[tuple[str, bool]] = field(default_factory=list)  # (col, desc)

    def output_columns(self, catalog):
        return self.children[0].output_columns(catalog)

    def label(self):
        return f"Sort({self.keys})"


@dataclass
class Union(Node):
    def output_columns(self, catalog):
        return self.children[0].output_columns(catalog)

    def label(self):
        return "∪"


# ---------------------------------------------------------------------------
# Semantic operators (paper §2.1)
# ---------------------------------------------------------------------------


@dataclass
class SemanticFilter(Node):
    """SF_φ(R) = {r ∈ R | M(r, φ) = true}. One LLM call per *distinct*
    non-null projection onto ``ref_cols`` under function caching."""

    phi: str = ""  # NL template, e.g. "{books.description} is about AI?"
    ref_cols: list[str] = field(default_factory=list)
    sf_id: int = -1  # filled by the optimizer pipeline
    selectivity_hint: Optional[float] = None

    @property
    def ref_tables(self) -> frozenset[str]:
        return tables_of(self.ref_cols)

    def output_columns(self, catalog):
        return self.children[0].output_columns(catalog)

    def label(self):
        return f"SF{self.sf_id if self.sf_id >= 0 else ''}[{self.phi!r}]"


@dataclass
class SemanticJoin(Node):
    """SJ_φ(R, S): pairs satisfying M(r, s, φ). Inner only (paper §3.2)."""

    phi: str = ""
    ref_cols: list[str] = field(default_factory=list)  # spans both children

    @property
    def ref_tables(self) -> frozenset[str]:
        return tables_of(self.ref_cols)

    def output_columns(self, catalog):
        return (
            self.children[0].output_columns(catalog)
            + self.children[1].output_columns(catalog)
        )

    def label(self):
        return f"SJ[{self.phi!r}]"


@dataclass
class SemanticProject(Node):
    """SP_φ(R): adds column ``out_col`` = M(r, φ) for each tuple."""

    phi: str = ""
    ref_cols: list[str] = field(default_factory=list)
    out_col: str = ""  # qualified "sp.<name>"
    out_dtype: str = "int"  # 'int' | 'float' | 'text'

    @property
    def ref_tables(self) -> frozenset[str]:
        return tables_of(self.ref_cols)

    def output_columns(self, catalog):
        return self.children[0].output_columns(catalog) + [self.out_col]

    def label(self):
        return f"SP[{self.phi!r} → {self.out_col}]"


# ---------------------------------------------------------------------------
# Catalog: schema + (optional) statistics. The analytic cost model reads
# base-table sizes here; the executor reads column types.
# ---------------------------------------------------------------------------


class Catalog:
    def __init__(self):
        self._tables: dict[str, dict] = {}

    def add_table(self, name: str, columns: Sequence[str], size: int,
                  ndv: Optional[dict[str, int]] = None):
        self._tables[name] = {
            "columns": list(columns),
            "size": int(size),
            "ndv": dict(ndv or {}),
        }

    def columns(self, table: str) -> list[str]:
        return self._tables[table]["columns"]

    def size(self, table: str) -> int:
        return self._tables[table]["size"]

    def ndv(self, qualified_col: str) -> Optional[int]:
        t, c = qualified_col.split(".", 1)
        if t in self._tables:
            return self._tables[t]["ndv"].get(c)
        return None

    def has_table(self, table: str) -> bool:
        return table in self._tables

    @property
    def tables(self) -> list[str]:
        return list(self._tables)


# ---------------------------------------------------------------------------
# Tree surgery shared by rewrite passes
# ---------------------------------------------------------------------------


def replace_child(parent: Node, old: Node, new: Node) -> None:
    for i, c in enumerate(parent.children):
        if c is old:
            parent.children[i] = new
            return
    raise ValueError("old is not a child of parent")


def swap_with_parent(root: Node, node: Node) -> Node:
    """Move a unary ``node`` above its parent p (paper Alg. 1 line 9).

    Before: g → p → ... node ... → c   After: g → node → p → ... c ...
    ``node`` must be unary. Returns the (possibly new) root.
    """
    assert len(node.children) == 1, "only unary operators can be pulled up"
    p = root.parent_of(node)
    if p is None:
        raise ValueError("node has no parent (is root)")
    g = root.parent_of(p)
    child = node.children[0]
    replace_child(p, node, child)
    node.children = [p]
    if g is None:
        return node
    replace_child(g, p, node)
    return root


def insert_above(root: Node, below: Node, new_unary: Node) -> Node:
    """Insert ``new_unary`` directly above ``below``. Returns new root."""
    assert not new_unary.children
    p = root.parent_of(below)
    new_unary.children = [below]
    if p is None:
        return new_unary
    replace_child(p, below, new_unary)
    return root


def remove_unary(root: Node, node: Node) -> Node:
    """Remove a unary node, splicing its child into its place."""
    assert len(node.children) == 1
    p = root.parent_of(node)
    child = node.children[0]
    node.children = []
    if p is None:
        return child
    replace_child(p, node, child)
    return root


def count_ops(root: Node) -> dict[str, int]:
    out: dict[str, int] = {}
    for n in root.walk():
        k = type(n).__name__
        out[k] = out.get(k, 0) + 1
    return out
