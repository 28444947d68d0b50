"""SQL front-end for hybrid semantic queries (paper §5 'Parsing and
binding').

Supports the paper's surface syntax:

    SELECT b.title, r.text
    FROM books b JOIN reviews r ON b.book_id = r.book_id
    WHERE SEMANTIC('{b.description} is about AI?')
      AND SEMANTIC('{r.text} is a positive review?')
      AND r.rating >= 3;

    SELECT b.title, SEMANTIC_INT('Rate {r.text} sentiment 1-5') AS score
    FROM books b JOIN reviews r ON b.id = r.book_id
    WHERE score >= 4;

Subset: SELECT list (columns, SEMANTIC_INT/FLOAT/TEXT projections with
AS), FROM with aliases, INNER/CROSS JOIN chains with equi ON, conjunctive
WHERE (comparisons, BETWEEN, IN, SEMANTIC()), ORDER BY, LIMIT. WHERE
clauses are split into minimal units so each semantic predicate becomes an
independently placeable SF (paper §5); alias-qualified columns inside
SEMANTIC templates are rebound to base-table names so ``ref(SF)`` is
correct. The emitted tree is the *unoptimized* plan — run it through
``repro.core.optimize`` exactly like builder-constructed plans.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from .builder import Q
from .plan import BoolOp, Cmp, Col, Expr, Node

_TOKEN_RE = re.compile(
    r"""
    (?P<string>'(?:[^']|'')*')
  | (?P<number>\d+\.\d+|\d+)
  | (?P<ident>[A-Za-z_][\w]*(?:\.[A-Za-z_][\w]*)?)
  | (?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*|;)
  | (?P<ws>\s+)
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "join", "cross", "inner", "on", "where", "and",
    "between", "in", "order", "by", "desc", "asc", "limit", "as",
    "semantic", "semantic_int", "semantic_float", "semantic_text",
    "group", "having", "not",
}


@dataclass
class Tok:
    kind: str  # string | number | ident | op | kw
    text: str


def tokenize(sql: str) -> list[Tok]:
    out: list[Tok] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SQLError(f"cannot tokenize at: {sql[pos:pos+24]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        kind = m.lastgroup
        text = m.group()
        if kind == "ident" and text.lower() in KEYWORDS:
            out.append(Tok("kw", text.lower()))
        else:
            out.append(Tok(kind, text))
    return out


class SQLError(ValueError):
    pass


@dataclass
class _SemProj:
    phi: str
    out_name: str
    dtype: str


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, k: int = 0) -> Optional[Tok]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Tok:
        t = self.peek()
        if t is None:
            raise SQLError("unexpected end of query")
        self.i += 1
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Tok]:
        t = self.peek()
        if t and t.kind == kind and (text is None or t.text == text):
            self.i += 1
            return t
        return None

    def expect(self, kind: str, text: Optional[str] = None) -> Tok:
        t = self.accept(kind, text)
        if t is None:
            got = self.peek()
            raise SQLError(f"expected {text or kind}, got "
                           f"{got.text if got else 'EOF'}")
        return t

    # -- grammar -----------------------------------------------------------
    def parse(self) -> Node:
        self.expect("kw", "select")
        select_items = self._select_list()
        self.expect("kw", "from")
        q, aliases = self._from_clause()

        # rebind helper: alias.col -> table.col
        def rebind(name: str) -> str:
            if "." in name:
                a, c = name.split(".", 1)
                return f"{aliases.get(a, a)}.{c}"
            return name

        sem_projs: list[_SemProj] = []
        out_cols: list[str] = []
        for item in select_items:
            if isinstance(item, _SemProj):
                item.phi = self._rebind_template(item.phi, aliases)
                sem_projs.append(item)
                out_cols.append(f"sp.{item.out_name}")
            else:
                out_cols.append(rebind(item))

        for sp in sem_projs:
            q = q.sem_project(sp.phi, f"sp.{sp.out_name}", dtype=sp.dtype)

        if self.accept("kw", "where"):
            for unit in self._where_units():
                kind, payload = unit
                if kind == "semantic":
                    q = q.sem_filter(self._rebind_template(payload, aliases))
                else:
                    q = q.where(self._rebind_expr(payload, aliases,
                                                  sem_projs))

        if self.accept("kw", "group"):
            raise SQLError("GROUP BY: use the builder API (Q.group_by)")
        order = []
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                col = rebind(self.expect("ident").text)
                desc = bool(self.accept("kw", "desc"))
                if not desc:
                    self.accept("kw", "asc")
                order.append((col, desc))
                if not self.accept("op", ","):
                    break
            q = q.order_by(*order)
        if self.accept("kw", "limit"):
            q = q.limit(int(self.expect("number").text))
        self.accept("op", ";")
        if self.peek() is not None:
            raise SQLError(f"trailing tokens at {self.peek().text!r}")
        return q.select(*out_cols).build()

    def _select_list(self):
        items = []
        while True:
            t = self.peek()
            if t.kind == "kw" and t.text.startswith("semantic_"):
                self.next()
                dtype = {"semantic_int": "int", "semantic_float": "float",
                         "semantic_text": "text"}[t.text]
                self.expect("op", "(")
                phi = self._string()
                self.expect("op", ")")
                self.expect("kw", "as")
                name = self.expect("ident").text
                items.append(_SemProj(phi=phi, out_name=name, dtype=dtype))
            else:
                items.append(self.expect("ident").text)
            if not self.accept("op", ","):
                return items

    def _from_clause(self):
        aliases: dict[str, str] = {}

        def table_ref():
            name = self.expect("ident").text
            alias = name
            t = self.peek()
            if t and t.kind == "ident":
                alias = self.next().text
            aliases[alias] = name
            return Q.scan(name), alias

        q, _ = table_ref()
        while True:
            if self.accept("kw", "cross"):
                self.expect("kw", "join")
                rhs, _ = table_ref()
                q = q.cross(rhs)
            elif self.accept("kw", "inner") or (
                    self.peek() and self.peek().kind == "kw"
                    and self.peek().text == "join"):
                self.accept("kw", "join") or self.expect("kw", "join")
                rhs, _ = table_ref()
                self.expect("kw", "on")
                lk = self.expect("ident").text
                self.expect("op", "=")
                rk = self.expect("ident").text
                lk, rk = (self._q(lk, aliases), self._q(rk, aliases))
                q = q.join(rhs, lk, rk)
            else:
                return q, aliases

    @staticmethod
    def _q(name: str, aliases: dict) -> str:
        a, c = name.split(".", 1)
        return f"{aliases.get(a, a)}.{c}"

    def _string(self) -> str:
        return self.expect("string").text[1:-1].replace("''", "'")

    def _where_units(self):
        """conjunctive units: ('semantic', phi) | ('rel', raw_cmp_tuple)."""
        units = []
        while True:
            if self.accept("kw", "semantic"):
                self.expect("op", "(")
                units.append(("semantic", self._string()))
                self.expect("op", ")")
            else:
                units.append(("rel", self._comparison()))
            if not self.accept("kw", "and"):
                return units

    def _comparison(self):
        neg = bool(self.accept("kw", "not"))
        lhs = self.expect("ident").text
        if self.accept("kw", "between"):
            lo = self._value()
            self.expect("kw", "and")
            hi = self._value()
            return ("between", lhs, (lo, hi), neg)
        if self.accept("kw", "in"):
            self.expect("op", "(")
            vals = [self._value()]
            while self.accept("op", ","):
                vals.append(self._value())
            self.expect("op", ")")
            return ("in", lhs, tuple(vals), neg)
        op = self.expect("op").text
        op = {"=": "==", "<>": "!="}.get(op, op)
        rhs = self._value()
        return (op, lhs, rhs, neg)

    def _value(self):
        t = self.next()
        if t.kind == "number":
            return float(t.text) if "." in t.text else int(t.text)
        if t.kind == "string":
            return t.text[1:-1]
        if t.kind == "ident":
            return Col(t.text)  # column-to-column comparison
        raise SQLError(f"bad value {t.text!r}")

    # -- rebinding -----------------------------------------------------------
    @staticmethod
    def _rebind_template(phi: str, aliases: dict) -> str:
        def sub(m):
            a, c = m.group(1).split(".", 1)
            return "{" + f"{aliases.get(a, a)}.{c}" + "}"

        return re.sub(r"\{([A-Za-z_]\w*\.[A-Za-z_]\w*)\}", sub, phi)

    def _rebind_expr(self, raw, aliases: dict,
                     sem_projs: list[_SemProj]) -> Expr:
        op, lhs, rhs, neg = raw
        sp_names = {sp.out_name for sp in sem_projs}
        if "." in lhs:
            a, c = lhs.split(".", 1)
            lhs_q = f"{aliases.get(a, a)}.{c}"
        elif lhs in sp_names:
            lhs_q = f"sp.{lhs}"  # reference to a SEMANTIC_* projection
        else:
            raise SQLError(f"unqualified column {lhs!r}")
        if isinstance(rhs, Col) and "." in rhs.name:
            a, c = rhs.name.split(".", 1)
            rhs = Col(f"{aliases.get(a, a)}.{c}")
        e: Expr = Cmp(op, Col(lhs_q), rhs)
        if neg:
            e = BoolOp("not", (e,))
        return e


def parse_sql(sql: str) -> Node:
    """Parse a hybrid semantic SQL query into an (unoptimized) plan tree."""
    return Parser(sql).parse()
