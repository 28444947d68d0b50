"""Plain evaluation of a query file over the benchmark's own tables.

The semantics the program's plans must keep, whatever order its
optimiser chose: scans, inner equi-joins and comparisons give candidate
rows; a semantic filter or join keeps a row iff the verdict of its
rendered prompt is true (a NULL value: no prompt, the row is out); then
grouped counts and projections. Verdicts come from the served answers
(``verdicts``: prompt -> bool); the reference renders every prompt
itself. A row is decided by the verdicts it has: out at the first
false one, in when every one is true. A row whose verdicts are all
true or absent, with one absent, needed an answer the program never
asked for, and is counted as missing."""
from __future__ import annotations

import re

import numpy as np

TEMPLATE_COL = re.compile(r"\{([A-Za-z_]\w*\.[A-Za-z_]\w*)\}")


def value(v):
    """A value as the program's columns hold it: float32 floats."""
    if isinstance(v, float):
        return float(np.float32(v))
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    if isinstance(v, np.integer):
        return int(v)
    return v


def render(phi: str, recs: dict) -> str | None:
    """``phi`` with each ``{table.col}`` replaced by ``str`` of the
    record's value; None when one is NULL."""
    missing = False

    def sub(m):
        nonlocal missing
        t, c = m.group(1).split(".", 1)
        v = recs[t].get(c) if t in recs else None
        if v is None:
            missing = True
            return m.group(0)
        return str(v)

    out = TEMPLATE_COL.sub(sub, phi)
    return None if missing else out


def _cmp(op: str, a, b) -> bool:
    a = value(a)
    if op == "between":
        return value(b[0]) <= a <= value(b[1])
    b = value(b)
    return {">=": a >= b, ">": a > b, "<=": a <= b, "<": a < b,
            "==": a == b, "!=": a != b}[op]


class Query:
    """One evaluation of query file ``spec`` over ``tables`` ({table:
    (records, text columns)}) with ``templates`` ({name: text})."""

    def __init__(self, spec: dict, tables: dict, templates: dict):
        self.spec, self.tables, self.templates = spec, tables, templates
        self.missing = 0

    def _scan(self, t: str) -> list:
        return [{t: r} for r in self.tables[t][0]]

    def _get(self, row: dict, qual: str):
        t, c = qual.split(".", 1)
        return row[t].get(c)

    def _rel(self, node: dict) -> list:
        """Rows as ``({table: record}, [prompt or None, ...])``."""
        rows = [(r, []) for r in self._scan(node["scan"])]
        for op in node["ops"]:
            if "join" in op:
                right = self._rel(op["join"])
                lk, rk = op["on"]
                index: dict = {}
                for rr, rp in right:
                    index.setdefault(value(self._get(rr, rk)), []).append(
                        (rr, rp))
                rows = [({**lr, **rr}, lp + rp) for lr, lp in rows
                        for rr, rp in index.get(value(self._get(lr, lk)),
                                                ())]
            elif "where" in op:
                c, o, v = op["where"]
                rows = [(r, p) for r, p in rows
                        if _cmp(o, self._get(r, c), v)]
            elif "sem_filter" in op:
                phi = self.templates[op["sem_filter"]]
                rows = [(r, p + [render(phi, r)]) for r, p in rows]
            elif "sem_join" in op:
                phi = self.templates[op["template"]]
                right = self._rel(op["sem_join"])
                rows = [({**lr, **rr}, lp + rp + [render(phi, {**lr, **rr})])
                        for lr, lp in rows for rr, rp in right]
            elif "group_by" in op or "select" in op:
                rows = self._decide(rows, self.verdicts)
                if "group_by" in op:
                    rows = self._group(rows, op)
            else:
                raise ValueError(f"unknown operator {sorted(op)}")
        return rows

    def _decide(self, rows: list, verdicts: dict) -> list:
        kept = []
        for r, prompts in rows:
            if any(p is None for p in prompts):
                continue  # SF(NULL) = NULL: the row is out, no call made
            seen = [verdicts[p] for p in prompts if p in verdicts]
            if not all(seen):
                continue
            if len(seen) < len(prompts):
                self.missing += 1
                continue
            kept.append((r, []))
        return kept

    def _group(self, rows: list, op: dict) -> list:
        groups: dict = {}
        for r, _ in rows:
            key = tuple(value(self._get(r, k)) for k in op["group_by"])
            groups.setdefault(key, []).append(r)
        out = []
        for key, members in groups.items():
            rec = {"agg": {}}
            for k, v in zip(op["group_by"], key):
                t, c = k.split(".", 1)
                rec.setdefault(t, {})[c] = v
            for func, colname, name in op["aggs"]:
                if func != "count":
                    raise NotImplementedError(f"aggregate {func!r}")
                rec["agg"][name] = len(members)
            out.append((rec, []))
        return out

    def rows(self, verdicts: dict) -> list:
        """The result's rows, each a tuple of the query's ``out``
        columns, sorted (SQL gives no order without ORDER BY)."""
        self.verdicts = verdicts
        self.missing = 0
        final = self._decide(self._rel(self.spec["plan"]), verdicts)
        return sorted(tuple(value(self._get(r, c)) for c in self.spec["out"])
                      for r, _ in final)

    def universe(self) -> set:
        """Every prompt a plan of this query could send: each semantic
        template rendered over every row (every pair of rows for a
        two-table template) of the tables it names."""
        out = set()

        def walk(node):
            for op in node["ops"]:
                for sub in ("join", "sem_join"):
                    if sub in op:
                        walk(op[sub])
                name = op.get("sem_filter") or op.get("template")
                if name:
                    phi = self.templates[name]
                    tabs = list(dict.fromkeys(
                        m.split(".", 1)[0] for m in TEMPLATE_COL.findall(phi)))
                    combos = [{}]
                    for t in tabs:
                        combos = [{**c, t: r} for c in combos
                                  for r in self.tables[t][0]]
                    out.update(render(phi, c) for c in combos)

        walk(self.spec["plan"])
        out.discard(None)
        return out
