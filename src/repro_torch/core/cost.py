"""Cost & cardinality estimation for PLOP (paper §4.2 + §5).

Statistics-free defaults exactly as the paper's implementation:

* semantic-filter selectivity            s_i   = 0.2
* per-join distinct-count reduction      s_⋈   = 0.1   (cross join: 1.0)
* relational filter selectivity default  0.25  (DuckDB-ish; hints override)
* join output |L ⋈ R| = |L|·|R| / max(ndv(lk), ndv(rk))  with ndv defaulting
  to the primary-side cardinality.

``N_{u,SF_i}`` (distinct rows at node u projected onto ref(SF_i)) follows
§5: the product over referenced base tables of (base size × s_⋈ per join on
the path from that table to u). Cross joins contribute factor 1. Note that,
unlike the prose in §5, other *semantic* filters are NOT folded into N here
— they enter through the explicit ``sel(ref(SF_i), S\\{i})`` factor of the
DP transition, which would otherwise double-count them.

``c(u)`` (per-operator relational cost, unfiltered by SFs) = estimated input
rows + output rows of u; cache-probe overhead of pulled-up filters is added
by the DP itself (§5 'function caching is not free').
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from .plan import (
    Aggregate,
    Catalog,
    CrossJoin,
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
    Union,
)

DEFAULT_SF_SELECTIVITY = 0.2
DEFAULT_JOIN_DISTINCT_SELECTIVITY = 0.1
DEFAULT_REL_FILTER_SELECTIVITY = 0.25

# physical equi-join operators, in deterministic tie-break order (the
# executor implements them in engine/exec.py::_equi_join)
JOIN_PHYSICAL_OPS = ("hash", "sort_merge", "host")


@dataclass
class CostParams:
    alpha: float = 1e-7
    s_sf: float = DEFAULT_SF_SELECTIVITY
    s_join: float = DEFAULT_JOIN_DISTINCT_SELECTIVITY
    s_rel: float = DEFAULT_REL_FILTER_SELECTIVITY
    # Per-filter selectivity overrides (sf_id -> s). Sampling-based
    # estimators fill this; benchmarks/fig8 sweeps it.
    sf_selectivity: dict[int, float] = field(default_factory=dict)
    # §5: charge one cache probe per row reaching a pulled-up filter.
    # False reproduces §4.2's formulas verbatim (no probe term).
    charge_probe_cost: bool = True
    # --- physical join selection (docs/joins.md, docs/cost_model.md) ---
    # c(u) of a Join becomes the min-cost physical operator's row model;
    # False keeps the flat rows-in + rows-out term of earlier revisions.
    price_physical_joins: bool = True
    # hash build weight: table insert + regroup passes over the build
    # side (vs one probe pass per probe row)
    w_hash_build: float = 2.0
    # host-oracle penalty per row: device→host transfer + code space
    w_host_join: float = 8.0
    # --- partitioned data tier (docs/sharding.md) ---
    # n_shards > 1 models the mesh executor: a Join's / grouped
    # Aggregate's local work divides across shards, but every row
    # entering the operator crosses the all_to_all exchange once,
    # charged at w_exchange per row. Defaults leave c(u) untouched.
    n_shards: int = 1
    w_exchange: float = 1.5

    def s_of(self, sf_id: int, hint: Optional[float] = None) -> float:
        if sf_id in self.sf_selectivity:
            return self.sf_selectivity[sf_id]
        if hint is not None:
            return hint
        return self.s_sf


class Estimator:
    """Bottom-up cardinality estimation over a plan *without* semantic
    filters applied (they are handled by the DP's sel() factors)."""

    def __init__(self, catalog: Catalog, params: CostParams):
        self.catalog = catalog
        self.params = params

    # -- cardinality ---------------------------------------------------------
    def card(self, node: Node) -> float:
        """Estimated output rows of ``node`` ignoring semantic filters."""
        if isinstance(node, Scan):
            return float(self.catalog.size(node.table))
        if isinstance(node, Filter):
            s = node.selectivity_hint
            if s is None:
                s = self.params.s_rel
            return self.card(node.children[0]) * s
        if isinstance(node, (SemanticFilter, SemanticProject)):
            # transparent: DP handles SF reduction; SP preserves cardinality
            return self.card(node.children[0])
        if isinstance(node, Join):
            lc = self.card(node.children[0])
            rc = self.card(node.children[1])
            lk_ndv = self.catalog.ndv(node.left_key)
            rk_ndv = self.catalog.ndv(node.right_key)
            denom = max(
                lk_ndv if lk_ndv else 0,
                rk_ndv if rk_ndv else 0,
                1,
            )
            if not lk_ndv and not rk_ndv:
                # no stats: classic System-R fallback, key side = bigger side
                denom = max(lc, rc, 1.0)
            return max(lc * rc / denom, 1.0)
        if isinstance(node, (CrossJoin, SemanticJoin)):
            return self.card(node.children[0]) * self.card(node.children[1])
        if isinstance(node, Aggregate):
            child = self.card(node.children[0])
            if not node.group_by:
                return 1.0
            return max(child * 0.1, 1.0)
        if isinstance(node, Limit):
            return min(self.card(node.children[0]), float(node.n))
        if isinstance(node, (Project, Sort)):
            return self.card(node.children[0])
        if isinstance(node, Union):
            return sum(self.card(c) for c in node.children)
        raise TypeError(f"unknown node {type(node)}")

    # -- physical join selection ----------------------------------------------
    def grouped_on(self, node: Node, key: str) -> bool:
        """True when ``node``'s output is guaranteed to arrive grouped
        (ascending) by ``key`` — the static mirror of the executor's
        ``Table.sorted_by`` metadata. Aggregate outputs ascend by their
        first group key (``np.unique`` order), ascending sorts by their
        primary key; filters, projections (key kept) and semantic
        operators preserve row order."""
        if isinstance(node, Aggregate):
            return bool(node.group_by) and node.group_by[0] == key
        if isinstance(node, Sort):
            return bool(node.keys) and node.keys[0] == (key, False)
        if isinstance(node, (Filter, SemanticFilter, SemanticProject)):
            return self.grouped_on(node.children[0], key)
        if isinstance(node, Project):
            return key in node.cols and self.grouped_on(node.children[0],
                                                        key)
        return False

    def join_physical_costs(self, node: Join) -> dict[str, float]:
        """Row-model cost of each physical operator for this join
        (probe side = left child, build side = right child):

        * ``hash``       —  |L| + w_hash_build·|R| + |out| : one probe
          pass, table insert + regroup passes over the build side;
        * ``sort_merge`` —  |L|·log2|R| + |R|·log2|R| + |out|, with the
          build-side sort term DISCOUNTED to a linear |R| touch when
          the input is already grouped by the key (an aggregate or
          ascending-sort output — ``grouped_on``);
        * ``host``       —  w_host_join·(|L| + |R|) + |out| : the
          searchsorted oracle plus its device→host transfers.
        """
        lc = self.card(node.children[0])
        rc = self.card(node.children[1])
        out = self.card(node)
        p = self.params
        lg_b = math.log2(max(rc, 2.0))
        presorted = self.grouped_on(node.children[1], node.right_key)
        return {
            "hash": lc + p.w_hash_build * rc + out,
            "sort_merge": lc * lg_b + (rc if presorted else rc * lg_b)
            + out,
            "host": p.w_host_join * (lc + rc) + out,
        }

    def choose_join_physical(self, node: Join) -> tuple[str, float]:
        """Min-cost physical operator for ``node`` and its cost, ties
        broken in ``JOIN_PHYSICAL_OPS`` order (hash first)."""
        costs = self.join_physical_costs(node)
        best = min(JOIN_PHYSICAL_OPS, key=lambda op: costs[op])
        return best, costs[best]

    # -- per-operator relational cost c(u) ------------------------------------
    def c(self, node: Node) -> float:
        """Rows processed by relational operator u on SF-unfiltered input
        (paper: 'estimated by the relational optimizer'). Equi joins are
        priced as their cheapest physical operator, putting physical
        join selection inside the DP objective's C_rel term.

        With ``n_shards > 1`` (the partitioned mesh executor) the local
        work of a Join / grouped Aggregate divides across shards while
        every input row pays the exchange term ``w_exchange`` once —
        so the DP sees that partitioning is not free, exactly like the
        cache-probe charge of pulled-up filters (§5)."""
        if isinstance(node, Scan):
            return float(self.catalog.size(node.table))
        p = self.params
        if isinstance(node, Join) and p.price_physical_joins:
            local = self.choose_join_physical(node)[1]
            if p.n_shards > 1:
                exchanged = sum(self.card(c) for c in node.children)
                return local / p.n_shards + p.w_exchange * exchanged
            return local
        ins = sum(self.card(c) for c in node.children)
        if (p.n_shards > 1 and isinstance(node, Aggregate)
                and node.group_by):
            return (ins + self.card(node)) / p.n_shards \
                + p.w_exchange * ins
        return ins + self.card(node)

    # -- N_{u,SF}: distinct rows of ref tables visible at u -------------------
    def distinct_at(self, root_of_subtree: Node,
                    ref_tables: frozenset[str]) -> float:
        """N_{u,SF_i}: for each referenced base table, base size reduced by
        s_⋈ per join on the path from the table's Scan up to u; referenced
        tables multiply together (SJ-decomposed filters see pairs)."""
        total = 1.0
        for t in ref_tables:
            path = _path_to_scan(root_of_subtree, t)
            if path is None:
                return float("inf")  # table not visible at this node
            n = float(self.catalog.size(t))
            for anc in path:  # nodes strictly above the Scan, up to u
                if isinstance(anc, Join):
                    n *= self.params.s_join
                # CrossJoin: selectivity 1 (paper §5) — no reduction
            total *= max(n, 1.0)
        return total


def select_physical_joins(root: Node, catalog: Catalog,
                          params: Optional[CostParams] = None) -> Node:
    """Annotate every equi join in ``root`` (in place) with its
    min-cost physical operator (``Join.physical``). Runs as the last
    optimizer stage, after semantic-operator placement settled the
    plan shape; the executor may still downgrade at runtime when key
    dtypes rule the device paths out."""
    est = Estimator(catalog, params or CostParams())
    for node in root.walk():
        if isinstance(node, Join):
            node.physical = est.choose_join_physical(node)[0]
    return root


def _path_to_scan(u: Node, table: str) -> Optional[list[Node]]:
    """Nodes on the path from u down to Scan(table), excluding the Scan,
    ordered top-down (u first). None if the table is not in u's subtree."""
    if isinstance(u, Scan):
        return [] if u.table == table else None
    for c in u.children:
        sub = _path_to_scan(c, table)
        if sub is not None:
            return [u] + sub
    return None


def plan_cost_report(root: Node, catalog: Catalog, params: CostParams) -> dict:
    """Estimate C_LLM and C_rel of a *concrete* plan (with SFs in place),
    used for optimizer unit tests and the overhead benchmark. Applies
    sel() reductions for semantic filters below each operator."""
    est = Estimator(catalog, params)

    def placed_below(node: Node) -> list[SemanticFilter]:
        return [n for n in node.walk() if isinstance(n, SemanticFilter)]

    c_rel = 0.0
    c_llm = 0.0
    for node in root.walk():
        if isinstance(node, (Scan,)):
            continue
        sfs_below = [
            sf for c in node.children for sf in placed_below(c)
        ]
        sel = 1.0
        tabs = node.base_tables()
        for sf in sfs_below:
            if sf.ref_tables & tabs:
                sel *= params.s_of(sf.sf_id, sf.selectivity_hint)
        if isinstance(node, SemanticFilter):
            others = [sf for sf in sfs_below if sf is not node]
            sel_others = 1.0
            for sf in others:
                if sf.ref_tables & node.ref_tables:
                    sel_others *= params.s_of(sf.sf_id, sf.selectivity_hint)
            n_u = est.distinct_at(node.children[0], node.ref_tables)
            c_llm += n_u * sel_others
        elif isinstance(node, SemanticProject):
            n_u = est.distinct_at(node.children[0], node.ref_tables)
            c_llm += n_u * sel
        elif not node.is_semantic:
            c_rel += est.c(node) * sel
    return {
        "c_llm": c_llm,
        "c_rel": c_rel,
        "total": c_llm + params.alpha * c_rel,
    }
