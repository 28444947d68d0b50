"""PLOP optimizer pipeline (paper §5 'Optimizer integration').

Stages, mirroring the paper's DuckDB integration:

1. ``baseline``  — DuckDB-style predicate pushdown puts every σ and SF at
   its lowest feasible position. This is the "DuckDB + Cache" reference
   plan and defines each SF's original anchor.
2. ``simplify``  — SP pull-up + SJ decomposition to convergence (§3.2).
3. strategy:
   * ``pullup`` — Alg. 1 greedy pull-up (PLOP-Pullup);
   * ``cost``   — Alg. 2 DP placement (PLOP-Cost);
   * ``none``   — keep the pushed-down baseline.

``optimize()`` returns an ``OptimizedPlan`` carrying the final tree, the
strategy metadata and wall-clock optimizer overhead split by phase
(reproducing Fig. 9's decomposition).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .cost import CostParams, plan_cost_report, select_physical_joins
from .dp import dp_place, lift_semantic_filters, rebuild_plan
from .plan import Catalog, Node, SemanticFilter
from .pullup import pull_up_semantic_filters
from .rewrite import push_down_filters, simplify

STRATEGIES = ("none", "pullup", "cost")


@dataclass
class OptimizedPlan:
    plan: Node
    strategy: str
    n_semantic_filters: int
    est_cost: float | None = None
    dp_states: int | None = None
    overhead: dict[str, float] = field(default_factory=dict)

    @property
    def total_overhead(self) -> float:
        return sum(self.overhead.values())


def optimize(
    root: Node,
    catalog: Catalog,
    strategy: str = "cost",
    params: CostParams | None = None,
) -> OptimizedPlan:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}")
    params = params or CostParams()
    plan = root.clone()
    overhead: dict[str, float] = {}

    t0 = time.perf_counter()
    plan = push_down_filters(plan, catalog)
    overhead["pushdown"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    plan = simplify(plan, catalog)
    # SJ decomposition exposes new pushdown opportunities: relational σ
    # sinks between × and the decomposed SF (§3.2).
    plan = push_down_filters(plan, catalog)
    overhead["simplify"] = time.perf_counter() - t0

    n_sf = sum(1 for n in plan.walk() if isinstance(n, SemanticFilter))

    est_cost = None
    dp_states = None
    if strategy == "pullup":
        t0 = time.perf_counter()
        plan = pull_up_semantic_filters(plan, catalog)
        overhead["placement"] = time.perf_counter() - t0
    elif strategy == "cost":
        t0 = time.perf_counter()
        skeleton, lifted = lift_semantic_filters(plan)
        result = dp_place(skeleton, lifted, catalog, params)
        plan = rebuild_plan(skeleton, lifted, result.placement, catalog)
        overhead["placement"] = time.perf_counter() - t0
        est_cost = result.cost
        dp_states = result.n_states
    else:
        overhead["placement"] = 0.0

    # physical join selection runs last: semantic placement has settled
    # the plan shape, so build-side grouping guarantees are final
    t0 = time.perf_counter()
    select_physical_joins(plan, catalog, params)
    overhead["physical_join"] = time.perf_counter() - t0

    return OptimizedPlan(
        plan=plan,
        strategy=strategy,
        n_semantic_filters=n_sf,
        est_cost=est_cost,
        dp_states=dp_states,
        overhead=overhead,
    )


def report(plan: Node, catalog: Catalog,
           params: CostParams | None = None) -> dict:
    return plan_cost_report(plan, catalog, params or CostParams())
