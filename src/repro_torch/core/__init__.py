"""PLOP core: hybrid plan IR, equivalence rewrites, pull-up, DP placement."""
from .builder import Q, and_, col, not_, or_, template_columns
from .cost import CostParams, Estimator, plan_cost_report
from .dp import dp_place, lift_semantic_filters, rebuild_plan
from .optimizer import OptimizedPlan, optimize, report
from .plan import (
    Aggregate,
    BoolOp,
    Catalog,
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
    Union,
    count_ops,
)
from .pullup import pull_up_semantic_filters
from .rewrite import (
    decompose_semantic_joins,
    pull_up_semantic_projections,
    push_down_filters,
    simplify,
)

__all__ = [
    "Q", "and_", "col", "not_", "or_", "template_columns",
    "CostParams", "Estimator", "plan_cost_report",
    "dp_place", "lift_semantic_filters", "rebuild_plan",
    "OptimizedPlan", "optimize", "report",
    "Aggregate", "BoolOp", "Catalog", "Cmp", "Col", "Const", "CrossJoin",
    "Expr", "Filter", "Join", "Limit", "Node", "Project", "Scan",
    "SemanticFilter", "SemanticJoin", "SemanticProject", "Sort", "Union",
    "count_ops",
    "pull_up_semantic_filters",
    "decompose_semantic_joins", "pull_up_semantic_projections",
    "push_down_filters", "simplify",
]
