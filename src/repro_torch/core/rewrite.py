"""Equivalence-preserving rewrites (paper §3.2) plus baseline pushdown.

* ``push_down_filters`` — predicate pushdown for relational filters AND
  semantic filters, reproducing DuckDB's native behaviour: "semantic filters
  start at the positions assigned by DuckDB's native optimizer, which
  typically pushes them down to their lowest feasible positions" (§5).
  This produces the *baseline* plan and the original anchor positions that
  PLOP optimizes from.

* ``pull_up_semantic_projections`` — first reduction: SPs move to their
  highest feasible position; relational operators that reference an SP's
  output column form a dependency *bundle* that moves with it (topological
  order preserved). Projections crossed on the way up are widened with the
  SP's referenced columns.

* ``decompose_semantic_joins`` — second reduction:
  ``SJ_φ(R,S) → SF_φ(R × S)``; the new SF is repositionable like any other.

* ``simplify`` — applies both reductions to convergence (decomposing an SJ
  yields a new SF, which may unblock an SP pull-up, etc.).
"""
from __future__ import annotations


from .plan import (
    Aggregate,
    Catalog,
    CrossJoin,
    Filter,
    Join,
    Node,
    Project,
    SemanticFilter,
    SemanticJoin,
    SemanticProject,
    insert_above,
    remove_unary,
    replace_child,
)

# ---------------------------------------------------------------------------
# Predicate pushdown (baseline / original positions)
# ---------------------------------------------------------------------------


def _pred_cols(node: Node) -> set[str]:
    if isinstance(node, Filter):
        return set(node.pred.columns())
    if isinstance(node, SemanticFilter):
        return set(node.ref_cols)
    raise TypeError(node)


def push_down_filters(root: Node, catalog: Catalog) -> Node:
    """Push σ and SF nodes to their lowest feasible position (in place)."""
    changed = True
    while changed:
        changed = False
        for node in list(root.walk()):
            if not isinstance(node, (Filter, SemanticFilter)):
                continue
            if not node.children:
                continue
            child = node.children[0]
            cols = _pred_cols(node)
            if isinstance(child, (Join, CrossJoin)):
                for side in child.children:
                    side_cols = set(side.output_columns(catalog))
                    if cols <= side_cols:
                        # splice node out, re-insert above `side`
                        root = remove_unary(root, node)
                        node.children = []
                        root = insert_above(root, side, node)
                        changed = True
                        break
            elif isinstance(child, Project):
                if cols <= set(child.children[0].output_columns(catalog)):
                    root = remove_unary(root, node)
                    node.children = []
                    root = insert_above(root, child.children[0], node)
                    changed = True
            elif (
                isinstance(node, Filter)
                and isinstance(child, (SemanticFilter, SemanticProject))
                and cols <= set(child.children[0].output_columns(catalog))
            ):
                # Relational σ sinks below semantic operators (cheap before
                # expensive; §3.2: "relational filters can be pushed between
                # × and SF"). The reverse swap is never applied, so the
                # loop terminates with σ canonically lowest.
                root = remove_unary(root, node)
                node.children = []
                root = insert_above(root, child.children[0], node)
                changed = True
            if changed:
                break
    return root


# ---------------------------------------------------------------------------
# Reduction 1: pull up semantic projections (+ dependent bundle)
# ---------------------------------------------------------------------------


def _references_col(node: Node, col: str) -> bool:
    if isinstance(node, Filter):
        return col in node.pred.columns()
    if isinstance(node, Project):
        return col in node.cols
    if isinstance(node, (SemanticFilter, SemanticProject)):
        return col in node.ref_cols
    if isinstance(node, SemanticJoin):
        return col in node.ref_cols
    if isinstance(node, Join):
        return col in (node.left_key, node.right_key)
    if isinstance(node, Aggregate):
        return col in node.group_by or any(c == col for _, c, _ in node.aggs)
    return False


def _bundle_top(root: Node, sp: SemanticProject) -> Node:
    """Maximal unary chain of movable dependents sitting directly above sp.

    Dependents are relational filters (σ) that reference sp.out_col — the
    case the paper's Fig. 2 illustrates. Anything else (aggregate, join key,
    another semantic op) pins the SP below it.
    """
    top = sp
    while True:
        p = root.parent_of(top)
        if (
            p is not None
            and isinstance(p, Filter)
            and sp.out_col in p.pred.columns()
        ):
            top = p
        else:
            return top


def pull_up_semantic_projections(root: Node, catalog: Catalog
                                 ) -> tuple[Node, bool]:
    """One convergence loop of SP pull-up. Returns (root, changed_any)."""
    changed_any = False
    progress = True
    while progress:
        progress = False
        for sp in [n for n in root.walk() if isinstance(n, SemanticProject)]:
            top = _bundle_top(root, sp)
            p = root.parent_of(top)
            if p is None or p.is_blocking or p.is_semantic:
                continue
            if _references_col(p, sp.out_col):
                continue  # non-movable dependent pins the bundle
            # widen projections we are about to cross
            if isinstance(p, Project):
                for c in sp.ref_cols:
                    if c not in p.cols:
                        p.cols.append(c)
            # move the chain [top .. sp] above p
            g = root.parent_of(p)
            child = sp.children[0]
            replace_child(p, top, child)
            sp.children = [p]
            if g is None:
                root = top
            else:
                replace_child(g, p, top)
            progress = True
            changed_any = True
            break
    return root, changed_any


# ---------------------------------------------------------------------------
# Reduction 2: decompose semantic joins
# ---------------------------------------------------------------------------


def decompose_semantic_joins(root: Node) -> tuple[Node, bool]:
    changed = False
    for sj in [n for n in root.walk() if isinstance(n, SemanticJoin)]:
        cross = CrossJoin(children=list(sj.children))
        sf = SemanticFilter(
            children=[cross],
            phi=sj.phi,
            ref_cols=list(sj.ref_cols),
        )
        p = root.parent_of(sj)
        sj.children = []
        if p is None:
            root = sf
        else:
            replace_child(p, sj, sf)
        changed = True
    return root, changed


# ---------------------------------------------------------------------------
# Full simplification to convergence (paper §3.2 'reduced problem')
# ---------------------------------------------------------------------------


def simplify(root: Node, catalog: Catalog) -> Node:
    while True:
        root, ch1 = decompose_semantic_joins(root)
        root, ch2 = pull_up_semantic_projections(root, catalog)
        if not (ch1 or ch2):
            break
    # assign stable sf_ids in plan order
    for i, sf in enumerate(n for n in root.walk()
                           if isinstance(n, SemanticFilter)):
        sf.sf_id = i
    return root
