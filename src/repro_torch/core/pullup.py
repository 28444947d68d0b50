"""Algorithm 1 (paper §4.1): greedy semantic-filter pull-up.

Repeatedly swaps each SF with its parent while the parent is not the root,
not a blocking operator, and not another semantic operator. Projections
crossed on the way up are widened with the SF's referenced columns so the
predicate stays evaluable (Alg. 1 lines 7-8). Terminates in O(n²·d)
(Thm 4.2).
"""
from __future__ import annotations

from .plan import (
    Catalog,
    Node,
    Project,
    SemanticFilter,
    swap_with_parent,
)


def pull_up_semantic_filters(root: Node, catalog: Catalog) -> Node:
    changed = True
    while changed:
        changed = False
        for sf in [n for n in root.walk() if isinstance(n, SemanticFilter)]:
            p = root.parent_of(sf)
            if p is None:
                continue  # sf is root (or detached)
            gp = root.parent_of(p)
            if gp is None:
                # p is the root: Alg.1 line 6 requires p != root
                continue
            if p.is_blocking or p.is_semantic:
                continue
            if isinstance(p, Project):
                for c in sf.ref_cols:
                    if c not in p.cols:
                        p.cols.append(c)
            root = swap_with_parent(root, sf)
            changed = True
    return root
