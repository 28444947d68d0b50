"""Algorithm 2 (paper §4.2): DP-based semantic-filter placement.

The DP runs on a *skeleton* tree — the simplified plan with all semantic
filters lifted out. Each SF is anchored at the node it sat directly above
(its "original position"; DuckDB-style pushdown puts this at the lowest
feasible position). The DP state ``dp[u][S]`` is the minimum
``C_LLM + α·C_rel`` for the subtree of u with the filters in S applied at
or below u.

Per node u and subset S (increasing size):

  Step 1  distribute S to children (subset convolution at binary nodes;
          filters anchored at u itself cannot descend — their child states
          are +∞ and they enter via Step 3);
  Step 2  add α·c(u)·sel(tab(u), S) — u's relational cost reduced by
          filters below it;
  Step 3  for each i ∈ S legal at u:
          dp[u][S] = min(dp[u][S],
                         dp[u][S\\{i}] + N_{u,SF_i}·sel(ref(SF_i), S\\{i})
                                       + α·probe_rows(u, S\\{i}))
          where the probe term charges one cache lookup per (non-distinct)
          row reaching the filter (§5 'function caching is not free');
          disable with ``charge_probe_cost=False`` to match §4.2 verbatim.

Legality: SF_i may be placed at u iff the path from its anchor up to and
including u crosses only non-blocking operators (Thm 4.1's swap-safe set).
Filters with anchors below a blocking node are therefore forced below it —
states violating this stay +∞ and never reach the root's full-set state.

Complexity O(|V|·n·2ⁿ + 3ⁿ) (Thm 4.3).
"""
from __future__ import annotations

from dataclasses import dataclass

from .cost import CostParams, Estimator
from .plan import (
    Catalog,
    Node,
    Project,
    SemanticFilter,
    insert_above,
    remove_unary,
)

INF = float("inf")


@dataclass
class LiftedSF:
    sf: SemanticFilter
    anchor_nid: int  # node the SF sat directly above
    idx: int  # bit index


def lift_semantic_filters(root: Node) -> tuple[Node, list[LiftedSF]]:
    """Remove every SF from (a clone of) the tree, recording anchors."""
    root = root.clone()
    lifted: list[LiftedSF] = []
    while True:
        sfs = [n for n in root.walk() if isinstance(n, SemanticFilter)]
        if not sfs:
            break
        sf = sfs[0]
        anchor = sf.children[0]
        # stacked SFs share the first non-SF descendant as their anchor
        while isinstance(anchor, SemanticFilter):
            anchor = anchor.children[0]
        root = remove_unary(root, sf)
        lifted.append(LiftedSF(sf=sf, anchor_nid=anchor.nid, idx=-1))
    # order by sf_id for stable bit indices
    lifted.sort(key=lambda l: l.sf.sf_id)
    for i, l in enumerate(lifted):
        l.idx = i
    return root, lifted


def _postorder(root: Node) -> list[Node]:
    out: list[Node] = []

    def rec(n: Node):
        for c in n.children:
            rec(c)
        out.append(n)

    rec(root)
    return out


def _subsets_increasing(mask: int) -> list[int]:
    """All submasks of ``mask`` ordered by popcount (paper Alg. 2 line 3)."""
    subs = []
    sub = mask
    while True:
        subs.append(sub)
        if sub == 0:
            break
        sub = (sub - 1) & mask
    subs.sort(key=lambda x: bin(x).count("1"))
    return subs


@dataclass
class DPResult:
    cost: float
    placement: dict[int, int]  # sf idx -> nid of node the SF is applied above
    n_states: int


def dp_place(
    skeleton: Node,
    lifted: list[LiftedSF],
    catalog: Catalog,
    params: CostParams,
    charge_probe_cost: bool | None = None,
) -> DPResult:
    if charge_probe_cost is None:
        charge_probe_cost = params.charge_probe_cost
    est = Estimator(catalog, params)
    n = len(lifted)
    full = (1 << n) - 1
    nodes = _postorder(skeleton)
    parent_of: dict[int, Node] = {}
    for u in nodes:
        for c in u.children:
            parent_of[c.nid] = u

    # -- legality: set of nids each filter may be placed at ------------------
    anchor_node = {l.idx: skeleton.find(l.anchor_nid) for l in lifted}
    legal: dict[int, set[int]] = {}
    for l in lifted:
        a = anchor_node[l.idx]
        assert a is not None, "anchor missing from skeleton"
        ok = {a.nid}
        v = a
        while v.nid in parent_of:
            p = parent_of[v.nid]
            if p.is_blocking:
                break
            ok.add(p.nid)
            v = p
        legal[l.idx] = ok

    # -- avail masks ----------------------------------------------------------
    anchored_at: dict[int, int] = {u.nid: 0 for u in nodes}
    for l in lifted:
        anchored_at[l.anchor_nid] |= 1 << l.idx
    avail: dict[int, int] = {}
    for u in nodes:  # postorder => children first
        m = anchored_at[u.nid]
        for c in u.children:
            m |= avail[c.nid]
        avail[u.nid] = m

    # -- selectivity helpers --------------------------------------------------
    s_of = {
        l.idx: params.s_of(l.sf.sf_id, l.sf.selectivity_hint) for l in lifted
    }
    ref_tables = {l.idx: l.sf.ref_tables for l in lifted}
    tab_cache = {u.nid: u.base_tables() for u in nodes}

    def sel(tables: frozenset[str], S: int) -> float:
        out = 1.0
        for i in range(n):
            if S >> i & 1 and ref_tables[i] & tables:
                out *= s_of[i]
        return out

    # precompute per-node static quantities. For equi joins, est.c()
    # already resolves to the cheapest physical operator (hash /
    # sort-merge with the pre-grouped discount / host oracle —
    # cost.py::join_physical_costs), so Step 2's α·c(u) term carries
    # physical join selection into the DP objective.
    c_u = {u.nid: est.c(u) for u in nodes}
    card_u = {u.nid: est.card(u) for u in nodes}
    N_ui: dict[tuple[int, int], float] = {}
    for u in nodes:
        for i in range(n):
            if avail[u.nid] >> i & 1 and u.nid in legal[i]:
                N_ui[(u.nid, i)] = est.distinct_at(u, ref_tables[i])

    dp: dict[int, dict[int, float]] = {}
    choice: dict[int, dict[int, tuple]] = {}
    n_states = 0

    for u in nodes:
        m = avail[u.nid]
        dpu: dict[int, float] = {}
        chu: dict[int, tuple] = {}
        child_masks = [avail[c.nid] for c in u.children]
        for S in _subsets_increasing(m):
            n_states += 1
            best = INF
            bc: tuple = ("none",)
            # ---- Step 1: distribute to children -----------------------------
            if len(u.children) == 2:
                m1, m2 = child_masks
                S_down = S & (m1 | m2)
                if S_down == S:  # all of S can descend
                    s1_all = S & m1
                    # enumerate submasks of s1_all; rest must fit child 2
                    sub = s1_all
                    while True:
                        rest = S & ~sub
                        if rest & ~m2 == 0:
                            v = dp[u.children[0].nid].get(sub, INF) + dp[
                                u.children[1].nid
                            ].get(rest, INF)
                            if v < best:
                                best = v
                                bc = ("split", sub, rest)
                        if sub == 0:
                            break
                        sub = (sub - 1) & s1_all
            elif len(u.children) == 1:
                v = dp[u.children[0].nid].get(S, INF)
                if S & ~child_masks[0] == 0 and v < best:
                    best = v
                    bc = ("unary",)
            else:  # leaf
                if S == 0:
                    best = 0.0
                    bc = ("leaf",)
            # ---- Step 2: relational cost at u -------------------------------
            if best < INF:
                best = best + params.alpha * c_u[u.nid] * sel(
                    tab_cache[u.nid], S)
            # ---- Step 3: place each i in S at u -----------------------------
            for i in range(n):
                if not (S >> i & 1):
                    continue
                if u.nid not in legal[i]:
                    continue
                prev = S & ~(1 << i)
                base = dpu.get(prev, INF)
                if base >= INF:
                    continue
                llm = N_ui[(u.nid, i)] * sel(ref_tables[i], prev)
                probe = 0.0
                if charge_probe_cost:
                    probe = params.alpha * card_u[u.nid] * sel(
                        tab_cache[u.nid], prev
                    )
                cand = base + llm + probe
                if cand < best:
                    best = cand
                    bc = ("place", i, prev)
            dpu[S] = best
            chu[S] = bc
        dp[u.nid] = dpu
        choice[u.nid] = chu

    root_cost = dp[skeleton.nid].get(full, INF)
    if root_cost >= INF:
        raise RuntimeError("DP found no feasible placement (blocking bug?)")

    # ---- traceback ----------------------------------------------------------
    placement: dict[int, int] = {}

    def trace(u: Node, S: int) -> None:
        while True:
            kind = choice[u.nid][S]
            if kind[0] == "place":
                _, i, prev = kind
                placement[i] = u.nid
                S = prev
            elif kind[0] == "split":
                _, s1, s2 = kind
                trace(u.children[0], s1)
                trace(u.children[1], s2)
                return
            elif kind[0] == "unary":
                u = u.children[0]
            elif kind[0] == "leaf":
                return
            else:
                raise RuntimeError("bad traceback state")

    trace(skeleton, full)
    return DPResult(cost=root_cost, placement=placement, n_states=n_states)


def rebuild_plan(
    skeleton: Node,
    lifted: list[LiftedSF],
    placement: dict[int, int],
    catalog: Catalog,
) -> Node:
    """Materialize the DP placement: insert each SF above its chosen node,
    widening any projection between its anchor and its new position so the
    referenced columns stay available (mirrors Alg. 1 lines 7-8)."""
    root = skeleton.clone()

    # order: most selective first when stacked at the same node.
    # ``insert_above`` pushes earlier insertions upward, so iterating in
    # DESCENDING selectivity leaves the most selective SF directly above
    # the target — it executes first and every stacked filter above it
    # sees the fewest rows. Hint-less SFs count as non-selective (1.0);
    # ties resolve toward the lower sf_id at the bottom.
    def _sel(i: int) -> float:
        h = lifted[i].sf.selectivity_hint
        return h if h is not None else 1.0

    order = sorted(range(len(lifted)),
                   key=lambda i: (_sel(i), lifted[i].sf.sf_id), reverse=True)
    for i in order:
        target_nid = placement[i]
        sf = lifted[i].sf
        new_sf = SemanticFilter(
            phi=sf.phi,
            ref_cols=list(sf.ref_cols),
            sf_id=sf.sf_id,
            selectivity_hint=sf.selectivity_hint,
        )
        # widen projections on the path anchor -> target
        anchor = root.find(lifted[i].anchor_nid)
        target = root.find(target_nid)
        assert target is not None
        if anchor is not None:
            path: list[Node] = []
            v = anchor
            while v is not None and v.nid != target_nid:
                v = root.parent_of(v)
                if v is not None:
                    path.append(v)
            for p in path:
                if isinstance(p, Project):
                    for c in sf.ref_cols:
                        if c not in p.cols:
                            p.cols.append(c)
        root = insert_above(root, target, new_sf)
    return root
