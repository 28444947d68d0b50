"""Sampling-based selectivity estimation — beyond-paper extension.

The paper uses statistics-free defaults (s_i = 0.2, s_⋈ = 0.1) and notes
that "fine-grained estimation via sampling or learned models is
complementary and can replace these fixed defaults" (§5). This module
implements that: before optimization, each semantic filter is evaluated on
a small uniform sample of its base-table rows through the SAME function
cache the query will use — so sampled rows are not wasted calls, they are
pre-warmed cache entries.

Join distinct-count reduction s_⋈ is estimated exactly from key-column
histograms (cheap, no LLM calls).

``estimate_params`` returns a CostParams with per-filter selectivities and
a per-plan measured s_⋈, plus the number of LLM calls spent sampling (so
benchmarks can account for the overhead honestly).
"""
from __future__ import annotations

import numpy as np

from ..semantic.runner import SemanticRunner
from .cost import CostParams
from .plan import Join, Node, SemanticFilter


def sample_sf_selectivity(db, sf: SemanticFilter, runner: SemanticRunner,
                          k: int = 32, seed: int = 0) -> tuple[float, int]:
    """Evaluate φ on k sampled rows of the referenced table(s); returns
    (selectivity, llm_calls_spent). Multi-table filters (SJ-derived)
    sample random row pairs."""
    tables = sorted(sf.ref_tables)
    rng = np.random.default_rng(seed)
    sizes = {t: len(db.payloads[t]) for t in tables}
    ctxs = []
    for _ in range(k):
        ctx = {t: db.payloads[t][int(rng.integers(sizes[t]))]
               for t in tables}
        ctxs.append(ctx)
    res = runner.evaluate(sf.phi, ctxs, out_dtype="bool")
    live = [v for v in res.values if v is not None]
    if not live:
        return 1.0, res.distinct_calls
    s = sum(bool(v) for v in live) / len(live)
    # clamp away from 0: a zero estimate would make the DP place the
    # filter arbitrarily (everything downstream looks free)
    return max(s, 1.0 / (2 * k)), res.distinct_calls


def measure_join_reduction(db, plan: Node) -> float:
    """Average over plan joins of (distinct FK-side keys that survive the
    join) / (side rows) — the measured analogue of s_⋈."""
    ratios = []
    for j in (n for n in plan.walk() if isinstance(n, Join)):
        try:
            lt, lc = j.left_key.split(".", 1)
            rt, rc = j.right_key.split(".", 1)
            lkeys = [r.get(lc) for r in db.payloads.get(lt, [])]
            rkeys = [r.get(rc) for r in db.payloads.get(rt, [])]
            if not lkeys or not rkeys:
                continue
            lset, rset = set(lkeys), set(rkeys)
            surviving = len(lset & rset)
            ratios.append(surviving / max(len(lset | rset), 1))
        except Exception:
            continue
    if not ratios:
        return CostParams().s_join
    return float(np.clip(np.mean(ratios), 0.01, 1.0))


def estimate_params(db, simplified_plan: Node, runner: SemanticRunner,
                    k: int = 32, alpha: float = 1e-7,
                    seed: int = 0) -> tuple[CostParams, int]:
    """CostParams with sampled per-filter selectivities + measured s_⋈."""
    spent = 0
    per_sf: dict[int, float] = {}
    for sf in (n for n in simplified_plan.walk()
               if isinstance(n, SemanticFilter)):
        s, calls = sample_sf_selectivity(db, sf, runner, k=k,
                                         seed=seed + sf.sf_id)
        per_sf[sf.sf_id] = s
        spent += calls
    s_join = measure_join_reduction(db, simplified_plan)
    params = CostParams(alpha=alpha, s_join=s_join,
                        sf_selectivity=per_sf)
    return params, spent
