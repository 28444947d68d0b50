"""Sampling-based selectivity estimation of the port
(``repro_torch.core.estimate``) against the reference's: the same
sampled selectivities and LLM calls from the same seeds, the same
measured join reduction and ``CostParams``, the same optimized-plan
answers, and the sampling calls pre-warming the query's cache."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import push_down_filters as r_push  # noqa: E402
from repro.core import simplify as r_simplify  # noqa: E402
from repro.core.estimate import (  # noqa: E402
    estimate_params as r_estimate,
    measure_join_reduction as r_measure,
    sample_sf_selectivity as r_sample,
)
from repro.data import make_bookreview as r_make  # noqa: E402
from repro.data.schemas import BOOKS_ABOUT_AI, REVIEW_POSITIVE  # noqa
from repro.semantic import OracleBackend as ROracle  # noqa: E402
from repro.semantic import SemanticRunner as RRunner  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Q,
    col,
    optimize,
    push_down_filters,
    simplify,
)
from repro_torch.core.estimate import (  # noqa: E402
    estimate_params,
    measure_join_reduction,
    sample_sf_selectivity,
)
from repro_torch.data import make_bookreview  # noqa: E402
from repro_torch.engine import Executor, result_f1  # noqa: E402
from repro_torch.semantic import OracleBackend, SemanticRunner  # noqa: E402
from torch_corpus_check import port_plan  # noqa: E402


@pytest.fixture(scope="module")
def dbs():
    return make_bookreview(seed=5, scale=0.5, device="cpu"), \
        r_make(seed=5, scale=0.5)


def _runner(db):
    return SemanticRunner(OracleBackend(truths=db.truths))


def _rrunner(db):
    return RRunner(ROracle(truths=db.truths))


def _joined(q, c):
    return (q.scan("books")
            .join(q.scan("reviews"), "books.book_id", "reviews.book_id")
            .where(c("reviews.rating") >= 3)
            .sem_filter(BOOKS_ABOUT_AI)
            .sem_filter(REVIEW_POSITIVE)
            .select("books.title", "reviews.review_id")
            .build())


def test_sf_selectivity_matches_reference(dbs):
    db, rdb = dbs
    from repro.core import Q as RQ

    plan = Q.scan("reviews").sem_filter(REVIEW_POSITIVE).build()
    rplan = RQ.scan("reviews").sem_filter(REVIEW_POSITIVE).build()
    sf = next(n for n in plan.walk() if hasattr(n, "phi"))
    rsf = next(n for n in rplan.walk() if hasattr(n, "phi"))
    sf.sf_id = rsf.sf_id = 0
    for k, seed in ((16, 0), (128, 3)):
        got = sample_sf_selectivity(db, sf, _runner(db), k=k, seed=seed)
        assert got == r_sample(rdb, rsf, _rrunner(rdb), k=k, seed=seed)
        assert 0 < got[1] <= k
    truth = np.mean([r["_sentiment"] > 0 for r in db.payloads["reviews"]])
    assert abs(sample_sf_selectivity(db, sf, _runner(db), k=128)[0]
               - truth) < 0.15


def test_join_reduction_and_params_match_reference(dbs):
    db, rdb = dbs
    from repro.core import Q as RQ
    from repro.core import col as rcol

    plan, rplan = _joined(Q, col), _joined(RQ, rcol)
    assert measure_join_reduction(db, plan) == r_measure(rdb, rplan)
    cat, rcat = db.catalog(), rdb.catalog()
    simp = simplify(push_down_filters(plan.clone(), cat), cat)
    rsimp = r_simplify(r_push(rplan.clone(), rcat), rcat)
    params, spent = estimate_params(db, simp, _runner(db), k=32)
    rparams, rspent = r_estimate(rdb, rsimp, _rrunner(rdb), k=32)
    assert spent == rspent > 0
    assert params.s_join == rparams.s_join
    assert params.sf_selectivity == rparams.sf_selectivity
    assert len(params.sf_selectivity) == 2


def test_estimated_params_preserve_results(dbs):
    db, _ = dbs
    plan = _joined(Q, col)
    cat = db.catalog()
    simp = simplify(push_down_filters(plan.clone(), cat), cat)
    params, _ = estimate_params(db, simp, _runner(db), k=32)
    ref_t, _ = Executor(db, _runner(db), kernel_impl="kernel").execute(
        optimize(plan, cat, "none").plan)
    opt_t, st = Executor(db, _runner(db), kernel_impl="kernel").execute(
        optimize(plan, cat, "cost", params=params).plan)
    cols = ["books.title", "reviews.review_id"]
    assert result_f1(db.materialize(ref_t, cols),
                     db.materialize(opt_t, cols)) == 1.0
    assert st.join_physical == {"hash": 1}


def test_sampling_prewarms_cache(dbs):
    db, _ = dbs
    plan = Q.scan("books").sem_filter(BOOKS_ABOUT_AI).build()
    cat = db.catalog()
    simp = simplify(push_down_filters(plan.clone(), cat), cat)
    runner = _runner(db)
    _, spent = estimate_params(db, simp, runner, k=64)
    ex = Executor(db, runner, fresh_cache_per_query=False)
    _, stats = ex.execute(optimize(plan, cat, "cost").plan)
    assert spent + stats.llm_calls == len(db.payloads["books"])


def test_port_plan_helper_builds_with_port_builder():
    from benchmarks.corpus import ALL_QUERIES

    spec = next(s for s in ALL_QUERIES if s.schema == "bookreview")
    assert type(port_plan(spec)).__module__.startswith("repro_torch")
