"""The port's semantic tier (``VerdictTable``, ``FunctionCache``,
``SemanticRunner``) against the reference's: the same verdicts,
``llm_calls``, ``cache_hits`` and ``prompts_rendered`` with the verdict
table on and off, as ``tests/test_verdict_table.py`` holds the
reference to its host path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Q as RQ  # noqa: E402
from repro.engine import Database as RDatabase  # noqa: E402
from repro.engine import Executor as RExecutor  # noqa: E402
from repro.semantic import (  # noqa: E402
    FunctionCache as RCache,
    OracleBackend as ROracle,
    SemanticRunner as RRunner,
    VerdictTable as RVerdicts,
)
from repro_torch.core import Q  # noqa: E402
from repro_torch.engine import Database, Executor  # noqa: E402
from repro_torch.kernels.sync import HOST_SYNCS  # noqa: E402
from repro_torch.semantic import (  # noqa: E402
    FunctionCache,
    OracleBackend,
    SemanticRunner,
    VerdictTable,
    render_prompt,
)
from repro_torch.semantic.cache import (  # noqa: E402
    VERDICT_FALSE,
    VERDICT_MISS,
    VERDICT_NULL,
    VERDICT_TRUE,
)

STAT_FIELDS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
               "sem_rows", "prompts_rendered")
PHI = "SEMANTIC: does {cats.name} sound odd?"


def _u32(*v):
    return np.asarray(v, dtype=np.uint32)


def _v8(*v):
    return np.asarray(v, dtype=np.int8)


# -------------------------------------------------------------- verdict table

def _script(vt):
    """One bind/probe script; returns every probe's answer."""
    out = [vt.probe("phi", _u32(1, 2), _u32(9, 8))]
    vt.bind("phi", _u32(1, 2, 3, 4), _u32(9, 8, 7, 6),
            _v8(VERDICT_TRUE, VERDICT_FALSE, VERDICT_NULL, VERDICT_TRUE))
    out.append(vt.probe("phi", _u32(1, 2, 3, 4, 5), _u32(9, 8, 7, 0, 0)))
    out.append(vt.probe("other", _u32(1), _u32(9)))
    # slot collisions: capacity 1 << 10, tags 4 and 4 + 1024 share a slot
    vt.bind("p", _u32(4, 4 + 1024), _u32(1, 2),
            _v8(VERDICT_TRUE, VERDICT_FALSE))
    vt.bind("p", _u32(4 + 2048), _u32(3), _v8(VERDICT_FALSE))
    out.append(vt.probe("p", _u32(4, 4 + 1024, 4 + 2048), _u32(1, 2, 3)))
    vt.clear()
    out.append(vt.probe("phi", _u32(1), _u32(9)))
    return out


def test_verdict_table_matches_reference():
    got = _script(VerdictTable(capacity=1 << 10, impl="on", device="cpu"))
    want = _script(RVerdicts(capacity=1 << 10, impl="on"))
    for a, b in zip(want, got):
        assert b.dtype == np.int8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        got[1], _v8(VERDICT_TRUE, VERDICT_FALSE, VERDICT_NULL,
                    VERDICT_MISS, VERDICT_MISS))


def test_verdict_table_sync_accounting():
    vt = VerdictTable(capacity=16, impl="on", device="cpu")
    HOST_SYNCS.reset()
    vt.probe("p", _u32(1), _u32(2))
    assert HOST_SYNCS.syncs == 0  # an unbound table answers host-side
    vt.bind("p", _u32(1), _u32(2), _v8(VERDICT_TRUE))
    assert vt.probe("p", _u32(1), _u32(2))[0] == VERDICT_TRUE
    assert HOST_SYNCS.by_site == {"verdict_table": 1}


def test_verdict_table_placement():
    vt = VerdictTable()
    assert vt.device is None and not vt.enabled
    vt.place("cpu")
    assert not vt.enabled  # "auto" enables the table on CUDA only
    on = VerdictTable(impl="on")
    with pytest.raises(RuntimeError, match="device"):
        on.bind("p", _u32(1), _u32(1), _v8(VERDICT_TRUE))
    off = VerdictTable(impl="off", device="cpu")
    off.bind("p", _u32(1), _u32(1), _v8(VERDICT_TRUE))
    assert off.probe("p", _u32(1), _u32(1))[0] == VERDICT_MISS
    with pytest.raises(ValueError):
        VerdictTable(capacity=12)


def test_render_prompt_single_pass_and_null():
    ctx = {"t": {"a": "{t.b}", "b": "x"}}
    assert render_prompt("A={t.a} B={t.b}", ctx) == "A={t.b} B=x"
    assert render_prompt("{t.c}", ctx) is None
    assert render_prompt("{u.a}", ctx) is None


# --------------------------------------------------------------- end to end

def _tables(n_cats=9, n_events=300, null_cat=None):
    cats = [{"cat_id": i, "name": f"category number {i}"}
            for i in range(n_cats)]
    if null_cat is not None:
        cats[null_cat]["name"] = None
    rng = np.random.default_rng(3)
    events = [{"event_id": j, "cat_id": int(rng.integers(0, n_cats))}
              for j in range(n_events)]
    return cats, events


def _build(db, cats, events):
    db.add_table("cats", cats, text_columns={"name"})
    db.add_table("events", events)
    db.truths = {PHI: lambda ctx: ctx["cats"]["cat_id"] % 2 == 1}
    return db


def _stacked(q):
    plan = (q.scan("events")
            .join(q.scan("cats"), "events.cat_id", "cats.cat_id")
            .sem_filter(PHI)
            .sem_filter(PHI)
            .build())
    for node in plan.walk():
        if type(node).__name__ == "Join":
            node.physical = "sort_merge"  # the port serves sort-merge
    return plan


def _run_port(plan, tables, table_impl, vectorized=True):
    db = _build(Database(device="cpu"), *tables)
    backend = OracleBackend(truths=db.truths)
    runner = SemanticRunner(backend, cache=FunctionCache(
        VerdictTable(impl=table_impl, device="cpu")))
    ex = Executor(db, runner, vectorized=vectorized, kernel_impl="ref")
    table, stats = ex.execute(plan)
    return (db.materialize(table, ["events.event_id"]), stats,
            backend.calls)


def _run_ref(plan, tables, table_impl, vectorized=True):
    db = _build(RDatabase(), *tables)
    backend = ROracle(truths=db.truths)
    runner = RRunner(backend, cache=RCache(RVerdicts(impl=table_impl)))
    ex = RExecutor(db, runner, vectorized=vectorized, kernel_impl="ref")
    table, stats = ex.execute(plan)
    return (db.materialize(table, ["events.event_id"]), stats,
            backend.calls)


@pytest.mark.parametrize("table_impl", ("on", "off"))
@pytest.mark.parametrize("null_cat", (None, 2))
def test_stacked_filters_match_reference(table_impl, null_cat):
    tables = _tables(null_cat=null_cat)
    recs_p, sp, calls_p = _run_port(_stacked(Q), tables, table_impl)
    recs_r, sr, calls_r = _run_ref(_stacked(RQ), tables, table_impl)
    assert recs_p == recs_r
    for f in STAT_FIELDS:
        assert getattr(sp, f) == getattr(sr, f), f
    assert calls_p == calls_r
    assert sp.pipeline_syncs == sr.pipeline_syncs
    assert sp.join_physical == sr.join_physical == {"sort_merge": 1}


def test_table_on_off_and_per_row_agree():
    tables = _tables(n_cats=5, n_events=60, null_cat=2)
    on = _run_port(_stacked(Q), tables, "on")
    off = _run_port(_stacked(Q), tables, "off")
    per_row = _run_port(_stacked(Q), tables, "off", vectorized=False)
    assert on[0] == off[0] == per_row[0]
    for f in ("llm_calls", "cache_hits", "null_skipped", "probe_rows"):
        assert getattr(on[1], f) == getattr(off[1], f) \
            == getattr(per_row[1], f), f
    assert on[1].null_skipped > 0
    assert per_row[1].join_physical == {"reference": 1}


def test_second_operator_resolves_from_table():
    tables = _tables()
    _, st_on, _ = _run_port(_stacked(Q), tables, "on")
    _, st_off, _ = _run_port(_stacked(Q), tables, "off")
    # the second filter neither renders nor calls the backend again
    assert st_on.prompts_rendered == st_off.prompts_rendered == 9
    assert st_on.llm_calls == st_off.llm_calls == 9


def test_semantic_project_shares_table_with_filter():
    cats, _ = _tables(n_cats=6, n_events=0)

    def plan(q):
        return (q.scan("cats").sem_project(PHI, "odd", dtype="bool")
                .sem_filter(PHI).build())

    db = _build(Database(device="cpu"), cats, [])
    runner = SemanticRunner(OracleBackend(truths=db.truths),
                            cache=FunctionCache(VerdictTable(
                                impl="on", device="cpu")))
    table, st = Executor(db, runner, kernel_impl="ref").execute(plan(Q))
    rdb = _build(RDatabase(), cats, [])
    rrunner = RRunner(ROracle(truths=rdb.truths),
                      cache=RCache(RVerdicts(impl="on")))
    rtable, rst = RExecutor(rdb, rrunner, kernel_impl="ref").execute(
        plan(RQ))
    assert db.materialize(table, ["cats.cat_id"]) == \
        rdb.materialize(rtable, ["cats.cat_id"])
    for f in STAT_FIELDS:
        assert getattr(st, f) == getattr(rst, f), f
    assert st.prompts_rendered == 6


def test_executor_places_an_unplaced_table():
    db = _build(Database(device="cpu"), *_tables(n_cats=3, n_events=5))
    runner = SemanticRunner(OracleBackend(truths=db.truths))
    Executor(db, runner)
    assert runner.cache.verdicts.device == torch.device("cpu")
    assert not runner.cache.verdicts.enabled


def test_hash_physical_raises_slice_two():
    """The hash physical of slice two no longer raises: annotated, and
    when ``None`` resolves to it at run time, it answers as the
    reference does, in rows, stats, syncs and ``join_physical``."""
    tables = _tables(n_cats=3, n_events=5)
    for physical in ("hash", None):
        plans = []
        for q in (Q, RQ):
            plan = _stacked(q)
            for node in plan.walk():
                if type(node).__name__ == "Join":
                    node.physical = physical
            plans.append(plan)
        recs_p, sp, calls_p = _run_port(plans[0], tables, "on")
        recs_r, sr, calls_r = _run_ref(plans[1], tables, "on")
        assert recs_p == recs_r and calls_p == calls_r
        for f in STAT_FIELDS:
            assert getattr(sp, f) == getattr(sr, f), f
        assert sp.pipeline_syncs == sr.pipeline_syncs
        assert sp.join_physical == sr.join_physical == {"hash": 1}
