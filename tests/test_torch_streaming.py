"""Streaming ingestion of the port against the reference: the
incremental hash table (``StreamJoinBuild``) against the batch oracles
and the reference's own incremental table (same probe lists, groups and
``rebuilds``/``inserts``/``probes`` counters), the append contract
(``append_rows``), standing-query deltas and stats after every
micro-batch of ``tests/test_streaming.py``'s append schedules, the sync
ticks of ingest and probe, and a ``FrontDoor`` run."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from benchmarks.corpus import ALL_QUERIES  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro.core import Q as RQ  # noqa: E402
from repro.core import optimize as r_optimize  # noqa: E402
from repro.data import SCHEMAS  # noqa: E402
from repro.engine import Database as RDatabase  # noqa: E402
from repro.engine import FrontDoor as RFrontDoor  # noqa: E402
from repro.kernels.hash_dedup.ops import (  # noqa: E402
    dedup_representatives as r_dedup,
)
from repro.kernels.hash_join.ref import hash_join_np as r_hash_join_np  # noqa
from repro.semantic import OracleBackend as ROracle  # noqa: E402
from repro.semantic import SemanticRunner as RRunner  # noqa: E402
from repro.streaming import StreamJoinBuild as RStreamJoinBuild  # noqa
from repro.streaming import StreamSession as RStreamSession  # noqa: E402
from repro.streaming import append_rows as r_append_rows  # noqa: E402
from repro_torch.core import Q  # noqa: E402
from repro_torch.data import SCHEMAS as PORT_SCHEMAS  # noqa: E402
from repro_torch.engine import Database, Executor, FrontDoor  # noqa: E402
from repro_torch.kernels.sync import HOST_SYNCS  # noqa: E402
from repro_torch.semantic import OracleBackend, SemanticRunner  # noqa: E402
from repro_torch.streaming import (  # noqa: E402
    StreamContext,
    StreamJoinBuild,
    StreamSession,
    append_rows,
    freeze_record,
)
from torch_corpus_check import port_plan  # noqa: E402

IMPLS = ("ref", "kernel")
STATS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
         "sem_rows", "rel_rows", "pipeline_syncs", "join_physical")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _frozen(recs):
    return [freeze_record(r) for r in recs]


class _KeyTable:
    """Minimal Table stand-in: one int32 key column."""

    def __init__(self, keys, device=True):
        k = np.asarray(keys, np.int32)
        self._k = torch.from_numpy(k) if device else jnp.asarray(k)

    def col(self, name):
        return self._k


# ------------------------------------------------------- StreamJoinBuild

@pytest.mark.parametrize("impl", IMPLS)
def test_probe_and_groups_match_batch_oracles_and_reference(impl):
    """Random append schedules (a small min_cap forces growth
    rebuilds): after every extend, probe ≡ ``hash_join_np``, groups ≡
    ``dedup_representatives``, and both ≡ the reference's incremental
    table, counters included."""
    rng = np.random.default_rng(0)
    for trial in range(4):
        allk = rng.integers(0, 20, size=int(rng.integers(0, 50))
                            ).astype(np.int32)
        b = StreamJoinBuild("t", "t.k", _KeyTable(allk), impl=impl,
                            min_cap=64)
        rb = RStreamJoinBuild("t", "t.k", _KeyTable(allk, device=False),
                              impl="ref", min_cap=64)
        for _ in range(5):
            delta = rng.integers(0, 20, size=int(rng.integers(0, 40))
                                 ).astype(np.int32)
            allk = np.concatenate([allk, delta])
            b.extend(_KeyTable(allk))
            rb.extend(_KeyTable(allk, device=False))
            pk = rng.integers(0, 25, size=int(rng.integers(0, 60))
                              ).astype(np.int32)
            got = [_np(x) for x in b.probe(torch.from_numpy(pk))]
            want = r_hash_join_np(pk, allk)
            ref = [np.asarray(x) for x in rb.probe(jnp.asarray(pk))]
            for g_, w_, r_ in zip(got, want, ref):
                np.testing.assert_array_equal(g_, w_)
                np.testing.assert_array_equal(g_, r_)
            _, reps, inverse = r_dedup(allk.reshape(-1, 1), impl="ref")
            g, rg = b.groups(), rb.groups()
            assert g.num_groups == rg.num_groups == len(reps) == b.distinct
            for f in ("reps", "counts", "group_ids"):
                np.testing.assert_array_equal(getattr(g, f),
                                              getattr(rg, f))
            np.testing.assert_array_equal(g.group_ids, inverse)
            assert (b.rebuilds, b.inserts, b.probes) \
                == (rb.rebuilds, rb.inserts, rb.probes)
        assert b.rebuilds >= 1, "growth path never exercised"


@pytest.mark.parametrize("impl", IMPLS)
def test_ingest_is_sync_free_probe_costs_one(impl):
    rng = np.random.default_rng(1)
    allk = rng.integers(0, 9, size=40).astype(np.int32)
    b = StreamJoinBuild("t", "t.k", _KeyTable(allk), impl=impl, min_cap=64)
    allk = np.concatenate([allk, rng.integers(0, 9, 30).astype(np.int32)])
    before = HOST_SYNCS.syncs
    b.extend(_KeyTable(allk))
    assert HOST_SYNCS.syncs == before, "ingest must cost 0 syncs"
    snap0 = HOST_SYNCS.by_site.get("stream_probe", 0)
    before = HOST_SYNCS.syncs
    b.probe(torch.from_numpy(rng.integers(0, 12, 25).astype(np.int32)))
    assert HOST_SYNCS.syncs == before + 1
    assert HOST_SYNCS.by_site["stream_probe"] == snap0 + 1
    before = HOST_SYNCS.syncs
    assert b.distinct == b.distinct == 9
    b.groups()
    assert HOST_SYNCS.syncs == before + 2  # stream_build + stream_groups


def test_empty_paths_and_host_defers():
    b = StreamJoinBuild("t", "t.k", _KeyTable([]), impl="ref", min_cap=64)
    out = b.probe(torch.tensor([1, 2], dtype=torch.int32))
    assert all(_np(x).size == 0 for x in out)
    assert b.groups().num_groups == 0
    out = b.probe(torch.zeros(0, dtype=torch.int32))
    assert all(_np(x).size == 0 for x in out)
    b = StreamJoinBuild("t", "t.k", _KeyTable([1, 2]), impl="ref")
    assert b.probe(torch.tensor([1], dtype=torch.int32), impl="host") \
        is None
    # "auto" on the CPU is the host fallback: the batch join serves
    b = StreamJoinBuild("t", "t.k", _KeyTable([1, 2]))
    assert b.probe(torch.tensor([1], dtype=torch.int32)) is None


# ------------------------------------------------------ append contract

def _pair(events):
    p, r = Database(device="cpu"), RDatabase()
    p.add_table("events", list(events))
    r.add_table("events", list(events))
    return p, r


def test_append_matches_cold_add_table_and_reference():
    recs = [{"eid": i, "k": i % 3, "v": float(i)} for i in range(7)]
    extra = [{"eid": 7, "k": 9, "v": 1.5},
             {"eid": 8, "k": 0, "v": None}]
    cold = Database(device="cpu")
    cold.add_table("events", list(recs) + [dict(extra[0]),
                                            {"eid": 8, "k": 0,
                                             "v": float("nan")}])
    db, rdb = _pair(recs)
    db.tables["events"].num_valid  # cache, as an executor would
    before = HOST_SYNCS.syncs
    t = append_rows(db, "events", extra)
    assert HOST_SYNCS.syncs == before, "append must cost 0 syncs"
    assert t.num_valid == 9
    rt = r_append_rows(rdb, "events", extra)
    for q in cold.tables["events"].columns:
        np.testing.assert_array_equal(_np(t.col(q)),
                                      _np(cold.tables["events"].col(q)))
        np.testing.assert_array_equal(_np(t.col(q)), np.asarray(rt.col(q)))
        assert t.col(q).dtype == cold.tables["events"].col(q).dtype
    assert db.payloads["events"] == rdb.payloads["events"]


def test_append_edge_cases():
    db, _ = _pair([{"eid": 0, "k": 1}])
    t0 = db.tables["events"]
    assert append_rows(db, "events", []) is t0
    with pytest.raises(KeyError):
        append_rows(db, "events", [{"eid": 1}])


def test_append_to_columnar_payload():
    from repro_torch.engine import database_from_numpy

    db = database_from_numpy({"events": {"eid": np.arange(3),
                                         "v": np.ones(3, np.float32),
                                         "name": ["a", "b", "c"]}},
                             {"events": ["name"]}, device="cpu")
    t = append_rows(db, "events", [{"eid": 3, "v": None, "name": "d"}])
    assert t.capacity == 4 and len(db.payloads["events"]) == 4
    assert db.payloads["events"][3]["name"] == "d"
    assert np.isnan(_np(t.col("events.v"))[3])
    assert _np(t.col("events.row_id")).tolist() == [0, 1, 2, 3]


# ---------------------------------------------------- standing queries

_PHI_CATS = "SEMANTIC: is category {cats.text} perishable?"


def _cats_events(db, n_events=120, n_cats=12, seed=0):
    cats = [{"cat_id": i, "text": f"category {i}"} for i in range(n_cats)]
    rng = np.random.default_rng(seed)
    events = [{"event_id": j, "cat_id": int(rng.integers(0, n_cats))}
              for j in range(n_events)]
    db.add_table("cats", cats, text_columns={"text"})
    db.add_table("events", events)
    db.truths = {_PHI_CATS: lambda ctx: ctx["cats"]["cat_id"] % 3 == 0}
    return db


def _cats_events_plan(q):
    return (q.scan("events")
            .join(q.scan("cats"), "events.cat_id", "cats.cat_id")
            .sem_filter(_PHI_CATS)
            .build())


def _held(d, rd):
    """A port BatchDelta against the reference's for the same batch."""
    assert _frozen(d.output) == _frozen(rd.output)
    assert _frozen(d.added) == _frozen(rd.added)
    assert _frozen(d.removed) == _frozen(rd.removed)
    for f in STATS:
        assert getattr(d.stats, f) == getattr(rd.stats, f), f


@pytest.mark.parametrize("impl", IMPLS)
def test_standing_query_deltas_match_reference(impl):
    """Appends of cached keys, new keys and a 10k one-key flood: after
    every batch the port's deltas, outputs and stats (``stream``
    joins, zero LLM calls for cached keys) equal the reference's, and
    the output equals a cold port run on the concatenated data."""
    db = _cats_events(Database(device="cpu"))
    rdb = _cats_events(RDatabase())
    cols = ["events.event_id", "cats.cat_id"]
    sess = StreamSession(db, OracleBackend(truths=db.truths),
                         kernel_impl=impl)
    rsess = RStreamSession(rdb, ROracle(truths=rdb.truths),
                           kernel_impl="ref")
    sq = sess.register("q", _cats_events_plan(Q), out_cols=cols)
    rsq = rsess.register("q", _cats_events_plan(RQ), out_cols=cols)
    assert sq.last_stats.llm_calls == rsq.last_stats.llm_calls == 12
    rng = np.random.default_rng(3)
    n0 = 120
    for ne in (1, 17, 64, 0, 10_000):
        cat = (lambda: 3) if ne == 10_000 else \
            (lambda: int(rng.integers(0, 12)))
        recs = [{"event_id": n0 + j, "cat_id": cat()} for j in range(ne)]
        n0 += ne
        d = sess.ingest("events", recs)["q"]
        rd = rsess.ingest("events", [dict(r) for r in recs])["q"]
        _held(d, rd)
        assert d.stats.llm_calls == 0
        assert d.stats.join_physical == {"stream": 1}
        cold_t, _ = Executor(db, SemanticRunner(
            OracleBackend(truths=db.truths)), kernel_impl=impl).execute(
                _cats_events_plan(Q))
        assert _frozen(d.output) == _frozen(db.materialize(cold_t, cols))
    b = sess.ctx.builds[("cats", "cats.cat_id")]
    rb = rsess.ctx.builds[("cats", "cats.cat_id")]
    assert (b.rebuilds, b.inserts, b.probes) \
        == (rb.rebuilds, rb.inserts, rb.probes)


def test_register_skips_keys_the_table_cannot_code():
    db = _cats_events(Database(device="cpu"))
    ctx = StreamContext(db, kernel_impl="ref")
    assert ctx.register_join_build("nope", "nope.k") is None
    assert ctx.register_join_build("cats", "cats.missing") is None
    assert ctx.register_join_build("cats", "cats.cat_id") is \
        ctx.register_join_build("cats", "cats.cat_id")
    assert ctx.build_for(db.tables["cats"], "cats.cat_id", "host") is None


def _append_schedule(db, donor, rng):
    """``tests/test_streaming.py``'s mixed schedule: one donor slice per
    table, an empty batch and a 64-row duplicate-key flood."""
    tables = sorted(db.tables)
    batches = []
    for t in tables:
        pool = donor.payloads[t]
        k = int(rng.integers(1, max(2, min(40, len(pool)))))
        batches.append((t, [pool[i] for i in range(k)]))
    flood_t = tables[int(rng.integers(0, len(tables)))]
    batches.append((flood_t, []))
    batches.append((flood_t, [donor.payloads[flood_t][0]] * 64))
    return batches


@pytest.mark.parametrize("schema", ("bookreview", "ecommerce"))
def test_corpus_replay_matches_reference(schema):
    """The corpus queries of a schema as standing queries under the
    default ``CostParams()``, fed the reference's append schedule: after
    every micro-batch the port's outputs, deltas and stats equal the
    reference's, and some join is served by the stream table."""
    specs = [s for s in ALL_QUERIES if s.schema == schema]
    db = PORT_SCHEMAS[schema](seed=0, scale=0.1, device="cpu")
    donor = PORT_SCHEMAS[schema](seed=1, scale=0.1, device="cpu")
    rdb = SCHEMAS[schema](seed=0, scale=0.1)
    sess = StreamSession(db, OracleBackend(truths=db.truths),
                         kernel_impl="kernel")
    rsess = RStreamSession(rdb, ROracle(truths=rdb.truths),
                           kernel_impl="ref")
    for spec in specs:
        plan = port_core.optimize(port_plan(spec), db.catalog(),
                                  strategy="cost").plan
        rplan = r_optimize(spec.build(), rdb.catalog(), strategy="cost").plan
        sess.register(spec.qid, plan, out_cols=spec.out_cols)
        rsess.register(spec.qid, rplan, out_cols=spec.out_cols)
    stream_joins = 0
    rng = np.random.default_rng(7)
    for tname, records in _append_schedule(db, donor, rng):
        deltas = sess.ingest(tname, records)
        rdeltas = rsess.ingest(tname, [dict(r) for r in records])
        for spec in specs:
            _held(deltas[spec.qid], rdeltas[spec.qid])
            stream_joins += deltas[spec.qid].stats.join_physical.get(
                "stream", 0)
    assert stream_joins > 0


# ------------------------------------------------------------ front door

def test_front_door_matches_reference():
    """Four lanes sharing one runner: the same outputs and stats per
    query as the reference's front door, and the shared cache makes the
    repeated query free."""
    db = _cats_events(Database(device="cpu"))
    rdb = _cats_events(RDatabase())
    fd = FrontDoor(db, SemanticRunner(OracleBackend(truths=db.truths)),
                   n_lanes=4, kernel_impl="kernel")
    rfd = RFrontDoor(rdb, RRunner(ROracle(truths=rdb.truths)), n_lanes=4,
                     kernel_impl="ref")
    plans = [_cats_events_plan(Q), _cats_events_plan(Q)]
    rplans = [_cats_events_plan(RQ), _cats_events_plan(RQ)]
    out, rout = fd.run(plans), rfd.run(rplans)
    cols = ["events.event_id", "cats.cat_id"]
    for (t, st, lat), (rt, rst, _) in zip(out, rout):
        assert lat > 0
        assert db.materialize(t, cols) == rdb.materialize(rt, cols)
        for f in STATS:
            assert getattr(st, f) == getattr(rst, f), f
    assert out[0][1].llm_calls == 12 and out[1][1].llm_calls == 0
    fd.reset_scope()
    assert fd.execute(plans[0])[1].llm_calls == 12
