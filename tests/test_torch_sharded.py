"""The port's partitioned data tier (``repro_torch.sharding``, the mesh
``Executor``, the mesh-partitioned ``VerdictTable``) against the
reference's (``repro.sharding``).

* Every output of the tier's pieces — partition layouts with their pads,
  group plans, gid maps, sharded min/max (NaN, signed zeros, ±inf, int32
  extremes), join match lists and the sync and collective counts —
  bit for bit: at P = 1 against the reference in this process, at P = 4
  against one module-scoped subprocess of the reference on four forced
  host devices (``torch_shard_check.py``). The port runs at ``ref`` and
  at ``kernel`` (the CUDA wrappers' plain versions on the CPU), on a
  mesh whose shards share one device (one permute-copy exchange) and on
  one whose shards alternate between two CPU device names (the
  peer-copy exchange).
* The port's cases of every test in ``tests/test_sharded.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_shard_check as C  # noqa: E402
from repro.data import SCHEMAS as REF_SCHEMAS  # noqa: E402
from repro.core import optimize as ref_optimize  # noqa: E402
from repro.engine import Executor as RExecutor  # noqa: E402
from repro.semantic import (  # noqa: E402
    OracleBackend as ROracle,
    SemanticRunner as RRunner,
)
from repro.sharding import make_data_mesh as ref_make_data_mesh  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import Q, col  # noqa: E402
from repro_torch.engine import Database, Executor, Table  # noqa: E402
from repro_torch.kernels.sync import HOST_SYNCS  # noqa: E402
from repro_torch.semantic import OracleBackend, SemanticRunner  # noqa: E402
from repro_torch.semantic.cache import (  # noqa: E402
    VERDICT_MISS,
    FunctionCache,
    VerdictTable,
)
from repro_torch.sharding import (  # noqa: E402
    DataMesh,
    PartitionCache,
    make_data_mesh,
    merge_partitions,
    partition_columns,
)

CPU4 = ["cpu"] * 4
# two device names of the CPU: the shards do not share one device, so
# the exchange takes the peer-copy path
CPU4_SPLIT = ["cpu", "cpu:0", "cpu", "cpu:0"]
MESH = make_data_mesh(4, devices=CPU4)
IMPLS = ("ref", "kernel")
STAT_FIELDS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
               "sem_rows", "rel_rows")


def _same_bits(got: dict, want: dict) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


# ---------------------------------------------------------------------------
# The tier's pieces, bit for bit against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    return C.reference_tier_mesh(tmp_path_factory.mktemp("tier"))


@pytest.fixture(scope="module")
def ref1():
    return C.reference_tier(ref_make_data_mesh(1))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("devices", (CPU4, CPU4_SPLIT),
                         ids=("shared", "split"))
def test_tier_matches_reference_four_shards(ref4, devices, impl):
    _same_bits(C.port_tier(make_data_mesh(4, devices=devices), impl), ref4)


@pytest.mark.parametrize("impl", IMPLS)
def test_tier_matches_reference_one_shard(ref1, impl):
    _same_bits(C.port_tier(make_data_mesh(1, devices=["cpu"]), impl), ref1)


def test_tier_cases_cover_the_edges(ref4):
    """The reference's outputs the equality above pins include NaN
    groups, both signed zeros and a budget of ticks per step."""
    lo = ref4["keys_minmax.vals_f32.min"]
    hi = ref4["keys_minmax.vals_f32.max"]
    assert np.isnan(lo).sum() == 24 and np.isnan(hi).sum() == 24
    zeros = lo[(lo == 0)]
    assert np.signbit(zeros).all() and len(zeros) == 12
    assert not np.signbit(hi[hi == 0]).any()
    assert ref4["keys_minmax.sync.shard_merge"] == 2
    assert ref4["keys_minmax.sync.shard_reduce"] == 4
    assert ref4["keys_multikey.coll.exchange_aggregate"] == 1
    assert ref4["join_random.coll.exchange_join_build"] == 1
    assert ref4["join_skew.coll.exchange_join_probe"] == 1
    assert ref4["join_random.sync.shard_join_probe"] == 2
    assert ref4["join_none.sync.shard_join_probe"] == 1
    assert ref4["keys_empty.data"].shape == (4, 4 * 1024)


# ---------------------------------------------------------------------------
# Partition layout: exact inverse, degenerate mesh, validation
# ---------------------------------------------------------------------------

def _partition_roundtrip(keys: np.ndarray, mesh, impl="ref") -> None:
    cols = [torch.as_tensor(keys[:, i]) for i in range(keys.shape[1])]
    st_ = partition_columns(cols, len(keys), mesh,
                            site="exchange_aggregate", impl=impl)
    assert np.array_equal(merge_partitions(st_), keys)


@pytest.mark.parametrize("impl", IMPLS)
def test_partition_merge_roundtrip_multikey(impl):
    rng = np.random.default_rng(0)
    keys = np.stack([rng.integers(-1000, 1000, 777),
                     rng.integers(0, 5, 777)], axis=1).astype(np.int32)
    _partition_roundtrip(keys, MESH, impl)


def test_partition_roundtrip_extremes_and_empty():
    ext = np.array([[2**31 - 1], [-2**31], [0], [2**31 - 1]],
                   dtype=np.int32)
    _partition_roundtrip(ext, MESH)
    _partition_roundtrip(np.zeros((0, 2), dtype=np.int32), MESH)


def test_partition_roundtrip_skew_single_key_value():
    _partition_roundtrip(np.full((2048, 1), 7, dtype=np.int32), MESH)


def test_single_shard_mesh_is_identity():
    mesh1 = make_data_mesh(1, devices=["cpu"])
    rng = np.random.default_rng(1)
    keys = rng.integers(-9, 9, (513, 2)).astype(np.int32)
    _partition_roundtrip(keys, mesh1)


def test_make_data_mesh_validation():
    with pytest.raises(ValueError):
        make_data_mesh(3, devices=CPU4)  # not a power of two
    with pytest.raises(ValueError):
        make_data_mesh(8, devices=CPU4)  # more shards than devices
    with pytest.raises(ValueError):
        DataMesh(("cpu",) * 3)
    # the default: the largest power of two of the devices, at most 8
    assert make_data_mesh(devices=["cpu"] * 7).n_shards == 4
    assert make_data_mesh(devices=["cpu"] * 20).n_shards == 8
    assert make_data_mesh(16, devices=["cpu"] * 20).n_shards == 16


def test_make_data_mesh_never_falls_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_data_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_data_mesh(1)


def test_repeated_devices_share_one_device():
    assert MESH.shared and MESH.n_shards == 4
    assert not make_data_mesh(4, devices=CPU4_SPLIT).shared


def test_group_plan_matches_np_unique():
    rng = np.random.default_rng(2)
    keys = np.stack([rng.integers(-20, 20, 4000),
                     rng.integers(0, 3, 4000)], axis=1).astype(np.int32)
    cols = [torch.as_tensor(keys[:, i]) for i in range(2)]
    st_ = partition_columns(cols, len(keys), MESH,
                            site="exchange_aggregate", impl="ref")
    plan, reps = st_.group_plan()
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    assert plan.num_groups == len(uniq)
    assert np.array_equal(plan.seg, inv)
    assert np.array_equal(plan.counts,
                          np.bincount(inv, minlength=len(uniq)))
    assert np.array_equal(plan.order, np.argsort(inv, kind="stable"))
    assert np.array_equal(keys[reps], uniq)


def test_partitioning_is_device_only():
    with pytest.raises(ValueError, match="device-only"):
        partition_columns([torch.arange(4, dtype=torch.int32)], 4, MESH,
                          site="exchange_aggregate", impl="host")


# ---------------------------------------------------------------------------
# Executor edges: fallbacks keep equivalence, budgets hold exactly
# ---------------------------------------------------------------------------

def _edge_records():
    rng = np.random.default_rng(3)
    ev = [{"eid": j, "k": int(k), "x": float(v)}
          for j, (k, v) in enumerate(zip(rng.integers(0, 13, 600),
                                         rng.normal(size=600)))]
    cat = [{"k": i, "label": f"cat {i}"} for i in range(13)]
    return ev, cat


def _edge_db(ev=None):
    evr, cat = _edge_records()
    db = Database(device="cpu")
    db.add_table("ev", ev if ev is not None else evr)
    db.add_table("cat", cat, text_columns={"label"})
    db.truths = {}
    return db


def _run(db, plan, out_cols, impl, mesh=None):
    backend = OracleBackend(truths=db.truths)
    ex = Executor(db, SemanticRunner(backend), kernel_impl=impl, mesh=mesh)
    table, stats = ex.execute(plan)
    return C._freeze(db.materialize(table, list(out_cols))), stats


def _both_paths(db, plan, out_cols, impl="ref"):
    recs_s, ss = _run(db, plan, out_cols, impl)
    recs_m, sm = _run(db, plan, out_cols, impl, MESH)
    return recs_s, ss, recs_m, sm


AGG_COLS = ["ev.k", "agg.n", "agg.lo", "agg.hi", "agg.s"]


def _agg_plan(Q):
    return (Q.scan("ev")
            .group_by(["ev.k"], aggs=[("count", "ev.x", "n"),
                                      ("min", "ev.x", "lo"),
                                      ("max", "ev.x", "hi"),
                                      ("sum", "ev.x", "s")])
            .build())


def _join_plan(Q):
    return Q.scan("ev").join(Q.scan("cat"), "ev.k", "cat.k").build()


@pytest.mark.parametrize("impl", IMPLS)
def test_partitioned_aggregate_and_join_equivalence(impl):
    db = _edge_db()
    recs_s, _, recs_m, sm = _both_paths(db, _agg_plan(Q), AGG_COLS, impl)
    assert recs_m == recs_s
    assert sm.collective_ops <= 1
    recs_s, _, recs_m, sm = _both_paths(db, _join_plan(Q),
                                        ["ev.eid", "cat.label"], impl)
    assert recs_m == recs_s
    assert sm.collective_ops <= 2
    assert sm.join_physical == {"partitioned": 1}


def test_partitioned_aggregate_and_join_match_the_reference():
    """The same edge tables through the reference's single-device
    executor: rows, order and the six stats."""
    from repro.core import Q as RQ
    from repro.engine import Database as RDatabase

    evr, cat = _edge_records()
    rdb = RDatabase()
    rdb.add_table("ev", evr)
    rdb.add_table("cat", cat, text_columns={"label"})
    rdb.truths = {}
    db = _edge_db()
    for plan_fn, cols in ((_agg_plan, AGG_COLS),
                          (_join_plan, ["ev.eid", "cat.label"])):
        rt, rst = RExecutor(rdb, RRunner(ROracle(truths={})),
                            kernel_impl="ref").execute(plan_fn(RQ))
        want = C._freeze(rdb.materialize(rt, cols))
        got, st = _run(db, plan_fn(Q), cols, "kernel", MESH)
        assert got == want
        for f in STAT_FIELDS:
            assert getattr(st, f) == getattr(rst, f), f


def test_empty_input_partitioned():
    db = _edge_db()
    plan = (Q.scan("ev").where(col("ev.eid") < 0)
            .group_by(["ev.k"], aggs=[("count", "ev.x", "n")])
            .build())
    recs_s, _, recs_m, _ = _both_paths(db, plan, ["ev.k", "agg.n"])
    assert recs_m == recs_s == []


@pytest.mark.parametrize("impl", IMPLS)
def test_nan_values_partitioned_minmax(impl):
    rows, _ = _edge_records()
    for r in rows[::7]:
        r["x"] = float("nan")
    db = _edge_db(rows)
    plan = (Q.scan("ev")
            .group_by(["ev.k"], aggs=[("min", "ev.x", "lo"),
                                      ("max", "ev.x", "hi")])
            .build())
    recs_s, _, recs_m, _ = _both_paths(db, plan,
                                       ["ev.k", "agg.lo", "agg.hi"], impl)
    assert recs_m == recs_s
    assert any(v == "NaN" for r in recs_m for _, v in r)


def test_float_group_keys_fall_back_single_device():
    """Float group keys are not partitionable: the mesh executor must
    fall back to the single-device aggregate with zero exchanges."""
    db = Database(device="cpu")
    rng = np.random.default_rng(4)
    db.add_table("t", [{"g": float(g), "v": float(v)}
                       for g, v in zip(rng.integers(0, 4, 200),
                                       rng.normal(size=200))])
    db.truths = {}
    plan = (Q.scan("t")
            .group_by(["t.g"], aggs=[("count", "t.v", "n")]).build())
    recs_s, _, recs_m, sm = _both_paths(db, plan, ["t.g", "agg.n"])
    assert recs_m == recs_s
    assert sm.collective_ops == 0


def test_string_join_keys_fall_back_single_device():
    """Host string key columns are not partitionable: the mesh join
    must take the single-device route with zero exchanges and match
    it exactly."""
    lt = Table(columns={"l.k": np.asarray(["a", "b", "a", "c"]),
                        "l.x": torch.arange(4, dtype=torch.int32)},
               valid=torch.ones(4, dtype=torch.bool))
    rt = Table(columns={"r.k": np.asarray(["a", "c", "a"]),
                        "r.y": torch.arange(3, dtype=torch.int32)},
               valid=torch.ones(3, dtype=torch.bool))
    db = Database(device="cpu")
    runner = SemanticRunner(OracleBackend(truths={}))
    outs = {}
    coll0 = HOST_SYNCS.collectives
    for mesh in (None, MESH):
        ex = Executor(db, runner, kernel_impl="ref", mesh=mesh)
        out = ex._equi_join(lt, rt, "l.k", "r.k")
        outs[mesh is None] = {k: np.asarray(v).tolist()
                              for k, v in out.columns.items()}
    assert outs[True] == outs[False]
    assert HOST_SYNCS.collectives == coll0


def test_int32_extreme_join_keys_partitioned():
    """INT32_MAX keys collide with the sorted-probe padding value —
    the valid-count clamp must keep matches exact."""
    big, small = 2**31 - 1, -2**31
    db = Database(device="cpu")
    db.add_table("l", [{"lid": i, "k": k} for i, k in
                       enumerate([big, small, 0, big, 7])])
    db.add_table("r", [{"rid": i, "k": k} for i, k in
                       enumerate([big, 7, small, big])])
    db.truths = {}
    plan = (Q.scan("l").join(Q.scan("r"), "l.k", "r.k").build())
    recs_s, _, recs_m, _ = _both_paths(db, plan, ["l.lid", "r.rid"])
    assert recs_m == recs_s
    assert len(recs_m) == 2 * 2 + 1 + 1  # big: 2x2, small, 7


@pytest.mark.parametrize("impl", IMPLS)
def test_collective_budget_cold_and_warm(impl):
    """Cold aggregate <= 1 exchange, warm exactly 0 (cached layout);
    cold join <= 2 (build + probe), warm exactly 1 (probe only)."""
    db = _edge_db()
    runner = SemanticRunner(OracleBackend(truths=db.truths))
    ex = Executor(db, runner, kernel_impl=impl, mesh=MESH)
    ap = (Q.scan("ev")
          .group_by(["ev.k"], aggs=[("count", "ev.x", "n")]).build())
    _, s_cold = ex.execute(ap)
    assert s_cold.collective_ops <= 1
    _, s_warm = ex.execute(ap)
    assert s_warm.collective_ops == 0
    _, j_cold = ex.execute(_join_plan(Q))
    assert j_cold.collective_ops <= 2
    _, j_warm = ex.execute(_join_plan(Q))
    assert j_warm.collective_ops == 1


def test_host_impl_keeps_the_mesh_executor_single_device():
    db = _edge_db()
    recs_s, _, recs_m, sm = _both_paths(db, _join_plan(Q),
                                        ["ev.eid", "cat.label"], "host")
    assert recs_m == recs_s
    assert sm.collective_ops == 0 and "partitioned" not in sm.join_physical


def test_partition_cache_reuses_layout():
    db = _edge_db()
    cache = PartitionCache(MESH)
    t = db.tables["ev"]
    st1 = cache.layout(t, ("ev.k",), site="exchange_aggregate",
                       impl="ref")
    st2 = cache.layout(t, ("ev.k",), site="exchange_aggregate",
                       impl="ref")
    assert st1 is st2


def test_partitioned_requires_mesh():
    db = _edge_db()
    with pytest.raises(ValueError):
        Executor(db, SemanticRunner(OracleBackend(truths={})),
                 partitioned=True)


def test_partitioned_false_keeps_single_device():
    db = _edge_db()
    runner = SemanticRunner(OracleBackend(truths={}))
    ex = Executor(db, runner, kernel_impl="ref", mesh=MESH,
                  partitioned=False)
    _, st = ex.execute(_join_plan(Q))
    assert st.collective_ops == 0
    assert "partitioned" not in st.join_physical


def test_corpus_query_with_exchange_planning():
    """A corpus-shaped query planned under ``CostParams(n_shards=4)``
    (the exchange-priced cost model) on the mesh equals the
    single-device run."""
    from repro_torch.data import SCHEMAS

    db = SCHEMAS["yelp"](seed=0, scale=0.1, device="cpu")
    plan = (Q.scan("businesses")
            .join(Q.scan("yreviews"), "businesses.biz_id",
                  "yreviews.biz_id")
            .group_by(["businesses.biz_id"], [("count", "*", "cnt")])
            .build())
    opt = port_core.optimize(plan, db.catalog(), strategy="cost",
                             params=port_core.CostParams(n_shards=4))
    cols = ["businesses.biz_id", "agg.cnt"]
    recs_s, _ = _run(db, opt.plan, cols, "kernel")
    recs_m, sm = _run(db, opt.plan, cols, "kernel", MESH)
    assert recs_m == recs_s and len(recs_m) > 0
    assert sm.join_physical == {"partitioned": 1}
    assert sm.collective_ops == 3


# ---------------------------------------------------------------------------
# VerdictTable partitioning: same key-hash routing, same semantics
# ---------------------------------------------------------------------------

def _verdict_batch():
    rng = np.random.default_rng(7)
    n = 1500
    return (rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.integers(0, 2, n).astype(np.int8))


@pytest.mark.parametrize("devices", (CPU4, CPU4_SPLIT),
                         ids=("shared", "split"))
def test_verdict_table_mesh_equivalence(devices):
    hashes, fps, verd = _verdict_batch()
    phi = "SEMANTIC: partitioned?"
    mesh = make_data_mesh(4, devices=devices)
    for vt in (VerdictTable(capacity=1 << 12, impl="on", device="cpu"),
               VerdictTable(capacity=1 << 12, impl="on", mesh=mesh)):
        vt.bind(phi, hashes, fps, verd)
        out = vt.probe(phi, hashes, fps)
        hit = out != VERDICT_MISS
        # every hit returns the bound verdict; misses only from slot
        # occupancy (the collision pattern may move across meshes)
        assert np.array_equal(out[hit], verd[hit])
        assert hit.sum() > 0
        vt.clear()
        out = vt.probe(phi, hashes, fps)
        assert np.all(out == VERDICT_MISS)


def test_verdict_table_mesh_matches_reference_slots():
    """The mesh table routes a tag as the reference does — owning shard
    (the reference's ``shard_of_np``) times the local capacity plus the
    tag's low bits — and at P = 1 answers a batch as the reference's
    mesh-bound table does, key for key."""
    from repro.kernels.partition.ref import shard_of_np as ref_shard_of
    from repro.semantic.cache import VerdictTable as RVerdicts

    hashes, fps, verd = _verdict_batch()
    vt = VerdictTable(capacity=1 << 12, impl="on", mesh=MESH)
    local = np.uint32((1 << 12) // 4)
    want = (ref_shard_of(hashes, 4).astype(np.uint32) * local
            + (hashes & (local - np.uint32(1))))
    assert np.array_equal(vt._slots(hashes), want)
    phi = "SEMANTIC: partitioned?"
    ref = RVerdicts(capacity=1 << 12, impl="on",
                    mesh=ref_make_data_mesh(1))
    one = VerdictTable(capacity=1 << 12, impl="on",
                       mesh=make_data_mesh(1, devices=["cpu"]))
    for t in (ref, one):
        t.bind(phi, hashes, fps, verd)
    assert np.array_equal(one.probe(phi, hashes, fps),
                          np.asarray(ref.probe(phi, hashes, fps)))


def test_verdict_table_capacity_must_divide():
    with pytest.raises(ValueError):
        VerdictTable(capacity=MESH.n_shards // 2, mesh=MESH)


def test_verdict_table_mesh_columns_live_on_their_shards():
    vt = VerdictTable(capacity=1 << 10, impl="on",
                      mesh=make_data_mesh(4, devices=CPU4_SPLIT))
    assert len(vt._cols) == 4
    assert all(c[2].numel() == 256 and c[0].device.type == "cpu"
               for c in vt._cols)
    assert not VerdictTable(mesh=MESH).enabled  # "auto": CUDA only


def test_executor_mesh_rewires_default_verdict_table():
    db = _edge_db()
    runner = SemanticRunner(OracleBackend(truths={}))
    assert runner.cache.verdicts.mesh is None
    Executor(db, runner, mesh=MESH)
    assert runner.cache.verdicts.mesh is MESH
    assert not runner.cache.verdicts.enabled  # "auto" on the CPU: off
    # an explicitly mesh-bound table is left alone
    custom = VerdictTable(capacity=1 << 10, impl="off", mesh=MESH)
    runner2 = SemanticRunner(OracleBackend(truths={}),
                             cache=FunctionCache(custom))
    Executor(db, runner2, mesh=MESH)
    assert runner2.cache.verdicts is custom
    # a table forced on stays on when rebound
    runner3 = SemanticRunner(OracleBackend(truths={}),
                             cache=FunctionCache(
                                 VerdictTable(impl="on", device="cpu")))
    Executor(db, runner3, mesh=MESH)
    assert runner3.cache.verdicts.enabled
    assert runner3.cache.verdicts.mesh is MESH


def test_mesh_executor_matches_reference_mesh_executor_one_shard():
    """A corpus query through both packages' mesh executors at P = 1:
    the same rows, stats, collectives, joins and syncs."""
    spec = C.specs("bookreview")[0]
    rdb = REF_SCHEMAS["bookreview"](seed=0, scale=C.SCALE)
    opt = ref_optimize(spec.build(), rdb.catalog(), strategy="cost")
    backend = ROracle(truths=rdb.truths)
    rt, rst = RExecutor(rdb, RRunner(backend), kernel_impl="ref",
                        mesh=ref_make_data_mesh(1)).execute(opt.plan)
    want = C._freeze(rdb.materialize(rt, list(spec.out_cols)))

    from repro_torch.data import SCHEMAS

    saved = C.corpus.Q, C.corpus.col
    C.corpus.Q, C.corpus.col = port_core.Q, port_core.col
    try:
        plan = spec.build()
    finally:
        C.corpus.Q, C.corpus.col = saved
    db = SCHEMAS["bookreview"](seed=0, scale=C.SCALE, device="cpu")
    popt = port_core.optimize(plan, db.catalog(), strategy="cost")
    pb = OracleBackend(truths=db.truths)
    t, st = Executor(db, SemanticRunner(pb), kernel_impl="kernel",
                     mesh=make_data_mesh(1, devices=["cpu"])
                     ).execute(popt.plan)
    assert C._freeze(db.materialize(t, list(spec.out_cols))) == want
    for f in STAT_FIELDS + C.MESH_FIELDS:
        assert getattr(st, f) == getattr(rst, f), f
    assert pb.calls == backend.calls
