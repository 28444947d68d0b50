"""The port's table layer against the reference's: the same columns and
dtypes from the same records, compaction / gathers / lazy host columns
at every impl, ``database_from_numpy`` against ``add_table``, and the
default device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine.table import Database as RDatabase  # noqa: E402
from repro.engine.table import Table as RTable  # noqa: E402
from repro.kernels.compact.ops import compact_index as r_compact  # noqa
from repro.kernels.sync import HOST_SYNCS as R_SYNCS  # noqa: E402
from repro_torch.engine.table import (  # noqa: E402
    ColumnarRows,
    Database,
    LazyColumn,
    Table,
    as_column,
    database_from_numpy,
)
from repro_torch.kernels.compact.ops import (  # noqa: E402
    compact_index,
    device_gather,
)
from repro_torch.kernels.sync import HOST_SYNCS  # noqa: E402

CPU = "cpu"


def _records(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": i, "score": float(rng.random()),
             "flag": bool(rng.random() < 0.5), "text": f"row {i}",
             "_latent": int(rng.integers(3))} for i in range(n)]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same_table(rt, pt):
    assert list(rt.columns) == list(pt.columns)
    for k in rt.columns:
        a, b = np.asarray(rt.columns[k]), _host(pt.columns[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(np.asarray(rt.valid), _host(pt.valid))


def test_add_table_same_columns_and_dtypes():
    recs = _records()
    rdb, pdb = RDatabase(), Database(device=CPU)
    for db in (rdb, pdb):
        db.add_table("t", recs, text_columns={"text"})
    _same_table(rdb.tables["t"], pdb.tables["t"])
    assert rdb.text_cols == pdb.text_cols
    assert pdb.tables["t"].columns["t.id"].dtype == torch.int32
    assert pdb.tables["t"].columns["t.score"].dtype == torch.float32
    assert pdb.tables["t"].columns["t.flag"].dtype == torch.int32
    rc, pc = rdb.catalog(), pdb.catalog()
    assert rc.tables == pc.tables


def test_as_column_width_rule():
    assert isinstance(as_column(np.arange(4, dtype=np.int32), CPU),
                      torch.Tensor)
    assert isinstance(as_column(np.zeros(3, np.float32), CPU), torch.Tensor)
    assert isinstance(as_column(np.arange(4, dtype=np.int64), CPU),
                      np.ndarray)
    assert isinstance(as_column(np.zeros(3), CPU), np.ndarray)
    assert isinstance(as_column(np.array(["a", "b"]), CPU), np.ndarray)


def _mixed_tables(n=40, seed=1):
    """The same mixed-width table in both packages: device int32 and
    float32 columns, host int64 and string columns, a validity mask."""
    rng = np.random.default_rng(seed)
    cols = {"t.a": np.arange(n, dtype=np.int32),
            "t.f": rng.random(n).astype(np.float32),
            "t.w": rng.integers(0, 2**40, n),
            "t.s": np.array([f"s{i}" for i in range(n)])}
    valid = rng.random(n) < 0.6
    rt = RTable(columns={k: (jnp.asarray(v) if v.dtype.itemsize <= 4
                             and v.dtype.kind != "U" else v)
                         for k, v in cols.items()},
                valid=jnp.asarray(valid))
    pt = Table(columns={k: as_column(v, CPU) for k, v in cols.items()},
               valid=torch.from_numpy(valid))
    return rt, pt, valid


@pytest.mark.parametrize("impl", ("host", "ref", "kernel"))
def test_compact_same_rows_as_reference(impl):
    rt, pt, valid = _mixed_tables()
    r_impl = "ref" if impl == "kernel" else impl
    rc, pc = rt.compact(r_impl), pt.compact(impl)
    assert rc.capacity == pc.capacity == int(valid.sum())
    for k in rc.columns:
        a, b = np.asarray(rc.columns[k]), np.asarray(_host(pc.columns[k]))
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert a.dtype == b.dtype
    if impl != "host":
        # host columns defer behind one lazily fetched index
        assert isinstance(pc.columns["t.s"], LazyColumn)
        assert isinstance(pc.columns["t.a"], torch.Tensor)


@pytest.mark.parametrize("impl", ("host", "ref", "kernel"))
def test_gather_and_take_rows_same_rows(impl):
    rt, pt, _ = _mixed_tables()
    idx = np.array([5, 0, 39, 5, 17])
    r_impl = "ref" if impl == "kernel" else impl
    rg, pg = rt.gather(idx, r_impl), pt.gather(idx, impl)
    for k in rg.columns:
        np.testing.assert_array_equal(np.asarray(rg.columns[k]),
                                      np.asarray(_host(pg.columns[k])))
    pr = pt.take_rows(torch.as_tensor(idx, dtype=torch.int32))
    for k in rg.columns:
        np.testing.assert_array_equal(np.asarray(rg.columns[k]),
                                      np.asarray(_host(pr.columns[k])))


def test_lazy_column_fetches_index_once():
    _, pt, valid = _mixed_tables()
    HOST_SYNCS.reset()
    out = pt.take_rows(torch.arange(5, dtype=torch.int32))
    s, w = out.columns["t.s"], out.columns["t.w"]
    assert s.dtype == np.dtype("<U3") and w.dtype == np.int64
    assert HOST_SYNCS.by_site.get("compact_host_cols", 0) == 0
    np.testing.assert_array_equal(np.asarray(s), [f"s{i}" for i in range(5)])
    np.asarray(w)
    assert HOST_SYNCS.by_site["compact_host_cols"] == 1


@pytest.mark.parametrize("impl", ("host", "ref", "kernel"))
def test_compact_index_matches_reference(impl):
    rng = np.random.default_rng(3)
    for n in (0, 1, 1023, 1025, 5000):
        valid = rng.random(n) < 0.3
        r_impl = "ref" if impl == "kernel" else impl
        ri, rn = r_compact(jnp.asarray(valid), impl=r_impl)
        pi, pn = compact_index(torch.from_numpy(valid), impl=impl)
        assert rn == pn
        np.testing.assert_array_equal(np.asarray(ri), _host(pi))
    # a known count skips the scalar fetch
    HOST_SYNCS.reset()
    valid = torch.from_numpy(np.arange(10) % 3 == 0)
    idx, cnt = compact_index(valid, count=4, impl="ref")
    assert cnt == 4 and HOST_SYNCS.syncs == 0
    np.testing.assert_array_equal(idx.numpy(), [0, 3, 6, 9])


def test_device_gather_uploads_host_index():
    a = torch.arange(6, dtype=torch.int32)
    b = torch.arange(6, dtype=torch.float32) / 2
    ga, gb = device_gather([a, b], np.array([4, 1]))
    np.testing.assert_array_equal(ga.numpy(), [4, 1])
    np.testing.assert_array_equal(gb.numpy(), [2.0, 0.5])
    assert device_gather([], np.array([0])) == []


def test_database_from_numpy_matches_add_table():
    recs = _records(30)
    cols = {k: [r[k] for r in recs] for k in recs[0]}
    tables = {"t": {k: (np.asarray(v) if k != "text" else v)
                    for k, v in cols.items()}}
    truths = {"phi": lambda ctx: ctx["t"]["_latent"] == 1}
    db = database_from_numpy(tables, {"t": ["text"]}, truths, device=CPU)
    ref = Database(device=CPU)
    ref.add_table("t", recs, text_columns={"text"})
    _same_table(ref.tables["t"], db.tables["t"])
    assert db.text_cols == ref.text_cols
    assert isinstance(db.payloads["t"], ColumnarRows)
    assert list(db.payloads["t"]) == recs
    assert db.payloads["t"][7] == recs[7]
    assert db.payload_value("t", 3, "text") == "row 3"
    assert db.catalog().tables == ref.catalog().tables
    assert db.truths["phi"]({"t": db.payloads["t"][4]}) == \
        (recs[4]["_latent"] == 1)


def test_materialize_same_records_as_reference():
    recs = _records(20)
    rdb, pdb = RDatabase(), Database(device=CPU)
    for db in (rdb, pdb):
        db.add_table("t", recs, text_columns={"text"})
    valid = np.arange(20) % 4 != 1
    rt = rdb.tables["t"].with_mask(jnp.asarray(valid))
    pt = pdb.tables["t"].with_mask(torch.from_numpy(valid))
    want = ["t.id", "t.score", "t.text"]
    assert rdb.materialize(rt, want) == pdb.materialize(pt, want)


def test_num_valid_is_one_cached_sync():
    pt = Table(columns={}, valid=torch.tensor([True, False, True]))
    HOST_SYNCS.reset()
    assert pt.num_valid == 2 and pt.num_valid == 2
    assert HOST_SYNCS.by_site == {"num_valid": 1}


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Database()
    with pytest.raises(RuntimeError, match="CUDA"):
        database_from_numpy({"t": {"x": np.arange(3)}})
    assert Database(device=CPU).device == torch.device("cpu")


def test_reference_sync_counter_is_separate():
    """The port keeps its own HOST_SYNCS: the reference's never moves."""
    R_SYNCS.reset()
    Table(columns={}, valid=torch.ones(3, dtype=torch.bool)).num_valid
    assert R_SYNCS.syncs == 0


@pytest.mark.parametrize("schema", ("bookreview", "yelp", "googlelocal",
                                    "tpch", "ecommerce"))
def test_schema_generators_match_reference(schema):
    from repro.data import SCHEMAS as R_SCHEMAS
    from repro_torch.data import SCHEMAS as P_SCHEMAS

    rdb = R_SCHEMAS[schema](seed=5, scale=0.05)
    pdb = P_SCHEMAS[schema](seed=5, scale=0.05, device=CPU)
    assert rdb.payloads == pdb.payloads
    assert rdb.text_cols == pdb.text_cols
    assert set(rdb.truths) == set(pdb.truths)
    assert list(rdb.tables) == list(pdb.tables)
    for name in rdb.tables:
        _same_table(rdb.tables[name], pdb.tables[name])
