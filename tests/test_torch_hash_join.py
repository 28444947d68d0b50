"""The hash-join family of the port against the reference: K6's plain
version against the Pallas radix-rank kernel in interpret mode,
``table_bits`` and the Fibonacci hash, ``hash_join_match`` at port
{ref, kernel, host} against the reference at {ref, interpret, host} on
``tests/test_hash_join.py``'s cases (bit-identical match lists and the
same sync ticks), the executor honouring every annotated physical, and
the wrappers raising for data on a card below compute capability 9.0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import Q as RQ  # noqa: E402
from repro.engine import Database as RDatabase  # noqa: E402
from repro.engine import Executor as RExecutor  # noqa: E402
from repro.kernels.hash_join.hash_join import (  # noqa: E402
    radix_rank_kernel as r_radix_rank,
)
from repro.kernels.hash_join.ops import (  # noqa: E402
    hash_join_match as r_hash_join,
)
from repro.kernels.hash_join.ref import (  # noqa: E402
    fib_hash_jnp,
    table_bits as r_table_bits,
)
from repro.kernels.sync import HOST_SYNCS as R_SYNCS  # noqa: E402
from repro.semantic import OracleBackend as ROracle  # noqa: E402
from repro.semantic import SemanticRunner as RRunner  # noqa: E402
from repro_torch.core import Q  # noqa: E402
from repro_torch.core.plan import Join  # noqa: E402
from repro_torch.engine import Database, Executor, Table  # noqa: E402
from repro_torch.engine.exec import ExecStats  # noqa: E402
from repro_torch.kernels.hash_join import hash_join as t_hj  # noqa: E402
from repro_torch.kernels.hash_join import ref as t_ref  # noqa: E402
from repro_torch.kernels.hash_join.ops import (  # noqa: E402
    _radix_order,
    hash_join_match,
)
from repro_torch.kernels.segmented_reduce.ops import (  # noqa: E402
    segment_count,
    segment_reduce_host,
)
from repro_torch.kernels.sync import HOST_SYNCS  # noqa: E402
from repro_torch.semantic import OracleBackend, SemanticRunner  # noqa: E402
from test_hash_join import CASES, _colliding_keys  # noqa: E402
from test_torch_cuda import exclusive_bases, k6_digit_cases  # noqa: E402

# port impl -> the reference impl it must match
IMPLS = (("ref", "ref"), ("kernel", "interpret"), ("host", "host"))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ------------------------------------------------------------------ K6

@pytest.mark.parametrize("n", (1024, 4096))
def test_radix_rank_plain_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    for d in k6_digit_cases(n, rng):
        base = exclusive_bases(d)
        want = np.asarray(r_radix_rank(jnp.asarray(d), jnp.asarray(base),
                                       interpret=True))
        got = t_hj.radix_rank_kernel(torch.from_numpy(d),
                                     torch.from_numpy(base))
        np.testing.assert_array_equal(_np(got), want)
        # dest is a permutation that sorts the rows stably by digit
        order = np.empty(n, np.int64)
        order[want] = np.arange(n)
        np.testing.assert_array_equal(order, np.argsort(d, kind="stable"))


def test_radix_rank_takes_any_bucket_count():
    rng = np.random.default_rng(3)
    for buckets in (1, 7, 300):
        for d in k6_digit_cases(777, rng, buckets):
            base = exclusive_bases(d, buckets)
            got = _np(t_hj.radix_rank_torch(torch.from_numpy(d),
                                            torch.from_numpy(base)))
            order = np.empty(777, np.int64)
            order[got] = np.arange(777)
            np.testing.assert_array_equal(order,
                                          np.argsort(d, kind="stable"))


@pytest.mark.parametrize("bits", (10, 17, 23))
def test_radix_order_is_the_stable_sort(bits):
    rng = np.random.default_rng(bits)
    key = rng.integers(0, 2**bits, 5000).astype(np.int32)
    key[:2000] = key[0]  # a long run of one slot
    got = _radix_order(torch.from_numpy(key), key_bits=bits)
    np.testing.assert_array_equal(_np(got), np.argsort(key, kind="stable"))


# ------------------------------------------------------- table and hash

def test_table_bits_and_fib_hash_match_reference():
    for n in (1, 2, 3, 511, 512, 513, 60_000, 2**22):
        assert t_ref.table_bits(n) == r_table_bits(n)
    keys = np.asarray([-2**31, -1, 0, 1, 42, 2**31 - 1, 123456789],
                      np.int32)
    for hbits in (10, 17, 23, 30):
        np.testing.assert_array_equal(
            _np(t_ref.fib_hash_torch(torch.from_numpy(keys), hbits)),
            np.asarray(fib_hash_jnp(jnp.asarray(keys), hbits)))


def test_build_owner_is_the_lowest_row_of_each_key():
    bk = np.asarray([5, 9, 5, 5, 9, 1], np.int32)
    owner, slot_of = t_ref.hash_table_build_torch(torch.from_numpy(bk), 10)
    owner, slot_of = _np(owner), _np(slot_of)
    assert sorted(owner[owner != t_ref.EMPTY_SLOT].tolist()) == [0, 1, 5]
    np.testing.assert_array_equal(owner[slot_of], [0, 1, 0, 0, 1, 5])


# ------------------------------------------------------ hash_join_match

def _held(pk, bk, impl, r_impl):
    """Port and reference on the same keys: identical match lists and
    identical sync sites and fallbacks."""
    HOST_SYNCS.reset()
    R_SYNCS.reset()
    got = hash_join_match(torch.from_numpy(pk), torch.from_numpy(bk),
                          impl=impl)
    want = r_hash_join(jnp.asarray(pk), jnp.asarray(bk), impl=r_impl)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert isinstance(got[0], torch.Tensor) == (impl != "host")
    assert HOST_SYNCS.by_site == R_SYNCS.by_site
    assert HOST_SYNCS.host_fallbacks == R_SYNCS.host_fallbacks
    return got


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_hash_join_matches_reference(name, impl, r_impl):
    pk, bk = CASES[name]
    _held(pk, bk, impl, r_impl)


@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_all_collision_chain(impl, r_impl):
    keys = _colliding_keys(12, t_ref.MIN_BITS)
    rng = np.random.default_rng(3)
    bk = rng.choice(keys[:8], size=64).astype(np.int32)
    pk = np.concatenate([keys, keys[:4]]).astype(np.int32)
    assert t_ref.table_bits(len(bk)) == t_ref.MIN_BITS
    _held(pk, bk, impl, r_impl)


@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_duplicate_heavy_random(impl, r_impl):
    rng = np.random.default_rng(11)
    bk = rng.integers(0, 37, size=1500).astype(np.int32)
    pk = rng.integers(0, 60, size=700).astype(np.int32)
    _held(pk, bk, impl, r_impl)


@pytest.mark.parametrize("impl", ("ref", "kernel"))
def test_one_probe_tick_and_counted_loop_fetches(impl):
    rng = np.random.default_rng(12)
    bk = rng.integers(-2**31, 2**31, 3000).astype(np.int32)
    pk = np.concatenate([bk[:500], rng.integers(0, 9, 500)]).astype(
        np.int32)
    HOST_SYNCS.reset()
    t_ref.reset_loop_fetches()
    hash_join_match(torch.from_numpy(pk), torch.from_numpy(bk), impl=impl)
    assert HOST_SYNCS.by_site == {"hash_join_probe": 1}
    assert HOST_SYNCS.syncs == 1
    assert t_ref.LOOP_FETCHES["build"] >= 1
    assert t_ref.LOOP_FETCHES["probe"] >= 1


def test_new_wrappers_raise_below_hopper(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    cuda = torch.device("cuda", 0)
    keys = np.arange(4, dtype=np.int32)
    for call in (
            lambda: hash_join_match(keys, keys, device=cuda),
            lambda: segment_count(keys, 4, device=cuda),
            lambda: segment_reduce_host(keys, keys, 4, "max", device=cuda)):
        with pytest.raises(RuntimeError, match="capability"):
            call()
    # an explicit plain token is the caller's choice and still serves
    out = hash_join_match(keys, keys, impl="host", device=cuda)
    np.testing.assert_array_equal(out[0], np.arange(4))


# ------------------------------------------------------ executor dispatch

def _facts_dims(rows=400, groups=13, str_keys=False):
    rng = np.random.default_rng(0)
    gs = rng.integers(0, groups, size=rows)
    key = (lambda g: f"k{g:03d}") if str_keys else int
    facts = [{"fact_id": i, "g": key(gs[i])} for i in range(rows)]
    dims = [{"g": key(gi), "w": gi * 10} for gi in range(groups)]
    return facts, dims


def _dbs(**kw):
    facts, dims = _facts_dims(**kw)
    p, r = Database(device="cpu"), RDatabase()
    for db in (p, r):
        db.add_table("facts", facts)
        db.add_table("dims", dims)
    return p, r


def _plan(q, phys):
    plan = (q.scan("facts").join(q.scan("dims"), "facts.g", "dims.g")
            .build())
    for node in plan.walk():
        if type(node).__name__ == "Join":
            node.physical = phys
    return plan


@pytest.mark.parametrize("impl", ("ref", "kernel", "host", "auto"))
@pytest.mark.parametrize("phys", ("hash", "sort_merge", "host"))
def test_annotated_physical_is_honoured(phys, impl):
    pdb, rdb = _dbs()
    ex = Executor(pdb, SemanticRunner(OracleBackend(truths={})),
                  kernel_impl=impl)
    t, st = ex.execute(_plan(Q, phys))
    r_impl = "ref" if impl == "kernel" else impl
    rt, rst = RExecutor(rdb, RRunner(ROracle(truths={})),
                        kernel_impl=r_impl).execute(_plan(RQ, phys))
    cols = ["facts.fact_id", "dims.w"]
    assert pdb.materialize(t, cols) == rdb.materialize(rt, cols)
    assert st.join_physical == rst.join_physical == {phys: 1}
    assert st.pipeline_syncs == rst.pipeline_syncs


def test_auto_physical_resolves_to_hash_at_run_time():
    pdb, rdb = _dbs()
    t, st = Executor(pdb, SemanticRunner(OracleBackend(truths={})),
                     kernel_impl="ref").execute(_plan(Q, None))
    rt, rst = RExecutor(rdb, RRunner(ROracle(truths={})),
                        kernel_impl="ref").execute(_plan(RQ, None))
    assert st.join_physical == rst.join_physical == {"hash": 1}
    cols = ["facts.fact_id", "dims.w"]
    assert pdb.materialize(t, cols) == rdb.materialize(rt, cols)


def test_string_keys_force_host_physical():
    lt = Table(columns={"l.k": np.asarray(["a", "b", "a", "c"]),
                        "l.x": torch.arange(4, dtype=torch.int32)},
               valid=torch.ones(4, dtype=torch.bool))
    rt = Table(columns={"r.k": np.asarray(["a", "c", "a"]),
                        "r.y": torch.arange(3, dtype=torch.int32)},
               valid=torch.ones(3, dtype=torch.bool))
    ex = Executor(Database(device="cpu"),
                  SemanticRunner(OracleBackend(truths={})),
                  kernel_impl="kernel")
    stats = ExecStats()
    out = ex._equi_join(lt, rt, "l.k", "r.k", physical="hash", stats=stats)
    assert stats.join_physical == {"host": 1}
    assert np.asarray(out.col("l.k")).tolist() == ["a", "a", "a", "a", "c"]
    assert _np(out.col("r.y")).tolist() == [0, 2, 0, 2, 1]


def test_default_plans_pick_hash_for_the_base_table_join():
    pdb, _ = _dbs()
    from repro_torch.core import CostParams, optimize

    plan = optimize(_plan(Q, None), pdb.catalog(), strategy="cost",
                    params=CostParams()).plan
    assert [n.physical for n in plan.walk() if isinstance(n, Join)] \
        == ["hash"]
