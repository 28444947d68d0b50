"""The port's group build, code assignment, dedup, segment expansion and
join match lists against the reference package and its numpy oracles,
bit for bit, at every impl the CPU runs (the CUDA kernels' wrappers take
their plain versions here)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.expand.ops import expand_segments as r_expand  # noqa
from repro.kernels.hash_dedup import ops as r_ops  # noqa: E402
from repro.kernels.hash_dedup.ref import (  # noqa: E402
    column_codes_np as r_codes_np,
    group_build_np as r_group_build_np,
)
from repro.kernels.hash_join.ops import (  # noqa: E402
    sorted_probe_match as r_sorted_probe,
)
from repro.kernels.segmented_reduce.ops import (  # noqa: E402
    join_match_lists as r_join,
    segment_plan_from_group_build as r_plan,
    segmented_aggregate as r_agg,
)
from repro_torch.kernels.expand.ops import expand_segments  # noqa: E402
from repro_torch.kernels.hash_dedup import ops as p_ops  # noqa: E402
from repro_torch.kernels.hash_dedup.ref import (  # noqa: E402
    column_codes_np,
    group_build_np,
)
from repro_torch.kernels.hash_join.ops import (  # noqa: E402
    hash_join_match,
    sorted_probe_match,
)
from repro_torch.kernels.segmented_reduce.ops import (  # noqa: E402
    join_match_lists,
    segment_count,
    segment_plan_from_group_build,
    segment_reduce,
    segment_reduce_host,
    segmented_aggregate,
)
from repro_torch.kernels.sync import HOST_SYNCS  # noqa: E402

# port impl -> the reference impl it must match
IMPLS = (("host", "host"), ("ref", "ref"), ("kernel", "ref"))
COLLIDING = np.asarray([[649328485, -737540650],
                        [-363843642, 1512784759]], dtype=np.int32)
FIELDS = ("group_ids", "reps", "counts", "starts", "order", "sort_keys")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_build(r, p):
    assert r.num_groups == p.num_groups
    for f in FIELDS:
        a, b = np.asarray(getattr(r, f)), np.asarray(getattr(p, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("impl,r_impl", IMPLS)
@pytest.mark.parametrize("n,c", [(1, 1), (7, 1), (100, 2), (1024, 1),
                                 (1025, 3), (3000, 4), (2**16 + 3, 2)])
def test_group_build_matches_reference(n, c, impl, r_impl):
    rng = np.random.default_rng(n + c)
    keys = rng.integers(-50, 50, size=(n, c)).astype(np.int32)
    p = p_ops.group_build(keys, impl=impl, device="cpu")
    _same_build(r_ops.group_build(keys, impl=r_impl), p)
    g, inv, reps, counts, starts, order, sk = group_build_np(keys)
    assert p.num_groups == g
    np.testing.assert_array_equal(p.group_ids, inv)
    np.testing.assert_array_equal(p.sort_keys, sk)
    np.testing.assert_array_equal(
        r_group_build_np(keys)[1], inv)


@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_group_build_extremes_and_empty(impl, r_impl):
    keys = np.asarray([[2**31 - 1], [-2**31], [0], [2**31 - 1], [-1]],
                      dtype=np.int32)
    _same_build(r_ops.group_build(keys, impl=r_impl),
                p_ops.group_build(keys, impl=impl))
    gb = p_ops.group_build(np.zeros((0, 3), np.int32), impl=impl)
    assert gb.num_groups == 0 and gb.sort_keys.dtype == np.uint32


@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_hash_collision_regroups_exactly(impl, r_impl):
    keys = np.concatenate([COLLIDING, COLLIDING[::-1], COLLIDING])
    HOST_SYNCS.reset()
    p = p_ops.group_build(keys, impl=impl)
    _same_build(r_ops.group_build(keys, impl=r_impl), p)
    assert p.num_groups == 2
    if impl != "host":
        assert HOST_SYNCS.host_fallbacks == {"group_build_collision": 1}
        assert HOST_SYNCS.by_site == {"group_build": 1}


def _columns(n, rng):
    f = rng.choice([0.5, -0.0, 0.0, np.nan, -2.5, np.inf], n).astype(
        np.float32)
    i = rng.choice([2**31 - 1, -2**31, 0, 7, -7], n).astype(np.int32)
    b = rng.random(n) < 0.5
    u = rng.integers(0, 300, n).astype(np.uint16)
    s = rng.integers(-3, 3, n).astype(np.int32)
    return [f, i, b, u, s]


@pytest.mark.parametrize("impl,r_impl", IMPLS)
@pytest.mark.parametrize("c", (1, 2, 3, 4))
def test_group_build_columns_matches_reference(c, impl, r_impl):
    rng = np.random.default_rng(10 + c)
    n = 500
    cols = _columns(n, rng)[:c] if c < 4 else _columns(n, rng)[1:5]
    cols_p = [torch.from_numpy(np.ascontiguousarray(k)) for k in cols]
    cols_r = [jnp.asarray(k) for k in cols]
    codes_r, gb_r = r_ops.group_build_columns(cols_r, impl=r_impl)
    codes_p, gb_p = p_ops.group_build_columns(cols_p, impl=impl)
    np.testing.assert_array_equal(codes_r, codes_p)
    np.testing.assert_array_equal(codes_p, column_codes_np(cols))
    np.testing.assert_array_equal(codes_p, r_codes_np(cols))
    _same_build(gb_r, gb_p)


def test_nan_keys_distinct_and_signed_zero_collapses():
    f = np.asarray([np.nan, -0.0, 0.0, np.nan, 1.0], dtype=np.float32)
    codes, gb = p_ops.group_build_columns([torch.from_numpy(f)],
                                          impl="ref")
    np.testing.assert_array_equal(codes[:, 0], [2, 0, 0, 3, 1])
    assert gb.num_groups == 4


@pytest.mark.parametrize("impl", ("ref", "kernel"))
def test_group_build_columns_one_fetch(impl):
    cols = [torch.arange(100, dtype=torch.int32) % 7,
            torch.arange(100, dtype=torch.float32) % 3]
    HOST_SYNCS.reset()
    p_ops.group_build_columns(cols, impl=impl)
    assert HOST_SYNCS.syncs == 1
    assert HOST_SYNCS.by_site == {"group_build_columns": 1}
    assert HOST_SYNCS.host_fallbacks == {}


def test_group_build_columns_wide_columns_take_host_oracle():
    cols = [np.array(["b", "a", "b"]), torch.tensor([1, 1, 2],
                                                     dtype=torch.int32)]
    HOST_SYNCS.reset()
    codes, gb = p_ops.group_build_columns(cols, impl="ref")
    np.testing.assert_array_equal(codes, [[1, 0], [0, 0], [1, 1]])
    assert HOST_SYNCS.host_fallbacks == {"group_key_codes": 1}


@pytest.mark.parametrize("impl,r_impl", IMPLS)
@pytest.mark.parametrize("c", (1, 2, 3))
def test_dedup_representatives_matches_reference(c, impl, r_impl):
    rng = np.random.default_rng(c)
    keys = rng.integers(0, 9, (700, c)).astype(np.int32)
    r = r_ops.dedup_representatives(keys, impl=r_impl, return_hashes=True)
    p = p_ops.dedup_representatives(keys, impl=impl, return_hashes=True)
    for a, b in zip(r, p):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_expand_segments_matches_reference(impl, r_impl):
    rng = np.random.default_rng(5)
    for n in (1, 10, 1025, 5000):
        counts = rng.integers(0, 4, n)
        counts[-2:] = 0
        offs = rng.integers(0, 100, n)
        for o in (None, offs):
            r = r_expand(counts, o, impl=r_impl)
            p = expand_segments(counts, o, impl=impl)
            for a, b in zip(r, p):
                assert b.dtype == np.int64
                np.testing.assert_array_equal(a, b)
            if impl != "host" and counts.sum():
                seg, pos = expand_segments(counts, o, impl=impl,
                                           as_device=True)
                assert seg.dtype == torch.int32
                np.testing.assert_array_equal(seg.numpy(), r[0])
                np.testing.assert_array_equal(pos.numpy(), r[1])


def _join_cases(rng):
    big = 2**31 - 1
    yield (rng.integers(-5, 40, 300).astype(np.int32),
           rng.integers(0, 30, 200).astype(np.int32))
    yield (np.asarray([big, 0, big, 5], np.int32),
           np.asarray([big, big, 5, -big], np.int32))
    yield (np.asarray([1, 2], np.int32), np.asarray([3, 4], np.int32))
    yield (rng.random(50).astype(np.float32).round(1),
           rng.random(40).astype(np.float32).round(1))
    yield (np.asarray(["a", "b", "c", "a"]), np.asarray(["a", "a", "c"]))


@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_join_match_lists_match_reference(impl, r_impl):
    rng = np.random.default_rng(11)
    for pk, bk in _join_cases(rng):
        if pk.dtype.kind == "U" or (pk.dtype.kind == "f"
                                    and impl != "host"):
            # host code space: segment_count off "host" is the K5 kernel
            continue
        as_p = [torch.from_numpy(a) if a.dtype.kind != "U" else a
                for a in (pk, bk)]
        as_r = [jnp.asarray(a) if a.dtype.kind != "U" else a
                for a in (pk, bk)]
        HOST_SYNCS.reset()
        pl, pr = join_match_lists(*as_p, impl=impl)
        p_syncs = dict(HOST_SYNCS.by_site)
        rl, rr = r_join(*as_r, impl=r_impl)
        np.testing.assert_array_equal(_np(rl), _np(pl))
        np.testing.assert_array_equal(_np(rr), _np(pr))
        assert isinstance(pl, torch.Tensor) == (impl != "host")
        if impl != "host" and pk.dtype.kind == "i":
            assert p_syncs == {"join_build_keys": 1, "group_build": 1,
                               "join_probe": 1}


def test_string_and_float_join_keys_on_host():
    rng = np.random.default_rng(12)
    for pk, bk in list(_join_cases(rng))[3:]:
        pl, pr = join_match_lists(pk, bk, impl="host")
        rl, rr = r_join(pk, bk, impl="host")
        np.testing.assert_array_equal(rl, pl)
        np.testing.assert_array_equal(rr, pr)


@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_sorted_probe_match_matches_reference(impl, r_impl):
    rng = np.random.default_rng(13)
    big = 2**31 - 1
    for bk in (np.sort(rng.integers(0, 40, 300)).astype(np.int32),
               np.asarray([-3, 0, 0, big, big], np.int32)):
        pk = np.concatenate([rng.integers(-2, 42, 100),
                             [big, -3]]).astype(np.int32)
        rl, rr = r_sorted_probe(jnp.asarray(pk), jnp.asarray(bk),
                                impl=r_impl)
        pl, pr = sorted_probe_match(torch.from_numpy(pk),
                                    torch.from_numpy(bk), impl=impl)
        np.testing.assert_array_equal(_np(rl), _np(pl))
        np.testing.assert_array_equal(_np(rr), _np(pr))


@pytest.mark.parametrize("impl,r_impl", IMPLS)
def test_segmented_aggregate_over_group_build(impl, r_impl):
    rng = np.random.default_rng(14)
    keys = rng.integers(0, 20, (400, 1)).astype(np.int32)
    vals_i = rng.integers(-10**6, 10**6, 400).astype(np.int32)
    vals_f = rng.random(400).astype(np.float32)
    plan_p = segment_plan_from_group_build(p_ops.group_build(keys,
                                                             impl=impl))
    plan_r = r_plan(r_ops.group_build(keys, impl=r_impl))
    for func in ("count", "sum", "avg"):
        for v in (vals_i, vals_f):
            a = r_agg(plan_r, jnp.asarray(v), func, impl=r_impl)
            b = segmented_aggregate(plan_p, torch.from_numpy(v), func,
                                    impl=impl)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # host-dtype min/max reduce on the host on every impl
    v64 = rng.integers(0, 10, 400)
    for func in ("min", "max"):
        np.testing.assert_array_equal(
            r_agg(plan_r, v64, func, impl=r_impl),
            segmented_aggregate(plan_p, v64, func, impl=impl))


def test_slice_two_operators_raise(monkeypatch):
    """The slice-two operators serve the CPU (host oracles at "auto",
    plain versions at "ref"/"kernel") and raise for data on a card
    below compute capability 9.0 instead of falling back."""
    keys = np.zeros((4, 1), np.int32)
    plan = segment_plan_from_group_build(p_ops.group_build(keys))
    np.testing.assert_array_equal(
        segment_count(np.asarray([0, 2, 2]), 3, impl="host"), [1, 0, 2])
    np.testing.assert_array_equal(
        segment_count(np.asarray([0, 2, 2]), 3, impl="ref"), [1, 0, 2])
    for impl in ("auto", "ref", "kernel", "host"):
        np.testing.assert_array_equal(
            segmented_aggregate(plan, torch.arange(4.0), "max", impl=impl),
            [3.0])
        out = hash_join_match(np.asarray([1, 2], np.int32),
                              np.asarray([2, 2, 1], np.int32), impl=impl)
        np.testing.assert_array_equal(_np(out[0]), [0, 1, 1])
        np.testing.assert_array_equal(_np(out[1]), [2, 0, 1])
    np.testing.assert_array_equal(
        segment_reduce(torch.arange(3), torch.zeros(3, dtype=torch.int32),
                       num_segments=1), [3])
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    cuda = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="capability"):
        hash_join_match(np.zeros(3, np.int32), np.zeros(3, np.int32),
                        device=cuda)
    with pytest.raises(RuntimeError, match="capability"):
        segment_count(np.zeros(3, np.int64), 1, device=cuda)
    with pytest.raises(RuntimeError, match="capability"):
        segment_reduce_host(np.zeros(3, np.float32), np.zeros(3, np.int32),
                            1, "min", device=cuda)
