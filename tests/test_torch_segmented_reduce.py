"""K5 and the segmented-reduction ops of the port against the reference:
the plain version of the segmented-reduction kernel against the Pallas
kernel in interpret mode (``segment_reduce_host(..., impl="interpret")``)
and the numpy oracle, ``segmented_aggregate`` min/max and
``segment_count`` on every impl, and the string/float-key
``join_match_lists`` that slice 1 could not serve off ``host``.

Tolerances: 0 for integer outputs and min/max (every NaN equal to every
NaN, -0.0 equal to +0.0); float32 sums within ``count * 2^-23 * sum|v|``
of the float64 sum, the worst-case float32 accumulation bound."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.hash_dedup import ops as r_ops  # noqa: E402
from repro.kernels.segmented_reduce.ops import (  # noqa: E402
    join_match_lists as r_join,
    segment_count as r_count,
    segment_plan_from_group_build as r_plan,
    segment_reduce_host as r_reduce_host,
    segmented_aggregate as r_agg,
)
from repro.kernels.segmented_reduce.ref import (  # noqa: E402
    segment_reduce_np as r_reduce_np,
)
from repro.kernels.sync import HOST_SYNCS as R_SYNCS  # noqa: E402
from repro_torch.kernels.hash_dedup import ops as p_ops  # noqa: E402
from repro_torch.kernels.segmented_reduce import (  # noqa: E402
    segmented_reduce as t_sr,
)
from repro_torch.kernels.segmented_reduce.ops import (  # noqa: E402
    join_match_lists,
    segment_count,
    segment_plan_from_group_build,
    segment_reduce,
    segment_reduce_host,
    segmented_aggregate,
)
from repro_torch.kernels.segmented_reduce.ref import (  # noqa: E402
    reduce_identity,
    segment_reduce_np,
    segment_reduce_torch,
)
from repro_torch.kernels.sync import HOST_SYNCS  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    k5_cases,
    minmax_bits,
    sum_within_bound,
)

OPS = ("sum", "min", "max")
DTYPES = (np.int32, np.float32)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _held(got, want, op, dtype, values, seg, g):
    got = _np(got)
    assert got.dtype == np.dtype(dtype) and got.shape == (g,)
    if op == "sum" and dtype == np.float32:
        sum_within_bound(got, values, seg, g)
    else:
        np.testing.assert_array_equal(minmax_bits(got), minmax_bits(want))


@pytest.mark.parametrize("n,g", [(1, 1), (300, 7), (2500, 600)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_plain_version_matches_pallas_interpret(op, dtype, n, g):
    """The kernel's plain version (the CUDA wrapper on a CPU tensor)
    against the Pallas kernel run in interpret mode and both numpy
    oracles, on every K5 case shape."""
    rng = np.random.default_rng(n * 31 + g)
    for v, s in k5_cases(n, g, dtype, rng, finite=op == "sum"):
        want = r_reduce_host(v, s, g, op, impl="interpret")
        np.testing.assert_array_equal(minmax_bits(r_reduce_np(v, s, g, op)),
                                      minmax_bits(segment_reduce_np(
                                          v, s, g, op)))
        plain = t_sr.segment_reduce_kernel(torch.from_numpy(v),
                                           torch.from_numpy(s), g, op)
        _held(plain, want, op, dtype, v, s, g)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_empty_segments_hold_the_identity(op, dtype):
    v = np.asarray([5, -3, 7], dtype)
    s = np.asarray([0, 0, 3], np.int32)
    got = _np(segment_reduce_torch(torch.from_numpy(v), torch.from_numpy(s),
                                   5, op))
    want = r_reduce_host(v, s, 5, op, impl="interpret")
    np.testing.assert_array_equal(got, want)
    ident = reduce_identity(op, np.dtype(dtype))
    assert got[1] == got[2] == got[4] == ident


def test_nan_propagates_through_min_and_max():
    v = np.asarray([1.0, np.nan, -np.inf, 2.0, np.inf, np.nan],
                   np.float32)
    s = np.asarray([0, 0, 1, 1, 2, 3], np.int32)
    for op in ("min", "max"):
        got = _np(segment_reduce(torch.from_numpy(v), torch.from_numpy(s),
                                 num_segments=4, op=op, impl="kernel"))
        want = r_reduce_host(v, s, 4, op, impl="interpret")
        np.testing.assert_array_equal(minmax_bits(got), minmax_bits(want))
        assert np.isnan(got[0]) and np.isnan(got[3])


def test_out_of_range_ids_are_dropped():
    v = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    s = torch.tensor([0, -1, 2, 1], dtype=torch.int32)
    for op in OPS:
        np.testing.assert_array_equal(
            _np(segment_reduce_torch(v, s, 2, op)),
            segment_reduce_np(np.asarray([1, 4]), np.asarray([0, 1]), 2, op))


@pytest.mark.parametrize("impl", ("auto", "ref", "kernel", "host"))
def test_segment_reduce_impls_agree(impl):
    rng = np.random.default_rng(5)
    for dtype in DTYPES:
        for v, s in k5_cases(900, 40, dtype, rng):
            for op in ("min", "max"):
                got = segment_reduce(torch.from_numpy(v), torch.from_numpy(s),
                                     num_segments=40, op=op, impl=impl)
                assert isinstance(got, torch.Tensor)
                np.testing.assert_array_equal(
                    minmax_bits(got),
                    minmax_bits(segment_reduce_np(v, s, 40, op)))


@pytest.mark.parametrize("impl,r_impl", [("ref", "ref"), ("kernel", "ref")])
def test_segment_reduce_host_matches_reference(impl, r_impl):
    """Host-facing wrapper: the same numpy result and ONE
    ``segment_reduce`` tick per call, as the reference."""
    rng = np.random.default_rng(6)
    v, s = k5_cases(3000, 300, np.float32, rng)[0]
    for op in ("min", "max"):
        HOST_SYNCS.reset()
        R_SYNCS.reset()
        got = segment_reduce_host(v, s, 300, op, impl=impl)
        want = r_reduce_host(v, s, 300, op, impl=r_impl)
        np.testing.assert_array_equal(minmax_bits(got), minmax_bits(want))
        assert HOST_SYNCS.by_site == R_SYNCS.by_site \
            == {"segment_reduce": 1}
    for n, g in ((0, 4), (5, 0)):
        got = segment_reduce_host(np.zeros(n, np.float32),
                                  np.zeros(n, np.int32), g, "max",
                                  impl=impl)
        np.testing.assert_array_equal(
            got, r_reduce_host(np.zeros(n, np.float32),
                               np.zeros(n, np.int32), g, "max",
                               impl=r_impl))


@pytest.mark.parametrize("impl,r_impl", [("host", "host"), ("ref", "ref"),
                                         ("kernel", "ref"),
                                         ("auto", "auto")])
def test_segment_count_matches_reference(impl, r_impl):
    rng = np.random.default_rng(7)
    seg = rng.integers(0, 50, 4000)
    seg[seg == 13] = 12  # an empty segment
    got = segment_count(seg, 55, impl=impl)
    want = r_count(seg, 55, impl=r_impl)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl,r_impl", [("host", "host"), ("ref", "ref"),
                                         ("kernel", "ref"),
                                         ("auto", "auto")])
def test_segmented_aggregate_min_max_matches_reference(impl, r_impl):
    """int32/float32 min/max over a group build: K5 on the port's
    device impls, against the reference's device path at ``ref``; the
    same values and dtypes, and the same sync ticks."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 37, (5000, 2)).astype(np.int32)
    plan_p = segment_plan_from_group_build(p_ops.group_build(keys,
                                                             impl=impl))
    plan_r = r_plan(r_ops.group_build(keys, impl=r_impl))
    vi = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    vf = k5_cases(5000, 3, np.float32, rng)[0][0]
    for v in (vi, vf):
        for func in ("min", "max"):
            HOST_SYNCS.reset()
            b = segmented_aggregate(plan_p, torch.from_numpy(v), func,
                                    impl=impl)
            R_SYNCS.reset()
            a = r_agg(plan_r, jnp.asarray(v), func, impl=r_impl)
            assert HOST_SYNCS.by_site == R_SYNCS.by_site
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(minmax_bits(b), minmax_bits(a))


def _repair_keys(rng):
    s = np.asarray(["k%03d" % i for i in rng.integers(0, 40, 300)],
                   dtype=object)
    f = rng.choice(np.asarray([np.nan, -0.0, 0.0, 1.5, -2.0, np.inf],
                              np.float32), 500)
    return [(s, s[:120].copy()), (f, f[:200].copy()),
            (np.asarray([1.0, np.nan, 2.0], np.float32),
             np.asarray([np.nan, 2.0, np.nan], np.float32))]


@pytest.mark.parametrize("impl", ("kernel", "ref"))
def test_string_and_float_key_join_repaired(impl):
    """The slice-1 fault: string- and float-key joins send their build
    histogram to ``segment_count``, which raised at ``kernel``. Now the
    port at ``kernel``/``ref`` equals the reference at ``ref`` (NaN
    matches NaN), with the same sync ticks."""
    rng = np.random.default_rng(9)
    for pk, bk in _repair_keys(rng):
        HOST_SYNCS.reset()
        got = join_match_lists(pk, bk, impl=impl, device="cpu")
        R_SYNCS.reset()
        want = r_join(pk, bk, impl="ref")
        assert HOST_SYNCS.by_site == R_SYNCS.by_site
        assert HOST_SYNCS.by_site.get("segment_reduce") == 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    got = join_match_lists(np.asarray([1.0, np.nan, 2.0], np.float32),
                           np.asarray([1.0, np.nan, 2.0], np.float32),
                           impl=impl, device="cpu")
    np.testing.assert_array_equal(_np(got[0]), [0, 1, 2])
    np.testing.assert_array_equal(_np(got[1]), [0, 1, 2])
