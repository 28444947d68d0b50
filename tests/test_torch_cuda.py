"""The port's CUDA kernels and the ops built on them, on the card: each
kernel bit-identical to its plain PyTorch version, each host-facing op
at ``impl="kernel"`` identical to its ``impl="host"`` numpy oracle, and
every launch counted (K1-K6). Imports neither JAX nor the reference, so
it runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA card of compute capability >= 9.0 and skips
itself elsewhere (``chip_smoke.py`` runs the same kernel checks). The
helpers ``marks_from_counts`` and ``k3_cases`` also feed the CPU tests
of ``tests/test_torch_kernels.py``; ``k5_cases``, ``k6_digit_cases``,
``minmax_bits`` and ``sum_within_bound`` feed
``tests/test_torch_segmented_reduce.py`` and
``tests/test_torch_hash_join.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.compact import compact as t_compact  # noqa: E402
from repro_torch.kernels.compact.ops import compact_index  # noqa: E402
from repro_torch.kernels.compact.ref import prefix_count_torch  # noqa: E402
from repro_torch.kernels.expand import expand as t_expand  # noqa: E402
from repro_torch.kernels.expand.ops import expand_segments  # noqa: E402
from repro_torch.kernels.expand.ref import (  # noqa: E402
    running_segment_ids_torch,
)
from repro_torch.kernels.hash_dedup import group_build as t_gb  # noqa: E402
from repro_torch.kernels.hash_dedup import hash_dedup as t_hash  # noqa: E402
from repro_torch.kernels.hash_dedup import ops  # noqa: E402
from repro_torch.kernels.hash_dedup.ref import (  # noqa: E402
    group_boundaries_ref,
    hash_rows_np,
    hash_rows_ref,
)
from repro_torch.kernels.hash_join import hash_join as t_hj  # noqa: E402
from repro_torch.kernels.hash_join.ops import hash_join_match  # noqa: E402
from repro_torch.kernels.segmented_reduce import (  # noqa: E402
    segmented_reduce as t_sr,
)
from repro_torch.kernels.segmented_reduce.ops import (  # noqa: E402
    join_match_lists,
    make_segment_plan,
    segment_count,
    segmented_aggregate,
)
from repro_torch.kernels.segmented_reduce.ref import (  # noqa: E402
    segment_reduce_torch,
)

INT32_MAX = 2**31 - 1
SIZES = (1, 1023, 1024, 1025, 4097, 65537, 2**16 + 3)


def marks_from_counts(counts: np.ndarray) -> np.ndarray:
    """K4 input: +1 at each segment's start; empty segments stack on the
    next start, trailing ones fall off the end."""
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts
    marks = np.zeros(total + 1, dtype=np.int32)
    np.add.at(marks, starts, 1)
    return marks[:total]


def k3_cases(n, rng):
    """Sorted int32 K3 inputs: a run of INT32_MAX keys (the reference's
    pad value, here ordinary rows), a wide sorted run, INT32_MIN ties
    and all-equal keys."""
    top = np.sort(rng.integers(INT32_MAX - 8, INT32_MAX, n)).astype(
        np.int32)
    top[n - n // 3:] = INT32_MAX
    wide = np.sort(rng.integers(-2**31, 2**31, n)).astype(np.int32)
    low = np.sort(rng.integers(-2**31, -2**31 + 3, n)).astype(np.int32)
    return [top, wide, low, np.full(n, 7, np.int32)]


def k5_cases(n, g, dtype, rng, finite=False):
    """K5 inputs as (values, segment_ids) numpy pairs: ids spread over
    [0, g) with every third segment left empty, a single hot segment
    taking ~90% of the rows, and ids sorted into runs. float32 values
    carry NaN, ±inf, -0.0 and +0.0 unless ``finite``; int32 values span
    the whole range (sums wrap)."""
    if dtype == np.int32:
        vals = rng.integers(-2**31, 2**31, n).astype(np.int32)
    else:
        vals = (rng.standard_normal(n) * 100).astype(np.float32)
        if not finite:
            special = np.asarray([np.nan, np.inf, -np.inf, -0.0, 0.0],
                                 np.float32)
            pick = rng.random(n) < 0.05
            vals[pick] = rng.choice(special, int(pick.sum()))
    spread = rng.integers(0, g, n).astype(np.int32)
    if g > 2:
        spread[spread % 3 == 1] -= 1
    hot = np.where(rng.random(n) < 0.9, g // 2,
                   rng.integers(0, g, n)).astype(np.int32)
    return [(vals, spread), (vals, hot), (vals, np.sort(spread))]


def k6_digit_cases(n, rng, buckets=256):
    """K6 digit columns: all equal, uniform over the buckets, and
    skewed (half the rows in one bucket, the rest in a few)."""
    skew = np.where(rng.random(n) < 0.5, 3,
                    rng.integers(0, min(buckets, 5), n))
    return [np.full(n, buckets - 1, np.int32),
            rng.integers(0, buckets, n).astype(np.int32),
            skew.astype(np.int32)]


def exclusive_bases(digits, buckets=256):
    hist = np.bincount(digits, minlength=buckets)
    return (np.cumsum(hist) - hist).astype(np.int32)


def minmax_bits(a) -> np.ndarray:
    """float32 min/max results as int32 codes for exact comparison:
    every NaN maps to one code and -0.0 to +0.0; int32 passes through."""
    a = _np(a)
    if a.dtype != np.float32:
        return a
    bits = (a + np.float32(0.0)).view(np.int32).copy()
    bits[np.isnan(a)] = 0x7fc00000
    return bits


def sum_within_bound(got, values, segment_ids, g) -> None:
    """float32 segment sums against the float64 sums, within the
    float32 accumulation bound count * 2^-23 * sum|v| per segment."""
    v = np.asarray(values, np.float64)
    seg = np.asarray(segment_ids)
    exact = np.bincount(seg, weights=v, minlength=g)
    mag = np.bincount(seg, weights=np.abs(v), minlength=g)
    cnt = np.bincount(seg, minlength=g)
    err = np.abs(_np(got).astype(np.float64) - exact)
    assert (err <= cnt * 2.0**-23 * mag).all(), float(err.max())


@pytest.fixture
def dev():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    return torch.device("cuda", 0)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_kernels_match_plain_versions(dev, n):
    rng = np.random.default_rng(3000 + n)

    def on(a):
        return torch.from_numpy(a).to(dev)

    _build.reset_launches()
    flags = on(rng.integers(0, 3, n).astype(np.int32))
    assert torch.equal(t_compact.prefix_count_kernel(flags),
                       prefix_count_torch(flags))
    marks = on(marks_from_counts(rng.integers(0, 4, max(n // 2, 1))))
    assert torch.equal(t_expand.running_segment_ids_kernel(marks),
                       running_segment_ids_torch(marks))
    for c in (1, 2, 4):
        keys = rng.integers(-2**31, 2**31, (n, c)).astype(np.int32)
        got = t_hash.hash_rows_kernel(on(keys))
        assert torch.equal(got, hash_rows_ref(on(keys)))
        np.testing.assert_array_equal(_np(got).view(np.uint32),
                                      hash_rows_np(keys))
    for keys in k3_cases(n, rng):
        got = t_gb.group_boundaries_kernel(on(keys))
        want = group_boundaries_ref(on(keys))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize(dev)
    assert _build.LAUNCHES == {"prefix_count": 1, "hash_rows": 3,
                               "group_boundaries": 4,
                               "running_segment_ids": int(marks.numel() > 0),
                               "segment_reduce": 0, "radix_rank": 0}


@pytest.mark.cuda
def test_wrappers_reject_wrong_operands(dev):
    with pytest.raises(TypeError):
        t_compact.prefix_count_kernel(torch.zeros(8, dtype=torch.int64,
                                                  device=dev))
    with pytest.raises(ValueError):
        t_hash.hash_rows_kernel(torch.zeros((8, 2), dtype=torch.int32,
                                            device=dev).t())
    with pytest.raises(ValueError):
        t_gb.group_boundaries_kernel(
            torch.zeros((8, 2), dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("c", (1, 2, 3))
def test_group_build_on_card_matches_host(dev, c):
    rng = np.random.default_rng(c)
    keys = rng.integers(-50, 50, (70000, c)).astype(np.int32)
    got = ops.group_build(keys, impl="kernel", device=dev)
    want = ops.group_build(keys, impl="host")
    assert got.num_groups == want.num_groups
    for f in ("group_ids", "reps", "counts", "starts", "order",
              "sort_keys"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    auto = ops.dedup_representatives(keys, impl="auto", device=dev)
    for a, b in zip(auto, ops.dedup_representatives(keys, impl="host")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_group_build_columns_on_card_matches_host(dev):
    rng = np.random.default_rng(9)
    n = 50000
    f = rng.choice([np.nan, -0.0, 0.0, 1.5, -2.0], n).astype(np.float32)
    i = rng.choice([INT32_MAX, -2**31, 0, 3], n).astype(np.int32)
    b = rng.random(n) < 0.5
    cols = [torch.from_numpy(x).to(dev) for x in (f, i, b)]
    codes, gb = ops.group_build_columns(cols, impl="kernel")
    codes_h, gb_h = ops.group_build_columns([f, i, b], impl="host")
    np.testing.assert_array_equal(codes, codes_h)
    np.testing.assert_array_equal(gb.group_ids, gb_h.group_ids)
    np.testing.assert_array_equal(gb.reps, gb_h.reps)


@pytest.mark.cuda
def test_compaction_expansion_and_join_on_card(dev):
    rng = np.random.default_rng(10)
    valid = rng.random(100000) < 0.4
    idx, cnt = compact_index(torch.from_numpy(valid).to(dev), impl="auto")
    np.testing.assert_array_equal(_np(idx), np.nonzero(valid)[0])
    counts = rng.integers(0, 4, 30000)
    offs = rng.integers(0, 9, 30000)
    for a, b in zip(expand_segments(counts, offs, impl="kernel", device=dev),
                    expand_segments(counts, offs, impl="host")):
        np.testing.assert_array_equal(a, b)
    pk = rng.integers(-5, 4000, 60000).astype(np.int32)
    bk = rng.integers(0, 3000, 9000).astype(np.int32)
    bk[:3] = INT32_MAX
    pk[:3] = INT32_MAX
    got = join_match_lists(torch.from_numpy(pk).to(dev),
                           torch.from_numpy(bk).to(dev), impl="auto")
    want = join_match_lists(pk, bk, impl="host")
    assert isinstance(got[0], torch.Tensor) and got[0].is_cuda
    np.testing.assert_array_equal(_np(got[0]), want[0])
    np.testing.assert_array_equal(_np(got[1]), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("g", (1, 16, 4097, 20000))
@pytest.mark.parametrize("dtype", (np.int32, np.float32))
def test_segment_reduce_kernel_matches_plain_version(dev, dtype, g):
    rng = np.random.default_rng(g)
    _build.reset_launches()
    calls = 0
    for n in (1, 1023, 1025, 65537):
        for op in ("sum", "min", "max"):
            finite = op == "sum"
            for v, s in k5_cases(n, g, dtype, rng, finite=finite):
                vt, st = torch.from_numpy(v).to(dev), \
                    torch.from_numpy(s).to(dev)
                got = t_sr.segment_reduce_kernel(vt, st, g, op)
                want = segment_reduce_torch(vt, st, g, op)
                calls += 1
                assert got.dtype == want.dtype and got.shape == (g,)
                if op == "sum" and dtype == np.float32:
                    sum_within_bound(got, v, s, g)
                else:
                    np.testing.assert_array_equal(minmax_bits(got),
                                                  minmax_bits(want))
    torch.cuda.synchronize(dev)
    assert _build.LAUNCHES["segment_reduce"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_radix_rank_kernel_matches_plain_version(dev, n):
    rng = np.random.default_rng(4000 + n)
    _build.reset_launches()
    calls = 0
    for buckets in (256, 7):
        for d in k6_digit_cases(n, rng, buckets):
            dt = torch.from_numpy(d).to(dev)
            bt = torch.from_numpy(exclusive_bases(d, buckets)).to(dev)
            got = t_hj.radix_rank_kernel(dt, bt)
            calls += 1
            assert torch.equal(got, t_hj.radix_rank_torch(dt, bt))
    torch.cuda.synchronize(dev)
    assert _build.LAUNCHES["radix_rank"] == calls


@pytest.mark.cuda
def test_new_wrappers_reject_wrong_operands(dev):
    with pytest.raises(TypeError):
        t_sr.segment_reduce_kernel(torch.zeros(8, dtype=torch.int64,
                                               device=dev),
                                   torch.zeros(8, dtype=torch.int32,
                                               device=dev), 2)
    with pytest.raises(ValueError):
        t_sr.segment_reduce_kernel(torch.zeros(8, device=dev),
                                   torch.zeros(7, dtype=torch.int32,
                                               device=dev), 2)
    with pytest.raises(ValueError):
        t_hj.radix_rank_kernel(torch.zeros(8, dtype=torch.int32, device=dev),
                               torch.zeros(2000, dtype=torch.int32,
                                           device=dev))


@pytest.mark.cuda
def test_hash_join_and_min_max_on_card_match_host(dev):
    rng = np.random.default_rng(12)
    pk = rng.integers(-5, 40000, 200000).astype(np.int32)
    bk = rng.integers(0, 30000, 50000).astype(np.int32)
    bk[:3] = INT32_MAX
    pk[:3] = INT32_MAX
    _build.reset_launches()
    got = hash_join_match(torch.from_numpy(pk).to(dev),
                          torch.from_numpy(bk).to(dev), impl="auto")
    assert isinstance(got[0], torch.Tensor) and got[0].is_cuda
    assert _build.LAUNCHES["radix_rank"] == 3  # hbits 17: three passes
    for a, b in zip(got, hash_join_match(pk, bk, impl="host")):
        np.testing.assert_array_equal(_np(a), b)
    seg = rng.integers(0, 120, 300000)
    plan = make_segment_plan(seg, 120)
    for v in (rng.integers(-2**31, 2**31, 300000).astype(np.int32),
              k5_cases(300000, 120, np.float32, rng)[0][0]):
        for func in ("min", "max"):
            np.testing.assert_array_equal(
                minmax_bits(segmented_aggregate(
                    plan, torch.from_numpy(v).to(dev), func, impl="auto")),
                minmax_bits(segmented_aggregate(plan, v, func,
                                                impl="host")))
    np.testing.assert_array_equal(
        segment_count(seg, 120, impl="kernel", device=dev),
        segment_count(seg, 120, impl="host"))
    fk = rng.choice(np.asarray([np.nan, 1.5, -2.0, 0.0], np.float32), 5000)
    got = join_match_lists(torch.from_numpy(fk).to(dev),
                           torch.from_numpy(fk[:900]).to(dev), impl="auto")
    for a, b in zip(got, join_match_lists(fk, fk[:900], impl="host")):
        np.testing.assert_array_equal(_np(a), b)
    # three radix histograms, four aggregates, two histograms of counts
    assert _build.LAUNCHES["segment_reduce"] == 9
