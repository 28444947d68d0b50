"""The port's CUDA kernels and the ops built on them, on the card: each
kernel bit-identical to its plain PyTorch version, each host-facing op
at ``impl="kernel"`` identical to its ``impl="host"`` numpy oracle, and
every launch counted (K1-K6), K1, K3 and K4 also over the look-back
sweep of ``scan_cases`` (sizes around the tile, repeated calls,
misaligned views, CUDA-graph replays, two streams; K3 over its sorted
key kinds), K5 over ``reduce_cases`` (sizes around its batch, segment
counts around its shared limit, every op and dtype, misaligned views,
graph replays, two streams), K6 over
``radix_cases`` (the same, for its per-bucket look-back, B in {1, 4, 7,
256, 1024}); K7/K8 within 1e-4
of their plain versions (K7 with a sliding window, K8 with the slot mask over a
wrapped ring too, and at its chunk edges: lengths around the chunk, a
4104-position cache, a full 2048-slot ring, rings with dead chunks
between live ones, CUDA-graph replays; its log-sum-exp route at the
slices of a cache split over the sequence, ``MESH_SEQ_DECODE_CASES``),
K9 within ``ssd_cases.tolerance`` of its plain
version over the ``ssd_cases`` sweep, the dense, SSM and hybrid
LMs' kernel paths equal to their plain paths (K7/K8/K9), K7/K8/K9
refusing grad mode, tiny train steps on the card equal to the CPU's,
K7/K8/K9 at the model mesh's shard shapes (``attention_cases.MESH_*``,
``ssd_cases.MESH_CASES``), the tiny SSM and hybrid served over a
mesh of the card on both paths, and tiny starcoder2 and deepseek served
over a mesh of the card under ``shard_cache_seq``,
K10 bit-identical
to its plain version over the ``partition_cases`` sweep (sizes around
its look-back tile, repeated calls, graph replays, two streams), and the
partitioned data tier on four shards of one card (and on two cards,
where there are two) equal to its plain path and to the single-device
executor. Imports neither JAX nor the reference, so it runs where only
PyTorch is installed:

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
from repro_torch.kernels import attention_cases as AC  # noqa: E402
from repro_torch.kernels import partition_cases as PC  # noqa: E402
from repro_torch.kernels import radix_cases as RADIX  # noqa: E402
from repro_torch.kernels import reduce_cases as RD  # noqa: E402
from repro_torch.kernels import scan_cases as SCAN  # noqa: E402
from repro_torch.kernels import ssd_cases as SC  # noqa: E402
from repro_torch.kernels.compact import compact as t_compact  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention as t_dec,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as t_fa,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
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
from repro_torch.kernels.partition import partition as t_part  # noqa: E402
from repro_torch.kernels.partition.ref import shard_rank_torch  # noqa: E402
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
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ssd as t_ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    ssd_chunk_ref,
    ssd_reference,
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
                               "segment_reduce": 0, "radix_rank": 0,
                               "flash_attention": 0, "decode_attention": 0,
                               "ssd_chunk": 0, "shard_rank": 0}


# ----------------------------------------------- K1/K4 look-back scan

LOOKBACK = (("prefix_count", t_compact.prefix_count_kernel,
             prefix_count_torch),
            ("running_segment_ids", t_expand.running_segment_ids_kernel,
             running_segment_ids_torch))


@pytest.mark.cuda
def test_lookback_tile_matches_the_library(dev):
    assert _build.library().repro_lookback_tile() == SCAN.TILE
    assert _build.library().repro_lookback_tiles(SCAN.TILE + 1) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", SCAN.SIZES)
def test_lookback_scans_match_plain_versions(dev, n):
    gen = torch.Generator(device=dev).manual_seed(6000 + n)
    _build.reset_launches()
    for kind in SCAN.KINDS:
        x = SCAN.make_input(kind, n, gen, dev)
        for name, kernel, plain in LOOKBACK:
            want = plain(x)
            for r in range(SCAN.REPEATS):
                assert torch.equal(kernel(x), want), (name, n, kind, r)
    torch.cuda.synchronize(dev)
    calls = len(SCAN.KINDS) * SCAN.REPEATS
    assert _build.LAUNCHES["prefix_count"] == calls
    assert _build.LAUNCHES["running_segment_ids"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("offset", SCAN.OFFSETS)
def test_lookback_scans_on_misaligned_views(dev, offset):
    gen = torch.Generator(device=dev).manual_seed(6100 + offset)
    for n in SCAN.SIZES:
        for kind in SCAN.KINDS:
            x = SCAN.make_input(kind, n, gen, dev)
            view = SCAN.misaligned(x, offset)
            assert view.data_ptr() % 16 != 0 and view.is_contiguous()
            for name, kernel, plain in LOOKBACK:
                assert torch.equal(kernel(view), plain(x)), (name, n, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (SCAN.SIZES[3], SCAN.SIZES[4]))
def test_lookback_scans_under_graph_replays(dev, n):
    gen = torch.Generator(device=dev).manual_seed(6200 + n)
    xs = [SCAN.make_input("small", n, gen, dev),
          SCAN.make_input("ones", n, gen, dev)]
    for name, kernel, plain in LOOKBACK:
        assert SCAN.graph_replays(kernel, xs, [plain(x) for x in xs]) \
            == SCAN.REPLAYS, name


@pytest.mark.cuda
def test_lookback_scans_on_two_streams(dev):
    gen = torch.Generator(device=dev).manual_seed(6300)
    n = SCAN.SIZES[4]
    xs = [SCAN.make_input("small", n, gen, dev),
          SCAN.make_input("ones", n, gen, dev)]
    for name, kernel, plain in LOOKBACK:
        for _ in range(10):
            assert SCAN.two_streams(kernel, xs, [plain(x) for x in xs]) \
                == 2, name


# ------------------------------------------------ K3 look-back scan

K3 = SCAN.boundaries(t_gb.group_boundaries_kernel)
K3_PLAIN = SCAN.boundaries(group_boundaries_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SCAN.SIZES)
def test_group_boundaries_lookback_cases(dev, n):
    gen = torch.Generator(device=dev).manual_seed(6400 + n)
    _build.reset_launches()
    for kind in SCAN.KEY_KINDS:
        x = SCAN.make_keys(kind, n, gen, dev)
        want = K3_PLAIN(x)
        for r in range(SCAN.REPEATS):
            assert torch.equal(K3(x), want), (n, kind, r)
    torch.cuda.synchronize(dev)
    assert _build.LAUNCHES["group_boundaries"] == \
        len(SCAN.KEY_KINDS) * SCAN.REPEATS


@pytest.mark.cuda
@pytest.mark.parametrize("offset", SCAN.OFFSETS)
def test_group_boundaries_on_misaligned_views(dev, offset):
    gen = torch.Generator(device=dev).manual_seed(6500 + offset)
    for n in SCAN.SIZES:
        for kind in SCAN.KEY_KINDS:
            x = SCAN.make_keys(kind, n, gen, dev)
            view = SCAN.misaligned(x, offset)
            assert view.data_ptr() % 16 != 0
            assert torch.equal(K3(view), K3_PLAIN(x)), (n, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (SCAN.SIZES[3], SCAN.SIZES[4]))
def test_group_boundaries_under_graph_replays_and_two_streams(dev, n):
    gen = torch.Generator(device=dev).manual_seed(6600 + n)
    xs = [SCAN.make_keys(kind, n, gen, dev)
          for kind in ("random", "increasing")]
    wants = [K3_PLAIN(x) for x in xs]
    assert SCAN.graph_replays(K3, xs, wants) == SCAN.REPLAYS
    for _ in range(10):
        assert SCAN.two_streams(K3, xs, wants) == 2


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


# ------------------------------------- K5 in one memset and one launch

@pytest.mark.cuda
def test_reduce_cases_match_the_library(dev):
    lib = _build.library()
    assert lib.repro_segment_reduce_batch() == RD.BATCH
    assert lib.repro_segment_reduce_shared_max() == RD.SHARED_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("g", RD.SEGMENTS)
@pytest.mark.parametrize("n", RD.SIZES)
def test_segment_reduce_cases_match_plain_version(dev, n, g):
    gen = torch.Generator(device=dev).manual_seed(8000 + n + g)
    _build.reset_launches()
    calls = 0
    for kind in RD.ID_KINDS:
        ids = RD.make_ids(kind, n, g, gen, dev)
        for dt in RD.DTYPES:
            for op in RD.OPS:
                v = RD.make_values(dt, n, gen, dev,
                                   finite=op == "sum" and dt == torch.float32)
                got = t_sr.segment_reduce_kernel(v, ids, g, op)
                calls += 1
                assert RD.held(got, segment_reduce_torch(v, ids, g, op), v,
                               ids, g, op), (kind, dt, op)
    torch.cuda.synchronize(dev)
    assert _build.LAUNCHES["segment_reduce"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("offset", RD.OFFSETS)
def test_segment_reduce_on_misaligned_views(dev, offset):
    gen = torch.Generator(device=dev).manual_seed(8100 + offset)
    for n in RD.SIZES[:3]:
        for g in (1, 120, RD.SHARED_MAX + 1):
            ids = RD.make_ids("uniform", n, g, gen, dev)
            for dt in RD.DTYPES:
                for op in RD.OPS:
                    v = RD.make_values(
                        dt, n, gen, dev,
                        finite=op == "sum" and dt == torch.float32)
                    vv, iv = RD.misaligned(v, offset), RD.misaligned(ids,
                                                                     offset)
                    assert vv.data_ptr() % 16 != 0
                    got = t_sr.segment_reduce_kernel(vv, iv, g, op)
                    assert RD.held(got, segment_reduce_torch(v, ids, g, op),
                                   v, ids, g, op), (n, g, dt, op)


@pytest.mark.cuda
@pytest.mark.parametrize("g", (120, 256))
@pytest.mark.parametrize("dt,op", ((torch.int32, "sum"),
                                   (torch.float32, "min"),
                                   (torch.float32, "max")))
def test_segment_reduce_under_graph_replays_and_two_streams(dev, g, dt, op):
    n = RD.SIZES[3]
    gen = torch.Generator(device=dev).manual_seed(8200 + g)
    xs = [RD.packed(RD.make_values(dt, n, gen, dev),
                    RD.make_ids(kind, n, g, gen, dev))
          for kind in ("uniform", "hot")]
    wants = [segment_reduce_torch(x[:n].view(dt), x[n:], g, op)
             .view(torch.int32) for x in xs]
    kernel = RD.unpacking(t_sr.segment_reduce_kernel, n, dt, g, op)
    assert SCAN.graph_replays(kernel, xs, wants, RD.REPLAYS) == RD.REPLAYS
    for _ in range(10):
        assert SCAN.two_streams(kernel, xs, wants) == 2


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


# ------------------------------------------------- K6 look-back rank

@pytest.mark.cuda
def test_radix_tile_matches_the_library(dev):
    lib = _build.library()
    assert lib.repro_radix_rank_tiles(RADIX.TILE) == 1
    assert lib.repro_radix_rank_tiles(RADIX.TILE + 1) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", RADIX.SIZES)
def test_radix_rank_cases_match_plain_version(dev, n):
    """Every digit kind and bucket count of ``radix_cases``, each call
    repeated; at B <= 32 also equal to K10 (the same function)."""
    gen = torch.Generator(device=dev).manual_seed(7000 + n)
    _build.reset_launches()
    calls = 0
    for buckets in RADIX.BUCKETS:
        for kind in RADIX.KINDS:
            d = RADIX.make_digits(kind, n, buckets, gen, dev)
            base = RADIX.exclusive_bases(d, buckets)
            want = t_hj.radix_rank_torch(d, base)
            for r in range(RADIX.REPEATS):
                assert torch.equal(t_hj.radix_rank_kernel(d, base), want), \
                    (buckets, kind, r)
            calls += RADIX.REPEATS
            if buckets <= t_part.MAX_SHARDS:
                assert torch.equal(t_part.shard_rank_kernel(d, base), want)
    torch.cuda.synchronize(dev)
    assert _build.LAUNCHES["radix_rank"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("buckets", (4, 256, 1024))
def test_radix_rank_under_graph_replays(dev, buckets):
    n = RADIX.SIZES[4]
    gen = torch.Generator(device=dev).manual_seed(7100 + buckets)
    ds = [RADIX.make_digits(kind, n, buckets, gen, dev)
          for kind in ("uniform", "skewed")]
    bases = [RADIX.exclusive_bases(d, buckets) for d in ds]
    xs = [RADIX.packed(d, b) for d, b in zip(ds, bases)]
    wants = [t_hj.radix_rank_torch(d, b) for d, b in zip(ds, bases)]
    kernel = RADIX.unpacking(t_hj.radix_rank_kernel, n)
    assert SCAN.graph_replays(kernel, xs, wants, RADIX.REPLAYS) \
        == RADIX.REPLAYS


@pytest.mark.cuda
def test_radix_rank_on_two_streams(dev):
    n = RADIX.SIZES[4]
    gen = torch.Generator(device=dev).manual_seed(7200)
    ds = [RADIX.make_digits(kind, n, 256, gen, dev)
          for kind in ("uniform", "descending")]
    bases = [RADIX.exclusive_bases(d, 256) for d in ds]
    xs = [RADIX.packed(d, b) for d, b in zip(ds, bases)]
    wants = [t_hj.radix_rank_torch(d, b) for d, b in zip(ds, bases)]
    kernel = RADIX.unpacking(t_hj.radix_rank_kernel, n)
    for _ in range(10):
        assert SCAN.two_streams(kernel, xs, wants) == 2


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", AC.HEAD_DIMS)
@pytest.mark.parametrize("group", AC.GROUPS)
@pytest.mark.parametrize("S", AC.SEQ_LENS)
def test_flash_attention_kernel_matches_plain_version(dev, S, group, d):
    g = torch.Generator(device=dev).manual_seed(S * 131 + group * 7 + d)
    B, K = 2, 2
    H = group * K
    # the model's (B, S, H, d) layout, read through transposed views
    q = torch.randn(B, S, H, d, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(B, S, K, d, generator=g, device=dev).transpose(1, 2)
    v = torch.randn(B, S, K, d, generator=g, device=dev).transpose(1, 2)
    for causal in (True, False):
        _build.reset_launches()
        got = t_fa.flash_attention_kernel(q, k, v, causal=causal)
        assert _build.LAUNCHES["flash_attention"] == 1
        want = attention_ref(q, k, v, causal=causal)
        assert got.stride() == q.stride()
        err = float((got - want).abs().max())
        assert err <= AC.TOLERANCE, (causal, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", AC.HEAD_DIMS)
@pytest.mark.parametrize("group", AC.GROUPS)
@pytest.mark.parametrize("T", AC.CACHE_LENS)
def test_decode_attention_kernel_matches_plain_version(dev, T, group, d):
    g = torch.Generator(device=dev).manual_seed(T * 17 + group * 3 + d)
    K = 2
    H = group * K
    lengths = torch.tensor(AC.decode_lengths(T), dtype=torch.int32,
                           device=dev)
    B = lengths.shape[0]
    q = torch.randn(B, H, d, generator=g, device=dev)
    # the model's (B, T, K, d) cache, read through a permuted view
    k = torch.randn(B, T, K, d, generator=g, device=dev).permute(0, 2, 1, 3)
    v = torch.randn(B, T, K, d, generator=g, device=dev).permute(0, 2, 1, 3)
    _build.reset_launches()
    got = t_dec.decode_attention_kernel(q, k, v, lengths)
    assert _build.LAUNCHES["decode_attention"] == 1
    err = float((got - decode_attention_ref(q, k, v, lengths)).abs().max())
    assert err <= AC.TOLERANCE, err
    zero = t_dec.decode_attention_kernel(q, k, v, torch.zeros_like(lengths))
    err0 = (zero - decode_attention_ref(q, k, v, torch.zeros_like(lengths)))
    assert float(err0.abs().max()) <= AC.TOLERANCE  # the mean of V


@pytest.mark.cuda
def test_attention_wrappers_reject_wrong_operands(dev):
    q = torch.zeros(1, 4, 8, 16, device=dev)
    k = torch.zeros(1, 3, 8, 16, device=dev)
    wide = torch.zeros(1, 2, 8, 257, device=dev)
    flash = t_fa.flash_attention_kernel
    with pytest.raises(ValueError):  # 4 heads over 3 KV heads
        flash(q, k, k)
    with pytest.raises(ValueError):  # head_dim above 256
        flash(wide, wide[:, :1], wide[:, :1])
    with pytest.raises(ValueError):  # head_dim above 256
        t_dec.decode_attention_kernel(
            wide[:, :, 0], wide[:, :1], wide[:, :1],
            torch.ones(1, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # out of another shape than q
        flash(q, q, q, out=torch.zeros(1, 4, 7, 16, device=dev))
    with pytest.raises(TypeError):
        flash(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):  # unit stride on d required
        flash(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
    with pytest.raises(ValueError):  # 33 query heads per KV head
        t_dec.decode_attention_kernel(
            torch.zeros(1, 33, 16, device=dev),
            torch.zeros(1, 1, 4, 16, device=dev),
            torch.zeros(1, 1, 4, 16, device=dev),
            torch.ones(1, dtype=torch.int32, device=dev))


@pytest.mark.cuda
def test_serving_kernel_path_matches_plain_path(dev):
    """A tiny GQA model served on the card with K7/K8 (``auto``) and
    with the plain grouped einsum (``ref``): the same answers through
    slot recycling, K7 launched once per layer per admission and K8 once
    per layer per round."""
    from repro_torch.configs import get_tiny
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_tiny("internlm2-20b").replace(vocab_size=512)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = [f"card serving probe {i} " + "word " * (i % 11)
               for i in range(13)]
    out = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(cfg, params, batch_size=4, max_seq=24,
                            max_new_tokens=3, device=dev, attn_impl=impl)
        _build.reset_launches()
        out[impl] = eng.answer(prompts)
        launches = dict(_build.LAUNCHES)
        if impl == "auto":
            assert launches["flash_attention"] == \
                cfg.num_layers * eng.stats.batches
            assert launches["decode_attention"] == \
                cfg.num_layers * eng.stats.decode_steps
        else:
            assert launches["flash_attention"] == 0
            assert launches["decode_attention"] == 0
    assert out["auto"] == out["ref"]


@pytest.mark.cuda
def test_moe_serving_kernel_path_matches_plain_path(dev):
    """olmoe-tiny (multi-head, group 1) at capacity factor 0.5, so
    experts drop rows at admissions and rounds, served on the card with
    K7/K8 and with the plain attention: the same answers, K7 once per
    layer per admission, K8 once per layer per round."""
    from repro_torch.configs import get_tiny
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_tiny("olmoe-1b-7b").replace(vocab_size=512,
                                          moe_capacity_factor=0.5)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = [f"card moe probe {i} " + "word " * (i % 11)
               for i in range(13)]
    out = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(cfg, params, batch_size=4, max_seq=24,
                            max_new_tokens=3, device=dev, attn_impl=impl)
        _build.reset_launches()
        out[impl] = eng.answer(prompts)
        launches = dict(_build.LAUNCHES)
        want = dict.fromkeys(launches, 0)
        if impl == "auto":
            want.update(flash_attention=cfg.num_layers * eng.stats.batches,
                        decode_attention=cfg.num_layers
                        * eng.stats.decode_steps)
        assert launches == want
    assert out["auto"] == out["ref"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mesh", (("olmoe-1b-7b", (2, 2)),
                                       ("olmoe-1b-7b", (1, 2)),
                                       ("starcoder2-3b", (1, 4))))
def test_mesh_serving_kernel_path_matches_plain_path(dev, arch, mesh):
    """A model mesh whose positions all lie on the card (olmoe-tiny at
    capacity factor 0.5, so experts drop rows; starcoder2-tiny's 2 KV
    heads read by 4 ranks): K7/K8 on every shard's local heads against
    the plain attention, the same answers, K7 once per layer per
    position per admission, K8 once per layer per position per round;
    the mesh's prefill logits within 1e-4 of the same mesh on the
    CPU."""
    from repro_torch.configs import get_tiny
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, prefill
    from repro_torch.models.params import shard_params
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding.policy import ShardingPolicy

    cfg = get_tiny(arch).replace(vocab_size=512)
    if cfg.num_experts:
        cfg = cfg.replace(moe_capacity_factor=0.5)
    n = mesh[0] * mesh[1]
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    pols = {d: ShardingPolicy.for_mesh(make_mesh(*mesh, devices=[d] * n))
            for d in (dev, torch.device("cpu"))}
    sp = shard_params(cfg, _tree_to(params, dev), pols[dev])
    prompts = [f"card mesh probe {i} " + "word " * (i % 11)
               for i in range(13)]
    out = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(cfg, sp, batch_size=4, max_seq=24,
                            max_new_tokens=3, attn_impl=impl,
                            policy=pols[dev])
        _build.reset_launches()
        out[impl] = eng.answer(prompts)
        launches = dict(_build.LAUNCHES)
        want = dict.fromkeys(launches, 0)
        if impl == "auto":
            want.update(
                flash_attention=cfg.num_layers * n * eng.stats.batches,
                decode_attention=cfg.num_layers * n
                * eng.stats.decode_steps)
        assert launches == want
    assert out["auto"] == out["ref"]
    toks = torch.randint(1, cfg.vocab_size, (4, 24),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, _ = prefill(cfg, sp, {"tokens": toks.to(dev)}, max_seq=28,
                         policy=pols[dev])
        cpu = torch.device("cpu")
        want, _ = prefill(cfg, shard_params(cfg, params, pols[cpu]),
                          {"tokens": toks}, max_seq=28, attn_impl="ref",
                          policy=pols[cpu])
    assert float((got.cpu() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.cuda
def test_mesh_training_matches_one_device(dev):
    """qwen-tiny trained 3 fp32 steps over a (2, 2) mesh whose positions
    all lie on the card, against the card's one-device run: losses
    within 1e-5, every parameter within 1e-4 (Adam's first step turns
    float noise in a gradient of a few eps into a move of part of lr);
    no kernel launches (training runs the plain attention)."""
    from repro_torch.configs import get_tiny
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.params import shard_params
    from repro_torch.sharding import model as sm
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.training import AdamWConfig, build_train_step, init_state
    from repro_torch.training.optimizer import leaves

    cfg = get_tiny("qwen2.5-32b")
    opt = AdamWConfig(lr=1e-3)
    host = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(1, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    pol = ShardingPolicy.for_mesh(make_mesh(2, 2, devices=[dev] * 4))
    runs = {}
    _build.reset_launches()
    for name, policy in (("one", None), ("mesh", pol)):
        params = _tree_to(host, dev)
        if policy is not None:
            params = shard_params(cfg, params, policy)
        state = init_state(params, opt)
        step = build_train_step(cfg, opt, remat=None, policy=policy)
        losses = []
        for _ in range(3):
            params, state, m = step(params, state, {"tokens": toks})
            losses.append(float(m["loss"]))
        runs[name] = (losses, sm.unshard(params, "cpu"))
    assert not any(_build.LAUNCHES.values())
    np.testing.assert_allclose(runs["mesh"][0], runs["one"][0], atol=1e-5,
                               rtol=0)
    for (k, a), (_, b) in zip(leaves(runs["one"][1]),
                              leaves(runs["mesh"][1])):
        np.testing.assert_allclose(b.numpy(), a.cpu().numpy(), atol=1e-4,
                                   rtol=0, err_msg=k)


@pytest.mark.cuda
def test_moe_block_on_the_card_is_deterministic(dev):
    """``moe_block`` on the card (stable sort, the scatter as distinct
    row writes): two calls equal bit for bit, and within 1e-4 of the
    same call on the CPU, drops included (capacity factor 1.0)."""
    from repro_torch.configs import get_tiny
    from repro_torch.models import init_params, moe_block

    cfg = get_tiny("olmoe-1b-7b").replace(moe_capacity_factor=1.0)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want = moe_block(cfg, p, x)
    pd = {k: v.to(dev) for k, v in p.items()}
    a, b = moe_block(cfg, pd, x.to(dev)), moe_block(cfg, pd, x.to(dev))
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_autograd_on_the_card(dev):
    """K7, K8 and K9 have no backward: with grad mode on and an input
    that requires grad they raise and launch nothing; under
    ``torch.no_grad()`` they launch once each."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_kernel,
    )
    from repro_torch.kernels.ssd.ssd import ssd_chunk_kernel

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 4, 16, 64, generator=g, device=dev,
                    requires_grad=True)
    kv = torch.randn(2, 2, 16, 64, generator=g, device=dev)
    x = torch.randn(1, 64, 2, 16, generator=g, device=dev,
                    requires_grad=True)
    dt = torch.rand(1, 64, 2, generator=g, device=dev)
    A = -torch.rand(2, generator=g, device=dev) - 1
    B = torch.randn(1, 64, 16, generator=g, device=dev)
    lengths = torch.full((2,), 16, dtype=torch.int32, device=dev)
    calls = {"flash_attention": lambda: t_fa.flash_attention_kernel(
                 q, kv, kv),
             "decode_attention": lambda: decode_attention_kernel(
                 q[:, :, 0], kv, kv, lengths),
             "ssd_chunk": lambda: ssd_chunk_kernel(x, dt, A, B, B,
                                                   chunk=64)}
    for name, call in calls.items():
        _build.reset_launches()
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert _build.LAUNCHES[name] == 0
        with torch.no_grad():
            call()
        torch.cuda.synchronize(dev)
        assert _build.LAUNCHES[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("stablelm-3b", "olmoe-1b-7b"))
def test_train_steps_on_the_card_match_the_cpu(dev, arch):
    """Three ``build_train_step`` steps (2 microbatches, remat "full")
    from one set of weights, on the card and on the CPU: every loss
    within 1e-4 relative; the served model then runs the kernel path on
    the trained tensors, even set to require grad (the engine serves
    without autograd)."""
    from repro_torch.configs import get_tiny
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.training import (
        AdamWConfig,
        TokenStream,
        build_train_step,
        init_state,
    )

    cfg = get_tiny(arch)
    opt = AdamWConfig(lr=1e-3)
    data = TokenStream(cfg.vocab_size, batch_size=4, seq_len=32, seed=7)
    losses = {}
    for device in ("cpu", dev):
        params = _to(init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu"), device)
        state = init_state(params, opt)
        step = build_train_step(cfg, opt, num_microbatches=2, remat="full")
        losses[str(device)] = []
        for i in range(3):
            batch = {"tokens": torch.from_numpy(data[i]["tokens"]).to(
                device)}
            params, state, m = step(params, state, batch)
            losses[str(device)].append(float(m["loss"]))
    np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)
    for v in _leaves(params):
        v.requires_grad_(True)  # the engine serves them without autograd
    _build.reset_launches()
    eng = ServingEngine(cfg, params, batch_size=4, max_seq=24, device=dev)
    assert all(eng.answer(["card train probe", "two words here"]))
    assert _build.LAUNCHES["flash_attention"] > 0


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


@pytest.mark.cuda
@pytest.mark.parametrize("d", AC.HEAD_DIMS)
@pytest.mark.parametrize("group", AC.GROUPS)
@pytest.mark.parametrize("window", AC.WINDOWS)
def test_flash_attention_window_matches_plain_version(dev, window, group,
                                                      d):
    g = torch.Generator(device=dev).manual_seed(window * 31 + group + d)
    B, K, S = 2, 2, AC.WINDOW_SEQ
    H = group * K
    q, k, v = (torch.randn(B, S, n, d, generator=g, device=dev)
               .transpose(1, 2) for n in (H, K, K))
    _build.reset_launches()
    got = t_fa.flash_attention_kernel(q, k, v, causal=True, window=window)
    assert _build.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, causal=True, window=window)
    assert float((got - want).abs().max()) <= AC.TOLERANCE
    # window 0 is no window: the dense path's numbers
    assert torch.equal(t_fa.flash_attention_kernel(q, k, v, causal=True,
                                                   window=0),
                       t_fa.flash_attention_kernel(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("d", (36, 37))
def test_flash_attention_unaligned_views_match_plain_version(dev, d):
    """Rows that do not start on 16 bytes (views at a storage offset of
    one float; d = 37 is not a multiple of 4 either) take K7's cp.async
    copies instead of the TMA unit's bulk copies."""
    g = torch.Generator(device=dev).manual_seed(d)
    B, K, S, group = 2, 2, 130, 3
    H = group * K

    def view(heads):
        flat = torch.randn(B * S * heads * d + 1, generator=g, device=dev)
        return flat[1:].view(B, S, heads, d).transpose(1, 2)

    q, k, v = view(H), view(K), view(K)
    assert q.data_ptr() % 16 != 0
    for causal, window in ((True, 0), (False, 0), (True, 17)):
        _build.reset_launches()
        got = t_fa.flash_attention_kernel(q, k, v, causal=causal,
                                          window=window)
        assert _build.LAUNCHES["flash_attention"] == 1
        want = attention_ref(q, k, v, causal=causal, window=window)
        assert float((got - want).abs().max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("d", AC.HEAD_DIMS)
@pytest.mark.parametrize("group", AC.GROUPS)
@pytest.mark.parametrize("W", AC.RING_WINDOWS)
def test_decode_attention_ring_matches_plain_version(dev, W, group, d):
    g = torch.Generator(device=dev).manual_seed(W * 17 + group + d)
    rows = AC.ring_rows(W)
    sp = torch.tensor(AC.ring_slot_pos(W, rows), dtype=torch.int32,
                      device=dev)
    pos = torch.tensor([p for _, p in rows], dtype=torch.int32, device=dev)
    B, K = len(rows), 2
    H = group * K
    q = torch.randn(B, H, d, generator=g, device=dev)
    k, v = (torch.randn(B, W, K, d, generator=g, device=dev)
            .permute(0, 2, 1, 3) for _ in range(2))
    _build.reset_launches()
    got = t_dec.decode_attention_kernel(q, k, v, slot_pos=sp, pos=pos,
                                        window=W)
    assert _build.LAUNCHES["decode_attention"] == 1
    want = decode_attention_ref(q, k, v, slot_pos=sp, pos=pos, window=W)
    assert float((got - want).abs().max()) <= AC.TOLERANCE
    # no live slot: the mean of V, as the plain version
    empty = torch.full_like(sp, -1)
    got0 = t_dec.decode_attention_kernel(q, k, v, slot_pos=empty, pos=pos,
                                         window=W)
    want0 = decode_attention_ref(q, k, v, slot_pos=empty, pos=pos, window=W)
    assert float((got0 - want0).abs().max()) <= AC.TOLERANCE


# ------------------------------------------------- K8 split over the cache

@pytest.mark.cuda
def test_decode_chunk_matches_the_library(dev):
    assert _build.library().repro_decode_chunk() == AC.DECODE_CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("group", AC.WIDE_GROUPS)
@pytest.mark.parametrize("S", (1, 65, 288))
def test_flash_attention_wide_head_matches_plain_version(dev, S, group):
    """head_dim 256 (paligemma-3b), causal, not causal and windowed."""
    g = torch.Generator(device=dev).manual_seed(S * 7 + group)
    B, K, d = 2, 1, AC.WIDE_HEAD_DIM
    q, k, v = (torch.randn(B, S, n, d, generator=g, device=dev)
               .transpose(1, 2) for n in (group * K, K, K))
    for causal, window in ((True, 0), (False, 0), (True, 17)):
        _build.reset_launches()
        got = t_fa.flash_attention_kernel(q, k, v, causal=causal,
                                          window=window)
        assert _build.LAUNCHES["flash_attention"] == 1
        want = attention_ref(q, k, v, causal=causal, window=window)
        err = float((got - want).abs().max())
        assert err <= AC.TOLERANCE, (causal, window, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", (64, AC.WIDE_HEAD_DIM))
@pytest.mark.parametrize("Sk", AC.CROSS_KEYS)
@pytest.mark.parametrize("Sq", AC.CROSS_QUERIES)
def test_flash_attention_cross_matches_plain_version(dev, Sq, Sk, d):
    """Sq != Sk without the causal mask: the whisper decoder's
    cross-attention over the encoder's frames."""
    g = torch.Generator(device=dev).manual_seed(Sq * 11 + Sk + d)
    B, K, group = 2, 2, 3
    q = torch.randn(B, Sq, group * K, d, generator=g,
                    device=dev).transpose(1, 2)
    k, v = (torch.randn(B, Sk, K, d, generator=g, device=dev)
            .transpose(1, 2) for _ in range(2))
    _build.reset_launches()
    got = t_fa.flash_attention_kernel(q, k, v, causal=False)
    assert _build.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, causal=False)
    assert float((got - want).abs().max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("d", (64, AC.WIDE_HEAD_DIM))
@pytest.mark.parametrize("S,prefix", AC.PREFIX_CASES)
def test_flash_attention_prefix_composition(dev, S, prefix, d):
    """The VLM's prefix-LM mask as two K7 calls, the second writing the
    prefix rows of the first's output through its strides."""
    from repro_torch.kernels.flash_attention.ops import prefix_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_prefix_ref)

    g = torch.Generator(device=dev).manual_seed(S + prefix + d)
    B, K, group = 2, 1, 8
    q, k, v = (torch.randn(B, S, n, d, generator=g, device=dev)
               .transpose(1, 2) for n in (group * K, K, K))
    _build.reset_launches()
    got = prefix_attention(q, k, v, prefix, impl="kernel")
    assert _build.LAUNCHES["flash_attention"] == 2
    want = attention_prefix_ref(q, k, v, prefix)
    assert float((got - want).abs().max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("group", AC.WIDE_GROUPS)
@pytest.mark.parametrize("T", (131, 304, 1500))
def test_decode_attention_wide_head_matches_plain_version(dev, T, group):
    """head_dim 256 (paligemma-3b) under lengths (whisper's cross decode
    at T = 1500 has every slot live) and under the slot mask."""
    g = torch.Generator(device=dev).manual_seed(T + group)
    K, d = 1, AC.WIDE_HEAD_DIM
    lengths = torch.tensor(AC.chunk_lengths(T), dtype=torch.int32,
                           device=dev)
    q, k, v = _decode_operands(g, lengths.shape[0], group * K, K, T, d, dev)
    _build.reset_launches()
    got = t_dec.decode_attention_kernel(q, k, v, lengths)
    assert _build.LAUNCHES["decode_attention"] == 1
    err = float((got - decode_attention_ref(q, k, v, lengths)).abs().max())
    assert err <= AC.TOLERANCE, err
    W = 64
    rows = AC.ring_rows(W)
    sp = torch.tensor(AC.ring_slot_pos(W, rows), dtype=torch.int32,
                      device=dev)
    pos = torch.tensor([p for _, p in rows], dtype=torch.int32, device=dev)
    q, k, v = _decode_operands(g, len(rows), group * K, K, W, d, dev)
    got = t_dec.decode_attention_kernel(q, k, v, slot_pos=sp, pos=pos,
                                        window=W)
    want = decode_attention_ref(q, k, v, slot_pos=sp, pos=pos, window=W)
    assert float((got - want).abs().max()) <= AC.TOLERANCE


def _decode_operands(g, B, H, K, T, d, dev):
    """q (B, H, d) and the model's (B, T, K, d) cache as permuted
    (B, K, T, d) views."""
    q = torch.randn(B, H, d, generator=g, device=dev)
    k, v = (torch.randn(B, T, K, d, generator=g, device=dev)
            .permute(0, 2, 1, 3) for _ in range(2))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("d", (36, 64, 128))
@pytest.mark.parametrize("group", AC.GROUPS)
@pytest.mark.parametrize("T", (131, AC.LONG_CACHE))
def test_decode_attention_chunk_edges(dev, T, group, d):
    """Lengths of C - 1, C, C + 1, 2C + 1 and T in one batch; the output
    equal bit for bit from call to call."""
    g = torch.Generator(device=dev).manual_seed(T + group * 3 + d)
    lengths = torch.tensor(AC.chunk_lengths(T), dtype=torch.int32,
                           device=dev)
    K = 2
    q, k, v = _decode_operands(g, lengths.shape[0], group * K, K, T, d, dev)
    _build.reset_launches()
    got = t_dec.decode_attention_kernel(q, k, v, lengths)
    assert _build.LAUNCHES["decode_attention"] == 1
    err = float((got - decode_attention_ref(q, k, v, lengths)).abs().max())
    assert err <= AC.TOLERANCE, err
    for _ in range(5):
        assert torch.equal(t_dec.decode_attention_kernel(q, k, v, lengths),
                           got)


@pytest.mark.cuda
@pytest.mark.parametrize("H,K,d", [(25, 5, 64), (24, 2, 128), (2, 2, 80)])
def test_decode_attention_full_ring(dev, H, K, d):
    """long_prefill's 2048-slot ring with every slot live (64 chunks,
    hymba-1.5b's heads among the widths)."""
    g = torch.Generator(device=dev).manual_seed(H + d)
    sp, pos = AC.full_ring()
    spt = torch.tensor([sp], dtype=torch.int32, device=dev)
    post = torch.tensor([pos], dtype=torch.int32, device=dev)
    q, k, v = _decode_operands(g, 1, H, K, AC.FULL_RING, d, dev)
    got = t_dec.decode_attention_kernel(q, k, v, slot_pos=spt, pos=post,
                                        window=AC.FULL_RING)
    want = decode_attention_ref(q, k, v, slot_pos=spt, pos=post,
                                window=AC.FULL_RING)
    assert float((got - want).abs().max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("d", AC.HEAD_DIMS)
@pytest.mark.parametrize("group", AC.GROUPS)
def test_decode_attention_gapped_ring(dev, group, d):
    """Rings whose live chunks have dead chunks between them, and a row
    with one live slot."""
    g = torch.Generator(device=dev).manual_seed(group * 5 + d)
    rows, pos, W = AC.gapped_ring()
    sp = torch.tensor(rows, dtype=torch.int32, device=dev)
    pt = torch.tensor(pos, dtype=torch.int32, device=dev)
    K = 2
    q, k, v = _decode_operands(g, len(rows), group * K, K, W, d, dev)
    got = t_dec.decode_attention_kernel(q, k, v, slot_pos=sp, pos=pt,
                                        window=W)
    want = decode_attention_ref(q, k, v, slot_pos=sp, pos=pt, window=W)
    assert float((got - want).abs().max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("d", (30, 64))
def test_decode_attention_unaligned_views(dev, d):
    """A cache whose rows do not start on 16 bytes (a storage offset of
    one float; d = 30 is not a multiple of 4 either) takes the 4-byte
    copies."""
    g = torch.Generator(device=dev).manual_seed(d)
    B, K, T, group = 3, 2, 200, 3
    H = group * K

    def cache():
        flat = torch.randn(B * T * K * d + 1, generator=g, device=dev)
        return flat[1:].view(B, T, K, d).permute(0, 2, 1, 3)

    q = torch.randn(B, H, d, generator=g, device=dev)
    k, v = cache(), cache()
    assert k.data_ptr() % 16 != 0
    lengths = torch.tensor([1, 100, 200], dtype=torch.int32, device=dev)
    got = t_dec.decode_attention_kernel(q, k, v, lengths)
    want = decode_attention_ref(q, k, v, lengths)
    assert float((got - want).abs().max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ("lengths", "slots"))
def test_decode_attention_under_graph_replays(dev, mask):
    """200 replays of one captured call on alternating inputs: the
    arrival counters are reset by every replay, and each output equals
    an eager call's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(len(mask))
    if mask == "lengths":
        B, H, K, T, d = 16, 24, 2, 131, 128
        xs = []
        for _ in range(2):
            q, k, v = _decode_operands(g, B, H, K, T, d, dev)
            lengths = torch.randint(1, T + 1, (B,), generator=g, device=dev,
                                    dtype=torch.int32)
            xs.append((q, k, v, lengths))
        wants = [decode_attention_ref(*x) for x in xs]
        kernel = t_dec.decode_attention_kernel
    else:
        B, H, K, T, d = 1, 25, 5, AC.FULL_RING, 64
        sp, pos = AC.full_ring()
        gap_rows, _, _ = AC.gapped_ring()
        spt = torch.tensor([sp], dtype=torch.int32, device=dev)
        gapped = torch.full_like(spt, -1)
        gapped[0, :len(gap_rows[0])] = torch.tensor(
            [x - gap_rows[0][-1] + pos if x >= 0 else -1
             for x in gap_rows[0]], dtype=torch.int32, device=dev)
        post = torch.tensor([pos], dtype=torch.int32, device=dev)
        xs = []
        for s in (spt, gapped):
            q, k, v = _decode_operands(g, B, H, K, T, d, dev)
            xs.append((q, k, v, s, post))
        wants = [decode_attention_ref(q, k, v, slot_pos=s, pos=p, window=T)
                 for q, k, v, s, p in xs]

        def kernel(q, k, v, s, p):
            return t_dec.decode_attention_kernel(q, k, v, slot_pos=s,
                                                 pos=p, window=T)
    assert AC.graph_replays(kernel, xs, wants) == AC.REPLAYS


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", SC.sweep())
def test_ssd_chunk_kernel_matches_plain_version(dev, b, s, h, p, n, chunk):
    g = torch.Generator(device=dev).manual_seed(s * 7 + h + n + b)
    x, dt, A, B, C = SC.case_inputs(b, s, h, p, n, chunk, g, dev)
    assert not x.is_contiguous()  # a slice of the conv output
    _build.reset_launches()
    got = t_ssd.ssd_chunk_kernel(x, dt, A, B, C, chunk=chunk)
    assert _build.LAUNCHES["ssd_chunk"] == 1
    want = ssd_chunk_ref(x, dt, A, B, C, chunk)
    tol = SC.tolerance(SC.cum_max(dt, A, chunk))
    for a, w in zip(got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all())
        err = float((a - w).abs().max())
        assert err <= tol * max(1.0, float(w.abs().max())), err


@pytest.mark.cuda
def test_ssd_kernel_matches_sequential_oracle(dev):
    b, s, h, p, n, chunk = SC.ORACLE_CASE
    x, dt, A, B, C = SC.oracle_inputs(
        torch.Generator(device=dev).manual_seed(0), dev)
    _build.reset_launches()
    y, state = ssd_ops.ssd(x, dt, A, B, C, chunk)  # auto: K9 on the card
    assert _build.LAUNCHES["ssd_chunk"] == 1
    want = ssd_reference(x, dt, A, B, C)
    tol = SC.tolerance(SC.cum_max(dt, A, chunk))
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    assert float((y - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
def test_ssd_chunk_kernel_head_groups_and_wide_state(dev):
    """K9 at a chunk that is not a multiple of 16, a state wider than one
    128-column slab whose B and C rows do not start on 16 bytes (n =
    150: 4-byte copies, C.B^T summed over two slabs, B staged again for
    each head's states): the wrapper (one launch, its own head groups)
    and the C entry point at every head-group count, within the
    tolerance of the plain version; a count above h is refused."""
    b, s, h, p, n, chunk = 2, 96, 5, 24, 150, 48
    g = torch.Generator(device=dev).manual_seed(5)
    x, dt, A, B, C = SC.case_inputs(b, s, h, p, n, chunk, g, dev)
    want = ssd_chunk_ref(x, dt, A, B, C, chunk)
    tol = SC.tolerance(SC.cum_max(dt, A, chunk))

    def entry(groups):
        outs = [torch.empty(w.shape, device=dev) for w in want]
        _build.call("repro_ssd_chunk", dev, *map(_build.ptr, (
            x, dt, A, B, C, *outs)), b, s, h, p, n, chunk, groups,
            *x.stride()[:3], *B.stride()[:2], *C.stride()[:2],
            _build.stream(x))
        return outs

    _build.reset_launches()
    runs = [t_ssd.ssd_chunk_kernel(x, dt, A, B, C, chunk=chunk)]
    assert _build.LAUNCHES["ssd_chunk"] == 1
    runs += [entry(groups) for groups in range(1, h + 1)]
    with pytest.raises(RuntimeError):
        entry(h + 1)
    for groups, got in enumerate(runs):
        for a, w in zip(got, want):
            assert bool(torch.isfinite(a).all())
            err = float((a - w).abs().max())
            assert err <= tol * max(1.0, float(w.abs().max())), (groups,
                                                                 err)


@pytest.mark.cuda
def test_ssd_wrapper_rejects_wrong_operands(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x, dt, A, B, C = SC.case_inputs(1, 64, 2, 16, 8, 64, g, dev)
    k9 = t_ssd.ssd_chunk_kernel
    with pytest.raises(TypeError):
        k9(x.double(), dt, A, B, C, chunk=64)
    with pytest.raises(ValueError):  # a CPU operand
        k9(x, dt.cpu(), A, B, C, chunk=64)
    with pytest.raises(ValueError):  # A for 3 heads, x has 2
        k9(x, dt, torch.ones(3, device=dev), B, C, chunk=64)
    with pytest.raises(ValueError):  # chunk 48 does not divide s = 64
        k9(x, dt, A, B, C, chunk=48)
    with pytest.raises(ValueError):  # chunk above 128
        k9(x, dt, A, B, C, chunk=256)
    with pytest.raises(ValueError):  # B and C of different widths
        k9(x, dt, A, B, C[..., :4], chunk=64)
    with pytest.raises(ValueError):  # unit stride on p required
        k9(x.transpose(2, 3), dt, A, B, C, chunk=64)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("mamba2-370m", "hymba-1.5b"))
def test_ssm_serving_kernel_path_matches_plain_path(dev, arch):
    """A tiny SSM or hybrid model served on the card with K9 (and, for
    the hybrid, K7 with its window and K8 with the slot mask) and with
    the plain paths, at max_seq 24, so the hybrid's 16-slot ring wraps:
    the same answers through slot recycling; K9 (and K7) once per layer
    per admission, K8 once per layer per round; the plain engine
    launches nothing."""
    from repro_torch.configs import get_tiny
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    cfg = get_tiny(arch).replace(vocab_size=512)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = [f"card serving probe {i} " + "word " * (i % 11)
               for i in range(13)]
    out = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(cfg, params, batch_size=4, max_seq=24,
                            max_new_tokens=3, device=dev, attn_impl=impl,
                            ssd_impl=impl)
        _build.reset_launches()
        out[impl] = eng.answer(prompts)
        launches = dict(_build.LAUNCHES)
        attn = int(cfg.family == "hybrid")
        L, st = cfg.num_layers, eng.stats
        want = dict.fromkeys(launches, 0)
        if impl == "auto":
            want.update(ssd_chunk=L * st.batches,
                        flash_attention=attn * L * st.batches,
                        decode_attention=attn * L * st.decode_steps)
        assert launches == want
    assert out["auto"] == out["ref"]


# ------------------------------------------------------------------ K10

@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_shard_rank_kernel_matches_plain_version(dev, n):
    gen = torch.Generator(device=dev).manual_seed(5000 + n)
    _build.reset_launches()
    cases = PC.sweep((n,))
    for _, p, dkind, bkind in cases:
        dest = PC.dest_case(dkind, n, p, gen, dev)
        base = PC.base_case(bkind, dest, p, gen)
        got = t_part.shard_rank_kernel(dest, base)
        assert torch.equal(got, shard_rank_torch(dest, base, p)), \
            (n, p, dkind, bkind)
    torch.cuda.synchronize(dev)
    assert _build.LAUNCHES["shard_rank"] == len(cases)
    assert _build.LAUNCHES["radix_rank"] == 0  # not K6


@pytest.mark.cuda
def test_shard_tile_matches_the_library(dev):
    lib = _build.library()
    assert lib.repro_shard_rank_tiles(PC.TILE) == 1
    assert lib.repro_shard_rank_tiles(PC.TILE + 1) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", PC.SIZES)
def test_shard_rank_lookback_cases_match_plain_version(dev, n):
    """K10's look-back sweep: sizes around its tile, every case of
    ``partition_cases`` repeated, one launch per call."""
    gen = torch.Generator(device=dev).manual_seed(5100 + n)
    _build.reset_launches()
    calls = 0
    for _, p, dkind, bkind in PC.sweep((n,)):
        dest = PC.dest_case(dkind, n, p, gen, dev)
        base = PC.base_case(bkind, dest, p, gen)
        want = shard_rank_torch(dest, base, p)
        for r in range(PC.REPEATS):
            assert torch.equal(t_part.shard_rank_kernel(dest, base), want), \
                (p, dkind, bkind, r)
        calls += PC.REPEATS
    torch.cuda.synchronize(dev)
    assert _build.LAUNCHES["shard_rank"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("p", (4, 32))
def test_shard_rank_under_graph_replays(dev, p):
    n = PC.SIZES[4]
    gen = torch.Generator(device=dev).manual_seed(5200 + p)
    ds = [PC.dest_case(kind, n, p, gen, dev) for kind in ("uniform", "half")]
    bases = [PC.base_case(kind, d, p, gen) for kind, d in zip(PC.BASES, ds)]
    xs = [RADIX.packed(d, b) for d, b in zip(ds, bases)]
    wants = [shard_rank_torch(d, b, p) for d, b in zip(ds, bases)]
    kernel = RADIX.unpacking(t_part.shard_rank_kernel, n)
    assert SCAN.graph_replays(kernel, xs, wants, PC.REPLAYS) == PC.REPLAYS


@pytest.mark.cuda
def test_shard_rank_on_two_streams(dev):
    n = PC.SIZES[4]
    gen = torch.Generator(device=dev).manual_seed(5300)
    ds = [PC.dest_case(kind, n, 4, gen, dev) for kind in ("uniform", "one")]
    bases = [PC.base_case(kind, d, 4, gen) for kind, d in zip(PC.BASES, ds)]
    xs = [RADIX.packed(d, b) for d, b in zip(ds, bases)]
    wants = [shard_rank_torch(d, b, 4) for d, b in zip(ds, bases)]
    kernel = RADIX.unpacking(t_part.shard_rank_kernel, n)
    for _ in range(10):
        assert SCAN.two_streams(kernel, xs, wants) == 2


@pytest.mark.cuda
def test_shard_rank_wrapper_rejects_wrong_operands(dev):
    d = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # 33 buckets: past one warp
        t_part.shard_rank_kernel(d, torch.zeros(33, dtype=torch.int32,
                                                device=dev))
    with pytest.raises(TypeError):
        t_part.shard_rank_kernel(d.long(), torch.zeros(4, dtype=torch.int32,
                                                       device=dev))
    with pytest.raises(ValueError):
        t_part.shard_rank_kernel(d[::2], torch.zeros(4, dtype=torch.int32,
                                                     device=dev))
    assert t_part.shard_rank_kernel(d[:0], torch.zeros(
        4, dtype=torch.int32, device=dev)).shape == (0,)


def _tier_db(device, n=200000, seed=21):
    """Facts keyed (k1, k2) with float and int values (NaN, signed zeros
    and int32 extremes among them) and a dimension on k2."""
    from repro_torch.engine import database_from_numpy

    rng = np.random.default_rng(seed)
    v = (rng.normal(size=n) * 50).astype(np.float32)
    v[::97] = np.nan
    v[1::89] = -0.0
    v[2::83] = 0.0
    w = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    w[::101] = -2**31
    w[1::103] = INT32_MAX
    facts = {"fid": np.arange(n), "k1": rng.integers(0, 500, n),
             "k2": rng.integers(0, 40, n), "v": v, "w": w}
    dims = {"k2": np.arange(48), "weight": rng.integers(0, 9, 48)}
    return database_from_numpy({"facts": facts, "dims": dims},
                               device=device)


def _tier_plans():
    from repro_torch.core import Q

    agg = (Q.scan("facts")
           .group_by(["facts.k1", "facts.k2"],
                     [("count", "*", "n"), ("min", "facts.v", "lo"),
                      ("max", "facts.v", "hi"), ("min", "facts.w", "wlo"),
                      ("max", "facts.w", "whi"), ("sum", "facts.v", "s")])
           .build())
    join = (Q.scan("facts")
            .join(Q.scan("dims"), "facts.k2", "dims.k2").build())
    return ((agg, ["facts.k1", "facts.k2", "agg.n", "agg.lo", "agg.hi",
                   "agg.wlo", "agg.whi", "agg.s"]),
            (join, ["facts.fid", "dims.weight"]))


def _tier_run(db, plan, cols, impl, mesh):
    from repro_torch.engine import Executor
    from repro_torch.semantic import OracleBackend, SemanticRunner

    ex = Executor(db, SemanticRunner(OracleBackend(truths={})),
                  kernel_impl=impl, mesh=mesh)
    table, stats = ex.execute(plan)
    rows = db.materialize(table, cols)
    # NaN as a string, -0.0 apart from +0.0: the comparison is exact
    return [tuple(sorted(
        (k, "NaN" if isinstance(x, float) and x != x else
         (x, str(x)) if isinstance(x, float) else x)
        for k, x in r.items())) for r in rows], stats


def _check_tier(dev, mesh):
    # a fresh database per run: a base table's first use costs a fetch
    # (its valid count) that a reused one would not
    for plan, cols in _tier_plans():
        _build.reset_launches()
        got, st = _tier_run(_tier_db(dev), plan, cols, "auto", mesh)
        launches = dict(_build.LAUNCHES)
        plain, st_ref = _tier_run(_tier_db(dev), plan, cols, "ref", mesh)
        single, _ = _tier_run(_tier_db(dev), plan, cols, "auto", None)
        assert got == plain == single
        assert st.collective_ops == st_ref.collective_ops >= 1
        assert st.pipeline_syncs == st_ref.pipeline_syncs
        assert launches["shard_rank"] > 0 and launches["hash_rows"] > 0
        if plan.__class__.__name__ == "Aggregate":
            assert launches["segment_reduce"] > 0


@pytest.mark.cuda
def test_partitioned_tier_on_one_card_matches_plain_path(dev):
    """Four shards on one card: the partitioned aggregate (K5 per
    shard: NaN, signed zeros, int32 extremes) and join at ``auto``
    (K2, K10, K5) equal the ``ref`` path and the single-device run."""
    from repro_torch.sharding import make_data_mesh

    _check_tier(dev, make_data_mesh(4, devices=[dev] * 4))


@pytest.mark.cuda
def test_partitioned_tier_on_two_cards(dev):
    """A mesh over two distinct cards: the exchange takes the peer-copy
    path; the same equalities hold."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.sharding import make_data_mesh

    mesh = make_data_mesh(2)
    assert not mesh.shared
    _check_tier(dev, mesh)


# ------------------------------------- the model mesh's shard shapes (K7-K9)

@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", SC.MESH_CASES)
def test_ssd_chunk_kernel_at_mesh_shard_shapes(dev, b, s, h, p, n, chunk):
    """K9 on one data rank's rows of a full admission over a model mesh
    (mamba2-370m at (2, 2), hymba-1.5b at (2, 1) and under
    ``dp_over_tp``), as ``chip_smoke.py``'s ``serve_tp_ssm`` gives it."""
    g = torch.Generator(device=dev).manual_seed(b * 3 + h + n)
    x, dt, A, B, C = SC.case_inputs(b, s, h, p, n, chunk, g, dev)
    _build.reset_launches()
    got = t_ssd.ssd_chunk_kernel(x, dt, A, B, C, chunk=chunk)
    assert _build.LAUNCHES["ssd_chunk"] == 1
    tol = SC.tolerance(SC.cum_max(dt, A, chunk))
    for a, w in zip(got, ssd_chunk_ref(x, dt, A, B, C, chunk)):
        err = float((a - w).abs().max())
        assert err <= tol * max(1.0, float(w.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,S,d,window", AC.MESH_WINDOW_CASES)
def test_flash_attention_window_at_mesh_shard_shapes(dev, B, H, K, S, d,
                                                     window):
    """K7's window route on one position's rows of hymba-1.5b's
    admission (its 25 query heads over 5 KV heads whole: the hybrid
    runs over the data ranks)."""
    g = torch.Generator(device=dev).manual_seed(B + S)
    q, k, v = (torch.randn(B, S, n, d, generator=g, device=dev)
               .transpose(1, 2) for n in (H, K, K))
    _build.reset_launches()
    got = t_fa.flash_attention_kernel(q, k, v, causal=True, window=window)
    assert _build.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, causal=True, window=window)
    assert float((got - want).abs().max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,T,d,window", AC.MESH_RING_CASES)
def test_decode_attention_slot_mask_at_mesh_shard_shapes(dev, B, H, K, T,
                                                         d, window):
    """K8's slot mask on one position's rows of hymba-1.5b's first
    decode round: prefill wrote slots 0..127, each row decodes at its
    own position."""
    g = torch.Generator(device=dev).manual_seed(B + T)
    pos = torch.randint(0, 128, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    sp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    sp = torch.where(sp < 128, sp, torch.full_like(sp, -1)).contiguous()
    q, k, v = _decode_operands(g, B, H, K, T, d, dev)
    _build.reset_launches()
    got = t_dec.decode_attention_kernel(q, k, v, slot_pos=sp, pos=pos,
                                        window=window)
    assert _build.LAUNCHES["decode_attention"] == 1
    want = decode_attention_ref(q, k, v, slot_pos=sp, pos=pos,
                                window=window)
    assert float((got - want).abs().max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,S,d,prefix", AC.MESH_PREFIX_CASES)
def test_flash_attention_prefix_at_mesh_shard_shapes(dev, B, H, K, S, d,
                                                     prefix):
    """K7's prefix route (two calls) on one tensor-parallel rank's heads
    of paligemma-3b at (1, 2): 4 query heads over its one KV head."""
    from repro_torch.kernels.flash_attention.ops import prefix_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_prefix_ref)

    g = torch.Generator(device=dev).manual_seed(S + H)
    q, k, v = (torch.randn(B, S, n, d, generator=g, device=dev)
               .transpose(1, 2) for n in (H, K, K))
    _build.reset_launches()
    got = prefix_attention(q, k, v, prefix, impl="kernel")
    assert _build.LAUNCHES["flash_attention"] == 2
    assert float((got - attention_prefix_ref(q, k, v, prefix)).abs()
                 .max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,T,d", AC.MESH_CROSS_DECODE_CASES)
def test_decode_attention_cross_at_mesh_shard_shapes(dev, B, H, K, T, d):
    """K8's cross route (every encoder frame live) on one position's rows
    and heads of whisper-small at (1, 2) and under ``dp_over_tp``."""
    g = torch.Generator(device=dev).manual_seed(B + H)
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    q, k, v = _decode_operands(g, B, H, K, T, d, dev)
    _build.reset_launches()
    got = t_dec.decode_attention_kernel(q, k, v, lengths)
    assert _build.LAUNCHES["decode_attention"] == 1
    assert float((got - decode_attention_ref(q, k, v, lengths)).abs()
                 .max()) <= AC.TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("lo", (0, 33))
@pytest.mark.parametrize("B,H,K,T,d", AC.MESH_SEQ_DECODE_CASES)
def test_decode_attention_lse_at_mesh_seq_slices(dev, B, H, K, T, d, lo):
    """K8's log-sum-exp route on one rank's slice of a cache split over
    the sequence: every head over the slice's T slots, lengths
    clamp(pos + 1 - lo, 0, T) from rows whose position lies before the
    slice (nothing live: 0 and -inf, no NaN) to past it, against the
    plain version's output and lse; one launch under its own route."""
    g = torch.Generator(device=dev).manual_seed(B + T + lo)
    lengths = torch.tensor(AC.slice_lengths(B, T, lo), dtype=torch.int32,
                           device=dev)
    q, k, v = _decode_operands(g, B, H, K, T, d, dev)
    _build.reset_launches()
    out, lse = t_dec.decode_attention_kernel(q, k, v, lengths,
                                             return_lse=True)
    assert _build.LAUNCHES["decode_attention"] == 1
    assert [key[1] for key in _build.SHAPE_LAUNCHES] == ["lengths_lse"]
    want, wlse = decode_attention_ref(q, k, v, lengths, return_lse=True)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    assert float((out - want).abs().max()) <= AC.TOLERANCE
    live = lengths > 0
    assert float((lse[live] - wlse[live]).abs().max()) <= AC.TOLERANCE
    assert torch.isneginf(lse[~live]).all()
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    # the slot mask route with its log-sum-exp: the same slots live
    sp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    sp = torch.where(sp < lengths[:, None], sp, -1).contiguous()
    o2, l2 = t_dec.decode_attention_kernel(
        q, k, v, slot_pos=sp, pos=(lengths - 1).clamp(min=0), window=0,
        return_lse=True)
    assert float((o2 - want).abs().max()) <= AC.TOLERANCE
    assert float((l2[live] - wlse[live]).abs().max()) <= AC.TOLERANCE
    assert torch.isneginf(l2[~live]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mesh", (("starcoder2-3b", (1, 4)),
                                       ("starcoder2-3b", (2, 2)),
                                       ("deepseek-v3-671b", (1, 2))))
def test_mesh_serving_seq_kernel_path_matches_plain_path(dev, arch, mesh):
    """A model mesh of the card under ``shard_cache_seq`` (the caches
    split over the sequence): the kernel path (K7 on each rank's heads,
    K8's log-sum-exp route on each rank's slice, once per layer per
    position per round; MLA has no kernel) against the plain path, the
    same answers, and the single-device engine's."""
    from repro_torch.configs import get_tiny
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.params import shard_params
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding.policy import ShardingPolicy

    cfg = get_tiny(arch).replace(vocab_size=512)
    n = mesh[0] * mesh[1]
    params = _tree_to(init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"), dev)
    pol = ShardingPolicy.for_mesh(make_mesh(*mesh, devices=[dev] * n)
                                  ).replace(shard_cache_seq=True)
    sp = shard_params(cfg, params, pol)
    prompts = [f"card seq probe {i} " + "word " * (i % 11)
               for i in range(13)]
    kw = dict(batch_size=4, max_seq=24, max_new_tokens=3)
    impls = ("ref",) if cfg.use_mla else ("auto", "ref")
    out = {}
    for impl in impls:
        eng = ServingEngine(cfg, sp, attn_impl=impl, policy=pol, **kw)
        _build.reset_launches()
        out[impl] = eng.answer(prompts)
        if impl == "auto":
            assert _build.LAUNCHES["decode_attention"] == \
                cfg.num_layers * n * eng.stats.decode_steps
            assert {key[1] for key in _build.SHAPE_LAUNCHES
                    if key[0] == "decode_attention"} == {"lengths_lse"}
        else:
            assert not any(_build.LAUNCHES.values())
    one = ServingEngine(cfg, params, attn_impl="ref", **kw)
    assert all(a == one.answer(prompts) for a in out.values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mesh,rep", (
    ("mamba2-370m", (2, 2), {}), ("hymba-1.5b", (2, 1), {}),
    ("hymba-1.5b", (2, 2), {"dp_over_tp": True})))
def test_mesh_serving_ssm_kernel_path_matches_plain_path(dev, arch, mesh,
                                                         rep):
    """The SSM and the hybrid over a model mesh whose positions all lie
    on the card: K9 once per layer per data rank per admission (the
    SSM's tensor ranks share one call on the card), K7 and K8 (window,
    slot mask) once per layer per position, the same answers as the
    plain path; the mesh's prefill logits within 1e-4 of the card's one
    device."""
    from repro_torch.configs import get_tiny
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, prefill
    from repro_torch.models.params import shard_params
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding import model as sm
    from repro_torch.sharding.policy import ShardingPolicy

    cfg = get_tiny(arch).replace(vocab_size=512)
    n = mesh[0] * mesh[1]
    params = _tree_to(init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"), dev)
    pol = ShardingPolicy.for_mesh(make_mesh(*mesh, devices=[dev] * n)
                                  ).replace(**rep)
    g = sm.mesh_grid(pol)
    sp = shard_params(cfg, params, pol)
    prompts = [f"card mesh probe {i} " + "word " * (i % 11)
               for i in range(13)]
    out = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(cfg, sp, batch_size=4, max_seq=24,
                            max_new_tokens=3, attn_impl=impl, ssd_impl=impl,
                            policy=pol)
        _build.reset_launches()
        out[impl] = eng.answer(prompts)
        launches = dict(_build.LAUNCHES)
        want = dict.fromkeys(launches, 0)
        if impl == "auto":
            L, adm = cfg.num_layers, eng.stats.batches
            want["ssd_chunk"] = L * g.dp * adm
            if cfg.family == "hybrid":
                want.update(flash_attention=L * n * adm,
                            decode_attention=L * n
                            * eng.stats.decode_steps)
        assert launches == want
    assert out["auto"] == out["ref"]
    toks = torch.randint(1, cfg.vocab_size, (4, 24),
                         generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        got, _ = prefill(cfg, sp, {"tokens": toks}, max_seq=28, policy=pol)
        want, _ = prefill(cfg, params, {"tokens": toks}, max_seq=28)
    assert float((got - want).abs().max()) <= \
        1e-4 * float(want.abs().max())
