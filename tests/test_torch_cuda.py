"""The port's CUDA kernels and the ops built on them, on the card: each
kernel bit-identical to its plain PyTorch version, each host-facing op
at ``impl="kernel"`` identical to its ``impl="host"`` numpy oracle, and
every launch counted. Imports neither JAX nor the reference, so it runs
where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA card of compute capability >= 9.0 and skips
itself elsewhere (``chip_smoke.py`` runs the same kernel checks). The
helpers ``marks_from_counts`` and ``k3_cases`` also feed the CPU tests
of ``tests/test_torch_kernels.py``."""
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
from repro_torch.kernels.segmented_reduce.ops import (  # noqa: E402
    join_match_lists,
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
                               "running_segment_ids": int(marks.numel() > 0)}


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
