"""The port's four kernels (K1 prefix count, K2 FNV-1a row hash, K3
group boundaries, K4 running segment ids) against the reference's
Pallas kernels run in interpret mode and against the numpy oracles.

On the CPU every wrapper takes its plain PyTorch version, so these
tests hold the plain versions bit for bit. The CUDA kernels themselves
are held against the plain versions by ``tests/test_torch_cuda.py``
(no JAX import, so it runs on the card) and by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.compact.compact import prefix_count_kernel  # noqa: E402
from repro.kernels.expand.expand import (  # noqa: E402
    running_segment_ids_kernel,
)
from repro.kernels.hash_dedup.group_build import (  # noqa: E402
    group_boundaries_kernel,
)
from repro.kernels.hash_dedup.hash_dedup import hash_rows_kernel  # noqa: E402
from repro.kernels.hash_dedup.ref import hash_rows_np  # noqa: E402
from repro_torch.kernels.compact import compact as t_compact  # noqa: E402
from repro_torch.kernels.compact.ref import prefix_count_torch  # noqa: E402
from repro_torch.kernels.expand import expand as t_expand  # noqa: E402
from repro_torch.kernels.expand.ref import (  # noqa: E402
    running_segment_ids_torch,
)
from repro_torch.kernels.hash_dedup import group_build as t_gb  # noqa: E402
from repro_torch.kernels.hash_dedup import hash_dedup as t_hash  # noqa: E402
from repro_torch.kernels.hash_dedup import ops as t_ops  # noqa: E402
from repro_torch.kernels.hash_dedup.ref import (  # noqa: E402
    group_boundaries_ref,
    hash_rows_ref,
)
from repro_torch.kernels import scan_cases as SCAN  # noqa: E402
from repro_torch.kernels.util import (  # noqa: E402
    check_int32_domain,
    resolve_impl,
)
from test_torch_cuda import k3_cases, marks_from_counts  # noqa: E402

INT32_MAX = 2**31 - 1
# with one short of, one and one past the look-back scan's tile (K1, K4)
SIZES = (0, 1, 1023, 1024, 1025, SCAN.TILE - 1, SCAN.TILE, SCAN.TILE + 1,
         65537, 2**16 + 3)
BLOCK = 1024


def _pad(a: np.ndarray, value=0) -> np.ndarray:
    """Pad axis 0 to a BLOCK multiple, as the reference's ops.py does
    before calling a Pallas kernel."""
    pad = (-a.shape[0]) % BLOCK
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, widths, constant_values=value)


def _interpret(fn, *arrays, n: int, pads=()):
    """Run a reference Pallas kernel in interpret mode on padded inputs
    and slice the real rows back out (tuple outputs too)."""
    if n == 0:
        return None
    padded = [jnp.asarray(_pad(a, *p)) for a, p in
              zip(arrays, pads or [()] * len(arrays))]
    out = fn(*padded, block_rows=BLOCK, interpret=True)
    if isinstance(out, (list, tuple)):
        return tuple(np.asarray(o)[:n] for o in out)
    return np.asarray(out)[:n]


def _np(t: "torch.Tensor") -> np.ndarray:
    return t.numpy()


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("n", SIZES)
def test_prefix_count_matches_pallas_and_numpy(n):
    rng = np.random.default_rng(n)
    for flags in (rng.integers(0, 2, n).astype(np.int32),
                  np.zeros(n, np.int32), np.ones(n, np.int32)):
        got = _np(prefix_count_torch(torch.from_numpy(flags)))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.cumsum(flags).astype(np.int32))
        ref = _interpret(prefix_count_kernel, flags, n=n)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
        # the CPU wrapper is the plain version
        np.testing.assert_array_equal(
            _np(t_compact.prefix_count_kernel(torch.from_numpy(flags))), got)


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("n", SIZES)
def test_running_segment_ids_match_pallas_and_numpy(n):
    rng = np.random.default_rng(100 + n)
    # k > 1 marks (empty segments stacking) and empty trailing segments
    counts = rng.integers(0, 4, max(n // 2, 1))
    counts[-3:] = 0
    marks = marks_from_counts(counts)
    t = len(marks)
    got = _np(running_segment_ids_torch(torch.from_numpy(marks)))
    assert got.dtype == np.int32
    want = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    ref = _interpret(running_segment_ids_kernel, marks, n=t)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        _np(t_expand.running_segment_ids_kernel(torch.from_numpy(marks))),
        got)


def test_running_segment_ids_multi_segment_marks():
    marks = np.array([3, 0, 1, 0, 0, 2, 1], dtype=np.int32)
    got = _np(running_segment_ids_torch(torch.from_numpy(marks)))
    np.testing.assert_array_equal(got, [2, 2, 3, 3, 3, 5, 6])


@pytest.mark.parametrize("kind", SCAN.KINDS)
@pytest.mark.parametrize("n", SCAN.SIZES[:4])
def test_scan_cases_match_pallas_and_numpy(n, kind):
    """The look-back sweep's input kinds at the sizes around its tile
    (2^24 + 17 runs on the card only) through the reference's K1 and K4
    Pallas kernels in interpret mode, the port's plain versions and
    numpy, so that what the card's sweep compares with is tied to the
    reference."""
    x = SCAN.make_input(kind, n, torch.Generator().manual_seed(n), "cpu")
    assert x.dtype == torch.int32 and x.shape == (n,)
    a = x.numpy()
    want = np.cumsum(a).astype(np.int32)
    got = _np(prefix_count_torch(x))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_interpret(prefix_count_kernel, a, n=n),
                                  got)
    got = _np(running_segment_ids_torch(x))
    np.testing.assert_array_equal(got, want - 1)
    np.testing.assert_array_equal(
        _interpret(running_segment_ids_kernel, a, n=n), got)


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("c", (1, 2, 3, 4))
@pytest.mark.parametrize("n", SIZES)
def test_hash_rows_match_pallas_and_numpy(n, c):
    rng = np.random.default_rng(1000 * c + n)
    keys = rng.integers(-2**31, 2**31, (n, c)).astype(np.int32)
    if n:
        keys[0] = -1
        keys[-1] = np.iinfo(np.int32).min
    got = _np(hash_rows_ref(torch.from_numpy(keys)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), hash_rows_np(keys))
    ref = _interpret(hash_rows_kernel, keys, n=n)
    if ref is not None:
        np.testing.assert_array_equal(got.view(np.uint32), ref)
    np.testing.assert_array_equal(
        _np(t_hash.hash_rows_kernel(torch.from_numpy(keys))), got)
    # the public op returns uint32, as the reference does
    pub = t_ops.hash_rows(torch.from_numpy(keys), impl="ref")
    assert pub.dtype == torch.uint32
    np.testing.assert_array_equal(pub.numpy(), hash_rows_np(keys))


def test_dedup_mask_matches_reference_semantics():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 5, (300, 2)).astype(np.int32)
    mask, h = t_ops.dedup_mask(torch.from_numpy(keys), impl="ref",
                               return_hashes=True)
    _, first = np.unique(keys, axis=0, return_index=True)
    want = np.zeros(len(keys), bool)
    want[first] = True
    np.testing.assert_array_equal(mask.numpy(), want)
    np.testing.assert_array_equal(h.numpy(), hash_rows_np(keys))


# ------------------------------------------------------------------ K3

def _k3_numpy(keys):
    prev = np.concatenate([keys[:1] ^ 1, keys[:-1]])
    bnd = (keys != prev).astype(np.int32)
    return bnd, (np.cumsum(bnd) - 1).astype(np.int32)


def _k3_pallas(keys):
    """The reference kernel on all-valid rows; its own pads (key
    0xFFFFFFFF, valid 0) fill the last block and are sliced off."""
    valid = np.ones(len(keys), np.int32)
    return _interpret(group_boundaries_kernel, keys.view(np.uint32), valid,
                      n=len(keys), pads=((0xFFFFFFFF,), (0,)))


@pytest.mark.parametrize("n", SIZES)
def test_group_boundaries_match_pallas_and_numpy(n):
    rng = np.random.default_rng(2000 + n)
    for keys in k3_cases(n, rng):
        bnd, gid = group_boundaries_ref(torch.from_numpy(keys))
        bnd, gid = _np(bnd), _np(gid)
        assert bnd.dtype == gid.dtype == np.int32
        want_b, want_g = _k3_numpy(keys)
        np.testing.assert_array_equal(bnd, want_b)
        np.testing.assert_array_equal(gid, want_g)
        ref = _k3_pallas(keys)
        if ref is not None:
            np.testing.assert_array_equal(bnd, ref[0])
            np.testing.assert_array_equal(gid, ref[1])
        kb, kg = t_gb.group_boundaries_kernel(torch.from_numpy(keys))
        np.testing.assert_array_equal(_np(kb), bnd)
        np.testing.assert_array_equal(_np(kg), gid)


def test_pad_rows_inherit_last_group_id():
    """The port has no pad rows: rows holding the reference's pad key
    INT32_MAX form one ordinary last group, as they do in the Pallas
    kernel when they are valid."""
    keys = np.array([1, 1, 5, 9, INT32_MAX, INT32_MAX], dtype=np.int32)
    bnd, gid = group_boundaries_ref(torch.from_numpy(keys))
    np.testing.assert_array_equal(bnd.numpy(), [1, 0, 1, 1, 1, 0])
    np.testing.assert_array_equal(gid.numpy(), [0, 0, 1, 2, 3, 3])
    ref = _k3_pallas(keys)
    np.testing.assert_array_equal(bnd.numpy(), ref[0])
    np.testing.assert_array_equal(gid.numpy(), ref[1])


# --------------------------------------------------------- impl resolution

def test_auto_resolves_to_the_fallback_on_cpu():
    t = torch.zeros(3)
    assert resolve_impl("auto", "host", t) == "host"
    assert resolve_impl("auto", "ref", t) == "ref"
    assert resolve_impl("auto", "ref", "cpu") == "ref"
    assert resolve_impl("kernel", "host", t) == "kernel"
    with pytest.raises(ValueError):
        resolve_impl("interpret", "host", t)


@pytest.mark.parametrize("cap,want", [((8, 0), None), ((8, 9), None),
                                      ((9, 0), "kernel"),
                                      ((10, 0), "kernel")])
def test_auto_on_a_cuda_device_is_the_kernel_or_raises(monkeypatch, cap,
                                                       want):
    """Data on a card never resolves to a fallback: Hopper and newer
    take the kernel, an older card raises."""
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: cap)
    dev = torch.device("cuda", 0)
    for fallback in ("host", "ref"):
        if want is None:
            with pytest.raises(RuntimeError, match="capability"):
                resolve_impl("auto", fallback, dev)
        else:
            assert resolve_impl("auto", fallback, dev) == want
        # an explicit token still passes through
        assert resolve_impl("host", fallback, dev) == "host"


def test_int32_domain_check_raises_on_cuda_only():
    check_int32_domain(2**30, torch.device("cuda", 0), "x")
    check_int32_domain(2**30 + 1, "cpu", "x")
    with pytest.raises(RuntimeError, match="int32"):
        check_int32_domain(2**30 + 1, torch.device("cuda", 0), "x")
