"""The port's partition family (``repro_torch.kernels.partition``: shard
routing, K10's plain version and wrapper, the three-impl ops) against
the reference's (``repro.kernels.partition``), bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.partition import ops as R  # noqa: E402
from repro.kernels.partition import ref as RR  # noqa: E402
from repro.kernels.util import pow2_bucket as ref_pow2_bucket  # noqa: E402

from repro_torch.kernels import partition_cases as PC  # noqa: E402
from repro_torch.kernels.partition import ops as P  # noqa: E402
from repro_torch.kernels.partition import ref as PR  # noqa: E402
from repro_torch.kernels.partition.partition import (  # noqa: E402
    MAX_SHARDS,
    shard_rank_kernel,
)
from repro_torch.kernels.sync import HOST_SYNCS  # noqa: E402
from repro_torch.kernels.util import pow2_bucket  # noqa: E402

SHARDS = (1, 2, 4, 8, 32)
U32_EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x9E3779B9,
                      12345, 2**16, 2**16 - 1], dtype=np.uint32)


def _hashes(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([U32_EDGES, h])


@pytest.mark.parametrize("p", SHARDS)
def test_shard_of_matches_reference(p):
    h = _hashes(seed=p)
    want = np.asarray(RR.shard_of_ref(jnp.asarray(h), p))
    np.testing.assert_array_equal(want, RR.shard_of_np(h, p))
    got_np = PR.shard_of_np(h, p)
    assert got_np.dtype == np.int32
    np.testing.assert_array_equal(got_np, want)
    # uint32 tensors and int32 tensors holding the same bits
    for t in (torch.from_numpy(h.view(np.int32)),
              torch.from_numpy(h.view(np.int32)).view(torch.uint32)):
        got = PR.shard_of_torch(t, p)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", (0, 3, 6, 48))
def test_shard_bits_rejects_non_powers_of_two(p):
    with pytest.raises(ValueError):
        PR.shard_bits(p)
    with pytest.raises(ValueError):
        RR.shard_bits(p)


def _skewed_dest(n, p, rng):
    d = rng.integers(0, p, n)
    d[rng.random(n) < 0.6] = p // 2
    return d.astype(np.int32)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("n", (1, 1023, 1024, 4097))
def test_shard_rank_matches_reference_kernel(n, p):
    rng = np.random.default_rng(100 * n + p)
    dest = _skewed_dest(n, p, rng)
    base = (np.arange(p) * n).astype(np.int32)
    want = np.asarray(R.shard_rank(jnp.asarray(dest), jnp.asarray(base),
                                   n_shards=p, impl="interpret"))
    np.testing.assert_array_equal(RR.shard_rank_np(dest, base, p), want)
    np.testing.assert_array_equal(PR.shard_rank_np(dest, base, p), want)
    td, tb = torch.from_numpy(dest), torch.from_numpy(base)
    np.testing.assert_array_equal(PR.shard_rank_torch(td, tb, p).numpy(),
                                  want)
    np.testing.assert_array_equal(shard_rank_kernel(td, tb).numpy(), want)
    for impl in ("ref", "kernel", "auto"):
        got = P.shard_rank(td, tb, n_shards=p, impl=impl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    HOST_SYNCS.reset()
    np.testing.assert_array_equal(
        P.shard_rank(dest, base, n_shards=p, impl="host"), want)
    assert HOST_SYNCS.host_fallbacks == {"shard_rank": 1}


def test_shard_rank_empty():
    """N = 0: the port returns an empty int32 rank; the reference's
    numpy oracle is the yardstick (its interpreted kernel cannot take
    an empty operand, which the tier never hands it)."""
    d = np.zeros(0, dtype=np.int32)
    b = np.zeros(4, dtype=np.int32)
    want = RR.shard_rank_np(d, b, 4)
    for impl in ("ref", "kernel"):
        got = P.shard_rank(torch.from_numpy(d), torch.from_numpy(b),
                           n_shards=4, impl=impl)
        assert got.shape == (0,) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(PR.shard_rank_np(d, b, 4), want)


@pytest.mark.parametrize("case", PC.sweep((1, 1025, 4097)),
                         ids=lambda c: "-".join(map(str, c)))
def test_partition_cases_plain_version_matches_oracle(case):
    """The card sweep's inputs, on the CPU: K10's plain version (what
    the wrapper takes for a CPU tensor) against the numpy oracle."""
    n, p, dkind, bkind = case
    gen = torch.Generator().manual_seed(n * 64 + p)
    dest = PC.dest_case(dkind, n, p, gen, "cpu")
    base = PC.base_case(bkind, dest, p, gen)
    assert int(dest.min()) >= 0 and int(dest.max()) < p
    got = shard_rank_kernel(dest, base)
    want = PR.shard_rank_np(dest.numpy(), base.numpy(), p)
    np.testing.assert_array_equal(got.numpy(), want)
    if bkind == "random":  # disjoint buckets: a permutation into room
        assert len(np.unique(want)) == n


def test_shard_rank_kernel_rejects_too_many_shards():
    d = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shard buckets"):
        shard_rank_kernel(d, torch.zeros(MAX_SHARDS * 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="offsets"):
        P.shard_rank(d, torch.zeros(3, dtype=torch.int32), n_shards=4,
                     impl="ref")


@pytest.mark.parametrize("c", (1, 2, 3))
@pytest.mark.parametrize("p", (1, 4, 32))
def test_shard_destinations_match_reference(p, c):
    rng = np.random.default_rng(7 * p + c)
    keys = rng.integers(-2**31, 2**31, (3000, c), dtype=np.int64)
    keys = keys.astype(np.int32)
    keys[:5] = np.array([[-2**31], [2**31 - 1], [0], [-1], [1]])
    want = np.asarray(R.shard_destinations(jnp.asarray(keys), p,
                                           impl="ref"))
    np.testing.assert_array_equal(
        np.asarray(R.shard_destinations(jnp.asarray(keys), p,
                                        impl="interpret")), want)
    for impl in ("ref", "kernel"):
        got = P.shard_destinations(torch.from_numpy(keys), p, impl=impl)
        np.testing.assert_array_equal(got.numpy(), want)
    HOST_SYNCS.reset()
    np.testing.assert_array_equal(
        P.shard_destinations(keys, p, impl="host"), want)
    assert HOST_SYNCS.host_fallbacks == {"shard_rank": 1}


def test_is_partitionable_matches_reference():
    cols = {
        "i32": (torch.zeros(3, dtype=torch.int32),
                jnp.zeros(3, dtype=jnp.int32)),
        "i16": (torch.zeros(3, dtype=torch.int16),
                jnp.zeros(3, dtype=jnp.int16)),
        "bool": (torch.zeros(3, dtype=torch.bool),
                 jnp.zeros(3, dtype=bool)),
        "u8": (torch.zeros(3, dtype=torch.uint8),
               jnp.zeros(3, dtype=jnp.uint8)),
        "f32": (torch.zeros(3, dtype=torch.float32),
                jnp.zeros(3, dtype=jnp.float32)),
        "host_i32": (np.zeros(3, dtype=np.int32),
                     np.zeros(3, dtype=np.int32)),
        "host_str": (np.asarray(["a"]), np.asarray(["a"])),
    }
    for name, (port_col, ref_col) in cols.items():
        assert P.is_partitionable(port_col) == R.is_partitionable(ref_col), \
            name
    assert P.is_partitionable(cols["i32"][0])
    assert not P.is_partitionable(cols["f32"][0])


@pytest.mark.parametrize("floor", (1, 256, 512, 1024))
def test_pow2_bucket_matches_reference(floor):
    for n in (0, 1, 2, 3, 255, 256, 257, 1000, 1024, 1025, 2**20 + 1):
        assert pow2_bucket(n, floor) == ref_pow2_bucket(n, floor)
