"""The arithmetic of the two kernels redesigned on the look-back and the
one-launch reduction, emulated in numpy on the CPU and held to the
reference.

K3 (``csrc/group_build.cu`` on ``csrc/scan_lookback.cuh``): each tile of
8192 keys is 8 warp runs of 1024, each lane holding 4 consecutive keys
of each 128-key stripe. A key's predecessor comes from its own lane's
registers, from lane l - 1 of the same stripe (``__shfl_up_sync``), for
lane 0 from lane 31 of the stripe before, and only for a warp run's
first key from memory; the flags are scanned lane, warp and block-wise,
and each tile's exclusive prefix comes from a look-back over windows of
32 predecessors' status words, summing aggregates back to the nearest
inclusive prefix (here with a random mix of published aggregates and
prefixes). The emulation is held to the reference's Pallas
``group_boundaries_kernel`` in interpret mode and to the port's plain
``group_boundaries_ref``, over ``scan_cases.KEY_KINDS`` at sizes around
the tile.

K5 (``csrc/segment_reduce.cu``): min and max reduce one unsigned word
whose identity is 0 (an int32 key, for floats the order-preserving map
with NaN beyond ±inf, biased by ``^ 0x80000000`` for max and ``^
0x7fffffff`` for min) with atomicMax, first per block, then into the
memset output, and the last block decodes. Emulated over ±0.0, ±inf,
NaNs of several payloads and signs, denormals, ±FLT_MAX and the int32
extremes, and held to the reference's Pallas ``segment_reduce_kernel``
in interpret mode (a NaN as any NaN: the reference keeps the payload,
the port gives the canonical quiet NaN; a denormal as the zero of its
sign: the reference's CPU run flushes denormals to zero) and to the
port's plain ``segment_reduce_torch`` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hash_dedup.group_build import (  # noqa: E402
    group_boundaries_kernel,
)
from repro.kernels.segmented_reduce.segmented_reduce import (  # noqa: E402
    segment_reduce_kernel,
)
from repro_torch.kernels import reduce_cases as RD  # noqa: E402
from repro_torch.kernels import scan_cases as SCAN  # noqa: E402
from repro_torch.kernels.hash_dedup.ref import (  # noqa: E402
    group_boundaries_ref,
)
from repro_torch.kernels.segmented_reduce.ref import (  # noqa: E402
    segment_reduce_torch,
)

THREADS, ITEMS = SCAN.THREADS, SCAN.ITEMS
WARPS, ROUNDS = THREADS // 32, ITEMS // 4
WARP_RUN = 32 * ITEMS
TILE = THREADS * ITEMS
SIZES = (1, 127, 1023, 1025, TILE - 1, TILE, TILE + 1, 3 * TILE + 130,
         33 * TILE + 1)
FLAG_A, FLAG_P = 1, 2


# ------------------------------------------------------------------ K3

def k3_flags(keys: np.ndarray) -> np.ndarray:
    """The prologue: (tiles, warps, rounds, 32 lanes, 4) boundary flags,
    each key's predecessor wired as the kernel wires it."""
    n = len(keys)
    tiles = -(-n // TILE)
    v = np.zeros(tiles * TILE, np.int32)
    v[:n] = keys
    v = v.reshape(tiles, WARPS, ROUNDS, 32, 4)
    i = np.arange(tiles * TILE).reshape(v.shape)
    live = i < n
    # lane 0's predecessor for round 0: the key before the warp run
    run = i[:, :, 0, 0, 0]
    carry = np.where((run > 0) & (run <= n), np.concatenate(
        [[0], keys])[np.clip(run, 0, n)], 0)
    pred = np.empty(v.shape[:4], np.int32)
    for r in range(ROUNDS):
        up = np.roll(v[:, :, r, :, 3], 1, axis=-1)   # __shfl_up_sync
        up[..., 0] = carry                           # lane 0
        pred[:, :, r] = up
        carry = v[:, :, r, 31, 3]                    # lane 31's last
    b = np.empty(v.shape, bool)
    b[..., 0] = (i[..., 0] == 0) | (v[..., 0] != pred)
    b[..., 1:] = v[..., 1:] != v[..., :-1]
    return (b & live).astype(np.int32)


def look_back(status: np.ndarray, tile: int) -> int:
    """The exclusive prefix of ``tile`` from its predecessors' status
    words (flag, value), a window of 32 at a time as one warp reads
    them: lane l reads tile last - l, the lanes up to the nearest
    inclusive prefix are summed."""
    excl = 0
    last = tile - 1
    while True:
        t = last - np.arange(32)
        flags = np.where(t >= 0, status[np.maximum(t, 0), 0], FLAG_P)
        vals = np.where(t >= 0, status[np.maximum(t, 0), 1], 0)
        assert (flags >= FLAG_A).all()  # every predecessor published
        prefixes = np.flatnonzero(flags == FLAG_P)
        stop = prefixes[0] if len(prefixes) else 31
        excl += int(vals[:stop + 1].sum())
        if len(prefixes):
            return excl
        last -= 32


def k3_emulate(keys: np.ndarray, rng) -> tuple[np.ndarray, np.ndarray]:
    """K3's (bnd, gid) as the kernel computes them, tiles in order with
    each predecessor's status word either its aggregate or its
    inclusive prefix (chosen at random)."""
    n = len(keys)
    b = k3_flags(keys)
    incl = np.cumsum(b, axis=-1)                       # the lane's 4
    own = incl[..., 3]                                 # (t, w, r, 32)
    lane_ex = np.cumsum(own, axis=-1) - own            # warp scan
    stripe = own.sum(axis=-1)                          # (t, w, r)
    round_ex = np.cumsum(stripe, axis=-1) - stripe     # carry
    warp_tot = stripe.sum(axis=-1)                     # (t, w)
    warp_ex = np.cumsum(warp_tot, axis=-1) - warp_tot
    agg = warp_tot.sum(axis=-1)                        # (t,)
    tiles = len(agg)
    status = np.zeros((tiles, 2), np.int64)
    prefix = np.zeros(tiles, np.int64)
    for t in range(tiles):
        if t:
            prefix[t] = look_back(status, t)
        if rng.random() < 0.5:
            status[t] = (FLAG_A, agg[t])
        else:
            status[t] = (FLAG_P, prefix[t] + agg[t])
    v = (incl + lane_ex[..., None] + round_ex[..., None, None]
         + warp_ex[..., None, None, None]
         + prefix[:, None, None, None, None])
    gid = (v.reshape(-1)[:n] - 1).astype(np.int32)
    return b.reshape(-1)[:n], gid


def k3_pallas(keys: np.ndarray, block: int = 8192):
    """The reference kernel on all-valid rows, padded to a block with
    pads (key 0xFFFFFFFF, valid 0) that are sliced off."""
    n = len(keys)
    pad = (-n) % block
    sk = np.concatenate([keys.view(np.uint32),
                         np.full(pad, 0xFFFFFFFF, np.uint32)])
    valid = np.concatenate([np.ones(n, np.int32), np.zeros(pad, np.int32)])
    bnd, gid = group_boundaries_kernel(jnp.asarray(sk), jnp.asarray(valid),
                                       block_rows=block, interpret=True)
    return np.asarray(bnd)[:n], np.asarray(gid)[:n]


@pytest.mark.parametrize("n", SIZES)
def test_k3_lookback_emulation_matches_plain_version(n):
    rng = np.random.default_rng(n)
    gen = torch.Generator().manual_seed(n)
    for kind in SCAN.KEY_KINDS:
        keys = SCAN.make_keys(kind, n, gen, "cpu").numpy()
        bnd, gid = k3_emulate(keys, rng)
        pb, pg = group_boundaries_ref(torch.from_numpy(keys))
        np.testing.assert_array_equal(bnd, pb.numpy(), err_msg=kind)
        np.testing.assert_array_equal(gid, pg.numpy(), err_msg=kind)


# one Pallas call in interpret mode takes ~0.25 s: the sizes on either
# side of a tile edge and the many-tile look-back
@pytest.mark.parametrize("n", (TILE - 1, TILE + 1, 33 * TILE + 1))
def test_k3_lookback_emulation_matches_reference(n):
    rng = np.random.default_rng(n)
    gen = torch.Generator().manual_seed(n)
    for kind in SCAN.KEY_KINDS:
        keys = SCAN.make_keys(kind, n, gen, "cpu").numpy()
        bnd, gid = k3_emulate(keys, rng)
        rb, rg = k3_pallas(keys)
        np.testing.assert_array_equal(bnd, rb, err_msg=kind)
        np.testing.assert_array_equal(gid, rg, err_msg=kind)


# ------------------------------------------------------------------ K5

def k5_encode(bits: np.ndarray, op: str, is_float: bool) -> np.ndarray:
    """Raw int32 value bits -> the min/max accumulator words (uint32)."""
    key = bits.astype(np.int64)
    if is_float:
        nan = np.isnan(bits.view(np.float32))
        key = np.where(key >= 0, key, key ^ 0x7FFFFFFF)
        key = np.where(nan, -2**31 if op == "min" else 2**31 - 1, key)
    bias = 0x7FFFFFFF if op == "min" else 0x80000000
    return ((key & 0xFFFFFFFF) ^ bias).astype(np.uint32)


def k5_decode(w: np.ndarray, op: str, is_float: bool) -> np.ndarray:
    """Accumulator words -> the output's int32 bits."""
    bias = 0x7FFFFFFF if op == "min" else 0x80000000
    key = (w.astype(np.int64) ^ bias).astype(np.uint32).view(np.int32)
    if not is_float:
        return key
    k = key.astype(np.int64)
    bits = np.where(k >= 0, k, k ^ 0x7FFFFFFF)
    bits = np.where(k == (-2**31 if op == "min" else 2**31 - 1),
                    0x7FC00000, bits)
    bits = np.where(w == 0, 0x7F800000 if op == "min" else 0xFF800000, bits)
    return (bits & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def k5_emulate(bits: np.ndarray, ids: np.ndarray, g: int, op: str,
               is_float: bool, blocks: int) -> np.ndarray:
    """Per-block accumulators (atomicMax from the zero word), flushed
    where non-zero into the memset output, then decoded."""
    out = np.zeros(g, np.uint32)
    words = k5_encode(bits, op, is_float)
    for part in np.array_split(np.arange(len(ids)), blocks):
        s = ids[part]
        ok = (s >= 0) & (s < g)
        acc = np.zeros(g, np.uint32)
        np.maximum.at(acc, s[ok], words[part][ok])
        touched = acc != 0
        out[touched] = np.maximum(out[touched], acc[touched])
    return k5_decode(out, op, is_float)


def k5_pallas(values: np.ndarray, ids: np.ndarray, g: int, op: str):
    """The reference kernel, rows padded to its block with id -1 (never
    matched) and segments to its segment tile."""
    rows, segs = 256, 512
    pad = (-len(ids)) % rows
    v = np.concatenate([values, np.zeros(pad, values.dtype)])
    s = np.concatenate([ids, np.full(pad, -1, np.int32)])
    gp = g + (-g) % segs
    out = segment_reduce_kernel(jnp.asarray(v), jnp.asarray(s), gp, op=op,
                                block_rows=rows, block_segments=segs,
                                interpret=True)
    return np.asarray(out)[:g]


def k5_values(dtype, n: int, rng) -> np.ndarray:
    """Values of ``reduce_cases``' kinds: int32 over the whole range
    with the extremes planted, float32 with its special bit patterns."""
    pick = rng.random(n) < 0.2
    if dtype == np.int32:
        v = rng.integers(-2**31, 2**31, n).astype(np.int32)
        v[pick] = rng.choice(np.asarray([-2**31, 2**31 - 1], np.int32),
                             int(pick.sum()))
        return v
    v = (rng.standard_normal(n) * 100).astype(np.float32)
    special = np.asarray(RD.SPECIAL_BITS, np.int64).astype(np.int32)
    v[pick] = rng.choice(special, int(pick.sum())).view(np.float32)
    return v


def same_or_both_nan(got_bits: np.ndarray, want: np.ndarray) -> None:
    """``got_bits`` against the reference kernel's ``want``: a NaN as any
    NaN, and a denormal as the zero of its sign (the reference's CPU run
    flushes denormals to zero where it compares)."""
    if want.dtype == np.float32:
        denormal = (got_bits & 0x7F800000) == 0
        got_bits = np.where(denormal, got_bits & -2**31, got_bits)
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got_bits.view(np.float32)),
                                      nan)
        np.testing.assert_array_equal(got_bits[~nan],
                                      want.view(np.int32)[~nan])
    else:
        np.testing.assert_array_equal(got_bits, want)


@pytest.mark.parametrize("g", (1, 7, 120))
@pytest.mark.parametrize("dtype", (np.int32, np.float32))
@pytest.mark.parametrize("op", ("min", "max"))
def test_k5_encoding_matches_reference(op, dtype, g):
    rng = np.random.default_rng(g)
    n = 3000
    values = k5_values(dtype, n, rng)
    ids = rng.integers(-2, g + 2, n).astype(np.int32)  # some dropped
    if g > 2:
        ids[ids == 1] = 0  # segment 1 empty: the identity
    is_float = dtype == np.float32
    got = k5_emulate(values.view(np.int32), ids, g, op, is_float, blocks=5)
    same_or_both_nan(got, k5_pallas(values, ids, g, op))
    plain = segment_reduce_torch(torch.from_numpy(values),
                                 torch.from_numpy(ids), g, op)
    np.testing.assert_array_equal(got, plain.numpy().view(np.int32))
    if is_float:  # every NaN decodes to the canonical quiet NaN
        nan = np.isnan(got.view(np.float32))
        assert (got[nan] == 0x7FC00000).all()


def test_k5_special_values_order():
    """Every pair of special values in one segment, each order: the
    words' max is the reference's min or max."""
    special = np.asarray(RD.SPECIAL_BITS, np.int64).astype(np.int32)
    pairs = np.stack(np.meshgrid(special, special), -1).reshape(-1, 2)
    bits = pairs.reshape(-1)
    ids = np.repeat(np.arange(len(pairs), dtype=np.int32), 2)
    values = bits.view(np.float32)
    for op in ("min", "max"):
        got = k5_emulate(bits, ids, len(pairs), op, True, blocks=3)
        same_or_both_nan(got, k5_pallas(values, ids, len(pairs), op))
    ints = np.asarray([-2**31, -1, 0, 1, 2**31 - 1], np.int32)
    pairs = np.stack(np.meshgrid(ints, ints), -1).reshape(-1, 2)
    ids = np.repeat(np.arange(len(pairs), dtype=np.int32), 2)
    for op in ("min", "max"):
        got = k5_emulate(pairs.reshape(-1), ids, len(pairs), op, False,
                         blocks=2)
        same_or_both_nan(got, k5_pallas(pairs.reshape(-1), ids, len(pairs),
                                        op))


def test_k5_identity_is_the_zero_word():
    for op in ("min", "max"):
        for is_float in (False, True):
            empty = k5_decode(np.zeros(1, np.uint32), op, is_float)[0]
            if is_float:
                assert empty == np.float32(
                    np.inf if op == "min" else -np.inf).view(np.int32)
            else:
                assert empty == (2**31 - 1 if op == "min" else -2**31)
