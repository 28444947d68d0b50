"""The arithmetic of K10's one-pass look-back rank (``csrc/shard_rank.cu``),
emulated in numpy on the CPU and held to the reference.

Each tile of ``kTile`` rows is 8 warp runs, lane l of a warp holding rows
lo + 32 j + l of its run. Per 32 rows the lanes are grouped by bucket
(for P <= ``kPerBucketMax`` one ballot per bucket, above it one ballot
per key bit, rows without a bucket taking the key P: the same groups),
and each row keeps its rank among its run's rows of its bucket: the
bucket's count before the step plus the group's lanes below it. Tiles
are taken in order but advance in a random interleaving: each publishes
its per-bucket counts (flag A; tile 0 its prefixes, flag P), then looks
back one window at a time, warp w reading row w of 32 status words, lane
l bucket l % span of predecessor w * 32 / span + l / span back (span: P
rounded up to a power of two); a warp's row waits while a word it needs
(up to its bucket's nearest inclusive prefix in the row) is empty, sums
each bucket's lanes up to there with xor shuffles within the bucket, the
rows combine in order, and the tile publishes its prefixes (flag P). So
a look-back meets predecessors that have published nothing yet, only
their aggregates, or their prefixes, and at P >= 7 it steps past a
window. The kernel's constants are read from its source. The emulation
is held to the reference's Pallas ``shard_rank_kernel`` in interpret
mode and to the port's plain ``shard_rank_torch``, for P in {1, 2, 4, 7,
8, 32} (7: lanes of no bucket), uniform, one-bucket and half-hot
destinations, at sizes around the tile.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.partition.partition import (  # noqa: E402
    shard_rank_kernel,
)
from repro_torch.kernels import partition_cases as PC  # noqa: E402
from repro_torch.kernels.partition.ref import shard_rank_torch  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "csrc" / "shard_rank.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


THREADS, RUNS = _constant("kThreads"), _constant("kRuns")
WARPS = THREADS // 32
WINDOW = int(re.search(r"constexpr int kWindowWarps = (\w+);", SOURCE)[1]
             .replace("kWarps", str(WARPS)))
TILE = WARPS * 32 * RUNS
SIZES = (1, TILE - 1, TILE, TILE + 1, 33 * TILE + 1)
SHARDS = (1, 2, 4, 7, 8, 32)
FLAG_A, FLAG_P = 1, 2
LANES = np.arange(32)
POW = np.uint64(1) << LANES.astype(np.uint64)


def test_tile_is_the_cases_tile():
    assert TILE == PC.TILE


def ballot(pred: np.ndarray) -> np.ndarray:
    """(..., 32) bools -> (...,) uint32 masks, bit l from lane l."""
    return (pred.astype(np.uint64) * POW).sum(axis=-1).astype(np.uint32)


def popc(m: np.ndarray) -> np.ndarray:
    return np.bitwise_count(m).astype(np.int64)


def lowest(m: np.ndarray) -> np.ndarray:
    """The lowest set bit's index of each mask (-1 for none)."""
    m = m.astype(np.int64)
    return np.where(m == 0, -1, popc((m & -m) - 1))


def peers_of(key: np.ndarray, bits: int) -> np.ndarray:
    """(..., 32) keys -> (..., 32) masks of the lanes with an equal key,
    one ballot per key bit."""
    peers = np.full(key.shape, 0xFFFFFFFF, np.uint32)
    for i in range(bits):
        one = ((key >> i) & 1).astype(bool)
        s = ballot(one)[..., None]
        peers &= np.where(one, s, ~s)
    return peers


def count_ranks(d: np.ndarray, p: int):
    """(WARPS, RUNS, 32) destinations of one tile (-1 for none) -> each
    row's rank among its warp run's rows of its bucket, and the warps'
    (WARPS, p) bucket counts: per 32 rows the bucket's count before the
    step plus the row's rank among the step's lanes of its bucket (the
    peer masks from one ballot per key bit; one ballot per bucket gives
    the same groups)."""
    bits = int(p).bit_length()            # 32 - __clz(p)
    peers = peers_of(np.where(d >= 0, d, p), bits)
    wc = np.zeros((WARPS, p), np.int64)
    pre = np.zeros(d.shape, np.int64)
    below = (np.uint64(1) << LANES.astype(np.uint64)) - np.uint64(1)
    warps = np.arange(WARPS)[:, None]
    for j in range(RUNS):
        dj, pj = d[:, j], peers[:, j]
        lead = (dj >= 0) & (lowest(pj) == LANES)
        before = np.where(lead, wc[warps, np.maximum(dj, 0)], 0)
        # the shuffle from the group's lowest lane
        pre[:, j] = np.take_along_axis(before, lowest(pj), axis=1) + popc(
            (pj.astype(np.uint64) & below).astype(np.uint32))
        for w in range(WARPS):
            np.add.at(wc[w], dj[w][lead[w]], popc(pj[w][lead[w]]))
    return pre, wc


class LookBack:
    """The block's look-back of tile ``tile`` as a resumable state: each
    ``step`` reads one window, warp w < WINDOW row w of 32 status words,
    lane l bucket l % span of predecessor w * 32 / span + l / span back. A
    warp's row is ready when no word it needs (up to its bucket's nearest
    inclusive prefix in the row) is empty; the window waits for every
    row, then combines the rows in order, and ``step`` returns True when
    every bucket has found its nearest inclusive prefix."""

    def __init__(self, tile: int, p: int):
        shift = (p - 1).bit_length()      # 32 - __clz(p - 1)
        self.span, self.p = 1 << shift, p
        self.b = LANES & (self.span - 1)
        self.per_row = 32 >> shift
        self.ahead = (np.arange(WINDOW)[:, None] * self.per_row
                      + (LANES >> shift))
        group = 1
        s = self.span
        while s < 32:
            group |= group << s
            s <<= 1
        self.group = (np.uint64(group) << self.b.astype(np.uint64)
                      ).astype(np.uint32)
        self.done = self.b >= p           # per bucket of each lane
        self.excl = np.zeros(32, np.int64)
        self.last = tile - 1

    def step(self, status: np.ndarray) -> bool:
        while True:
            t = self.last - self.ahead                # (WARPS, 32)
            skip = self.done | (t < 0)
            ti = np.maximum(t, 0)
            bi = np.minimum(self.b, self.p - 1)
            flag = np.where(skip, FLAG_P, status[ti, bi, 0])
            val = np.where(skip, 0, status[ti, bi, 1])
            prefixes = ballot(flag >= FLAG_P)[:, None] & self.group
            stop = np.where(prefixes != 0, lowest(prefixes), 31)
            if (~self.done & (LANES <= stop) & (flag < FLAG_A)).any():
                return False              # poll: a word a row needs is empty
            v = np.where(~self.done & (LANES <= stop), val, 0)
            o = 16
            while o >= self.span:         # xor shuffles within a bucket
                v = v + v[:, LANES ^ o]
                o >>= 1
            found = prefixes != 0
            for lane in range(32):        # the rows in order, per bucket
                if self.done[lane]:
                    continue
                for r in range(WINDOW):
                    self.excl[lane] += v[r, self.b[lane]]
                    if found[r, self.b[lane]]:
                        self.done[lane] = True
                        break
            if self.done.all():
                return True
            self.last -= WINDOW * self.per_row


def emulate(dest: np.ndarray, base: np.ndarray, rng) -> np.ndarray:
    """K10's output for (dest, base), the tiles advancing in a random
    interleaving of at most a random number of resident blocks."""
    n, p = len(dest), len(base)
    tiles = -(-n // TILE)
    d = np.full(tiles * TILE, -1, np.int64)
    d[:n] = dest
    d = d.reshape(tiles, WARPS, RUNS, 32)
    status = np.zeros((tiles, p, 2), np.int64)   # (flag, value)
    out = np.full((tiles, WARPS, RUNS, 32), -1, np.int64)
    resident = int(rng.integers(1, 41))
    state, started = {}, 0
    while state or started < tiles:
        while started < tiles and len(state) < resident:
            state[started] = None                 # took the next tile
            started += 1
        t = int(rng.choice(list(state)))
        if state[t] is None:                      # counted; publish
            pre, wc = count_ranks(d[t], p)
            count = wc.sum(axis=0)
            status[t, :, 0] = FLAG_P if t == 0 else FLAG_A
            status[t, :, 1] = count
            state[t] = (pre, wc, count, LookBack(t, p) if t else None)
            continue
        pre, wc, count, lb = state[t]
        if lb is not None and not lb.step(status):
            continue                              # still waiting
        excl = lb.excl[:p] if lb is not None else np.zeros(p, np.int64)
        status[t, :, 0] = FLAG_P
        status[t, :, 1] = excl + count
        # the walk: lane b of each warp holds its first row of bucket b
        first = np.cumsum(wc, axis=0) - wc + base + excl     # (WARPS, p)
        at = np.take_along_axis(first, np.maximum(d[t], 0).reshape(
            WARPS, -1), axis=1).reshape(d[t].shape)
        out[t] = np.where(d[t] >= 0, at + pre, -1)
        del state[t]
    return out.reshape(-1)[:n].astype(np.int32)


@functools.partial(jax.jit, static_argnames="p")
def _pallas(dest, base, p):
    return shard_rank_kernel(dest, base, n_shards=p, block_rows=TILE,
                             interpret=True)


def reference(dest: np.ndarray, base: np.ndarray) -> np.ndarray:
    """The reference's Pallas kernel (interpret mode) over ``dest``
    padded to one length for every size, so each P compiles once: rows
    after the n-th change no rank before it."""
    padded = np.zeros(-(-SIZES[-1] // TILE) * TILE, np.int32)
    padded[:len(dest)] = dest
    out = _pallas(jnp.asarray(padded), jnp.asarray(base), len(base))
    return np.asarray(out)[:len(dest)]


def make_case(kind: str, n: int, p: int, rng):
    dest = rng.integers(0, p, n).astype(np.int32)
    if kind == "one":
        dest[:] = p - 1
    elif kind == "half":
        dest[rng.random(n) < 0.5] = p - 1
    counts = np.bincount(dest, minlength=p)
    room = counts + rng.integers(0, 64, p)
    order = rng.permutation(p)
    base = np.empty(p, np.int64)
    base[order] = np.cumsum(room[order]) - room[order]
    return dest, base.astype(np.int32)


@pytest.mark.parametrize("kind", ("uniform", "one", "half"))
@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("n", SIZES)
def test_lookback_rank_matches_reference(n, p, kind):
    rng = np.random.default_rng(1000 * n + 10 * p + len(kind))
    dest, base = make_case(kind, n, p, rng)
    want = reference(dest, base)
    got = emulate(dest, base, rng)
    np.testing.assert_array_equal(got, want)
    plain = shard_rank_torch(torch.from_numpy(dest), torch.from_numpy(base),
                             p)
    np.testing.assert_array_equal(plain.numpy(), want)
