"""The cases that hold K6 (the radix rank, a one-pass decoupled
look-back over per-bucket status words, ``csrc/radix_rank.cu``) to its
plain version bit for bit: one copy for the card tests and for
``chip_smoke.py``.

Sizes around the kernel's tile: one short of a tile, one tile, one past
it (the first look-back), 32 tiles and one (past two of a bucket's
16-word look-back windows) and 2^22 + 17 (the hash join's largest pass,
many waves, a ragged tail). Digits: all equal, uniform, skewed (half in
one bucket), uniform with one bucket left empty, and descending (each
bucket one run, the last bucket first). Bucket counts B in {1, 4, 7,
256, 1024}: one bucket, the partitioned tier's P = 4 (where K6 equals
K10), an odd count, the hash join's 8-bit digits and the kernel's
limit. Each case is repeated ``REPEATS`` times, since a fault of memory
ordering shows only now and then; a captured CUDA graph is replayed
``REPLAYS`` times on alternating inputs (each replay must reset the
scratch), and two calls run on two streams at once
(``scan_cases.graph_replays`` / ``two_streams`` over ``packed``
operands).
"""
from __future__ import annotations

import torch

# rows per tile: csrc/radix_rank.cu's kTile (8 warps x 32 lanes x 32
# rows); the library's repro_radix_rank_tiles(n) counts tiles of it
TILE = 8192
SIZES = (TILE - 1, TILE, TILE + 1, 32 * TILE + 1, 2**22 + 17)
KINDS = ("equal", "uniform", "skewed", "empty", "descending")
BUCKETS = (1, 4, 7, 256, 1024)
REPEATS = 20
REPLAYS = 200


def make_digits(kind: str, n: int, buckets: int, gen: torch.Generator,
                device) -> torch.Tensor:
    """(n,) int32 digits in [0, buckets) of the given kind."""
    def uniform(hi):
        return torch.randint(0, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)

    if kind == "equal":
        return torch.full((n,), buckets - 1, dtype=torch.int32,
                          device=device)
    if kind == "uniform":
        return uniform(buckets)
    if kind == "skewed":
        hot = torch.rand(n, generator=gen, device=device) < 0.5
        return torch.where(hot, buckets // 2, uniform(buckets)).to(
            torch.int32)
    if kind == "empty":
        # bucket buckets // 2 left empty (with one bucket, all in it)
        d = uniform(max(buckets - 1, 1))
        return torch.where(d >= buckets // 2, d + 1, d).clamp(
            max=buckets - 1).to(torch.int32)
    if kind == "descending":
        i = torch.arange(n, device=device, dtype=torch.int64)
        return (buckets - 1 - i * buckets // n).to(torch.int32)
    raise ValueError(f"unknown digit kind {kind!r}")


def exclusive_bases(digits: torch.Tensor, buckets: int) -> torch.Tensor:
    """(buckets,) int32 exclusive offsets of the buckets in order: the
    hash join's bases."""
    hist = torch.zeros(buckets, dtype=torch.int64, device=digits.device)
    hist.index_add_(0, digits.long(),
                    torch.ones_like(digits, dtype=torch.int64))
    return (torch.cumsum(hist, 0) - hist).to(torch.int32)


def packed(digits: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Digits and offsets in one tensor, so one static input carries
    both through ``scan_cases.graph_replays``/``two_streams``."""
    return torch.cat([digits, base])


def unpacking(kernel, n: int):
    """``kernel(digits, base)`` over a ``packed`` tensor of ``n``
    digits."""
    return lambda x: kernel(x[:n], x[n:])
