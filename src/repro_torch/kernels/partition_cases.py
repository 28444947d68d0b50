"""The sweep that holds K10 (the stable shard rank, a one-pass decoupled
look-back over per-bucket status words, ``csrc/shard_rank.cu``) to its
plain version bit for bit: one copy for the card tests and for
``chip_smoke.py``.

Shard counts P in {1, 2, 4, 8, 32} (32 is the kernel's limit: one warp
holds every bucket); destinations uniform over [0, P), all in one
bucket, or half in one bucket and the rest uniform; offsets
``arange(P) * N`` (the exchange's fixed-stride buckets, each with room
for every row) or random exclusive offsets (the buckets in a random
order, with random gaps between them).

Sizes around the kernel's tile: one short of a tile, one tile, one past
it (the first look-back), 33 tiles and one (past the 8 predecessors one
look-back window of 8 rows of 32 status words covers at P = 32) and
2^22 + 17 (the sharded e2e's source blocks: many waves, a ragged tail,
past the 256 predecessors a window covers at P = 1). Each case is
repeated ``REPEATS`` times, since a fault of memory ordering shows only
now and then; a captured CUDA graph is replayed ``REPLAYS`` times on
alternating inputs (each replay must reset the scratch), and two calls
run on two streams at once (``scan_cases.graph_replays`` /
``two_streams`` over ``radix_cases.packed`` operands).
"""
from __future__ import annotations

import torch

# rows per tile: csrc/shard_rank.cu's kTile (8 warps x 32 lanes x 32
# rows); the library's repro_shard_rank_tiles(n) counts tiles of it
TILE = 8192
SIZES = (TILE - 1, TILE, TILE + 1, 33 * TILE + 1, 2**22 + 17)
REPEATS = 20
REPLAYS = 200
SHARDS = (1, 2, 4, 8, 32)
DESTS = ("uniform", "one", "half")
BASES = ("blocks", "random")


def sweep(sizes) -> list[tuple[int, int, str, str]]:
    """Every (N, P, destinations, offsets) of the K10 sweep."""
    return [(n, p, d, b) for n in sizes for p in SHARDS for d in DESTS
            for b in BASES]


def dest_case(kind: str, n: int, p: int, gen: torch.Generator,
              device) -> torch.Tensor:
    """(n,) int32 destinations in [0, p) of the given kind."""
    uni = torch.randint(0, p, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    if kind == "uniform":
        return uni
    hot = p - 1
    if kind == "one":
        return torch.full((n,), hot, dtype=torch.int32, device=device)
    if kind == "half":
        pick = torch.rand(n, generator=gen, device=device) < 0.5
        return torch.where(pick, hot, uni).to(torch.int32)
    raise ValueError(f"unknown destination kind {kind!r}")


def base_case(kind: str, dest: torch.Tensor, p: int,
              gen: torch.Generator) -> torch.Tensor:
    """(p,) int32 exclusive bucket offsets of the given kind for
    ``dest``."""
    n, dev = dest.shape[0], dest.device
    if kind == "blocks":
        return torch.arange(p, dtype=torch.int32, device=dev) * n
    if kind != "random":
        raise ValueError(f"unknown offset kind {kind!r}")
    counts = torch.zeros(p, dtype=torch.int64, device=dev)
    counts.index_add_(0, dest.long(), torch.ones_like(dest, dtype=torch.int64))
    gaps = torch.randint(0, 64, (p,), generator=gen, device=dev)
    order = torch.randperm(p, generator=gen, device=dev)
    room = (counts + gaps)[order]
    base = torch.empty(p, dtype=torch.int64, device=dev)
    base[order] = torch.cumsum(room, 0) - room
    return base.to(torch.int32)
