"""The cases that hold the one-pass look-back scans of
``csrc/scan_lookback.cuh`` (K1 prefix count, K3 group boundaries, K4
running segment ids) to their plain versions bit for bit: one copy for
the card tests and for ``chip_smoke.py``.

Sizes around the look-back's tile: one short of a tile, one tile, one
past it (the first look-back), 32 tiles and one (past one warp's window
of 32 predecessors) and 2^24 + 17 (many waves, a ragged tail). K1/K4
inputs: 0/1 flags, all zero, all one (the largest totals through every
look-back), small counts in [0, 4] and K4's marks (+k where k segments
start). K3's sorted keys (``KEY_KINDS``): runs that cross the 128-element
stripes, the 1024-element warp runs and the tile edges (the predecessor
from a neighbouring lane, from lane 31 of the round before, loaded
before the warp run, from another tile), a key change exactly at every
``8192 k``, all-equal keys, runs of INT32_MIN and INT32_MAX, strictly
increasing keys (every element a boundary) and random sorted keys. Each
look-back size is repeated ``REPEATS`` times, since a fault of memory
ordering shows only now and then; misaligned views start ``OFFSETS``
elements into a buffer; a captured CUDA graph is replayed ``REPLAYS``
times on alternating inputs (the scratch must be reset by each replay);
and two calls run on two streams at once.
"""
from __future__ import annotations

import torch

# csrc/scan_lookback.cuh's tile: threads a block and items a thread;
# TILE (its kTile) is exported by the library as repro_lookback_tile()
THREADS, ITEMS = 256, 32
TILE = THREADS * ITEMS
SIZES = (TILE - 1, TILE, TILE + 1, 32 * TILE + 1, 2**24 + 17)
KINDS = ("flags", "zeros", "ones", "small", "marks")
KEY_KINDS = ("stripe_runs", "warp_runs", "tile_runs", "tile_changes",
             "equal", "extremes", "increasing", "random")
OFFSETS = (1, 2, 3)
REPEATS = 50
REPLAYS = 200


def make_input(kind: str, n: int, gen: torch.Generator,
               device) -> torch.Tensor:
    """(n,) int32 input of the given kind."""
    if kind == "flags":
        return torch.randint(0, 2, (n,), generator=gen, device=device,
                             dtype=torch.int32)
    if kind == "zeros":
        return torch.zeros(n, dtype=torch.int32, device=device)
    if kind == "ones":
        return torch.ones(n, dtype=torch.int32, device=device)
    if kind == "small":
        return torch.randint(0, 5, (n,), generator=gen, device=device,
                             dtype=torch.int32)
    if kind == "marks":
        # segments of 0-3 rows: empty ones stack on the next start
        counts = torch.randint(0, 4, (n // 2 + 1,), generator=gen,
                               device=device)
        starts = torch.cumsum(counts, 0) - counts
        marks = torch.zeros(n + 1, dtype=torch.int32, device=device)
        marks.index_add_(0, starts.clamp(max=n),
                         torch.ones_like(starts, dtype=torch.int32))
        return marks[:n].contiguous()
    raise ValueError(f"unknown input kind {kind!r}")


def make_keys(kind: str, n: int, gen: torch.Generator,
              device) -> torch.Tensor:
    """(n,) sorted int32 keys of the given kind (K3's input)."""
    i = torch.arange(n, device=device, dtype=torch.int64)
    if kind == "stripe_runs":  # runs of 100 from 37 rows in
        return ((i + 37) // 100).to(torch.int32)
    if kind == "warp_runs":  # runs of 1000 from 300 rows in
        return ((i + 300) // 1000).to(torch.int32)
    if kind == "tile_runs":  # runs of 9000 from 4000 rows in
        return ((i + 4000) // 9000 - 2**31).to(torch.int32)
    if kind == "tile_changes":  # a new key at every 8192 k
        return (i // TILE).to(torch.int32)
    if kind == "equal":
        return torch.full((n,), 7, dtype=torch.int32, device=device)
    if kind == "extremes":
        return torch.where(i < n // 3, -2**31,
                           torch.where(i < n // 2, 0, 2**31 - 1)
                           ).to(torch.int32)
    if kind == "increasing":
        return (i - n // 2).to(torch.int32)
    if kind == "random":
        return torch.sort(torch.randint(0, max(n // 4, 1), (n,),
                                        generator=gen, device=device,
                                        dtype=torch.int32))[0]
    raise ValueError(f"unknown key kind {kind!r}")


def boundaries(kernel):
    """K3's ``kernel(keys) -> (bnd, gid)`` as one tensor, for
    ``graph_replays``/``two_streams``."""
    return lambda x: torch.cat(kernel(x))


def misaligned(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous view equal to ``x`` that starts ``offset`` int32
    elements into a fresh buffer (not 16-byte aligned for offsets 1-3)."""
    buf = torch.zeros(x.shape[0] + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:]
    view.copy_(x)
    return view


def graph_replays(kernel, xs, wants, replays: int = REPLAYS) -> int:
    """Capture ``kernel`` on a static input once, then replay the graph
    ``replays`` times, copying ``xs[k % len(xs)]`` into the input before
    replay k and comparing the output with ``wants[k % len(xs)]``.
    Returns the number of replays compared; raises at the first that
    differs."""
    static = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(static)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(static)
    for k in range(replays):
        j = k % len(xs)
        static.copy_(xs[j])
        graph.replay()
        if not torch.equal(out, wants[j]):
            raise AssertionError(f"graph replay {k} differs from the plain "
                                 f"version")
    return replays


def two_streams(kernel, xs, wants) -> int:
    """Run ``kernel`` on each of ``xs`` at once, each on its own stream,
    and compare each output with its ``wants``. Returns the calls
    compared."""
    cur = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in xs]
    outs = []
    for s, x in zip(streams, xs):
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            outs.append(kernel(x))
    for s in streams:
        cur.wait_stream(s)
    for k, (got, want) in enumerate(zip(outs, wants)):
        if not torch.equal(got, want):
            raise AssertionError(f"stream {k} differs from the plain version")
    return len(xs)
