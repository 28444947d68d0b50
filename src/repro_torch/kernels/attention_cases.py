"""The sweep that holds K7 (flash attention) and K8 (decode attention)
to their plain versions on the card, and its tolerance: one copy for
the card tests and for ``chip_smoke.py``.

K8 splits the cache into chunks of ``DECODE_CHUNK`` positions, one
block each, and the last chunk of a (row, KV head) to arrive combines
the partial softmax states; its edges: lengths of C - 1, C and C + 1
(``chunk_lengths``), long_prefill's 4104-position lengths cache
(``LONG_CACHE``), a full 2048-slot ring (``FULL_RING``), rings whose
live chunks have dead ones between them (``gapped_ring``), and
``REPLAYS`` graph replays (``graph_replays``), which hold the arrival
counters' reset and that the output is the same from run to run."""
from __future__ import annotations

import torch

# K7: sequence lengths around its 64-row query tile and 32-key tile
SEQ_LENS = (1, 63, 64, 65, 128, 1000)
# both: query heads per KV head (MHA, a small group, starcoder2-3b's 12)
GROUPS = (1, 2, 12)
# the models' 64 and 128, and 36 and 80, which K7 zero-pads to its
# 16-column tiles
HEAD_DIMS = (36, 64, 80, 128)
# paligemma-3b's head_dim, which K7 and K8 take in instances of their own,
# at group 1 and at paligemma's group of 8 query heads over one KV head
WIDE_HEAD_DIM = 256
WIDE_GROUPS = (1, 8)
# K7 with queries and keys of different lengths, not causal: the whisper
# decoder's cross-attention (its prompt over 1500 encoder frames), at
# query counts around K7's 64-row tile and key counts around its 32-key
# tile and at whisper's
CROSS_QUERIES = (1, 32, 65)
CROSS_KEYS = (63, 1500)
# the VLM's prefix-LM mask, (S, prefix): paligemma's 256 image tokens
# before 32 text tokens, prefixes at and off K7's tiles, all image
PREFIX_CASES = ((288, 256), (65, 64), (100, 37), (16, 16))
# K8: cache lengths T (131 = the serve phase's max_seq + max_new + 1)
CACHE_LENS = (1, 131, 1000)
# K8's chunk: csrc/decode_attention.cu's kChunk, exported by the library
# as repro_decode_chunk()
DECODE_CHUNK = 64
# long_prefill's lengths cache (4096 prompt + 8 decode positions) and its
# ring of the hybrid's 2048-position window
LONG_CACHE = 4104
FULL_RING = 2048
REPLAYS = 200
# float32 sums over <= 1000 keys, taken in another order than the
# plain version's
TOLERANCE = 1e-4


def decode_lengths(T: int) -> list[int]:
    """Unequal per-row lengths for one K8 batch over a T-long cache:
    1, 2, T - 1 and T, those of them in [1, T]."""
    return sorted({1, 2, max(T - 1, 1), T} & set(range(1, T + 1)))
# K7's sliding window (causal), at a sequence it cuts many times over
WINDOWS = (1, 17, 64)
WINDOW_SEQ = 1000
# K8's slot mask over a ring cache of T = window slots
RING_WINDOWS = (16, 64)
# one model-mesh position's rows and heads at the full widths that
# chip_smoke.py serves (batch 16, 128-token prompts, 131-slot caches):
# hymba-1.5b's window route and slot mask at (2, 1) and at (2, 2) under
# dp_over_tp, (B, H, K, S or T, d, window); paligemma-3b's prefix route
# at (1, 2), (B, H, K, S, d, prefix); whisper-small's cross decode at
# (1, 2) and (2, 2) under dp_over_tp, (B, H, K, encoder frames, d)
MESH_WINDOW_CASES = ((8, 25, 5, 128, 64, 2048), (4, 25, 5, 128, 64, 2048))
MESH_RING_CASES = ((8, 25, 5, 131, 64, 2048), (4, 25, 5, 131, 64, 2048))
MESH_PREFIX_CASES = ((16, 4, 1, 288, 256, 256),)
MESH_CROSS_DECODE_CASES = ((16, 6, 6, 1500, 64), (4, 12, 12, 1500, 64))
# K8's log-sum-exp route on one tensor-parallel rank's slice of a cache
# split over the sequence (``shard_cache_seq``): every query head over
# every KV head, (B, H, K, slice, d) — starcoder2-3b's 131 slots over 4
# ranks (33), whisper-small's 64 over 2 (32), paligemma-3b's 304 over 2
# (152, three chunks)
MESH_SEQ_DECODE_CASES = ((16, 24, 2, 33, 128), (16, 12, 12, 32, 64),
                         (16, 8, 1, 152, 256))


def slice_lengths(B: int, n: int, lo: int) -> list[int]:
    """K8's lengths clamp(pos + 1 - lo, 0, n) for B rows of a slice of
    n slots starting at ``lo``, their positions spread from before the
    slice (empty rows) to past its end (full ones)."""
    a, b = max(lo - 4, 0), lo + n + 4
    return [min(max(a + (b - a) * i // max(B - 1, 1) + 1 - lo, 0), n)
            for i in range(B)]


def ring_rows(W: int) -> list[tuple[int, int]]:
    """(prefilled length S, decode position pos) of the rows of one K8
    ring batch over a W-slot cache: a ring wrapped once and decoding on,
    a short prompt behind a wrapped padded prefill (every prefilled
    entry above pos: only the slot it writes is live), a decode far past
    the wrap, a nearly empty ring (-1 entries) and an unwrapped one."""
    return [(W + 5, W + 4), (2 * W + 3, 3), (W, 3 * W + 7), (1, 0),
            (W // 2, W // 2 - 1)]


def ring_slot_pos(W: int, rows) -> list[list[int]]:
    """``slot_pos`` of a W-slot ring after each row's prefill of S
    positions (the last W at slot p % W) and its decode write at
    ``pos`` (slot pos % W), as the hybrid model leaves it."""
    out = []
    for S, pos in rows:
        sp = [-1] * W
        for p in range(max(S - W, 0), S):
            sp[p % W] = p
        sp[pos % W] = pos
        out.append(sp)
    return out


def chunk_lengths(T: int, chunk: int = DECODE_CHUNK) -> list[int]:
    """Per-row lengths at K8's chunk edges over a T-long cache: C - 1,
    C, C + 1, 2C + 1 and T, those of them in [1, T]."""
    want = {chunk - 1, chunk, chunk + 1, 2 * chunk + 1, T}
    return sorted(x for x in want if 1 <= x <= T)


def full_ring(W: int = FULL_RING) -> tuple[list[int], int]:
    """(slot_pos, pos) of a W-slot ring wrapped three times: every slot
    live, slot t holding the position of the last write at t."""
    pos = 3 * W + 7
    return [pos - (pos - t) % W for t in range(W)], pos


def gapped_ring(chunk: int = DECODE_CHUNK) -> tuple[list[list[int]],
                                                     list[int], int]:
    """(slot_pos rows, pos, window) of a ring of 4 chunks whose live
    chunks have dead ones between them: chunks 0 and 3 live, 1 and 2
    empty (-1); chunk 1 live, the others holding positions above pos;
    chunk 2 alone dead, its positions too old for the window; one live
    slot, the last."""
    W = 4 * chunk
    pos = 10 * W + 3
    live = [pos - (W - 1 - t) for t in range(W)]

    def row(keep, dead):
        return [live[t] if t // chunk in keep else dead(t) for t in range(W)]

    rows = [row({0, 3}, lambda t: -1),
            row({1}, lambda t: pos + 1 + t),
            row({0, 1, 3}, lambda t: pos - W - t)]
    rows.append([-1] * (W - 1) + [pos])
    return rows, [pos] * len(rows), W


def graph_replays(kernel, xs, wants, replays: int = REPLAYS) -> int:
    """Capture ``kernel(*args)`` on static copies of ``xs[0]`` (a tuple
    of tensors) once, then replay the graph ``replays`` times, copying
    ``xs[k % len(xs)]`` in before replay k: each output within
    ``TOLERANCE`` of ``wants[k % len(xs)]`` and equal bit for bit to an
    eager call on the same inputs (the output does not depend on which
    block arrived last). Returns the replays compared."""
    static = [x.clone() for x in xs[0]]
    eager = [kernel(*x) for x in xs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*static)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(*static)
    for k in range(replays):
        j = k % len(xs)
        for s, x in zip(static, xs[j]):
            s.copy_(x)
        graph.replay()
        err = float((out - wants[j]).abs().max())
        if not err <= TOLERANCE or not torch.equal(out, eager[j]):
            raise AssertionError(f"graph replay {k}: max|diff| {err} from "
                                 f"the plain version, or not equal to an "
                                 f"eager call")
    return replays
