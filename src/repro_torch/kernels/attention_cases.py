"""The sweep that holds K7 (flash attention) and K8 (decode attention)
to their plain versions on the card, and its tolerance: one copy for
the card tests and for ``chip_smoke.py``."""
from __future__ import annotations

# K7: sequence lengths around its 64-row query tile and 32-key tile
SEQ_LENS = (1, 63, 64, 65, 128, 1000)
# both: query heads per KV head (MHA, a small group, starcoder2-3b's 12)
GROUPS = (1, 2, 12)
# the models' 64 and 128, and 36 and 80, which K7 zero-pads to its
# 16-column tiles
HEAD_DIMS = (36, 64, 80, 128)
# K8: cache lengths T (131 = the serve phase's max_seq + max_new + 1)
CACHE_LENS = (1, 131, 1000)
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
