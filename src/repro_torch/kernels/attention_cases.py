"""The sweep that holds K7 (flash attention) and K8 (decode attention)
to their plain versions on the card, and its tolerance: one copy for
the card tests and for ``chip_smoke.py``."""
from __future__ import annotations

# K7: sequence lengths around its 64-row query tile and 32-key tile
SEQ_LENS = (1, 63, 64, 65, 128, 1000)
# both: query heads per KV head (MHA, a small group, starcoder2-3b's 12)
GROUPS = (1, 2, 12)
HEAD_DIMS = (64, 80, 128)
# K8: cache lengths T (131 = the serve phase's max_seq + max_new + 1)
CACHE_LENS = (1, 131, 1000)
# float32 sums over <= 1000 keys, taken in another order than the
# plain version's
TOLERANCE = 1e-4


def decode_lengths(T: int) -> list[int]:
    """Unequal per-row lengths for one K8 batch over a T-long cache:
    1, 2, T - 1 and T, those of them in [1, T]."""
    return sorted({1, 2, max(T - 1, 1), T} & set(range(1, T + 1)))
