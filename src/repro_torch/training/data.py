"""The word-level hash tokenizer of the serving tier, copied from the
reference's ``training/data.py`` (``TokenStream`` and ``PromptStream``
wait for the training slice)."""
from __future__ import annotations

import numpy as np


class HashTokenizer:
    """Deterministic word-level hash tokenizer (no external vocab files).
    Reserves: 0 = PAD, 1 = BOS, 2 = YES, 3 = NO, 4 = SEP."""

    PAD, BOS, YES, NO, SEP = 0, 1, 2, 3, 4
    RESERVED = 8

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def token(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return self.RESERVED + h % (self.vocab_size - self.RESERVED)

    def encode(self, text: str, max_len: int) -> np.ndarray:
        ids = [self.BOS] + [self.token(w) for w in text.lower().split()]
        ids = ids[:max_len]
        out = np.zeros(max_len, dtype=np.int32)
        out[: len(ids)] = ids
        return out
