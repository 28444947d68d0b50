"""The serving tier's prompt encoding, a frozen copy of the port's
``HashTokenizer`` and ``ServingEngine.encode_row``: a BOS token, one
FNV-1a hashed id a lower-cased word, cut at ``max_seq`` tokens, the
last kept token replaced by SEP."""
from __future__ import annotations

PAD, BOS, YES, NO, SEP = 0, 1, 2, 3, 4
RESERVED = 8


def token(word: str, vocab: int) -> int:
    h = 2166136261
    for ch in word.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return RESERVED + h % (vocab - RESERVED)


def prompt_tokens(prompt: str, max_seq: int, vocab: int) -> list[int]:
    """The real (unpadded) token ids the engine prefills for
    ``prompt``."""
    text = prompt + " sep"
    ids = ([BOS] + [token(w, vocab) for w in text.lower().split()])
    ids = ids[:max_seq]
    ids[-1] = SEP
    return ids


def verdict(ids: list[int]) -> bool:
    """A boolean answer as the semantic tier parses it: YES iff the
    first served token is YES."""
    return bool(ids) and ids[0] == YES
