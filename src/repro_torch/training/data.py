"""Step-addressable synthetic data and the word-level tokenizer, copied
from the reference's ``training/data.py`` (numpy, so both packages draw
the same batches).

``TokenStream(seed, ...)[step]`` is a pure function of (seed, step), so
a restarted worker resumes the exact batch schedule from a
checkpointed step — the determinism half of the fault-tolerance story
(the atomic checkpoint is the other half). Two generators:

* ``TokenStream`` — Zipf-ish synthetic LM tokens with structure (a
  copied span) so small models show decreasing loss;
* ``PromptStream`` — labelled YES/NO semantic-predicate prompts from
  the query-benchmark schemas, tokenized with ``HashTokenizer``; it
  trains the small semantic backend (``examples/torch_train_backend.py``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator

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


@dataclass
class TokenStream:
    """Batches of synthetic tokens, a pure function of (seed, step)."""

    vocab_size: int
    batch_size: int
    seq_len: int
    seed: int = 0

    def __getitem__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # mixture: random tokens + copied spans (learnable structure)
        toks = rng.integers(8, self.vocab_size,
                            size=(self.batch_size, self.seq_len),
                            dtype=np.int64)
        span = self.seq_len // 4
        if span > 1:
            toks[:, -span:] = toks[:, :span]  # copy task
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self[step]
            step += 1


@dataclass
class PromptStream:
    """Labelled prompts drawn from a Database's semantic predicates."""

    db: object  # repro_torch.engine.Database
    tokenizer: HashTokenizer
    batch_size: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        from ..semantic.runner import render_prompt

        self._examples: list[tuple[str, bool]] = []
        rng = np.random.default_rng(self.seed)
        phis = list(self.db.truths)
        for phi in phis:
            tables = sorted({c.split(".")[0] for c in
                             re.findall(r"\{(\w+)\.", phi)})
            if not all(t in self.db.payloads for t in tables):
                continue
            n = min(len(self.db.payloads[t]) for t in tables)
            for i in range(min(n, 400)):
                ctx = {t: self.db.payloads[t][i % len(self.db.payloads[t])]
                       for t in tables}
                prompt = render_prompt(phi, ctx)
                if prompt is None:
                    continue
                val = self.db.truths[phi](ctx)
                if isinstance(val, (bool, np.bool_)):
                    self._examples.append((prompt, bool(val)))
        rng.shuffle(self._examples)

    def __len__(self):
        return len(self._examples)

    def __getitem__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        idx = rng.integers(0, len(self._examples), size=self.batch_size)
        toks = np.zeros((self.batch_size, self.seq_len), dtype=np.int32)
        labels = np.zeros(self.batch_size, dtype=np.int32)
        for j, i in enumerate(idx):
            prompt, truth = self._examples[int(i)]
            enc = self.tokenizer.encode(prompt, self.seq_len - 2)
            n = int((enc != 0).sum())
            toks[j, :n] = enc[:n]
            toks[j, n] = self.tokenizer.SEP
            toks[j, n + 1] = (self.tokenizer.YES if truth
                              else self.tokenizer.NO)
            labels[j] = toks[j, n + 1]
        return {"tokens": toks, "labels": labels}
