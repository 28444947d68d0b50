"""Semantic backends: the ℳ in SF_φ(R) = {r | ℳ(r, φ)}.

* ``OracleBackend`` — deterministic ground-truth evaluator over the
  synthetic generator's latent attributes, with an optional per-prompt
  borderline-flip rate ε that models LLM non-determinism (paper §7
  attributes its F1≈0.85 gap to exactly this). Flips are a deterministic
  hash of (prompt, seed): re-evaluating the same prompt in one run gives
  the same answer (like function caching would enforce anyway), but
  *different runs/placements* sample independent flips — reproducing the
  paper's observation that even semantics-preserving rewrites show F1 < 1
  against a separate execution.

The reference's ``ModelBackend`` (a language model served through the
serving tier) waits for the port's LLM slice.

Backends count invocations so benchmarks can report C_LLM exactly.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence


class Backend:
    """Interface: evaluate a batch of rendered prompts.

    ``preferred_batch_rows`` is an optional dispatch-size hint: when set,
    ``SemanticRunner`` streams distinct misses to ``evaluate_batch`` in
    chunks of at most this many prompts (aligned with the serving tier's
    bucket size) instead of one monolithic batch.

    ``supports_async`` marks backends that additionally implement the
    ticket protocol (``submit_batch`` / ``collect``): the runner then
    submits every chunk up front — so rendering/encoding chunk k+1
    overlaps the engine's device work on chunk k — and collects all
    results at the end. Sync backends keep the chunked
    ``evaluate_batch`` shape.
    """

    calls: int
    preferred_batch_rows: Optional[int] = None
    supports_async: bool = False

    def evaluate_batch(self, prompts: Sequence[str],
                       contexts: Sequence[dict]) -> list[object]:
        raise NotImplementedError

    def reset_counters(self) -> None:
        self.calls = 0


def _stable_unit(prompt: str, seed: int) -> float:
    h = hashlib.sha1(f"{seed}:{prompt}".encode()).digest()
    return int.from_bytes(h[:8], "little") / 2**64


@dataclass
class OracleBackend(Backend):
    """truths: phi template -> callable(ctx) -> bool|int|float|str where ctx
    maps table name -> payload row dict for the referenced tables."""

    truths: dict[str, Callable]
    noise: float = 0.0
    seed: int = 0
    calls: int = 0
    per_call_latency_s: float = 0.0  # simulated per-*batch-item* latency
    preferred_batch_rows: Optional[int] = None

    def evaluate_batch(self, prompts, contexts):
        out = []
        for prompt, ctx in zip(prompts, contexts):
            self.calls += 1
            phi = ctx["__phi__"]
            fn = self.truths.get(phi)
            if fn is None:
                raise KeyError(f"no ground-truth evaluator for phi={phi!r}")
            val = fn(ctx)
            if self.noise > 0.0 and isinstance(val, (bool,)):
                if _stable_unit(prompt, self.seed) < self.noise:
                    val = not val
            out.append(val)
        if self.per_call_latency_s > 0.0 and prompts:
            # simulate LLM latency in one sleep per batch (the items of
            # a batch are a single serving dispatch): C_LLM cost scales
            # with the number of prompts actually evaluated, which is
            # what makes cache-avoided calls visible in wall time
            time.sleep(self.per_call_latency_s * len(prompts))
        return out
