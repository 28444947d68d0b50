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

* ``ModelBackend`` — answers prompts with the port's LM served through
  the serving tier (``repro_torch.serving.ServingEngine``: prefill +
  continuous decode, K7/K8 on the card).

Both count invocations so benchmarks can report C_LLM exactly.
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


class ModelBackend(Backend):
    """Wraps a callable ``answer_fn(prompts) -> list[str]`` (typically
    ``ServingEngine.answer``); parses YES/NO or integers out of the reply.

    Constructed via ``from_engine(engine)`` (the default, continuous
    mode) it also speaks the async ticket protocol: ``submit_batch``
    enqueues prompts on the engine's continuous scheduler — row weights
    become weighted-fair admission priorities — and returns once the
    admissions are queued on the device, ``collect`` drains the tickets
    and parses the answers. ``from_engine(engine, continuous=False)``
    keeps the drain-per-batch dispatch."""

    def __init__(self, answer_fn: Callable[[Sequence[str]], list[str]],
                 out_dtype: str = "bool",
                 preferred_batch_rows: Optional[int] = None,
                 engine=None):
        self.answer_fn = answer_fn
        self.out_dtype = out_dtype
        self.preferred_batch_rows = preferred_batch_rows
        self.engine = engine
        self.calls = 0

    @property
    def supports_async(self) -> bool:
        """Ticket protocol available iff a continuous engine is bound."""
        return self.engine is not None

    @classmethod
    def from_engine(cls, engine, out_dtype: str = "bool",
                    continuous: bool = True) -> "ModelBackend":
        """Wrap a ``ServingEngine``, inheriting its bucket-aligned
        dispatch size so runner chunks map onto whole serving batches.
        ``continuous=False`` pins the drained path."""
        if continuous:
            return cls(engine.answer, out_dtype=out_dtype,
                       preferred_batch_rows=getattr(
                           engine, "preferred_batch_rows", None),
                       engine=engine)
        return cls(engine.answer_drained, out_dtype=out_dtype,
                   preferred_batch_rows=getattr(
                       engine, "preferred_batch_rows", None))

    # ------------------------------------------------- async ticket API
    def submit_batch(self, prompts, contexts, weights=None):
        """Enqueue one chunk on the continuous scheduler; returns an
        opaque handle for ``collect``. Does not wait for the device."""
        prompts = list(prompts)
        self.calls += len(prompts)
        ticket = self.engine.submit(prompts, weights=weights)
        return ticket, list(contexts)

    def collect(self, handles):
        """Drain every submitted ticket and parse answers, in order."""
        out = []
        for ticket, ctxs in handles:
            self.engine.drain(ticket)
            raw = self.engine.answers(ticket)
            out.extend(self._parse(r, ctx) for r, ctx in zip(raw, ctxs))
        return out

    # ------------------------------------------------------ sync path
    def evaluate_batch(self, prompts, contexts):
        self.calls += len(prompts)
        raw = self.answer_fn(list(prompts))
        return [self._parse(r, ctx) for r, ctx in zip(raw, contexts)]

    def _parse(self, r, ctx):
        dtype = ctx.get("__dtype__", self.out_dtype)
        txt = (r or "").strip().upper()
        if dtype in ("bool",):
            return (txt.startswith("YES") or txt.startswith("TRUE")
                    or txt.startswith("1"))
        if dtype in ("int", "float"):
            num = ""
            for ch in txt:
                if ch.isdigit() or (ch == "-" and not num):
                    num += ch
                elif num:
                    break
            try:
                return int(num) if dtype == "int" else float(num)
            except ValueError:
                return 0
        return r
