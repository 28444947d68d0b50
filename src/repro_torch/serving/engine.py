"""Batched serving engine for semantic-operator backends (the
reference's ``src/repro/serving/engine.py``, on PyTorch).

The query tier hands the engine *distinct* prompts (function caching
already deduplicated them). Two serving disciplines share one set of
weights and one tokenizer:

* **Continuous** (the default, ``answer`` / ``submit`` / ``poll`` /
  ``drain``): a ``SlotScheduler`` admits queued prompts into freed
  slots *mid-decode* via per-slot prefill-into-cache, decodes over
  whatever slot mix is live, and detects completion on device — one
  host sync per scheduling round (site ``serving_round``) and one per
  admission batch, whose upload waits for the queued device work (site
  ``serving_admit``).
* **Drained** (``answer_drained``): the drain-per-batch baseline — pad
  each chunk to ``batch_size``, prefill, decode to completion with a
  per-step host fetch (site ``serving_decode``), only then admit the
  next chunk. The two paths are verdict-for-verdict identical.

An admission prefills its rows at the bucket width and the
admission's length (``prefill_len``): for a dense model on one device
the smallest multiple of 16 that holds the batch's longest prompt, for
every other model ``max_seq``. Rows are right-padded and a dense block
mixes positions only through causal attention, so the keys and values
at a row's real positions, its first token and its position do not
depend on the padding past them; decode reads cache positions up to
``pos`` only. A mixture of experts routes its padding and counts it in
its capacity, and padding reaches the SSM state and the hybrid's ring,
so there the padded positions are part of the reference's answer and
stay.

JAX's buffer donation becomes in-place updates of the shared cache and
slot state (``index_copy_`` on the slot axis; the SSM ``state`` and
``conv`` leaves travel along batch axis 1 like K/V). ``attn_impl``
picks the attention path of every layer and ``ssd_impl`` the SSD path
of the SSM/hybrid prefill (``models/layers.py``): on the card "auto" is
the K7/K8 and K9 kernels, "ref" the plain grouped einsum and
``ssd_chunked``; an engine with both "ref" launches no kernel. An MLA
configuration (deepseek-v3-671b) has one attention path, which "auto"
and "ref" both run (the reference computes MLA outside any Pallas
kernel); "kernel" is refused at construction.

Over a model-parallel mesh (``policy``; the dense, MoE, SSM and MLA
families, and the hybrid over the data axes or under ``dp_over_tp``):
the parameters come from ``models.params.shard_params``, the decode
cache is per shard (``init_cache(..., policy=)``: slots over the
data-parallel ranks, KV heads over the tensor-parallel ranks, MLA's
latent one tensor a device, or under ``shard_cache_seq`` the K/V and
latent positions over the tensor-parallel ranks; the SSM state and
conv tail and the hybrid's ring with their slots), each
admission's prefill rows go into the shards that hold their slots
(``sharding.model.insert_rows``), and the slot state and the gathered
logits stay on the mesh's first device, so the scheduler and the
semantic tier (``ModelBackend.from_engine``) run unchanged.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.table import resolve_device
from ..kernels.sync import HOST_SYNCS
from ..models import (
    check_supported,
    check_tokens_only,
    decode_step,
    prefill,
)
from ..models.config import ModelConfig
from ..models.layers import ATTN_IMPLS, check_mla_impl
from ..models.lm import _check_mesh as check_mesh
from ..sharding import model as sm
from ..sharding.policy import ShardingPolicy
from ..training.data import HashTokenizer
from .scheduler import SlotScheduler, Ticket


@dataclass
class ServingStats:
    """Serving-tier counters; one instance per engine, resettable."""

    prompts: int = 0
    batches: int = 0  # prefill launches (any width)
    prefill_tokens: int = 0  # real prompt tokens only, never padding
    prefill_positions: int = 0  # positions prefilled, padding included
    decode_steps: int = 0  # decode rounds (one device step each)
    wall_s: float = 0.0
    # --- slot occupancy ---
    prefill_rows: int = 0  # rows prefilled, incl. dead padded slots
    live_prefill_rows: int = 0  # rows that carried a real prompt
    slot_steps: int = 0  # batch_size × decode rounds
    live_slot_steps: int = 0  # slots decoding a live request
    decode_tokens: int = 0  # tokens emitted for live requests
    # --- queue latency / time-to-verdict ---
    queue_wait_s: float = 0.0  # total submit→admit wait
    queue_wait_max_s: float = 0.0
    queued_peak: int = 0
    ttv_s: list = field(default_factory=list)  # submit→done per request

    @property
    def occupancy(self) -> float:
        """Fraction of decode slot-steps spent on live requests."""
        return self.live_slot_steps / max(self.slot_steps, 1)

    @property
    def prefill_occupancy(self) -> float:
        """Fraction of prefilled rows that carried a real prompt."""
        return self.live_prefill_rows / max(self.prefill_rows, 1)

    @property
    def prefill_fill(self) -> float:
        """Fraction of prefilled positions that held a prompt token."""
        return self.prefill_tokens / max(self.prefill_positions, 1)

    def snapshot(self) -> dict:
        """JSON-ready view (ttv list summarized as count + p50/p99)."""
        ttv = sorted(self.ttv_s)

        def pct(q):
            if not ttv:
                return 0.0
            return ttv[min(len(ttv) - 1, int(q * (len(ttv) - 1)))]

        return {
            "prompts": self.prompts,
            "batches": self.batches,
            "prefill_tokens": self.prefill_tokens,
            "prefill_positions": self.prefill_positions,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "wall_s": self.wall_s,
            "occupancy": self.occupancy,
            "prefill_occupancy": self.prefill_occupancy,
            "prefill_fill": self.prefill_fill,
            "queue_wait_s": self.queue_wait_s,
            "queue_wait_max_s": self.queue_wait_max_s,
            "queued_peak": self.queued_peak,
            "ttv_p50_s": pct(0.50),
            "ttv_p99_s": pct(0.99),
        }


class ServingEngine:
    """One model, one cache, two serving disciplines (see module doc).
    ``params`` must already live on ``device`` (default the card; a
    missing card raises). Its device functions run without autograd,
    so weights that require grad (fresh from training) reach the
    kernels, which refuse grad mode, as plain inputs."""

    def __init__(self, cfg: ModelConfig, params,
                 tokenizer: Optional[HashTokenizer] = None,
                 batch_size: int = 16, max_seq: int = 128,
                 max_new_tokens: int = 2, device="cuda",
                 attn_impl: str = "auto", ssd_impl: str = "auto",
                 policy: Optional[ShardingPolicy] = None):
        check_supported(cfg)
        check_tokens_only(cfg, "ServingEngine")
        for name, impl in (("attn_impl", attn_impl), ("ssd_impl", ssd_impl)):
            if impl not in ATTN_IMPLS:
                raise ValueError(f"{name} must be one of {ATTN_IMPLS}, got "
                                 f"{impl!r}")
        if cfg.use_mla:
            check_mla_impl(attn_impl)
        self.cfg = cfg
        self.params = params
        self.policy = policy if sm.on_mesh(policy) else None
        if self.policy is not None:
            check_mesh(cfg, self.policy)
            if not isinstance(params.get("embed"), sm.Sharded):
                raise ValueError("ServingEngine: under a mesh policy the "
                                 "parameters must come from shard_params")
            self.device = sm.home_device(self.policy)
        else:
            self.device = resolve_device(device)
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
        self.tok = tokenizer or HashTokenizer(cfg.vocab_size)
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.max_new = max_new_tokens
        self.stats = ServingStats()
        self.cache_len = max_seq + max_new_tokens + 1
        # prefill only the admission's length (``prefill_len``): a dense
        # model on one device; every other model keeps max_seq
        self.trim_prefill = (self.policy is None and cfg.family == "dense"
                             and not cfg.num_experts and not cfg.use_mla
                             and not cfg.attn_window)
        # the length the next ``_prefill_insert`` prefills, set by the
        # scheduler from its host-side lengths (the packed upload keeps
        # its max_seq + 2 columns)
        self.admit_len = max_seq
        self.scheduler = SlotScheduler(self)

    @property
    def preferred_batch_rows(self) -> int:
        """Dispatch-size hint for the semantic tier: one upstream chunk
        fills a handful of serving batches."""
        return self.batch_size * 8

    def prefill_len(self, lengths) -> int:
        """Positions an admission of prompts of ``lengths`` real tokens
        prefills: the smallest multiple of 16 that holds the longest,
        at most ``max_seq``, where the prefill is position-local under
        right padding (``trim_prefill``: attention-only, no experts, no
        SSM state, no window ring, one device); else ``max_seq``. Under
        a mesh ``policy`` it is ``max_seq`` too: ``insert_rows`` and a
        cache split over the sequence are left as they are."""
        if not self.trim_prefill:
            return self.max_seq
        n = max(int(x) for x in lengths)
        return min(-(-n // 16) * 16, self.max_seq)

    # ------------------------------------------------- device functions
    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor):
        return prefill(self.cfg, self.params, {"tokens": tokens},
                       max_seq=self.cache_len, attn_impl=self.attn_impl,
                       ssd_impl=self.ssd_impl, policy=self.policy)

    @torch.no_grad()
    def _decode(self, cache, tok, pos):
        return decode_step(self.cfg, self.params, cache, tok, pos,
                           attn_impl=self.attn_impl, policy=self.policy)

    def _prefill_insert(self, cache, cur, pos, live, rem,
                        adm: torch.Tensor) -> None:
        """Per-slot prefill-into-cache: prefill at the admission width
        and length (``admit_len``, which it resets to ``max_seq``), then
        copy every cache leaf's rows (batch axis 1) and the slot state
        into the shared tensors at the assigned slots, in place; cache
        positions past the length hold zeros, which nothing reads.
        ``adm`` is the packed admission batch — ``max_seq`` token
        columns with the slot index and real length in the last two."""
        toks, slots, lens = adm[:, :-2], adm[:, -2].long(), adm[:, -1]
        n, self.admit_len = self.admit_len, self.max_seq
        _, new = self._prefill(toks[:, :n])
        width = toks.shape[0]
        for k, v in cache.items():
            if self.policy is None:
                v.index_copy_(1, slots, new[k])
            else:  # into the shards that hold the slots
                sm.insert_rows(v, new[k], slots, width,
                               sm.mesh_grid(self.policy))
        last = torch.clamp(lens - 1, min=0)
        first = toks[torch.arange(width, device=toks.device), last.long()]
        cur.index_copy_(0, slots, first)
        pos.index_copy_(0, slots, last)
        live.index_fill_(0, slots, True)
        rem.index_fill_(0, slots, self.max_new)

    def _decode_round(self, cache, cur, pos, live, rem) -> torch.Tensor:
        """One decode step over the live slot mix; done detection stays
        on device. Updates the slot state in place and returns the
        packed (emit ‖ finished) vector the caller fetches once."""
        logits, _ = self._decode(cache, cur, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        hit = (nxt == self.tok.YES) | (nxt == self.tok.NO)
        rem_new = torch.where(live, rem - 1, rem)
        fin = live & (hit | (rem_new <= 0))
        emit = torch.where(live, nxt, torch.full_like(nxt, -1))
        packed = torch.cat([emit, fin.to(torch.int32)])
        pos.copy_(torch.where(live, pos + 1, pos))
        cur.copy_(nxt)
        live.copy_(live & ~fin)
        rem.copy_(rem_new)
        return packed

    # --------------------------------------------------------- encoding
    def encode_row(self, prompt: str) -> tuple[np.ndarray, int]:
        """Encode one prompt to a SEP-terminated ``(max_seq,)`` row."""
        enc = self.tok.encode(prompt + " sep", self.max_seq)
        n = int((enc != 0).sum())
        # terminate with SEP so the model knows to answer
        enc[max(n - 1, 0)] = self.tok.SEP
        return enc, n

    def _encode_batch(self, prompts: Sequence[str]
                      ) -> tuple[np.ndarray, np.ndarray]:
        toks = np.zeros((self.batch_size, self.max_seq), dtype=np.int32)
        lens = np.ones(self.batch_size, dtype=np.int32)
        for i, p in enumerate(prompts):
            toks[i], lens[i] = self.encode_row(p)
        return toks, lens

    # ----------------------------------------------- continuous serving
    def submit(self, prompts: Sequence[str],
               weights: Optional[Sequence[float]] = None) -> Ticket:
        """Enqueue prompts on the continuous scheduler (optionally
        row-weighted for fair admission); returns a ``Ticket``."""
        return self.scheduler.submit(prompts, weights)

    def poll(self) -> int:
        """Run one scheduling round; returns outstanding requests."""
        return self.scheduler.poll()

    def drain(self, ticket: Optional[Ticket] = None) -> None:
        """Run rounds until ``ticket`` (or everything) completes."""
        self.scheduler.drain(ticket)

    def done(self, ticket: Ticket) -> bool:
        """True once every request of ``ticket`` has finished."""
        return self.scheduler.done(ticket)

    def answers(self, ticket: Ticket) -> list[str]:
        """Detokenized answers for a completed ticket, submit order."""
        return [self._detok(ids) for ids in self.scheduler.take(ticket)]

    def answer(self, prompts: Sequence[str]) -> list[str]:
        """Greedy-decode an answer per prompt — a thin submit-all /
        await-all wrapper over the continuous scheduler."""
        t0 = time.perf_counter()
        ticket = self.submit(prompts)
        self.drain(ticket)
        out = self.answers(ticket)
        self.stats.wall_s += time.perf_counter() - t0
        return out

    # -------------------------------------------------- drained serving
    def answer_drained(self, prompts: Sequence[str]) -> list[str]:
        """Drain-per-batch baseline: each fixed batch decodes to
        completion before the next is admitted."""
        t0 = time.perf_counter()
        out: list[str] = []
        for start in range(0, len(prompts), self.batch_size):
            chunk = list(prompts[start: start + self.batch_size])
            out.extend(self._answer_batch(chunk))
        self.stats.prompts += len(prompts)
        self.stats.wall_s += time.perf_counter() - t0
        return out

    def _answer_batch(self, chunk: list[str]) -> list[str]:
        toks, lens = self._encode_batch(chunk)
        t_in = time.perf_counter()
        self.stats.batches += 1
        # padded slots past len(chunk) are dead weight the drained
        # shape cannot avoid; count only real prompt tokens and report
        # the waste through the occupancy counters
        n = self.prefill_len(lens[:len(chunk)])
        self.stats.prefill_tokens += int(lens[:len(chunk)].sum())
        self.stats.prefill_positions += self.batch_size * n
        self.stats.prefill_rows += self.batch_size
        self.stats.live_prefill_rows += len(chunk)
        _, cache = self._prefill(torch.from_numpy(toks[:, :n]).to(
            self.device))
        answers = [[] for _ in chunk]
        # the first sampled token comes from each row's last real prompt
        # position: one decode step at pos = len - 1 re-derives it
        pos = torch.from_numpy(lens - 1).to(self.device)
        done = np.zeros(len(chunk), dtype=bool)
        cur = torch.from_numpy(
            toks[np.arange(self.batch_size),
                 np.maximum(lens - 1, 0)]).to(self.device)
        for _step in range(self.max_new + 1):
            logits, cache = self._decode(cache, cur, pos)
            self.stats.decode_steps += 1
            live = int((~done).sum())
            self.stats.slot_steps += self.batch_size
            self.stats.live_slot_steps += live
            self.stats.decode_tokens += live
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = cur.cpu().numpy()
            HOST_SYNCS.tick(site="serving_decode")  # per-STEP host sync
            pos = pos + 1
            # only live slots reach the host loop: finished sequences
            # and padded slots past len(chunk) are masked out entirely
            for i in np.nonzero(~done)[0]:
                answers[i].append(int(nxt[i]))
                if nxt[i] in (self.tok.YES, self.tok.NO) or \
                        len(answers[i]) >= self.max_new:
                    done[i] = True
            if done.all():
                break  # every live slot finished: recycle the batch
        ttv = time.perf_counter() - t_in
        self.stats.ttv_s.extend([ttv] * len(chunk))
        return [self._detok(a) for a in answers]

    def _detok(self, ids: list[int]) -> str:
        words = []
        for t in ids:
            if t == self.tok.YES:
                words.append("YES")
                break
            if t == self.tok.NO:
                words.append("NO")
                break
            words.append(f"<{t}>")
        return " ".join(words)
