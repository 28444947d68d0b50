"""Continuous-batching slot scheduler: the serving tier's core loop
(the reference's ``src/repro/serving/scheduler.py``, on PyTorch).

``SlotScheduler`` keeps a request queue plus a slot table over ONE
shared decode cache:

* **submit** — prompts are encoded host-side, stamped with an arrival
  sequence number and a row weight, and pushed onto the admission queue
  (a heap ordered by the weighted-fair key ``seq / weight``, ties by
  arrival). Submission eagerly admits into any free slots, so the
  per-slot prefill is already queued on the device while the caller
  renders its next chunk (CUDA launches are asynchronous).
* **admit** — free slots are filled by binary decomposition over
  power-of-two admission widths (largest bucket ≤ min(free, queued)
  first), so a partial chunk never pays a full-batch prefill. Each
  admission batch travels as ONE packed host→device upload into the
  engine's ``_prefill_insert``: prefill at the bucket width, then copy
  the new K/V rows, first token, position, liveness and token budget
  into the shared state at the assigned slots, in place. The upload
  is a copy from pageable host memory, which waits for the work
  queued on the stream before it: a host sync, ticked as site
  ``serving_admit``.
* **round** — one decode step over whatever mix of slots is live. Done
  detection runs on the device (answer token or budget exhausted) and
  the round fetches a single packed (emit ‖ finished) vector — one
  device→host sync per scheduling round, ticked as site
  ``serving_round``. A finished sequence frees its slot mid-decode.

The tier's syncs are thus one per admission batch and one per round.
Both sites are in ``kernels.sync.SERVING_SITES``, so they count in
``ExecStats.serving_syncs`` and not in ``pipeline_syncs``.

Spans (``repro_torch.trace``, off unless a traced window turns them
on): ``serving.admit`` around each admission batch, with
``serving.admit.upload`` and ``serving.admit.prefill`` inside;
``serving.round`` around each round with live slots, with
``serving.round.launch`` (the decode step enqueued),
``serving.round.fetch`` and ``serving.round.harvest``; and one
``serving.request`` for each request finished, written from its
``t_submit``/``t_admit``/``t_done`` stamps, carrying the trace id of
the query that submitted it.

Fairness: admission order is ascending ``seq / weight`` (stable by
``seq``); equal weights are FIFO, and a request standing for ``w``
input rows is admitted as if it had arrived at ``seq / w``.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.sync import HOST_SYNCS
from ..models import init_cache
from ..trace import RECORDER, span


@dataclass
class Request:
    """One queued/served prompt and its lifecycle timestamps."""

    rid: int
    prompt: str
    tokens: np.ndarray  # (max_seq,) int32, SEP-terminated
    length: int  # real token count (pos starts at length - 1)
    weight: float = 1.0
    seq: int = 0  # arrival order (fairness tie-break)
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_done: Optional[float] = None
    out_ids: list = field(default_factory=list)
    trace: int = 0  # the submitting query's trace id (0: none recorded)

    @property
    def vkey(self) -> tuple[float, int]:
        """Weighted-fair admission key: ascending ``seq / weight``,
        stable by arrival sequence."""
        return (self.seq / max(self.weight, 1e-9), self.seq)


@dataclass(frozen=True)
class Ticket:
    """Handle for a submitted batch; resolves in submit order."""

    rids: tuple[int, ...]


class SlotScheduler:
    """Request queue + slot table over the engine's shared decode
    cache. The engine provides the device functions
    (``_prefill_insert``, ``_decode_round``), the tokenizer/shape
    parameters and the ``ServingStats`` this scheduler accounts into.
    The slot state (``cache``, ``cur``, ``pos``, ``live``, ``rem``)
    lives on the engine's device and is updated in place.
    """

    def __init__(self, engine):
        self.engine = engine
        b = engine.batch_size
        dev = engine.device
        # admission widths: power-of-two buckets ≤ batch_size, largest
        # first
        self.buckets = []
        w = 1
        while w <= b:
            self.buckets.append(w)
            w *= 2
        self.buckets.reverse()
        self._queue: list[tuple[tuple[float, int], Request]] = []
        self._slot_req: list[Optional[Request]] = [None] * b
        self._reqs: dict[int, Request] = {}
        self._next_rid = 0
        self._cache = init_cache(engine.cfg, b, engine.cache_len,
                                 device=dev,
                                 policy=getattr(engine, "policy", None))
        self._cur = torch.zeros(b, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(b, dtype=torch.int32, device=dev)
        self._live = torch.zeros(b, dtype=torch.bool, device=dev)
        self._rem = torch.zeros(b, dtype=torch.int32, device=dev)

    # ------------------------------------------------------------- state
    def live_slots(self) -> list[int]:
        """Indices of slots currently decoding a request."""
        return [s for s, r in enumerate(self._slot_req) if r is not None]

    def free_slots(self) -> list[int]:
        """Indices of slots available for admission (ascending)."""
        return [s for s, r in enumerate(self._slot_req) if r is None]

    def queued(self) -> int:
        """Requests waiting for a slot."""
        return len(self._queue)

    def outstanding(self) -> int:
        """Requests not yet finished (queued + live)."""
        return len(self._queue) + len(self.live_slots())

    # ------------------------------------------------------------ submit
    def submit(self, prompts: Sequence[str],
               weights: Optional[Sequence[float]] = None) -> Ticket:
        """Enqueue prompts (optionally row-weighted) and eagerly admit
        into free slots; returns a ``Ticket`` resolving in order."""
        eng = self.engine
        now = time.perf_counter()
        trace = RECORDER.trace_id()
        rids = []
        for i, p in enumerate(prompts):
            toks, n = eng.encode_row(p)
            wt = float(weights[i]) if weights is not None else 1.0
            req = Request(rid=self._next_rid, prompt=p, tokens=toks,
                          length=n, weight=max(wt, 1e-9),
                          seq=self._next_rid, t_submit=now, trace=trace)
            self._next_rid += 1
            self._reqs[req.rid] = req
            heapq.heappush(self._queue, (req.vkey, req))
            rids.append(req.rid)
        eng.stats.prompts += len(rids)
        eng.stats.queued_peak = max(eng.stats.queued_peak,
                                    len(self._queue))
        self._admit()  # prefill launches overlap the caller's host work
        return Ticket(tuple(rids))

    # ------------------------------------------------------------- admit
    def _admit(self) -> None:
        """Fill free slots from the queue in weighted-fair order, in
        power-of-two admission batches (largest bucket ≤ backlog)."""
        if not self._queue:
            return
        eng = self.engine
        free = self.free_slots()
        while self._queue and free:
            with span("serving.admit") as sp:
                k = min(len(free), len(self._queue))
                width = next(w for w in self.buckets if w <= k)
                batch = [heapq.heappop(self._queue)[1]
                         for _ in range(width)]
                # packed admission batch: token rows plus (slot, length)
                # in the last two columns — ONE upload per admission
                adm = np.zeros((width, eng.max_seq + 2), dtype=np.int32)
                now = time.perf_counter()
                real_tokens = 0
                for j, req in enumerate(batch):
                    adm[j, :eng.max_seq] = req.tokens
                    slot = free.pop(0)
                    adm[j, -2] = slot
                    adm[j, -1] = req.length
                    real_tokens += req.length
                    self._slot_req[slot] = req
                    req.t_admit = now
                    wait = now - req.t_submit
                    eng.stats.queue_wait_s += wait
                    eng.stats.queue_wait_max_s = max(
                        eng.stats.queue_wait_max_s, wait)
                sp.set("width", width)
                sp.set("tokens", real_tokens)
                with span("serving.admit.upload"):
                    # pageable memory: waits for the queued device work
                    adm_dev = torch.from_numpy(adm).to(eng.device)
                HOST_SYNCS.tick(site="serving_admit")
                with span("serving.admit.prefill"):
                    eng._prefill_insert(self._cache, self._cur, self._pos,
                                        self._live, self._rem, adm_dev)
            eng.stats.batches += 1
            eng.stats.prefill_tokens += real_tokens
            eng.stats.prefill_rows += width
            eng.stats.live_prefill_rows += width

    # ------------------------------------------------------------- round
    def _round(self) -> None:
        """One decode step over the live slot mix + the round's single
        packed device→host fetch; finished slots free mid-decode."""
        eng = self.engine
        live = self.live_slots()
        if not live:
            return
        b = eng.batch_size
        with span("serving.round") as sp:
            sp.set("live", len(live))
            with span("serving.round.launch"):
                packed = eng._decode_round(self._cache, self._cur,
                                           self._pos, self._live, self._rem)
            with span("serving.round.fetch"):
                out = packed.cpu().numpy()  # the round's one host sync
            HOST_SYNCS.tick(site="serving_round")
            emit, fin = out[:b], out[b:] != 0
            eng.stats.decode_steps += 1
            eng.stats.slot_steps += b
            eng.stats.live_slot_steps += len(live)
            eng.stats.decode_tokens += len(live)
            with span("serving.round.harvest"):
                now = time.perf_counter()
                for s in live:
                    req = self._slot_req[s]
                    req.out_ids.append(int(emit[s]))
                    if fin[s]:
                        req.t_done = now
                        eng.stats.ttv_s.append(now - req.t_submit)
                        self._slot_req[s] = None  # slot freed mid-decode
                        if RECORDER.on:
                            self._record(req)

    @staticmethod
    def _record(req: Request) -> None:
        """The finished ``req`` as a ``serving.request`` span."""
        RECORDER.add("serving.request", RECORDER.stamp_ns(req.t_submit),
                     RECORDER.stamp_ns(req.t_done), req.trace, rid=req.rid,
                     query=req.trace,
                     queued_ns=round((req.t_admit - req.t_submit) * 1e9))

    # -------------------------------------------------------------- loop
    def poll(self) -> int:
        """One scheduling round: admit → decode the live mix → harvest
        finished → admit into the freed slots. Returns the number of
        outstanding requests (0 = drained)."""
        self._admit()
        self._round()
        self._admit()
        return self.outstanding()

    def done(self, ticket: Ticket) -> bool:
        """True when every request of ``ticket`` has finished."""
        return all(self._reqs[r].t_done is not None for r in ticket.rids)

    def drain(self, ticket: Optional[Ticket] = None) -> None:
        """Run scheduling rounds until ``ticket`` (or everything)
        completes."""
        if ticket is None:
            while self.poll():
                pass
            return
        while not self.done(ticket):
            self.poll()

    def take(self, ticket: Ticket) -> list[list[int]]:
        """Pop a completed ticket's emitted token ids, submit order."""
        out = []
        for rid in ticket.rids:
            req = self._reqs.pop(rid)
            out.append(req.out_ids)
        return out
