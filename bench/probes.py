"""Probes the benchmark sets on instances of the program's serving
tier, so that the program itself carries no timing.

``Requests`` (every run) records each served request's prompt and
token ids, by wrapping ``ServingEngine.submit`` and
``SlotScheduler.take`` on the instance. ``Timers`` (the traced run)
records CUDA events around every ``SlotScheduler._admit`` and
``_round`` call (as ``chip_smoke.py``'s ``timed_serve`` does), the
cache lengths K8 reads in each round (from the scheduler's host state:
a live slot is at its prompt's last position plus the tokens it has
emitted, a finished slot stays where it stopped), and the host's phases
on the host clock (``time.time_ns``, the profiler's clock), which the
trace's idle gaps are labelled by."""
from __future__ import annotations

import time

import torch


class Requests:
    def __init__(self, engine):
        self.done: list = []  # (prompt, ids) in the order taken
        self._prompts: dict = {}
        sched = engine.scheduler
        submit, take = engine.submit, sched.take

        def submit_recorded(prompts, weights=None):
            ticket = submit(prompts, weights)
            self._prompts[ticket] = list(prompts)
            return ticket

        def take_recorded(ticket):
            out = take(ticket)
            self.done.extend(zip(self._prompts.pop(ticket),
                                 (list(ids) for ids in out)))
            return out

        engine.submit, sched.take = submit_recorded, take_recorded

    def pop(self) -> list:
        out, self.done = self.done, []
        return out


class Phases:
    """Host phases as ``[(time_ns, name)]`` transitions."""

    def __init__(self):
        self.marks: list = []
        self._stack: list = []

    def enter(self, name: str) -> None:
        self._stack.append(name)
        self.marks.append((time.time_ns(), name))

    def leave(self) -> None:
        self._stack.pop()
        self.marks.append((time.time_ns(),
                           self._stack[-1] if self._stack else "between"))


class Timers:
    def __init__(self, engine, phases: Phases):
        self.admits: list = []  # (start event, end event, batches made)
        self.rounds: list = []  # (start event, end event)
        self.k8_lengths: list = []  # per round: every slot's live length
        sched = engine.scheduler
        pos = [0] * engine.batch_size
        admit, round_ = sched._admit, sched._round

        def events():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            return a, b

        def admit_timed():
            before = engine.stats.batches
            free = sched.free_slots()
            a, b = events()
            phases.enter("admit")
            a.record()
            admit()
            b.record()
            phases.leave()
            self.admits.append((a, b, engine.stats.batches - before))
            for s in free:
                req = sched._slot_req[s]
                if req is not None:
                    pos[s] = req.length - 1

        def round_timed():
            live = sched.live_slots()
            if not live:
                return round_()
            for s in live:
                req = sched._slot_req[s]
                pos[s] = req.length - 1 + len(req.out_ids)
            self.k8_lengths.append([p + 1 for p in pos])
            a, b = events()
            phases.enter("round")
            a.record()
            round_()
            b.record()
            phases.leave()
            self.rounds.append((a, b))
            for s in live:
                pos[s] += 1

        sched._admit, sched._round = admit_timed, round_timed

    def admit_ms(self) -> list:
        """Each ``_admit`` call that admitted, in ms."""
        return [a.elapsed_time(b) for a, b, n in self.admits if n]

    def round_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.rounds]


class Steps:
    """Copies of a seeded sample of the window's admissions and rounds,
    for a reference that follows the program step by step (a mixture of
    experts, whose tokens route together with the rest of their batch):
    an admission's prompts, packed token rows and the cache rows it
    wrote; a round's tokens, positions and live slots before it, the
    cache after it (which holds the keys and values it wrote) and the
    tokens it emitted; and the routing each layer of a sampled step
    took, read by wrapping the port's ``top_k``
    (``repro_torch.models.layers``) while that step runs. The admission
    and the round that first serve one of ``longest`` (the longest
    prompts) are taken too.

    Which steps are taken is decided from the scheduler's host state
    alone, so a step that is not taken runs exactly as without the
    probe. A taken step's tensors go to host buffers made before the
    window (page-locked on a card) by copies that do not wait for the
    device, cut to the first ``positions`` cache positions, which hold
    every prompt and served token of the mix: while the window runs the
    check keeps on the device only the sampled steps' routing ids (a few
    MB), and one step's copy until it has been sent. ``close`` puts
    ``top_k`` back."""

    def __init__(self, engine, admits: set, rounds: set, longest: set,
                 positions: int):
        from repro_torch.models import layers

        self.admissions: list = []
        self.rounds: list = []
        self._layers, self._top_k = layers, layers.top_k
        sched = engine.scheduler
        b, T = engine.batch_size, positions
        L, B, _, K, d = sched._cache["k"].shape
        pin = sched._cache["k"].is_cuda

        def host(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        kv = (2, L, B, T, K, d)
        free_adm = [(host((b, engine.max_seq + 2), torch.int32),
                     host(kv, torch.float32))
                    for _ in range(len(admits) + 1)]
        free_rnd = [(host((3, b), torch.int32), host((b,), torch.int32),
                     host(kv, torch.float32))
                    for _ in range(len(rounds) + 1)]
        count = {"admit": 0, "round": 0}
        seen = {"admit": False, "round": False}
        known = list(sched._slot_req)
        rec: list = []

        def wanted(kind, index_set, prompts) -> bool:
            i = count[kind]
            count[kind] += 1
            if i in index_set:
                return True
            if not seen[kind] and longest & set(prompts):
                seen[kind] = True
                return True
            return False

        def top_k(probs, k):
            vals, ids = self._top_k(probs, k)
            rec.append(ids.clone())
            return vals, ids

        def routed(step, *args):
            rec.clear()
            layers.top_k = top_k
            try:
                return step(*args), list(rec)
            finally:
                layers.top_k = self._top_k

        def to_host(dst, src):
            """``src`` into the host buffer ``dst`` (its first
            ``src.numel()`` elements), not waiting for the device."""
            out = dst.view(-1)[:src.numel()].view(src.shape)
            out.copy_(src.contiguous(), non_blocking=True)
            return out

        prefill_insert, decode_round = (engine._prefill_insert,
                                        engine._decode_round)

        def prefill_sampled(cache, cur, pos, live, rem, adm):
            new = [s for s, r in enumerate(sched._slot_req)
                   if r is not None and r is not known[s]]
            known[:] = sched._slot_req
            if len(new) != adm.shape[0]:
                raise RuntimeError(f"admission of {adm.shape[0]} rows "
                                   f"filled {len(new)} slots")
            prompts = [sched._slot_req[s].prompt for s in new]
            if not wanted("admit", admits, prompts):
                return prefill_insert(cache, cur, pos, live, rem, adm)
            _, routes = routed(prefill_insert, cache, cur, pos, live, rem,
                               adm)
            slots = adm[:, -2].long()
            kv = torch.stack([cache["k"].index_select(1, slots)[:, :, :T],
                              cache["v"].index_select(1, slots)[:, :, :T]])
            h_adm, h_kv = free_adm.pop()
            self.admissions.append({
                "prompts": prompts, "adm": to_host(h_adm, adm),
                "kv": to_host(h_kv, kv), "routes": routes})

        def round_sampled(cache, cur, pos, live, rem):
            prompts = [sched._slot_req[s].prompt for s in sched.live_slots()]
            if not wanted("round", rounds, prompts):
                return decode_round(cache, cur, pos, live, rem)
            state = torch.stack([cur.int(), pos.int(), live.int()])
            packed, routes = routed(decode_round, cache, cur, pos, live,
                                    rem)
            kv = torch.stack([cache["k"][:, :, :T], cache["v"][:, :, :T]])
            h_state, h_emit, h_kv = free_rnd.pop()
            self.rounds.append({
                "state": to_host(h_state, state),
                "emit": to_host(h_emit, packed[:b]),
                "kv": to_host(h_kv, kv), "routes": routes})
            return packed

        engine._prefill_insert = prefill_sampled
        engine._decode_round = round_sampled

    def close(self) -> None:
        self._layers.top_k = self._top_k
