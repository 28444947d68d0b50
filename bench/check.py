"""The comparison that decides ``correct``.

What the timed path produced is held to the plain references:

* every query's rows in every pass, against ``ref/sql.py`` evaluated on
  the benchmark's own tables with the verdicts of the served answers;
* the semantic tier's prompts: each one a prompt the query's templates
  render from those tables, none sent twice in a pass (the cache scope),
  the LLM calls each query reports equal to the prompts it sent, and
  every pass's calls and cache hits equal to the set-up's warm pass;
* the model's outputs: the keys and values a seeded sample of the
  window's admissions wrote into the cache (``kv_err``, relative to the
  reference's largest in each row); and the served tokens, by their
  widest gap below the reference's best logit at their position
  (``served_gap``). A teacher-forced check runs the reference once over
  a seeded sample of the finished requests, the longest prompts among
  them, each prompt with its served tokens; a step-by-step check (a
  mixture of experts, whose tokens route with their whole batch)
  replays sampled admissions and rounds from the program's inputs to
  them (``replay``). Float32 with TF32 off.

Each number is compared with its limit: ``served_gap`` and ``kv_err``
with the configuration's ``limits``, the counts with 0, the tokens
checked with a floor. The lower-precision control (the reference itself
in TF32 in the program's place) is ``replay(tf32=True)`` and
``control_gap``, read by ``bench/control.py``, never by a run."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .ref import sql
from .ref import tokenizer as tk

MIN_TOKENS = 200  # served tokens the logit check must cover


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 in matrix products on (control) or off (the reference)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def sample(requests: list, n: int, longest: int, seed: int, max_seq: int,
           vocab: int) -> list:
    """Indices of ``n`` finished requests: the ``longest`` longest
    prompts, then others drawn from ``seed``."""
    lens = [len(tk.prompt_tokens(p, max_seq, vocab)) for p, _ in requests]
    order = sorted(range(len(requests)), key=lambda i: (-lens[i], i))
    head = order[:longest]
    rest = np.random.default_rng(seed).permutation(order[longest:])
    return head + [int(i) for i in rest[:max(n - len(head), 0)]]


def teacher_rows(requests: list, idx: list, max_seq: int, vocab: int):
    """Per sampled request: the token row (prompt then the served tokens
    fed back), the positions whose logits chose each served token, and
    the served tokens."""
    rows, at, served = [], [], []
    for i in idx:
        prompt, ids = requests[i]
        toks = tk.prompt_tokens(prompt, max_seq, vocab)
        n = len(toks)
        rows.append(toks + list(ids[:-1]))
        at.append(list(range(n - 1, n - 1 + len(ids))))
        served.append(list(ids))
    return rows, at, served


def served_gap(ref, cfg, weights, rows, at, served) -> float:
    """Widest gap between the reference's best logit and the served
    token's, over every served token of the sample."""
    with matmul_precision(False):
        logits = ref.logits_at(cfg, weights, rows, at)
    gap = 0.0
    for lg, ids in zip(logits, served):
        ids_t = torch.tensor(ids, device=lg.device)
        g = lg.max(-1).values - lg.gather(1, ids_t[:, None])[:, 0]
        gap = max(gap, float(g.max()))
    return gap


def control_gap(ref, cfg, weights, rows) -> float:
    """The control: the widest gap, under the float32 reference, of the
    token the TF32 reference puts first, at each position of the same
    prompts and served tokens."""
    at = [list(range(len(r))) for r in rows]
    with matmul_precision(False):
        exact = ref.logits_at(cfg, weights, rows, at)
    with matmul_precision(True):
        low = ref.logits_at(cfg, weights, rows, at)
    gap = 0.0
    for e, lo in zip(exact, low):
        pick = lo.argmax(-1)
        g = e.max(-1).values - e.gather(1, pick[:, None])[:, 0]
        gap = max(gap, float(g.max()))
    return gap


def shape(ps: list) -> list:
    """A pass's LLM work: each query's calls and cache hits."""
    return [(q["qid"], q["llm_calls"], q["cache_hits"]) for q in ps]


def relational(work, passes: list, warm: list) -> dict:
    """The query tier's numbers over every pass of the window, each pass
    judged by the verdicts of its own answers (``warm``: the set-up's
    pass, whose LLM work every pass repeats)."""
    refq = {sp["qid"]: sql.Query(sp, work.ref_tables[sp["schema"]],
                                 work.templates[sp["schema"]])
            for sp in work.queries}
    universes = {qid: q.universe() for qid, q in refq.items()}
    out = {"rows_wrong": 0, "prompts_unknown": 0, "prompts_repeated": 0,
           "calls_mismatch": 0, "verdicts_missing": 0, "pass_spread": 0,
           "answers_missing": 0}
    for ps in passes:
        verdicts = {p: tk.verdict(ids) for q in ps
                    for p, ids in q["requests"]}
        sent: set = set()
        for q in ps:
            want = refq[q["qid"]].rows(verdicts)
            out["verdicts_missing"] += refq[q["qid"]].missing
            got = sorted(tuple(sql.value(r.get(c)) for c in q["out"])
                         for r in q["rows"])
            out["rows_wrong"] += int(got != want)
            prompts = [p for p, _ in q["requests"]]
            out["prompts_unknown"] += sum(p not in universes[q["qid"]]
                                          for p in prompts)
            out["prompts_repeated"] += len(prompts) - len(set(prompts)) \
                + len(sent & set(prompts))
            sent |= set(prompts)
            out["calls_mismatch"] += abs(q["llm_calls"] - len(prompts)) \
                + abs(q["backend_calls"] - len(prompts))
            out["answers_missing"] += sum(not ids
                                          for _, ids in q["requests"])
        out["pass_spread"] += int(shape(ps) != shape(warm))
    return out


def replay(ref, cfg: dict, weights, steps, tf32: bool = False) -> dict:
    """The step-by-step reference over the sampled admissions and rounds
    (``probes.Steps``): the widest served-token gap of the rounds' live
    slots, the widest error of the keys and values the steps wrote
    (relative to the reference's largest in each row), the routings
    that are not a top-k of the reference's probabilities, and the
    admissions whose token rows differ from the reference's encoding of
    their prompts. With ``tf32`` it reads the control instead: the
    reference in TF32 on its own routing, against the float32 one."""
    eng = cfg["engine"]
    S, V = eng["max_seq"], cfg["vocab_size"]
    out = {"served_gap": 0.0, "tokens_checked": 0, "kv_err": 0.0,
           "routes_invalid": 0, "tokens_mismatch": 0}

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    dev = weights["embed"].device
    for a in steps.admissions:
        adm = a["adm"]
        toks = torch.zeros(adm.shape[0], S, dtype=torch.long)
        lens = []
        for i, p in enumerate(a["prompts"]):
            t = tk.prompt_tokens(p, S, V)
            toks[i, :len(t)] = torch.tensor(t)
            lens.append(len(t))
        out["tokens_mismatch"] += int(
            not torch.equal(toks, adm[:, :-2].long())
            or adm[:, -1].tolist() != lens)
        toks = toks.to(dev)
        with matmul_precision(False):
            k, v, route = ref.prefill_kv(cfg, weights, toks, a["routes"])
        got_k, got_v = a["kv"].to(dev)
        if tf32:
            with matmul_precision(True):
                got_k, got_v, route = ref.prefill_kv(cfg, weights, toks)
        else:
            out["routes_invalid"] += route.invalid
        for i, n in enumerate(lens):
            out["kv_err"] = max(out["kv_err"],
                                err(got_k[:, i, :n], k[:, i, :n]),
                                err(got_v[:, i, :n], v[:, i, :n]))
    for r in steps.rounds:
        # the cache after the round: the keys and values it wrote at each
        # slot's position, the earlier positions as the round read them
        cache_k, cache_v = r["kv"].to(dev)
        cur, pos, live = r["state"].to(dev).long()
        if int(pos.max()) >= cache_k.shape[2]:
            raise ValueError("a round's position lies past the copied cache")
        rows = torch.arange(cur.shape[0], device=dev)
        got_k, got_v = cache_k[:, rows, pos], cache_v[:, rows, pos]
        with matmul_precision(False):
            logits, nk, nv, route = ref.step_logits(
                cfg, weights, cache_k, cache_v, cur, pos, r["routes"])
        emit = r["emit"].to(dev).long()
        if tf32:
            with matmul_precision(True):
                low, got_k, got_v, _ = ref.step_logits(
                    cfg, weights, cache_k, cache_v, cur, pos)
            emit = low.argmax(-1)
            live = torch.ones_like(live)
        else:
            out["routes_invalid"] += route.invalid
        live_rows = torch.nonzero(live)[:, 0]
        if live_rows.numel():
            g = logits[live_rows].max(-1).values - \
                logits[live_rows, emit[live_rows]]
            out["served_gap"] = max(out["served_gap"], float(g.max()))
            out["tokens_checked"] += int(live_rows.numel())
        out["kv_err"] = max(out["kv_err"], err(got_k, nk), err(got_v, nv))
    return out


def judge(ref, cfg: dict, work, passes: list, warm: list, weights,
          seed: int, steps) -> list:
    """``[(name, value, op, limit)]`` of every number compared: the
    sampled steps replayed; with a teacher-forced check also the served
    tokens of a sample of requests through the reference; then the
    query tier's numbers."""
    lim = cfg["limits"]
    model = replay(ref, cfg, weights, steps)
    if cfg["check"]["mode"] == "teacher_forced":
        eng = cfg["engine"]
        reqs = [r for ps in passes for q in ps for r in q["requests"]
                if r[1]]
        idx = sample(reqs, work.mix["check_requests"],
                     work.mix["check_longest"], seed, eng["max_seq"],
                     cfg["vocab_size"])
        rows, at, served = teacher_rows(reqs, idx, eng["max_seq"],
                                        cfg["vocab_size"])
        model["served_gap"] = max(model["served_gap"], served_gap(
            ref, cfg, weights, rows, at, served))
        model["tokens_checked"] += sum(map(len, served))
    checks = [("tokens_checked", model.pop("tokens_checked"), ">=",
               MIN_TOKENS)]
    checks += [(k, v, "<=", lim.get(k, 0)) for k, v in model.items()]
    checks += [(k, v, "<=", 0) for k, v in relational(work, passes,
                                                       warm).items()]
    return checks


def holds(value, op: str, limit) -> bool:
    return value <= limit if op == "<=" else value >= limit
