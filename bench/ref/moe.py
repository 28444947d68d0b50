"""Plain forward pass of the mixture-of-experts decoder (the ``moe``
family): the dense decoder's attention (``ref/dense.py``) with each
MLP replaced by token-choice routing as the configuration states it:
softmax router in float32, the ``num_experts_per_tok`` largest
probabilities (ties to the lower expert), their gates renormalised
(``norm_topk_prob``), and each expert keeping the first
ceil(n k / E x ``moe_capacity_factor``) (token, choice) rows routed to
it, in token order, of the n tokens that route together; a dropped
row adds nothing.

Which tokens route together is the batch the program ran: every row of
an admission (padding included) or every slot of a decode round. So
this reference is run step by step from the program's own inputs to a
step (``prefill_kv``: an admission's token rows; ``step_logits``: a
round's cache, tokens and positions). A routing the program took may
be pinned (``routes``): it is checked against this reference's router
probabilities, a chosen expert no less likely than an unchosen one but
for ``ROUTE_TIE`` (rounding between two float32 paths), and counted as
invalid otherwise; the step then follows the pinned routing, so that a
near tie does not part the two sides."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dense

ROUTE_TIE = 1e-6  # probability a float32 path may differ by at a tie


def capacity(cfg, n_tokens: int) -> int:
    return max(math.ceil(n_tokens * cfg["num_experts_per_tok"]
                         / cfg["num_experts"] * cfg["moe_capacity_factor"]),
               1)


class Router:
    """Routing of each layer's call, own or pinned, with the count of
    pinned routings that are not a top-k of this reference's
    probabilities."""

    def __init__(self, cfg, routes=None):
        self.cfg, self.routes, self.invalid = cfg, routes, 0

    def __call__(self, l: int, x, router):
        k = self.cfg["num_experts_per_tok"]
        probs = torch.softmax(x @ router, dim=-1)
        ids = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
        if self.routes is not None:
            pin = self.routes[l].to(probs.device).long()
            chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(
                1, pin, True)
            low = probs.masked_fill(~chosen, float("inf")).min(-1).values
            high = probs.masked_fill(chosen, float("-inf")).max(-1).values
            self.invalid += int((low < high - ROUTE_TIE).sum())
            ids = pin
        gates = probs.gather(1, ids)
        return ids, gates / gates.sum(-1, keepdim=True)


def experts(cfg, w, l: int, x, route: Router):
    """The mixture of layer ``l`` over the n tokens ``x`` (n, D) that
    route together."""
    b = w["blocks"]["moe"]
    n, k = x.shape[0], cfg["num_experts_per_tok"]
    ids, gates = route(l, x, b["router"][l])
    cap = capacity(cfg, n)
    flat, fg = ids.reshape(-1), gates.reshape(-1)
    y = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        rows = torch.nonzero(flat == e)[:, 0][:cap]  # token order
        if not rows.numel():
            continue
        xe = x[rows // k]
        h = xe @ b["w_in"][l, e]
        if "w_gate" in b:
            h = F.silu(xe @ b["w_gate"][l, e]) * h
        else:
            h = F.gelu(h, approximate="tanh")
        y.index_add_(0, rows // k, (h @ b["w_out"][l, e]) * fg[rows, None])
    return y


@torch.no_grad()
def prefill_kv(cfg, w, tokens, routes=None):
    """Keys and values (each (L, B, S, K, d)) an admission of token rows
    ``tokens`` (B, S) writes, every row routing together; and the
    router (its ``invalid`` count)."""
    route = Router(cfg, routes)
    kv: list = []

    def ffn(l, x):
        B, S, D = x.shape
        return experts(cfg, w, l, x.reshape(B * S, D), route).view(B, S, D)

    dense.hidden(cfg, w, tokens.long(), ffn=ffn, kv=kv)
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]),
            route)


@torch.no_grad()
def step_logits(cfg, w, k_cache, v_cache, cur, pos, routes=None):
    """One decode round of every slot from the program's cache, tokens
    and positions (``dense.step``), the slots routing together."""
    route = Router(cfg, routes)
    logits, k, v = dense.step(cfg, w, k_cache, v_cache, cur, pos,
                              ffn=lambda l, x: experts(cfg, w, l, x, route))
    return logits, k, v, route
