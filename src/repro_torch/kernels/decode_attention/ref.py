"""Plain PyTorch version of K8, single-token decode attention (a copy
of the reference's ``decode_attention_ref`` in torch, plus the
reference model's slot mask of ``attention_decode``)."""
from __future__ import annotations

import math

import torch


def live_slots(slot_pos: torch.Tensor, pos: torch.Tensor,
               window: int = 0) -> torch.Tensor:
    """The reference's decode mask (``models/layers.py::
    attention_decode``): slot t of row b is live iff 0 <= slot_pos[b,t]
    <= pos[b] and, for window > 0, pos[b] - slot_pos[b,t] < window.
    Returns (B, T) bool."""
    p = pos.to(slot_pos.device)[:, None]
    ok = (slot_pos >= 0) & (slot_pos <= p)
    if window > 0:
        ok = ok & (p - slot_pos < window)
    return ok


def softmax_lse(s: torch.Tensor):
    """s (..., T) float32 scores, -inf where masked: (w, lse), the
    softmax weights (all 0 where nothing is live) and the log-sum-exp
    (-inf there): the partial state of one slice of a cache, which
    ``sharding/model.py::combine_partials`` merges."""
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    w = e / torch.where(den > 0, den, torch.ones_like(den))
    return w, (m + torch.log(den))[..., 0]


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor,
                         lengths: torch.Tensor | None = None,
                         sm_scale: float | None = None, *,
                         slot_pos: torch.Tensor | None = None,
                         pos: torch.Tensor | None = None,
                         window: int = 0, return_lse: bool = False):
    """q: (B,H,d); k/v: (B,K,T,d); the first ``lengths`` (B,) positions
    live, or the slots ``live_slots(slot_pos, pos, window)`` keeps.
    Returns (B,H,d). A row with nothing live softmaxes T equal masked
    scores: the mean of V. With ``return_lse`` returns (out, lse): lse
    (B,H) float32 the log of the sum of exp(sm_scale · q·k) over the
    live slots, the output normalised by that sum, and a row with
    nothing live 0 and -inf."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    group = H // K
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhd,bhtd->bht", q.float(), kk.float()) * sm_scale
    if slot_pos is not None:
        mask = live_slots(slot_pos, pos, window)[:, None, :]
    else:
        mask = (torch.arange(T, device=q.device)[None, None, :]
                < lengths.to(q.device)[:, None, None])
    if return_lse:
        w, lse = softmax_lse(torch.where(mask, s,
                                         torch.full_like(s, -torch.inf)))
        out = torch.einsum("bht,bhtd->bhd", w, vv.float())
        return out.to(q.dtype), lse
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", w, vv.float()).to(q.dtype)
