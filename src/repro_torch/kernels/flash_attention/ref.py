"""Plain PyTorch version of K7, flash attention: float32 softmax, GQA
(a copy of the reference's ``attention_ref`` in torch, with the
reference model's sliding-window bound)."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: float | None = None,
                  window: int = 0) -> torch.Tensor:
    """q: (B,H,Sq,d), k/v: (B,K,Sk,d); returns (B,H,Sq,d). ``window``
    > 0 also masks keys ``window`` or more positions before the query
    (the reference model's ``_mask_bias`` bound)."""
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    group = H // K
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * sm_scale
    if causal or window > 0:
        d_pos = (torch.arange(Sq, device=q.device)[:, None]
                 - torch.arange(Sk, device=q.device)[None, :])
        mask = d_pos >= 0 if causal else torch.ones_like(d_pos, dtype=bool)
        if window > 0:
            mask &= d_pos < window
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv.float()).to(q.dtype)


def attention_prefix_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         prefix: int) -> torch.Tensor:
    """The prefix-LM mask of the reference model's ``_mask_bias`` (mode
    "prefix") over q/k/v (B,H,S,d) / (B,K,S,d): query i sees key j iff
    j <= i or j < ``prefix``. Returns (B,H,S,d)."""
    B, H, S, d = q.shape
    group = H // k.shape[1]
    kk = torch.repeat_interleave(k, group, dim=1).float()
    vv = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    i = torch.arange(S, device=q.device)
    mask = (i[:, None] >= i[None, :]) | (i[None, :] < prefix)
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(q.dtype)
