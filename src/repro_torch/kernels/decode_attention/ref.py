"""Plain PyTorch version of K8, single-token decode attention (a copy
of the reference's ``decode_attention_ref`` in torch)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, lengths: torch.Tensor,
                         sm_scale: float | None = None) -> torch.Tensor:
    """q: (B,H,d); k/v: (B,K,T,d); lengths: (B,). Returns (B,H,d). A row
    of length 0 softmaxes T equal masked scores: the mean of V."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    group = H // K
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhd,bhtd->bht", q.float(), kk.float()) * sm_scale
    mask = (torch.arange(T, device=q.device)[None, None, :]
            < lengths.to(q.device)[:, None, None])
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", w, vv.float()).to(q.dtype)
