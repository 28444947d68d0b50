"""Building blocks of the dense LM, the subset of the reference's
``src/repro/models/layers.py`` that a dense decoder-only model runs:
``rms_norm``, ``rope`` (halves concatenated, not interleaved), ``mlp``,
``_qkv``, ``_mask_bias``, ``gqa_attention`` and the prefill / decode
attention blocks.

Attention has two paths, chosen by ``attn_impl`` through
``kernels/util.py::resolve_impl`` ("auto": the kernel on a CUDA tensor,
the plain path on a CPU one):

* "kernel" — prefill through K7 (``kernels/flash_attention``), decode
  through K8 (``kernels/decode_attention``); raises off the card;
* "ref" — the reference's grouped einsum ``gqa_attention`` with its
  additive mask, the plain path.

Both compute the same function: prefill is causal over positions
``arange(S)`` on every row with no window, which is all K7 masks; a
decode row's cache holds position ``t`` at slot ``t`` for every
``t <= pos`` (prefill writes ``arange(S)``, decode writes slot ``pos``,
admission replaces the whole row), so K8's ``lengths = pos + 1`` masks
what ``slot_pos`` masks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.util import resolve_impl
from .config import ModelConfig

ATTN_IMPLS = ("auto", "kernel", "ref")


def attn_path(attn_impl: str, x: torch.Tensor) -> str:
    """``attn_impl`` resolved for activations ``x``: "kernel" or "ref"."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    return resolve_impl(attn_impl, "ref", x)


# ---------------------------------------------------------------------------
# norms / rope / mlp
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps=1e-5):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x, positions, theta: float):
    """x: (..., S, H, hd) rotated by halves; positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w) as one matrix product."""
    D = w.shape[0]
    return (x @ w.reshape(D, -1)).reshape(*x.shape[:-1], *w.shape[1:])


def mlp(cfg: ModelConfig, p, x):
    h = _proj(x, p["w_in"])
    if "w_gate" in p:
        h = F.silu(_proj(x, p["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------


def _qkv(cfg, p, x):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _mask_bias(q_pos, k_pos):
    """Causal additive bias from position comparisons. q_pos: (B, S);
    k_pos: (T,) or (B, T). Returns (B, S, T) float32."""
    if k_pos.dim() == 1:
        k_pos = k_pos[None].expand(q_pos.shape[0], k_pos.shape[0])
    d = q_pos[:, :, None] - k_pos[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(d >= 0, zero, torch.full_like(zero, -1e30))


def gqa_attention(q, k, v, bias):
    """q: (B,S,H,hd), k/v: (B,T,K,hd), bias: (B,S,T). Grouped einsum — KV
    heads are never materialised H-wide."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(hd)
    scores = scores + bias[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, hd)


def attention_block(cfg: ModelConfig, p, x, attn_impl: str = "auto"):
    """Causal self-attention over positions ``arange(S)`` on every row
    (train forward / prefill). Returns (out (B,S,D), k, v) with the
    roped keys and values (B,S,K,hd) the decode cache stores."""
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if attn_path(attn_impl, x) == "kernel":
        # K7 reads the (B, S, H, hd) projections through their strides
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True,
                              impl="kernel").transpose(1, 2)
    else:
        out = gqa_attention(q, k, v, _mask_bias(positions, positions))
    o = out.reshape(B, S, -1) @ p["wo"].reshape(-1, cfg.d_model)
    return o, k, v


def attention_decode(cfg: ModelConfig, p, x, k_cache, v_cache, slot_pos,
                     pos, attn_impl: str = "auto"):
    """Single-token decode. x: (B,1,D); caches (B,T,K,hd) and slot_pos
    (B,T) (-1 = empty) are updated IN PLACE at slot ``pos`` of each row;
    pos: (B,) current absolute positions, each < T. Returns (B,1,D)."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    bidx = torch.arange(B, device=x.device)
    slot = pos.long()
    k_cache[bidx, slot] = k_new[:, 0]
    v_cache[bidx, slot] = v_new[:, 0]
    slot_pos[bidx, slot] = pos.to(slot_pos.dtype)
    if attn_path(attn_impl, x) == "kernel":
        # slot_pos[t] == t for every t <= pos, so the live prefix is
        # pos + 1 long; K8 reads the (B, T, K, hd) cache through its
        # strides
        out = decode_attention(q[:, 0], k_cache.permute(0, 2, 1, 3),
                               v_cache.permute(0, 2, 1, 3),
                               (pos + 1).to(torch.int32),
                               impl="kernel")[:, None]
    else:
        ok = (slot_pos >= 0) & (slot_pos <= pos[:, None])
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        bias = torch.where(ok, zero, torch.full_like(zero, -1e30))[:, None]
        out = gqa_attention(q, k_cache, v_cache, bias)
    return out.reshape(B, 1, -1) @ p["wo"].reshape(-1, cfg.d_model)
