"""The decoder-only LM (dense, MoE, SSM and hybrid families): forward, the
decode cache, prefill and one-token decode — the subset of the
reference's ``src/repro/models/lm.py`` those families run.

Entry points
------------
forward(cfg, params, batch)                        -> (logits, h)
prefill(cfg, params, batch, max_seq)               -> (logits_last, cache)
decode_step(cfg, params, cache, tokens, pos)       -> (logits, cache)
init_cache / build_cache_spec                      -> the reference's
    layout: (L, B, T, K, hd) K/V plus (L, B, T) ``slot_pos`` (T =
    min(max_seq, attn_window) for the hybrid, a ring at ``pos % T``),
    and for the SSM/hybrid (L, B, nh, hd, ns) ``state`` and
    (L, B, cw-1, conv_dim) ``conv``

``batch`` is ``{"tokens": (B, S) int tensor}``. The reference's
``lax.scan`` over stacked layers is a Python loop over
``params["blocks"][...][l]``; ``decode_step`` updates the cache in place
(the reference returns a new one, which its engine donates) and returns
the same dict. ``attn_impl`` picks the attention path and ``ssd_impl``
the SSD path of every layer (see ``layers.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import ModelConfig
from .layers import (
    attention_block,
    attention_decode,
    mlp,
    moe_block,
    rms_norm,
    ssm_block,
    ssm_decode,
)
from .params import check_supported


def _layer(tree: dict, l: int) -> dict:
    """Layer ``l`` of the stacked block parameters."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def _embed_tokens(params, tokens):
    return params["embed"][tokens.long()]


def _lm_logits(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def _window(cfg: ModelConfig) -> int:
    """The attention window the family runs (only the hybrid has one)."""
    return cfg.attn_window if cfg.family == "hybrid" else 0


def _mix(cfg, bp, x, attn_impl, ssd_impl):
    """One layer's mixer over the full sequence (the reference's
    ``_mixer_train``). Returns (out, k, v, state, conv_tail), the parts
    a family lacks as None."""
    k = v = state = conv = None
    if cfg.family != "ssm":
        a, k, v = attention_block(cfg, bp["attn"], x, attn_impl,
                                  _window(cfg))
    if cfg.family in ("dense", "moe"):
        return a, k, v, state, conv
    s, state, conv = ssm_block(cfg, bp["ssm"], x, ssd_impl)
    if cfg.family == "ssm":
        return s, k, v, state, conv
    out = 0.5 * (rms_norm(a, bp["attn_norm"], cfg.norm_eps)
                 + rms_norm(s, bp["ssm_norm"], cfg.norm_eps))
    return out, k, v, state, conv


def _ffn(cfg, bp, h):
    """The block's FFN residual: the mixture of experts when the
    configuration has experts, else the MLP (None for the SSM family,
    which has none)."""
    if cfg.family == "ssm":
        return None
    x = rms_norm(h, bp["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        return moe_block(cfg, bp["moe"], x)
    return mlp(cfg, bp["mlp"], x)


def _ring_slots(S: int, T: int, device) -> tuple[int, torch.Tensor]:
    """(first, slots): positions ``first..S-1`` are the ones a T-slot
    cache keeps after S positions, at slots ``pos % T``."""
    first = max(S - T, 0)
    return first, torch.arange(first, S, device=device) % T


def _write_kv(dst, src):
    """Write the (B, S, K, hd) keys or values ``src`` into one layer's
    (B, T, K, hd) cache ``dst``: at slots ``arange(S)``, or the last T
    positions at ``pos % T`` when S > T (the hybrid's ring)."""
    S, T = src.shape[1], dst.shape[1]
    if S <= T:
        dst[:, :S] = src
        return
    first, slots = _ring_slots(S, T, src.device)
    dst[:, slots] = src[:, first:]


def _blocks(cfg, params, h, attn_impl, ssd_impl, cache=None):
    """Every layer over the full sequence; with ``cache`` each layer's
    roped K/V (``_write_kv``) and its SSM state and conv tail are
    written into layer ``l`` of the cache's leaves."""
    for l in range(cfg.num_layers):
        bp = _layer(params["blocks"], l)
        mix, k, v, state, conv = _mix(
            cfg, bp, rms_norm(h, bp["ln1"], cfg.norm_eps), attn_impl,
            ssd_impl)
        if cache is not None:
            if k is not None:
                _write_kv(cache["k"][l], k)
                _write_kv(cache["v"][l], v)
            if state is not None:
                cache["state"][l] = state
                cache["conv"][l] = conv
        h = h + mix
        f = _ffn(cfg, bp, h)
        if f is not None:
            h = h + f
    return h


def forward(cfg: ModelConfig, params, batch, attn_impl: str = "auto",
            ssd_impl: str = "auto"):
    """Full-sequence logits (B, S, V) and final hidden states."""
    check_supported(cfg)
    h = _embed_tokens(params, batch["tokens"])
    h = _blocks(cfg, params, h, attn_impl, ssd_impl)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _lm_logits(cfg, params, h), h


def build_cache_spec(cfg: ModelConfig, batch_size: int, max_seq: int
                     ) -> dict:
    """{name: shape} of the decode cache, in the reference's layout."""
    check_supported(cfg)
    L, B = cfg.num_layers, batch_size
    spec = {}
    if cfg.family != "ssm":
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        attn_T = max_seq
        if cfg.family == "hybrid" and cfg.attn_window:
            attn_T = min(max_seq, cfg.attn_window)
        spec["k"] = (L, B, attn_T, K, hd)
        spec["v"] = (L, B, attn_T, K, hd)
        spec["slot_pos"] = (L, B, attn_T)
    if cfg.family in ("ssm", "hybrid"):
        nh, shd, ns = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
        conv_dim = cfg.ssm_d_inner + 2 * ns
        spec["state"] = (L, B, nh, shd, ns)
        spec["conv"] = (L, B, cfg.ssm_conv_width - 1, conv_dim)
    return spec


def init_cache(cfg, batch_size, max_seq, dtype=torch.float32,
               device="cuda") -> dict:
    """Zero K/V and ``slot_pos`` -1 (empty) on ``device``."""
    out = {}
    for name, shape in build_cache_spec(cfg, batch_size, max_seq).items():
        if name == "slot_pos":
            out[name] = torch.full(shape, -1, dtype=torch.int32,
                                   device=device)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def prefill(cfg: ModelConfig, params, batch,
            max_seq: Optional[int] = None, attn_impl: str = "auto",
            ssd_impl: str = "auto"):
    """Run the full prompt, build the decode cache (length ``max_seq``,
    default S), return the logits of the last (padded) position. The
    hybrid keeps the last ``T = min(max_seq, attn_window)`` positions in
    ring layout (slot ``pos % T``)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    h = _embed_tokens(params, tokens)
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or S, dtype=h.dtype, device=h.device)
    h = _blocks(cfg, params, h, attn_impl, ssd_impl, cache=cache)
    if "slot_pos" in cache:
        first, slots = _ring_slots(S, cache["slot_pos"].shape[2], h.device)
        cache["slot_pos"][:, :, slots] = torch.arange(
            first, S, dtype=torch.int32, device=h.device)
    logits = _lm_logits(cfg, params,
                        rms_norm(h[:, -1:], params["final_ln"],
                                 cfg.norm_eps))
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                attn_impl: str = "auto"):
    """One decode step. tokens: (B,) int, pos: (B,) int32 absolute
    positions (each < T without a window). Writes the step's K/V (at
    slot ``pos``, or ``pos % window`` for the hybrid) and SSM state and
    conv tail into ``cache`` in place; returns (logits (B, V), cache)."""
    h = _embed_tokens(params, tokens[:, None])
    window = _window(cfg)
    for l in range(cfg.num_layers):
        bp = _layer(params["blocks"], l)
        x = rms_norm(h, bp["ln1"], cfg.norm_eps)
        if cfg.family != "ssm":
            a = attention_decode(cfg, bp["attn"], x, cache["k"][l],
                                 cache["v"][l], cache["slot_pos"][l], pos,
                                 attn_impl, window)
        if cfg.family in ("ssm", "hybrid"):
            s, st, cv = ssm_decode(cfg, bp["ssm"], x, cache["state"][l],
                                   cache["conv"][l])
            cache["state"][l] = st
            cache["conv"][l] = cv
        if cfg.family in ("dense", "moe"):
            mix = a
        elif cfg.family == "ssm":
            mix = s
        else:
            mix = 0.5 * (rms_norm(a, bp["attn_norm"], cfg.norm_eps)
                         + rms_norm(s, bp["ssm_norm"], cfg.norm_eps))
        h = h + mix
        f = _ffn(cfg, bp, h)
        if f is not None:
            h = h + f
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _lm_logits(cfg, params, h)[:, 0], cache
