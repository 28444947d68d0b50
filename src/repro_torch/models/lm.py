"""The dense decoder-only LM: forward, KV cache, prefill and one-token
decode — the dense subset of the reference's ``src/repro/models/lm.py``.

Entry points
------------
forward(cfg, params, batch)                        -> (logits, h)
prefill(cfg, params, batch, max_seq)               -> (logits_last, cache)
decode_step(cfg, params, cache, tokens, pos)       -> (logits, cache)
init_cache / build_cache_spec                      -> the reference's
    (L, B, T, K, hd) K/V layout plus (L, B, T) ``slot_pos``

``batch`` is ``{"tokens": (B, S) int tensor}``. The reference's
``lax.scan`` over stacked layers is a Python loop over
``params["blocks"][...][l]``; ``decode_step`` updates the cache in place
(the reference returns a new one, which its engine donates) and returns
the same dict. ``attn_impl`` picks the attention path of every layer
(see ``layers.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import ModelConfig
from .layers import attention_block, attention_decode, mlp, rms_norm
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


def _blocks(cfg, params, h, attn_impl, kv_out=None):
    """Every layer over the full sequence; with ``kv_out`` (the cache's
    "k"/"v" leaves) each layer's roped K and V are written into
    ``kv_out[...][l, :, :S]``."""
    S = h.shape[1]
    for l in range(cfg.num_layers):
        bp = _layer(params["blocks"], l)
        a, k, v = attention_block(cfg, bp["attn"],
                                  rms_norm(h, bp["ln1"], cfg.norm_eps),
                                  attn_impl)
        if kv_out is not None:
            kv_out["k"][l, :, :S] = k
            kv_out["v"][l, :, :S] = v
        h = h + a
        h = h + mlp(cfg, bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps))
    return h


def forward(cfg: ModelConfig, params, batch, attn_impl: str = "auto"):
    """Full-sequence logits (B, S, V) and final hidden states."""
    check_supported(cfg)
    h = _embed_tokens(params, batch["tokens"])
    h = _blocks(cfg, params, h, attn_impl)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _lm_logits(cfg, params, h), h


def build_cache_spec(cfg: ModelConfig, batch_size: int, max_seq: int
                     ) -> dict:
    """{name: shape} of the dense decode cache."""
    check_supported(cfg)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": (L, batch_size, max_seq, K, hd),
            "v": (L, batch_size, max_seq, K, hd),
            "slot_pos": (L, batch_size, max_seq)}


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
            max_seq: Optional[int] = None, attn_impl: str = "auto"):
    """Run the full prompt, build the decode cache (length ``max_seq``,
    default S), return the logits of the last (padded) position."""
    check_supported(cfg)
    tokens = batch["tokens"]
    h = _embed_tokens(params, tokens)
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or S, dtype=h.dtype, device=h.device)
    h = _blocks(cfg, params, h, attn_impl, kv_out=cache)
    cache["slot_pos"][:, :, :S] = torch.arange(S, dtype=torch.int32,
                                               device=h.device)
    logits = _lm_logits(cfg, params,
                        rms_norm(h[:, -1:], params["final_ln"],
                                 cfg.norm_eps))
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                attn_impl: str = "auto"):
    """One decode step. tokens: (B,) int, pos: (B,) int32 absolute
    positions (each < T). Writes the step's K/V into ``cache`` in place;
    returns (logits (B, V), cache)."""
    h = _embed_tokens(params, tokens[:, None])
    for l in range(cfg.num_layers):
        bp = _layer(params["blocks"], l)
        x = rms_norm(h, bp["ln1"], cfg.norm_eps)
        h = h + attention_decode(cfg, bp["attn"], x, cache["k"][l],
                                 cache["v"][l], cache["slot_pos"][l], pos,
                                 attn_impl)
        h = h + mlp(cfg, bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps))
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _lm_logits(cfg, params, h)[:, 0], cache
