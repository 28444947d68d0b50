"""Plain forward pass of the dense decoder (the ``dense`` family) as
the configuration file states it: token embedding; each layer
``h + attn(rms(h))`` then ``h + mlp(rms(h))`` with grouped-query causal
attention over RoPE (rotation by halves, ``rope_theta``), softmax scale
1/sqrt(head_dim), and a GELU (tanh) MLP or a SiLU-gated one; a final
RMSNorm and the output head. No kernel, no cache, no batching beyond
the rows given; float32, TF32 as the caller sets it."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x: (B, S, H, d), positions 0..S-1."""
    S, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(cfg, w, l, x, kv=None):
    """Causal self-attention of layer ``l`` over positions 0..S-1; the
    roped keys and the values (B, S, K, d) are appended to ``kv``."""
    B, S, D = x.shape
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["head_dim"]
    q = (x @ w["wq"][l].reshape(D, H * d)).view(B, S, H, d)
    k = (x @ w["wk"][l].reshape(D, K * d)).view(B, S, K, d)
    v = (x @ w["wv"][l].reshape(D, K * d)).view(B, S, K, d)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    if kv is not None:
        kv.append((k, v))
    g = H // K
    k = k.repeat_interleave(g, dim=2)  # head h reads KV head h // g
    v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return o.reshape(B, S, H * d) @ w["wo"][l].reshape(H * d, D)


def mlp(cfg, w, x):
    h = x @ w["w_in"]
    if "w_gate" in w:
        return (F.silu(x @ w["w_gate"]) * h) @ w["w_out"]
    return F.gelu(h, approximate="tanh") @ w["w_out"]


def eps(cfg) -> float:
    return cfg.get("norm_epsilon", cfg.get("rms_norm_eps"))


def hidden(cfg, w, tokens, ffn=None, kv=None):
    """Final hidden states (B, S, D) of ``tokens`` (B, S); ``ffn(l, x)``
    replaces the dense MLP of layer ``l`` (the MoE family's); each
    layer's keys and values are appended to ``kv``."""
    b = w["blocks"]
    h = w["embed"][tokens]
    for l in range(cfg["num_hidden_layers"]):
        h = h + attention(cfg, b["attn"], l, rms(h, b["ln1"][l], eps(cfg)),
                          kv)
        x = rms(h, b["ln2"][l], eps(cfg))
        if ffn is None:
            h = h + mlp(cfg, {n: t[l] for n, t in b["mlp"].items()}, x)
        else:
            h = h + ffn(l, x)
    return rms(h, w["final_ln"], eps(cfg))


def head(cfg, w):
    return w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]


@torch.no_grad()
def logits_at(cfg, w, rows: list, at: list, block: int = 16) -> list:
    """Logits (len(at[i]), V) of each token row ``rows[i]`` at its
    positions ``at[i]``, the rows run ``block`` at a time (right-padded:
    causal attention keeps padding out of every earlier position)."""
    out = []
    dev = w["embed"].device
    for s in range(0, len(rows), block):
        chunk = rows[s:s + block]
        n = max(map(len, chunk))
        toks = torch.zeros(len(chunk), n, dtype=torch.long, device=dev)
        for i, r in enumerate(chunk):
            toks[i, :len(r)] = torch.tensor(r, device=dev)
        h = hidden(cfg, w, toks)
        for i, pos in enumerate(at[s:s + block]):
            out.append(h[i, pos] @ head(cfg, w))
    return out


def rope_at(x, pos, theta: float):
    """x: (B, H, d) at absolute positions ``pos`` (B,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


@torch.no_grad()
def step(cfg, w, k_cache, v_cache, cur, pos, ffn=None):
    """One decode step of every row from a given cache: ``cur`` (B,)
    tokens at positions ``pos`` (B,) over ``k_cache``/``v_cache``
    (L, B, T, K, d), whose positions below ``pos`` the row attends to
    with its own new key and value at ``pos``. Returns the logits
    (B, V) and the new keys and values (L, B, K, d). ``ffn(l, x)``
    replaces the dense MLP (x: (B, D))."""
    b = w["blocks"]
    B = cur.shape[0]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d, D = cfg["head_dim"], cfg["hidden_size"]
    T = k_cache.shape[2]
    live = torch.arange(T, device=cur.device)[None] <= pos[:, None]
    rows = torch.arange(B, device=cur.device)
    h = w["embed"][cur.long()]
    new_k, new_v = [], []
    for l in range(cfg["num_hidden_layers"]):
        a = b["attn"]
        x = rms(h, b["ln1"][l], eps(cfg))
        q = (x @ a["wq"][l].reshape(D, H * d)).view(B, H, d)
        k = (x @ a["wk"][l].reshape(D, K * d)).view(B, K, d)
        v = (x @ a["wv"][l].reshape(D, K * d)).view(B, K, d)
        q = rope_at(q, pos, cfg["rope_theta"])
        k = rope_at(k, pos, cfg["rope_theta"])
        kc, vc = k_cache[l].clone(), v_cache[l].clone()
        kc[rows, pos.long()] = k
        vc[rows, pos.long()] = v
        new_k.append(k)
        new_v.append(v)
        g = H // K
        kh = kc.repeat_interleave(g, dim=2)  # (B, T, H, d)
        vh = vc.repeat_interleave(g, dim=2)
        s = torch.einsum("bhd,bthd->bht", q, kh) / math.sqrt(d)
        s = s.masked_fill(~live[:, None, :], float("-inf"))
        o = torch.einsum("bht,bthd->bhd", torch.softmax(s, -1), vh)
        h = h + o.reshape(B, H * d) @ a["wo"][l].reshape(H * d, D)
        x = rms(h, b["ln2"][l], eps(cfg))
        if ffn is None:
            h = h + mlp(cfg, {n: t[l] for n, t in b["mlp"].items()}, x)
        else:
            h = h + ffn(l, x)
    h = rms(h, w["final_ln"], eps(cfg))
    return h @ head(cfg, w), torch.stack(new_k), torch.stack(new_v)


class Routes:
    """The dense family routes nothing: no routing is ever invalid."""

    invalid = 0


@torch.no_grad()
def prefill_kv(cfg, w, tokens, routes=None):
    """Keys and values (each (L, B, S, K, d)) of the token rows
    ``tokens`` (B, S) at every position (rows are independent)."""
    kv: list = []
    hidden(cfg, w, tokens.long(), kv=kv)
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]),
            Routes())


def step_logits(cfg, w, k_cache, v_cache, cur, pos, routes=None):
    """One decode round of every slot from the program's cache, tokens
    and positions (``step``)."""
    logits, k, v = step(cfg, w, k_cache, v_cache, cur, pos)
    return logits, k, v, Routes()
