"""Building blocks of the LM, the reference's
``src/repro/models/layers.py``: ``rms_norm``, ``rope``
(halves concatenated, not interleaved), ``mlp``, ``_qkv``,
``_mask_bias`` (causal, bidirectional and prefix-LM, with the hybrid's
sliding window), ``gqa_attention``, the prefill / decode attention
blocks (self-attention, and the encoder-decoder's cross-attention),
the mixture of experts (``moe_block`` with its routing and capacity
dispatch ``moe_route`` over an expert window, and the dense oracle
``moe_reference``), and
the SSM block: ``causal_conv1d``, ``ssd_chunked``, ``ssd_reference``,
``ssm_block`` and ``ssm_decode``, and DeepSeek-V3's latent attention
(MLA): ``_mla_q``, ``_mla_kv_latent``, ``mla_block`` and ``mla_decode``.

Attention has two paths, chosen by ``attn_impl`` through
``kernels/util.py::resolve_impl`` ("auto": the kernel on a CUDA tensor,
the plain path on a CPU one):

* "kernel" — prefill through K7 (``kernels/flash_attention``), decode
  through K8 (``kernels/decode_attention``); raises off the card;
* "ref" — the reference's grouped einsum ``gqa_attention`` with its
  additive mask, the plain path.

Both compute the same function. Prefill runs over positions
``arange(S)`` on every row in one of the reference's three modes, each
a route through K7:

* "causal" (the decoder-only LMs, the whisper decoder's
  self-attention): K7 ``causal=True``, within ``window`` when one is
  given;
* "bidir" (the whisper encoder, and the decoder's cross-attention over
  the encoder's keys, where the query and key counts differ): K7
  ``causal=False``;
* "prefix" (the VLM: image tokens first, then text): K7 ``causal=True``
  over all S rows, then K7 ``causal=False`` over the first ``prefix``
  queries against the first ``prefix`` keys, written into those rows
  of the same output through K7's output strides
  (``kernels/flash_attention/ops.py::prefix_attention``). Exact: for a
  text row the prefix mask ``(d >= 0) | (k < prefix)`` is ``d >= 0``,
  since every image key lies before it, and an image row sees exactly
  the image keys.

Without a window a decode row's cache holds position ``t`` at slot
``t`` for every ``t <= pos`` (prefill writes ``arange(S)``, the VLM's
image positions included, decode writes slot ``pos``, admission
replaces the whole row), so K8's ``lengths = pos + 1`` masks what
``slot_pos`` masks; the hybrid's ring cache (slot ``pos % window``)
breaks that, so there K8 takes the reference's slot mask itself. Cross
decode (``cross=True``) reads the encoder's keys, every slot live: K8
with ``lengths = encoder_seq`` on every row.

Over a model-parallel mesh (``policy=``; ``sharding/model.py``)
``mlp``, ``attention_block`` and ``attention_decode`` run
tensor-parallel on each rank's local weights (its query heads, the KV
heads they read, its ``d_ff`` slice) through the one-device code, so
K7/K8 take their one-device routes at those local shapes (window,
prefix, bidirectional, cross), their partial ``w_out``/``wo`` products
all-reduced, and ``moe_block`` runs the reference's expert-parallel
branches (``_moe_mesh``, ``_moe_dp_over_tp``). Under ``shard_cache_seq``
(``sharding.model.seq_sharded``) a decode step's self-attention reads
a cache split over the sequence: every rank attends with every query
head over its slice of every KV head's positions (K8's log-sum-exp
route, or the grouped einsum with its log-sum-exp), the slices merge
by ``sharding.model.combine_partials``, and each rank takes its own
heads through its ``wo`` part (``_decode_seq``). A rank whose query
heads straddle KV groups (hymba-1.5b's 25 over 5 at tp 2 and 4) attends
in runs (``sharding.model.head_runs``: a partial group, whole groups, a
partial group), one K7 or K8 call (or grouped einsum) a run at a group
size the kernels take (``_by_runs``).

The reference's ``Q_CHUNK`` / ``Q_CHUNK_MODE`` knob (set by the dry run)
runs the plain prefill attention and MLA's in query blocks
(``_chunked_gqa``); the kernel path ignores it.

MLA has one path: the reference computes it with einsums outside any
Pallas kernel, so there is no kernel to port; "auto" and "ref" both
run it, and "kernel" raises (``check_mla_impl``), on a mesh too. Over
a mesh ``mla_block`` and ``mla_decode`` run each rank's heads
(``wuq``/``wuk``/``wuv``/``wo`` over ``heads``) on one latent a card:
the query's down-projection and the latent, whose weights
(``wdq``/``wdkv``, FSDP on ``embed``) every rank holds whole, are
computed once for the positions that share a device, and the latent
cache is one tensor a card (or, under ``shard_cache_seq``, each
rank's slice of positions).

The SSD scan has two paths too, chosen by ``ssd_impl``: "kernel" runs
``kernels/ssd/ops.py::ssd`` (K9 for the intra-chunk step, the
recurrence across chunks in torch), "ref" the reference's plain
``ssd_chunked``. ``ssm_decode`` is plain torch on both (the reference
has no decode kernel for it).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.decode_attention.ref import softmax_lse
from ..kernels.flash_attention.ops import flash_attention, prefix_attention
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd.ref import ssd_reference  # noqa: F401  (re-export)
from ..kernels.util import resolve_impl
from ..sharding import model as sm
from ..trace import span
from .config import ModelConfig

ATTN_IMPLS = ("auto", "kernel", "ref")


def attn_path(attn_impl: str, x: torch.Tensor) -> str:
    """``attn_impl`` (or ``ssd_impl``) resolved for activations ``x``:
    "kernel" or "ref"."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl / ssd_impl must be one of "
                         f"{ATTN_IMPLS}, got {attn_impl!r}")
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
    return (x @ w.reshape(D, math.prod(w.shape[1:]))).reshape(
        *x.shape[:-1], *w.shape[1:])


def _rows(w):
    """A (..., D) weight as a (rows, D) matrix (also with no rows: a
    tensor-parallel rank without query heads)."""
    return w.reshape(math.prod(w.shape[:-1]), w.shape[-1])


def mlp(cfg: ModelConfig, p, x, policy=None):
    """The (gated) MLP. Under an active ``policy`` (``p`` sharded,
    ``x`` ``Rows``) each tensor-parallel rank runs its ``d_ff`` slice
    and the partial ``w_out`` products are all-reduced (no bias, so
    the partial sums add up to the product)."""
    if sm.on_mesh(policy):
        g = sm.mesh_grid(policy)
        return sm.all_reduce(sm.gmap(lambda pl, xl: mlp(cfg, pl, xl),
                                     sm.local_grid(p, g), x), g)
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


MODES = ("causal", "bidir", "prefix")


def _mask_bias(q_pos, k_pos, window: int = 0, mode: str = "causal",
               prefix: int = 0):
    """Additive bias from position comparisons (the reference's
    ``_mask_bias(mode, q_pos, k_pos, window, prefix)``): ``mode``
    "causal" keeps keys at or before the query, "bidir" every key,
    "prefix" those and every key before position ``prefix``; the
    sliding-window bound too when ``window`` > 0. q_pos: (B, S); k_pos:
    (T,) or (B, T). Returns (B, S, T) float32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if k_pos.dim() == 1:
        k_pos = k_pos[None].expand(q_pos.shape[0], k_pos.shape[0])
    d = q_pos[:, :, None] - k_pos[:, None, :]
    if mode == "bidir":
        ok = torch.ones_like(d, dtype=torch.bool)
    elif mode == "prefix":
        ok = (d >= 0) | (k_pos[:, None, :] < prefix)
    else:
        ok = d >= 0
    if window > 0:
        ok = ok & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


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


# The reference's query-chunked attention knob (its ``Q_CHUNK`` /
# ``Q_CHUNK_MODE``, set by the dry run's ``--chunk-attn``): when > 0 and
# it divides a longer sequence S, the plain prefill attention (and MLA's,
# in the causal mode) runs in blocks of Q_CHUNK queries, so the (S x T)
# scores never exist whole. "triangle": block i attends to exactly the
# keys [0, (i + 1)·Q_CHUNK) under the causal mask without a window (the
# causal S²/2 score FLOPs), every other mode as "scan"; "scan": every
# block against all keys, a Python loop (the reference's ``lax.scan``).
# The kernel path (K7) tiles already and ignores the knob.
Q_CHUNK = 0
Q_CHUNK_MODE = "triangle"


def _chunked(S: int) -> bool:
    return bool(Q_CHUNK) and S > Q_CHUNK and S % Q_CHUNK == 0


def _plain_attention(q, k, v, positions, k_pos, window: int, mode: str,
                     prefix: int, runs=None):
    """The plain path's attention of ``attention_block``: the grouped
    einsum under ``_mask_bias``, by ``runs``, in query blocks of
    ``Q_CHUNK`` where the knob applies."""
    if _chunked(q.shape[1]):
        return _by_runs(runs, lambda q_, k_, v_: _chunked_gqa(
            q_, k_, v_, positions, k_pos, mode, window, prefix, Q_CHUNK),
            q, k, v)
    bias = _mask_bias(positions, k_pos, window, mode, prefix)
    return _by_runs(runs, lambda q_, k_, v_: gqa_attention(q_, k_, v_, bias),
                    q, k, v)


def _chunked_gqa(q, k, v, positions, k_pos, mode: str, window: int,
                 prefix: int, bq: int):
    """The reference's ``_chunked_gqa``: S / bq blocks of queries, each
    an exactly sized causal attention over keys [0, (i + 1)·bq) under
    "triangle" (causal, no window, as many keys as queries), else each
    against every key under its mask."""
    S = q.shape[1]
    nb = S // bq
    outs = []
    tri = (Q_CHUNK_MODE == "triangle" and mode == "causal" and window == 0
           and k.shape[1] == S)
    for i in range(nb):
        rows = slice(i * bq, (i + 1) * bq)
        if tri:
            hi = (i + 1) * bq
            kp = k_pos[:, :hi] if k_pos.dim() == 2 else k_pos[:hi]
            bias = _mask_bias(positions[:, rows], kp)
            outs.append(gqa_attention(q[:, rows], k[:, :hi], v[:, :hi],
                                      bias))
        else:
            bias = _mask_bias(positions[:, rows], k_pos, window, mode,
                              prefix)
            outs.append(gqa_attention(q[:, rows], k, v, bias))
    return torch.cat(outs, dim=1)


def k7_attention(q, k, v, mode: str = "causal", prefix: int = 0,
                 window: int = 0, impl: str = "kernel"):
    """The K7 route of ``mode`` (module doc) over the model's (B,S,H,hd)
    queries and (B,T,K,hd) keys and values, which K7 reads through
    their strides as (B,H,S,hd) views; ``impl="ref"`` runs the same
    route on K7's plain version. Returns (B,S,H,hd)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if mode == "prefix":
        out = prefix_attention(qt, kt, vt, prefix, impl=impl)
    elif mode in ("causal", "bidir"):
        out = flash_attention(qt, kt, vt, causal=mode == "causal",
                              window=window, impl=impl)
    else:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return out.transpose(1, 2)


def _by_runs(runs, fn, q, k, v):
    """``fn(q, k, v)`` over each run (qa, qb, ka, kb) of ``head_runs``:
    query heads [qa, qb) of q with KV heads [ka, kb) of k and v (dim 2
    of each), the outputs concatenated on dim 2; ``runs`` None is one
    call over every head."""
    if runs is None:
        return fn(q, k, v)
    if not runs:  # a rank with no query heads
        return q.new_zeros(q.shape)
    return torch.cat([fn(q[:, :, qa:qb], k[:, :, ka:kb], v[:, :, ka:kb])
                      for qa, qb, ka, kb in runs], dim=2)


def attention_block(cfg: ModelConfig, p, x, attn_impl: str = "auto",
                    window: int = 0, mode: str = "causal", prefix: int = 0,
                    kv_override=None, policy=None, runs=None):
    """Self-attention over positions ``arange(S)`` on every row (train
    forward / prefill) under ``mode`` (causal, bidir, prefix with
    ``prefix`` image positions), within ``window`` when it is > 0.
    Returns (out (B,S,D), k, v) with the roped keys and values
    (B,S,K,hd) the decode cache stores. With ``kv_override`` = (k, v),
    the encoder's (B,T,K,hd) keys and values (``_cross_kv``), it is the
    whisper decoder's cross-attention: q is the bare projection (no
    rope, no ``bq``), and k, v come back None (the cache stores them
    apart).

    Under an active ``policy`` (``p`` sharded, ``x`` ``Rows``,
    ``kv_override`` None or a grid of each position's (k, v)) each
    position attends over its rows with its rank's query heads and the
    KV heads they read, through the one-device code at those local
    shapes (so K7 takes the same route as on one device: the window,
    the prefix, bidirectional); the partial ``wo`` products are
    all-reduced over the tensor-parallel ranks, and k, v come back as
    grids of each position's local keys and values. A rank whose query
    heads straddle KV groups attends in ``runs`` (``head_runs``), one
    K7 call (or grouped einsum) a run."""
    if sm.on_mesh(policy):
        g = sm.mesh_grid(policy)
        out = sm.gmap(lambda pl, xl, kv, rn: attention_block(
            cfg, pl, xl, attn_impl, window, mode, prefix, kv, runs=rn),
            sm.local_grid(p, g), x, kv_override,
            sm.run_grid(cfg.num_heads, cfg.num_kv_heads, policy))
        o, k, v = sm.unzip(out.grid, 3)
        return sm.all_reduce(sm.Rows(o, x.n), g), k, v
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if kv_override is None:
        q, k, v = _qkv(cfg, p, x)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_pos = positions
    else:
        q = _proj(x, p["wq"])
        k, v = kv_override
        k_pos = torch.arange(k.shape[1], device=x.device)
    if attn_path(attn_impl, x) == "kernel":
        out = _by_runs(runs, lambda q_, k_, v_: k7_attention(
            q_, k_, v_, mode, prefix, window), q, k, v)
    else:
        out = _plain_attention(q, k, v, positions, k_pos, window, mode,
                               prefix, runs)
    o = (out.reshape(B, S, out.shape[2] * out.shape[3])
         @ _rows(p["wo"]))
    if kv_override is not None:
        return o, None, None
    return o, k, v


def attention_decode(cfg: ModelConfig, p, x, k_cache, v_cache, slot_pos,
                     pos, attn_impl: str = "auto", window: int = 0,
                     cross: bool = False, policy=None, runs=None):
    """Single-token decode. x: (B,1,D); caches (B,T,K,hd) and slot_pos
    (B,T) (-1 = empty) are updated IN PLACE at slot ``pos`` of each row,
    or ``pos % window`` when ``window`` > 0 (the hybrid's ring); pos:
    (B,) current absolute positions. With ``cross`` the caches are the
    encoder's cross K/V (``xk``/``xv``): nothing is written, q is
    unroped (``bq`` added) and every slot is live (``slot_pos`` is not
    read). Returns (B,1,D).

    Under an active ``policy`` (``p`` sharded, ``x`` and ``pos``
    ``Rows``, the caches grids of each position's layer views;
    ``slot_pos`` None with ``cross``) each position decodes its rows
    over its local heads and cache through the one-device code (K8 at
    those shapes on the kernel path, with the ring's slot mask under a
    window, over every encoder slot with ``cross``), and the partial
    ``wo`` products are all-reduced over the tensor-parallel ranks.
    Under ``shard_cache_seq`` each position's caches are its rank's
    slice of the sequence (``_decode_seq``, the hybrid's ring too; not
    with ``cross``, whose ``xk``/``xv`` carry no ``kv_seq``). A rank
    whose query heads straddle KV groups attends in ``runs``
    (``head_runs``), one K8 call (or grouped einsum) a run."""
    if sm.on_mesh(policy):
        g = sm.mesh_grid(policy)
        if sm.seq_sharded(policy) and not cross:
            return _decode_seq(cfg, p, x, k_cache, v_cache, slot_pos, pos,
                               attn_impl, window, g)
        return sm.all_reduce(sm.gmap(
            lambda pl, xl, kc, vc, sp, ps, rn: attention_decode(
                cfg, pl, xl, kc, vc, sp, ps, attn_impl, window, cross,
                runs=rn),
            sm.local_grid(p, g), x, k_cache, v_cache, slot_pos, pos,
            sm.run_grid(cfg.num_heads, cfg.num_kv_heads, policy)), g)
    B = x.shape[0]
    if cross:
        return _cross_decode(cfg, p, x, k_cache, v_cache, attn_impl, runs)
    q, k_new, v_new = _qkv(cfg, p, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    bidx = torch.arange(B, device=x.device)
    slot = (pos % window if window > 0 else pos).long()
    k_cache[bidx, slot] = k_new[:, 0]
    v_cache[bidx, slot] = v_new[:, 0]
    slot_pos[bidx, slot] = pos.to(slot_pos.dtype)
    kernel = attn_path(attn_impl, x) == "kernel"
    if kernel and window > 0:
        # a ring slot does not hold its own position: K8 takes the
        # reference's slot mask; it reads the (B, T, K, hd) cache
        # through its strides
        def attend(q_, kc, vc):
            return decode_attention(q_[:, 0], kc.permute(0, 2, 1, 3),
                                    vc.permute(0, 2, 1, 3),
                                    slot_pos=slot_pos, pos=pos,
                                    window=window, impl="kernel")[:, None]
    elif kernel:
        # slot_pos[t] == t for every t <= pos, so the live prefix is
        # pos + 1 long
        def attend(q_, kc, vc):
            return decode_attention(q_[:, 0], kc.permute(0, 2, 1, 3),
                                    vc.permute(0, 2, 1, 3),
                                    (pos + 1).to(torch.int32),
                                    impl="kernel")[:, None]
    else:
        bias = _decode_bias(slot_pos, pos, window)

        def attend(q_, kc, vc):
            return gqa_attention(q_, kc, vc, bias)
    out = _by_runs(runs, attend, q, k_cache, v_cache)
    return (out.reshape(B, 1, out.shape[2] * out.shape[3])
            @ _rows(p["wo"]))


def _live_slots(slot_pos, pos, window: int):
    """(B, T): the slots a decode step at ``pos`` attends to, the
    reference's mask (``0 <= slot_pos <= pos``, within ``window``)."""
    ok = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window > 0:
        ok = ok & (pos[:, None] - slot_pos < window)
    return ok


def _decode_bias(slot_pos, pos, window: int):
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return torch.where(_live_slots(slot_pos, pos, window), zero,
                       torch.full_like(zero, -1e30))[:, None]


def gqa_decode_lse(q, k, v, ok):
    """The grouped einsum of one query token with its log-sum-exp: q
    (B,H,hd), k/v (B,T,K,hd), ``ok`` (B,T) the live slots. Returns (out
    (B,H,hd), lse (B,H)); a row with nothing live gives 0 and -inf."""
    B, H, hd = q.shape
    K = k.shape[2]
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, K, H // K, hd),
                     k).float() / math.sqrt(hd)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, -torch.inf))
    w, lse = softmax_lse(s)
    out = torch.einsum("bkgt,btkd->bkgd", w.to(q.dtype), v)
    return out.reshape(B, H, hd), lse.reshape(B, H)


def _owned(slot, lo: int, n: int):
    """(local, own): the local slot ``slot - lo`` of each row, clamped
    into [0, n), and whether the row's slot lies in the slice [lo,
    lo + n) (n > 0)."""
    loc = slot.long() - lo
    return loc.clamp(0, n - 1), (loc >= 0) & (loc < n)


def _write_owned(cache, new, slot, own) -> None:
    """Write row b's ``new[b]`` into ``cache[b, slot[b]]`` in place where
    ``own[b]``, leaving the other rows' slots as they were."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    old = cache[bidx, slot]
    keep = own.view(-1, *([1] * (old.dim() - 1)))
    cache[bidx, slot] = torch.where(keep, new.to(old.dtype), old)


def _decode_seq(cfg: ModelConfig, p, x, k_cache, v_cache, slot_pos, pos,
                attn_impl: str, window: int, g):
    """``attention_decode`` over caches split over the sequence: each
    rank's query heads gathered over the tensor-parallel ranks (every
    rank has q for every head), the new token's K/V gathered over the
    KV heads (``kv_pieces``) and written only by the rank whose slice
    holds its slot (``pos``, or ``pos % window`` in the hybrid's ring);
    each rank attends over its slice [lo, lo + n) with every head: K8's
    log-sum-exp route with lengths clamp(pos + 1 - lo, 0, n) (with the
    reference's slot mask in the ring), or the grouped einsum over its
    live slots; the partials merge in rank order
    (``combine_partials``); each rank's heads (``head_range``) go
    through its ``wo`` part and the products are all-reduced."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    loc = sm.local_grid(p, g)

    def project(pl, xl, ps):
        q, k, v = _qkv(cfg, pl, xl)
        return (rope(q, ps[:, None], cfg.rope_theta)[:, 0],
                rope(k, ps[:, None], cfg.rope_theta)[:, 0], v[:, 0])

    q, k_new, v_new = sm.unzip(sm.gmap(project, loc, x, pos).grid, 3)
    q = sm.all_gather(q, g, dim=1)
    pieces = sm.kv_pieces(H, K, g.tp)
    k_new = sm.gather_ranks(k_new, g, pieces, dim=1)
    v_new = sm.gather_ranks(v_new, g, pieces, dim=1)
    T = sum(k_cache[0, u].shape[1] for u in range(g.tp))
    kernel = attn_path(attn_impl, x.grid[0, 0]) == "kernel"

    def attend(it, qq, kc, vc, sp, ps, kn, vn):
        lo, n = sm.seq_slice(T, g.tp, it[1])
        B = qq.shape[0]
        if n == 0:
            return (qq.new_zeros(qq.shape), qq.new_full((B, H), -torch.inf,
                                                        dtype=torch.float32))
        slot, own = _owned(ps % window if window > 0 else ps, lo, n)
        _write_owned(kc, kn, slot, own)
        _write_owned(vc, vn, slot, own)
        _write_owned(sp, ps.to(sp.dtype), slot, own)
        if kernel and window > 0:
            return decode_attention(qq, kc.permute(0, 2, 1, 3),
                                    vc.permute(0, 2, 1, 3), slot_pos=sp,
                                    pos=ps, window=window, impl="kernel",
                                    return_lse=True)
        if kernel:
            lengths = (ps.long() + 1 - lo).clamp(0, n).to(torch.int32)
            return decode_attention(qq, kc.permute(0, 2, 1, 3),
                                    vc.permute(0, 2, 1, 3), lengths,
                                    impl="kernel", return_lse=True)
        return gqa_decode_lse(qq, kc, vc, _live_slots(sp, ps, window))

    parts = sm.gmap(attend, sm.positions(g), q, k_cache, v_cache, slot_pos,
                    pos, k_new, v_new)
    out = sm.combine_partials(*sm.unzip(parts.grid, 2), g)

    def proj(it, o, pl):
        a, b = sm.head_range(H, g.tp, it[1])
        return (o[:, a:b].reshape(o.shape[0], 1, (b - a) * o.shape[-1])
                @ _rows(pl["wo"]))

    return sm.all_reduce(sm.Rows(sm.gmap(proj, sm.positions(g), out, loc),
                                 x.n), g)


def _cross_decode(cfg: ModelConfig, p, x, xk, xv, attn_impl: str,
                  runs=None):
    """One token's cross-attention over the encoder's (B,T,K,hd) keys
    and values, every slot live (the reference's ``slot_pos`` of zeros
    with pos >= 0): K8 with ``lengths = T`` on every row, or the grouped
    einsum with a zero bias, by ``runs``. Returns (B,1,D)."""
    B, T = x.shape[0], xk.shape[1]
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if attn_path(attn_impl, x) == "kernel":
        lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)

        def attend(q_, kc, vc):
            return decode_attention(q_[:, 0], kc.permute(0, 2, 1, 3),
                                    vc.permute(0, 2, 1, 3), lengths,
                                    impl="kernel")[:, None]
    else:
        bias = torch.zeros(B, 1, T, dtype=torch.float32, device=x.device)

        def attend(q_, kc, vc):
            return gqa_attention(q_, kc, vc, bias)
    out = _by_runs(runs, attend, q, xk, xv)
    return (out.reshape(B, 1, out.shape[2] * out.shape[3])
            @ _rows(p["wo"]))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): latent-compressed attention
# ---------------------------------------------------------------------------


def check_mla_impl(attn_impl: str) -> None:
    """MLA runs one path for "auto" and "ref"; "kernel" raises, since
    the reference runs MLA outside any Pallas kernel and so the port
    has no kernel for it (never a silent fallback)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    if attn_impl == "kernel":
        raise ValueError("attn_impl='kernel': MLA has no kernel path (the "
                         "reference runs MLA outside any Pallas kernel); "
                         "use 'auto' or 'ref'")


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_cq(cfg: ModelConfig, p, x):
    """The query's normed down-projection (B,S,q_lora_rank)."""
    return rms_norm(_proj(x, p["wdq"]), p["q_ln"], cfg.norm_eps)


def _mla_q_up(cfg: ModelConfig, p, cq, positions):
    """The queries of ``p``'s heads from ``cq``: (B,S,H,qk_nope) unroped
    and (B,S,H,qk_rope) roped."""
    q = _proj(cq, p["wuq"])
    qn, qr = torch.split(q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                         dim=-1)
    return qn, rope(qr, positions, cfg.rope_theta)


def _mla_q(cfg: ModelConfig, p, x, positions):
    """The queries: (B,S,H,qk_nope) unroped and (B,S,H,qk_rope) roped."""
    return _mla_q_up(cfg, p, _mla_cq(cfg, p, x), positions)


def _mla_kv_latent(cfg: ModelConfig, p, x, positions):
    """The latent the cache stores: the normed (B,S,kv_lora_rank) ``ckv``
    and the one shared roped key head (B,S,qk_rope)."""
    ckv, k_rope = torch.split(_proj(x, p["wdkv"]),
                              [cfg.kv_lora_rank, cfg.qk_rope_head_dim],
                              dim=-1)
    ckv = rms_norm(ckv, p["kv_ln"], cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


# the MLA leaves every tensor-parallel rank holds whole (FSDP on
# ``embed`` at most): the query's down-projection and the latent
MLA_SHARED = ("wdq", "q_ln", "wdkv", "kv_ln")


def _mla_shared(cfg: ModelConfig, p, x, positions):
    """(cq, ckv, k_rope): the work of ``MLA_SHARED``, the same at every
    tensor-parallel rank."""
    return (_mla_cq(cfg, p, x), *_mla_kv_latent(cfg, p, x, positions))


def _mla_shared_mesh(cfg: ModelConfig, p, x, g, pos=None):
    """``_mla_shared`` over the mesh, at positions ``arange(S)`` or, with
    ``pos`` (``Rows``), one decode token's: grids of cq, ckv and k_rope,
    one call for the positions that share a device (``local_grid``
    gives them one dict of ``MLA_SHARED``'s leaves), so the latent is
    one tensor a card."""
    shared = sm.local_grid({n: p[n] for n in MLA_SHARED}, g)

    def one(pl, xl, ps):
        return _mla_shared(cfg, pl, xl, _arange_positions(xl) if ps is None
                           else ps[:, None])

    return sm.unzip(sm.gmap(one, shared, x, pos).grid, 3)


def _mla_attend(cfg: ModelConfig, p, cq, ckv, k_rope, positions):
    """Causal MLA of ``p``'s heads over positions ``arange(S)``: the
    queries from ``cq``, per-head K/V materialised from the latent;
    returns ``p["wo"]``'s product (B,S,D)."""
    B, S = cq.shape[0], cq.shape[1]
    qn, qr = _mla_q_up(cfg, p, cq, positions)
    kn = _proj(ckv, p["wuk"])
    v = _proj(ckv, p["wuv"])

    def attend(rows, hi):
        """Queries ``rows`` over the keys [0, hi)."""
        scores = (torch.einsum("bshk,bthk->bhst", qn[:, rows], kn[:, :hi])
                  + torch.einsum("bshk,btk->bhst", qr[:, rows],
                                 k_rope[:, :hi])).float()
        bias = _mask_bias(positions[:, rows], positions[:, :hi])
        w = torch.softmax(scores * _mla_scale(cfg) + bias[:, None],
                          dim=-1).to(cq.dtype)
        return torch.einsum("bhst,bthk->bshk", w, v[:, :hi])

    if _chunked(S):  # the reference's Q_CHUNK blocks (causal mode)
        out = torch.cat([attend(slice(i, i + Q_CHUNK), i + Q_CHUNK if
                                Q_CHUNK_MODE == "triangle" else S)
                         for i in range(0, S, Q_CHUNK)], dim=1)
    else:
        out = attend(slice(None), S)
    return out.reshape(B, S, -1) @ p["wo"].reshape(-1, cfg.d_model)


def _arange_positions(x):
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def mla_block(cfg: ModelConfig, p, x, policy=None):
    """Causal MLA over positions ``arange(S)`` on every row (train
    forward / prefill), per-head K/V materialised from the latent.
    Returns (out (B,S,D), ckv, k_rope), the latent the decode cache
    stores.

    Under an active ``policy`` (``p`` sharded, ``x`` ``Rows``) each
    position computes its heads' ``qn``/``qr``/``kn``/``v`` from its
    ``wuq``/``wuk``/``wuv`` parts over the latent of its device
    (``_mla_shared_mesh``), the partial ``wo`` products all-reduced;
    ckv and k_rope come back as grids of each position's latent."""
    if sm.on_mesh(policy):
        g = sm.mesh_grid(policy)
        cq, ckv, k_rope = _mla_shared_mesh(cfg, p, x, g)
        o = sm.gmap(lambda pl, xl, c, kv, kr: _mla_attend(
            cfg, pl, c, kv, kr, _arange_positions(xl)),
            sm.local_grid(p, g), x, cq, ckv, k_rope)
        return sm.all_reduce(o, g), ckv, k_rope
    positions = _arange_positions(x)
    cq, ckv, k_rope = _mla_shared(cfg, p, x, positions)
    return _mla_attend(cfg, p, cq, ckv, k_rope, positions), ckv, k_rope


def _mla_write(ckv_cache, krope_cache, ckv_new, krope_new, pos) -> None:
    """Write one token's latent at slot ``pos`` of each row, in place."""
    bidx = torch.arange(ckv_cache.shape[0], device=ckv_cache.device)
    slot = pos.long()
    ckv_cache[bidx, slot] = ckv_new[:, 0]
    krope_cache[bidx, slot] = krope_new[:, 0]


def _mla_absorbed_q(cfg: ModelConfig, p, cq, pos):
    """The absorbed queries of ``p``'s heads: ``q_abs`` (B,1,H,r), with
    ``wuk`` folded in, and the roped ``qr`` (B,1,H,qk_rope)."""
    qn, qr = _mla_q_up(cfg, p, cq, pos[:, None])
    return torch.einsum("bshk,rhk->bshr", qn, p["wuk"]), qr


def _mla_scores(cfg: ModelConfig, q_abs, qr, ckv_cache, krope_cache):
    return (torch.einsum("bshr,btr->bhst", q_abs, ckv_cache)
            + torch.einsum("bshk,btk->bhst", qr, krope_cache)
            ).float() * _mla_scale(cfg)


def _mla_out(cfg: ModelConfig, p, ctx):
    """(B,1,H,r) context of ``p``'s heads through ``wuv`` and ``wo``."""
    out = torch.einsum("bshr,rhk->bshk", ctx, p["wuv"])
    return out.reshape(ctx.shape[0], 1, -1) @ p["wo"].reshape(
        -1, cfg.d_model)


def _mla_decode_heads(cfg: ModelConfig, p, cq, ckv_cache, krope_cache,
                      pos):
    """The absorbed step of ``p``'s heads over the whole latent cache,
    every slot ``<= pos`` visible: (B,1,D)."""
    q_abs, qr = _mla_absorbed_q(cfg, p, cq, pos)
    T = ckv_cache.shape[1]
    scores = _mla_scores(cfg, q_abs, qr, ckv_cache, krope_cache)
    ok = torch.arange(T, device=cq.device)[None, :] <= pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=cq.device)
    scores = scores + torch.where(ok, zero, torch.full_like(zero, -1e30)
                                  )[:, None, None, :]
    w = torch.softmax(scores, dim=-1).to(cq.dtype)
    ctx = torch.einsum("bhst,btr->bshr", w, ckv_cache)  # (B,1,H,r)
    return _mla_out(cfg, p, ctx)


def mla_decode(cfg: ModelConfig, p, x, ckv_cache, krope_cache, pos,
               policy=None):
    """Absorbed-form single-token MLA: ``wuk`` folds into the query and
    ``wuv`` into the output, so the step reads only the latent cache and
    never materialises per-head K/V. x: (B,1,D); caches ckv (B,T,r) and
    krope (B,T,qk_rope) are updated IN PLACE at slot ``pos`` of each
    row; every slot ``<= pos`` is visible. Returns (B,1,D).

    Under an active ``policy`` (``p`` sharded, ``x`` and ``pos``
    ``Rows``, the caches grids of each position's layer views) the new
    latent is computed once a card and written once into each distinct
    cache part: without ``shard_cache_seq`` the latent cache is
    replicated over the tensor-parallel ranks (one tensor a card) and
    each rank runs its heads over all of it; with it each rank holds a
    slice of the positions (``_mla_decode_seq``). The partial ``wo``
    products are all-reduced."""
    if sm.on_mesh(policy):
        g = sm.mesh_grid(policy)
        cq, ckv_new, krope_new = _mla_shared_mesh(cfg, p, x, g, pos)
        if sm.seq_sharded(policy):
            return _mla_decode_seq(cfg, p, x, cq, ckv_new, krope_new,
                                   ckv_cache, krope_cache, pos, g)
        done = set()
        for (i, t), part in np.ndenumerate(ckv_cache):
            if id(part) not in done:
                done.add(id(part))
                _mla_write(part, krope_cache[i, t], ckv_new[i, t],
                           krope_new[i, t], pos.grid[i, t])
        return sm.all_reduce(sm.gmap(
            lambda pl, c, kc, kr, ps: _mla_decode_heads(cfg, pl, c, kc, kr,
                                                        ps),
            sm.local_grid(p, g), cq, ckv_cache, krope_cache, pos), g)
    cq, ckv_new, krope_new = _mla_shared(cfg, p, x, pos[:, None])
    _mla_write(ckv_cache, krope_cache, ckv_new, krope_new, pos)
    return _mla_decode_heads(cfg, p, cq, ckv_cache, krope_cache, pos)


def _mla_decode_seq(cfg: ModelConfig, p, x, cq, ckv_new, krope_new,
                    ckv_cache, krope_cache, pos, g):
    """``mla_decode`` over latent caches split over the sequence: the
    new latent written by the rank whose slice [lo, lo + n) holds slot
    ``pos``; each rank's ``q_abs`` and ``qr`` gathered over the
    tensor-parallel ranks; each rank's scores and context (B,1,H,r) of
    every head over its slice, with their log-sum-exp; the partials
    merged in rank order (``combine_partials``); each rank's heads
    through its ``wuv`` and ``wo`` parts, the products all-reduced."""
    H = cfg.num_heads
    loc = sm.local_grid(p, g)
    q = sm.gmap(lambda pl, c, ps: _mla_absorbed_q(cfg, pl, c, ps), loc, cq,
                pos)
    q_abs, qr = (sm.all_gather(a, g, dim=2) for a in sm.unzip(q.grid, 2))
    T = sum(ckv_cache[0, u].shape[1] for u in range(g.tp))

    def attend(it, qa, qq, kc, kr, cn, rn, ps):
        lo, n = sm.seq_slice(T, g.tp, it[1])
        B = qa.shape[0]
        if n == 0:
            return (qa.new_zeros((B, H, qa.shape[-1])),
                    qa.new_full((B, H), -torch.inf, dtype=torch.float32))
        slot, own = _owned(ps, lo, n)
        _write_owned(kc, cn[:, 0], slot, own)
        _write_owned(kr, rn[:, 0], slot, own)
        s = _mla_scores(cfg, qa, qq, kc, kr)[:, :, 0]  # (B,H,n)
        ok = lo + torch.arange(n, device=s.device)[None, :] <= ps[:, None]
        s = torch.where(ok[:, None], s, torch.full_like(s, -torch.inf))
        w, lse = softmax_lse(s)
        return torch.einsum("bht,btr->bhr", w.to(qa.dtype), kc), lse

    parts = sm.gmap(attend, sm.positions(g), q_abs, qr, ckv_cache,
                    krope_cache, ckv_new, krope_new, pos)
    ctx = sm.combine_partials(*sm.unzip(parts.grid, 2), g)
    h = H // g.tp
    return sm.all_reduce(sm.Rows(sm.gmap(
        lambda it, c, pl: _mla_out(cfg, pl, c[:, None, it[1] * h:
                                              (it[1] + 1) * h]),
        sm.positions(g), ctx, loc), x.n), g)


# ---------------------------------------------------------------------------
# MoE: token-choice routing with a capacity gather, on one device
# ---------------------------------------------------------------------------


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows each expert takes when ``n_tokens`` rows route: the
    reference's ceil(n·k / E · capacity_factor), at least 1."""
    return max(int(math.ceil(n_tokens * cfg.experts_per_tok
                             / cfg.num_experts * cfg.moe_capacity_factor)), 1)


def top_k(probs, k: int):
    """The k largest of each row of ``probs`` and their indices, largest
    first, ties to the lower index as ``jax.lax.top_k`` breaks them
    (``torch.topk`` may pick any of the tied indices, which changes the
    selected set, not only its order). A stable descending sort keeps
    ties in index order, needs no host sync (the serving CUDA graphs
    capture it) and passes gradients to the values."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_route(x, router, cap: int, k: int, lo: int = 0,
              e_loc: Optional[int] = None):
    """The reference's routing and capacity dispatch (``_moe_local``'s
    first half) over the expert window [lo, lo + e_loc) (every expert
    by default). x: (T, D); routing reads the full ``router``. Returns
    (gate (T·k,), rows, valid, toks), the last three (e_loc, cap): slot
    c of local expert e holds the flattened (token, choice) row
    ``rows[e, c]`` of token ``toks[e, c]`` where ``valid``. An expert
    keeps the first ``cap`` rows routed to it, in token order; the rest
    are dropped, and rows routed outside the window go to the overflow
    bucket ``e_loc``, which no slot reads."""
    T = x.shape[0]
    E = router.shape[-1]
    e_loc = E if e_loc is None else e_loc
    probs = torch.softmax(x.float() @ router, dim=-1)
    gate, ids = top_k(probs, k)  # (T, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    flat_ids = ids.reshape(-1)
    if lo or e_loc != E:
        local = (flat_ids >= lo) & (flat_ids < lo + e_loc)
        flat_ids = torch.where(local, flat_ids - lo,
                               torch.full_like(flat_ids, e_loc))
    # stable, as jnp.argsort: an expert's rows stay in token order, which
    # decides the rows its capacity keeps
    order = torch.argsort(flat_ids, stable=True)
    experts = torch.arange(e_loc, device=x.device)
    sorted_ids = flat_ids[order]
    starts = torch.searchsorted(sorted_ids, experts)
    ends = torch.searchsorted(sorted_ids, experts, right=True)
    slot = starts[:, None] + torch.arange(cap, device=x.device)[None, :]
    valid = slot < ends[:, None]
    rows = torch.where(valid, order[slot.clamp(0, T * k - 1)], 0)
    return gate.reshape(-1).to(x.dtype), rows, valid, rows // k


def _moe_local(x, p, lo: int, e_loc: int, cap: int, k: int, gated: bool):
    """The reference's ``_moe_local``: the contribution of the local
    experts [lo, lo + e_loc) (``p``'s expert weights are that slice,
    its router the full one) to each of the (T, D) tokens ``x``. The
    routing with the gather into expert rows runs under the span
    ``model.moe.route``, the expert products with the weighted sum under
    ``model.moe.experts``."""
    T, D = x.shape
    with span("model.moe.route"):
        flat_gate, rows, valid, toks = moe_route(x, p["router"], cap, k,
                                                 lo, e_loc)
        xg = x[toks] * valid[..., None].to(x.dtype)  # (E, cap, D)
    with span("model.moe.experts"):
        h = torch.bmm(xg, p["w_in"])
        if gated:
            h = F.silu(torch.bmm(xg, p["w_gate"])) * h
        else:
            h = F.gelu(h, approximate="tanh")
        yg = torch.bmm(h, p["w_out"])
        wts = (flat_gate[rows] * valid).to(x.dtype)
        # a kept slot's row is a distinct (token, choice) index: write
        # each into its own row of a (T·k + 1, D) buffer (dropped slots
        # into the last, discarded) and sum over the choices, a
        # deterministic form of the reference's scatter-add
        out = x.new_zeros(T * k + 1, D)
        out[torch.where(valid, rows, T * k).reshape(-1)] = \
            (yg * wts[..., None]).reshape(-1, D)
        return out[:T * k].view(T, k, D).sum(dim=1)


def moe_block(cfg: ModelConfig, p, x, policy=None):
    """x: (B, S, D). Off a mesh, the reference's single-device
    ``moe_block``: every row of the batch routes, padding and empty
    decode slots included, against ``moe_capacity(cfg, B·S)`` rows per
    expert, plus the shared experts' MLP when the configuration has
    them. Under an active ``policy`` (``p`` sharded by
    ``shard_params``, ``x`` a ``sharding.model.Rows``), the
    reference's expert-parallel branches (``_moe_mesh``)."""
    if sm.on_mesh(policy):
        return _moe_mesh(cfg, p, x, policy)
    B, S, D = x.shape
    E = cfg.num_experts
    y = _moe_local(x.reshape(B * S, D), p, 0, E, moe_capacity(cfg, B * S),
                   cfg.experts_per_tok, cfg.gated_mlp).reshape(B, S, D)
    if "shared" in p:
        y = y + mlp(cfg, p["shared"], x)
    return y


def _moe_mesh(cfg: ModelConfig, p, x, policy):
    """The reference's two expert-parallel branches of ``moe_block``.

    * default: the n·S tokens, flattened, split into DP contiguous
      chunks of t_loc = n·S / DP (raises unless DP divides n·S, where
      the reference's ``shard_map`` raises); capacity
      ``moe_capacity(cfg, t_loc)``; TP rank t computes experts
      [t·E/TP, (t+1)·E/TP) for its chunk, and the partial sums are
      all-reduced over the TP ranks;
    * ``ep_over_dp`` (when DP > 1 and DP·TP divides E): every position
      sees every token (capacity ``moe_capacity(cfg, n·S)``), position
      (i, t) computes experts [(i·TP + t)·e, ...) of e = E / (DP·TP),
      and the partial sums are all-reduced over every position.

    Under ``dp_over_tp`` the reference's default branch still splits
    the experts over the model axis and the tokens over the data axes
    alone, but takes its capacity from n·S / (DP·TP)
    (``_moe_dp_over_tp``).

    The shared experts' MLP runs tensor-parallel on the rows."""
    if policy.dp_over_tp:
        return _moe_dp_over_tp(cfg, p, x, policy)
    g = sm.mesh_grid(policy)
    E, k, gated = cfg.num_experts, cfg.experts_per_tok, cfg.gated_mlp
    T = x.n * x.grid[0, 0].shape[1]
    locs = sm.local_grid({n: p[n] for n in p if n != "shared"}, g)
    everywhere = (policy.ep_over_dp and g.dp > 1
                  and E % (g.dp * g.tp) == 0)
    if everywhere:
        e_loc = E // (g.dp * g.tp)
        cap = moe_capacity(cfg, T)

        def lo(i, t):
            return (i * g.tp + t) * e_loc
    else:
        if T % g.dp:
            raise ValueError(f"moe_block: {T} tokens do not split over "
                             f"{g.dp} data-parallel ranks")
        if E % g.tp:
            raise ValueError(f"moe_block: {E} experts over tp={g.tp}")
        e_loc = E // g.tp
        cap = moe_capacity(cfg, T // g.dp)

        def lo(i, t):
            return t * e_loc
    xs = sm.token_chunks(x, g, everywhere)
    y = sm.gmap(lambda it, pl, xt: _moe_local(xt, pl, lo(*it), e_loc, cap,
                                              k, gated),
                sm.positions(g), locs, xs)
    y = sm.tokens_to_rows(sm.all_reduce(y, g, "all" if everywhere
                                        else "tp"), x, g, everywhere)
    if "shared" in p:
        y = sm.gmap(torch.add, y, mlp(cfg, p["shared"], x, policy))
    return y


def _moe_dp_over_tp(cfg: ModelConfig, p, x, policy):
    """The reference's default ``shard_map`` branch under ``dp_over_tp``:
    the n·S tokens, flattened, in dp contiguous chunks (dp the data
    axes' size; raises unless it divides n·S), model rank t computing
    experts [t·E/tp, (t+1)·E/tp) of its chunk at capacity
    ``moe_capacity(cfg, n·S / (dp·tp))`` (the reference's ``t_loc``,
    whose ``dp_size`` counts the model axis too), the partial sums
    added over t in rank order. The grid's data rank r = i·tp + t is
    (data rank i, model rank t); every position holds every expert, so
    each computes its (i, t) share on its own device, then takes its
    rows of the sums."""
    g = sm.mesh_grid(policy)
    tp = policy.tp_size()
    dp = g.dp // tp
    E, k, gated = cfg.num_experts, cfg.experts_per_tok, cfg.gated_mlp
    S = x.grid[0, 0].shape[1]
    T = x.n * S
    if T % dp:
        raise ValueError(f"moe_block: {T} tokens do not split over {dp} "
                         f"data-parallel ranks")
    if E % tp:
        raise ValueError(f"moe_block: {E} experts over tp={tp}")
    e_loc, c = E // tp, T // dp
    cap = moe_capacity(cfg, T // g.dp)
    locs = sm.local_grid({n: p[n] for n in p if n != "shared"}, g)
    toks = sm.token_chunks(x, g, everywhere=True)

    def share(it, pl, xt):
        i, t = divmod(it[0], tp)
        lo = t * e_loc
        pw = {n: w if n == "router" else w[lo:lo + e_loc]
              for n, w in pl.items()}
        return _moe_local(xt[i * c:(i + 1) * c], pw, lo, e_loc, cap, k,
                          gated)

    y = sm.gmap(share, sm.positions(g), locs, toks)
    out, made = np.empty(y.shape, dtype=object), {}
    for r, _ in g.coords():
        dev = g.devices[r, 0]
        if str(dev) not in made:
            made[str(dev)] = torch.cat([functools.reduce(torch.add, [
                y[i * tp + t, 0].to(dev) for t in range(tp)])
                for i in range(dp)])
        out[r, 0] = made[str(dev)]
    y = sm.tokens_to_rows(out, x, g, everywhere=True)
    if "shared" in p:
        y = sm.gmap(torch.add, y, mlp(cfg, p["shared"], x, policy))
    return y


def moe_reference(cfg: ModelConfig, p, x):
    """Dense oracle: the exact top-k mixture, no capacity drops, every
    expert over every token (tests only)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gate, ids = top_k(probs, cfg.experts_per_tok)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        h = xt @ p["w_in"][e]
        if cfg.gated_mlp:
            h = F.silu(xt @ p["w_gate"][e]) * h
        else:
            h = F.gelu(h, approximate="tanh")
        w_e = torch.where(ids == e, gate, torch.zeros_like(gate)).sum(-1)
        y = y + (h @ p["w_out"][e]) * w_e[:, None].to(xt.dtype)
    y = y.reshape(B, S, D)
    if "shared" in p:
        y = y + mlp(cfg, p["shared"], x)
    return y


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality, chunked)
# ---------------------------------------------------------------------------


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: (B,S,C), w: (cw,C). The reference's cw
    shifted multiply-adds in its order (tap i multiplies x[t-(cw-1-i)]),
    not a library convolution, whose float32 may run in TF32."""
    cw, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    y = 0
    for i in range(cw):
        y = y + xp[:, i:i + S] * w[i]
    return y + b


def _segsum(a):
    """a: (..., L). Returns (..., L, L) lower-tri cumulative sums:
    out[i,j] = sum(a[j+1..i]) for i>=j, -inf above diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, d, torch.full_like(d, -torch.inf))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD forward (Mamba-2 §6), the plain path. Shapes:
    x: (b,s,h,p), dt: (b,s,h) (post-softplus), A: (h,) negative,
    B,C: (b,s,n) single group. Returns y: (b,s,h,p) and final state
    (b,h,p,n)."""
    b, s, h, p_ = x.shape
    n = B.shape[-1]
    s_orig = s
    if s % chunk != 0:
        # pad with dt=0 steps: decay exp(0·A)=1 and zero input leave the
        # state untouched; padded outputs are sliced away below.
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p_)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    dA = dtc * A  # (b,c,l,h)
    dA_cum = torch.cumsum(dA, dim=2)

    # intra-chunk (diagonal blocks): L = exp(segsum(dA)) per head
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (b,c,h,l,l)
    xdt = xc * dtc[..., None]  # (b,c,l,h,p)
    # mixed operands (bfloat16 weights beside the float32 decays) are
    # promoted first, as the reference's einsums promote them
    ct = torch.promote_types(Cc.dtype, Lmat.dtype)
    cb = Cc.to(ct) @ Bc.to(ct).transpose(-1, -2)  # (b,c,l,s)
    w = cb[:, :, None] * Lmat
    y_diag = torch.einsum("bchls,bcshp->bclhp", w, xdt.to(w.dtype))

    # chunk states: contribution of each chunk to its final state
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b,c,l,h)
    dx = decay_states[..., None] * xdt
    states = torch.einsum("bcln,bclhp->bchpn", Bc.to(dx.dtype), dx)

    # inter-chunk recurrence, carried in float32
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])  # (b,c,h)
    hstate = torch.zeros((b, h, p_, n), dtype=torch.float32,
                         device=x.device)
    prev = []
    for c in range(nc):
        prev.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] \
            + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)  # (b,c,h,p,n)

    # inter-chunk output: state entering the chunk, decayed to each position
    state_decay = torch.exp(dA_cum)  # (b,c,l,h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc.to(prev_states.dtype),
                         prev_states) * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p_)
    return y[:, :s_orig], hstate


def _ssm_split(cfg: ModelConfig, zxbcdt):
    di, ns = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    Bv = zxbcdt[..., 2 * di:2 * di + ns]
    Cv = zxbcdt[..., 2 * di + ns:2 * di + 2 * ns]
    dt = zxbcdt[..., 2 * di + 2 * ns:]
    return z, xs, Bv, Cv, dt


def ssm_block(cfg: ModelConfig, p, x, ssd_impl: str = "auto"):
    """Mamba2 block, full sequence. Returns (out, final_state (B,nh,hd,ns),
    conv_tail (B,cw-1,conv_dim)). ``ssd_impl``: "kernel" (K9 through
    ``kernels/ssd/ops.py::ssd``; raises off the card), "ref" (the plain
    ``ssd_chunked``) or "auto" (the kernel for a CUDA tensor)."""
    B_, S, D = x.shape
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
    hd = cfg.ssm_head_dim
    zxbcdt = _proj(x, p["w_in"])
    z, xs, Bv, Cv, dt = _ssm_split(cfg, zxbcdt)
    conv_in = torch.cat([xs, Bv, Cv], dim=-1)
    conv_out = F.silu(causal_conv1d(conv_in, p["conv_w"], p["conv_b"]))
    xs, Bv, Cv = (conv_out[..., :di], conv_out[..., di:di + ns],
                  conv_out[..., di + ns:])
    dt = F.softplus(dt + p["dt_bias"])  # (b,s,nh)
    A = -torch.exp(p["A_log"].float())  # (nh,)
    xh = xs.reshape(B_, S, nh, hd)  # a strided view of conv_out
    if attn_path(ssd_impl, x) == "kernel":
        y, state = ssd_ops.ssd(xh, dt, A, Bv, Cv, cfg.ssm_chunk,
                               impl="kernel")
    else:
        y, state = ssd_chunked(xh, dt, A, Bv, Cv, cfg.ssm_chunk)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"]).to(x.dtype)
    # the tail of the conv INPUT, which the decode step's window extends
    conv_tail = conv_in[:, -(cfg.ssm_conv_width - 1):, :].to(x.dtype)
    return out, state.to(x.dtype), conv_tail


def ssm_decode(cfg: ModelConfig, p, x, ssm_state, conv_state):
    """Single-step SSM. x: (B,1,D); ssm_state: (B,nh,hd,ns);
    conv_state: (B,cw-1,conv_dim) previous conv inputs. Returns
    (out (B,1,D), new_state, new_conv)."""
    B_ = x.shape[0]
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
    hd = cfg.ssm_head_dim
    zxbcdt = _proj(x, p["w_in"])
    z, xs, Bv, Cv, dt = _ssm_split(cfg, zxbcdt)
    conv_in = torch.cat([xs, Bv, Cv], dim=-1)  # (B,1,conv_dim)
    window = torch.cat([conv_state, conv_in], dim=1)  # (B,cw,conv)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                      + p["conv_b"])
    xs = conv_out[:, :di]
    Bv = conv_out[:, di:di + ns]
    Cv = conv_out[:, di + ns:]
    dt = F.softplus(dt[:, 0] + p["dt_bias"])  # (B,nh)
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B_, nh, hd)
    decay = torch.exp(dt * A)  # (B,nh)
    new_state = (ssm_state.float() * decay[..., None, None]
                 + torch.einsum("bhp,bn->bhpn",
                                xh * dt[..., None].to(xh.dtype), Bv
                                ).float())
    y = torch.einsum("bhpn,bn->bhp", new_state, Cv.float())
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(B_, di).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, 0]), p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"])[:, None, :].to(x.dtype)
    return (out, new_state.to(ssm_state.dtype),
            window[:, 1:, :].to(conv_state.dtype))
