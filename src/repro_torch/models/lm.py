"""The LM of every family: decoder-only (dense, MoE, SSM and hybrid,
MLA and multi-token prediction), encoder-decoder (whisper) and VLM
(paligemma): forward, the decode cache, prefill and one-token decode —
the reference's ``src/repro/models/lm.py``, on one device and over a
model-parallel mesh (``policy=``, the reference's sharded ``jit``;
``abstract_cache`` and ``cache_specs`` give the cache's shapes and
specs).

Entry points
------------
forward_loss(cfg, params, batch, remat)            -> scalar loss (training)
forward(cfg, params, batch)                        -> (logits, h)
encode(cfg, params, frames)                        -> encoder output
prefill(cfg, params, batch, max_seq)               -> (logits_last, cache)
decode_step(cfg, params, cache, tokens, pos)       -> (logits, cache)
init_cache / build_cache_spec                      -> the reference's
    layout: (L, B, T, K, hd) K/V plus (L, B, T) ``slot_pos`` (T =
    min(max_seq, attn_window) for the hybrid, a ring at ``pos % T``),
    and for the SSM/hybrid (L, B, nh, hd, ns) ``state`` and
    (L, B, cw-1, conv_dim) ``conv``; an MLA configuration stores only
    the latent: (L, B, T, kv_lora_rank) ``ckv`` and (L, B, T,
    qk_rope_head_dim) ``krope``; the encoder-decoder adds the cross K/V
    (L, B, encoder_seq, K, hd) ``xk`` and ``xv``

``batch`` is ``{"tokens": (B, S) int tensor}``, plus ``"frames"`` (B,
Senc, D) for the encoder-decoder and ``"patches"`` (B, P, D) for the
VLM: the stub frontends' precomputed embeddings, as in the reference.
The VLM's sequence is its P image positions, then the S text
positions, under the prefix-LM mask: its logits cover P + S positions
and its cache holds both, so decode starts at ``pos = P + S``. The
reference's ``lax.scan`` over stacked layers is a Python loop over
the layers of ``params["blocks"]`` (unbound once, so the gradients of
the L layers land in the stacked ``(L, ...)`` leaves in one stack, and
training keeps the reference's leaves); ``decode_step`` updates the
cache in place (the reference returns a new one, which its engine
donates) and returns the same dict. ``attn_impl`` picks the attention
path and ``ssd_impl`` the SSD path of every layer (see ``layers.py``;
MLA has one path, and "kernel" raises on an MLA configuration).

Under an active ``ShardingPolicy`` (``params`` from
``models.params.shard_params``) ``forward``, ``forward_loss``,
``prefill`` and ``decode_step`` run every layer over the mesh's
positions (``sharding/model.py``): the embedding and the logits sharded
over the vocabulary (an all-reduce of the lookups, an all-gather of the
logits), attention in every mode and MLA, the MLP and the mixture of
experts as ``models/layers.py`` shards them, the SSM on each position's
rows (its weights replicated over the tensor-parallel ranks), the
whisper encoder and the VLM's patch projection on each position's
frames or patches (``_prepare_mesh``); the cache is per shard
(``init_cache``; under ``shard_cache_seq`` the K/V, ``slot_pos`` and
latent leaves split over the sequence) and the logits come back whole
on the mesh's first device. ``forward_loss`` over the mesh is the
global loss of the batch, the MTP loss included, and autograd runs
back through every position to the parts of the ``Sharded`` leaves
(``training/train_step.py``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..sharding import model as sm
from ..sharding.policy import ShardingPolicy
from .config import ModelConfig
from .layers import (
    _proj,
    attention_block,
    attention_decode,
    check_mla_impl,
    mla_block,
    mla_decode,
    mlp,
    moe_block,
    rms_norm,
    ssm_block,
    ssm_decode,
)
from .params import check_supported, encoder_config, mtp_config


def _layers(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of the stacked block parameters, each leaf
    unbound along its first axis once (one stack in the backward, where
    ``n`` slices would each build a zero (L, ...) gradient)."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        if isinstance(v, dict):
            parts = _layers(v, n)
        elif isinstance(v, sm.Sharded):
            parts = v.layers(n)
        else:
            parts = torch.unbind(v)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _embed_tokens(params, tokens):
    # a gather whose backward is deterministic on the card, where
    # indexing's accumulating index_put_ adds with atomics
    return F.embedding(tokens.long(), params["embed"])


def _lm_logits(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def _window(cfg: ModelConfig) -> int:
    """The attention window the family runs (only the hybrid has one)."""
    return cfg.attn_window if cfg.family == "hybrid" else 0


def _mix(cfg, bp, x, attn_impl, ssd_impl, mode="causal", prefix=0):
    """One layer's mixer over the full sequence (the reference's
    ``_mixer_train``), its attention under ``mode`` and ``prefix``.
    Returns (out, kv, state, conv_tail): ``kv`` the cache leaves of its
    attention by name (roped ``k`` and ``v``, or MLA's latent ``ckv``
    and ``krope``), the parts a family lacks as None."""
    kv = state = conv = None
    if cfg.use_mla:
        a, ckv, krope = mla_block(cfg, bp["mla"], x)
        kv = {"ckv": ckv, "krope": krope}
    elif cfg.family != "ssm":
        a, k, v = attention_block(cfg, bp["attn"], x, attn_impl,
                                  _window(cfg), mode, prefix)
        kv = {"k": k, "v": v}
    if cfg.family not in ("ssm", "hybrid"):
        return a, kv, state, conv
    s, state, conv = ssm_block(cfg, bp["ssm"], x, ssd_impl)
    if cfg.family == "ssm":
        return s, kv, state, conv
    out = 0.5 * (rms_norm(a, bp["attn_norm"], cfg.norm_eps)
                 + rms_norm(s, bp["ssm_norm"], cfg.norm_eps))
    return out, kv, state, conv


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
    """Write the (B, S, ...) keys, values or MLA latent ``src`` into one
    layer's (B, T, ...) cache ``dst``: at slots ``arange(S)``, or the
    last T positions at ``pos % T`` when S > T (the hybrid's ring)."""
    S, T = src.shape[1], dst.shape[1]
    if S <= T:
        dst[:, :S] = src
        return
    first, slots = _ring_slots(S, T, src.device)
    dst[:, slots] = src[:, first:]


# remat="dots": keep the outputs of matrix products without batch
# dimensions and recompute the rest, the counterpart of the reference's
# ``checkpoint_dots_with_no_batch_dims`` (the projections are ``mm``;
# attention scores and expert products are ``bmm`` and are recomputed)
_SAVE_DOTS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])
REMATS = (None, "full", "dots")


def _cross_kv(p, enc):
    """The cross-attention's keys and values (B, Senc, K, hd) from the
    encoder output ``enc`` (B, Senc, D): bare projections, no bias and
    no rope, as the reference's ``_cross_kv``."""
    return _proj(enc, p["wk"]), _proj(enc, p["wv"])


def _block(cfg, bp, h, attn_impl, ssd_impl, cache=None, l=0,
           mode="causal", prefix=0, enc=None):
    """One layer (the reference's ``_block_train``), its attention under
    ``mode`` and ``prefix``; with ``enc`` (the encoder output) the
    whisper decoder's cross-attention residual between the mixer and
    the FFN. With ``cache`` its roped K/V or MLA latent
    (``_write_kv``), its SSM state and conv tail and its cross K/V are
    written into layer ``l`` of the cache's leaves."""
    mix, kv, state, conv = _mix(
        cfg, bp, rms_norm(h, bp["ln1"], cfg.norm_eps), attn_impl, ssd_impl,
        mode, prefix)
    if cache is not None:
        for name, t in (kv or {}).items():
            _write_kv(cache[name][l], t)
        if state is not None:
            cache["state"][l] = state
            cache["conv"][l] = conv
    h = h + mix
    if enc is not None:
        xk, xv = _cross_kv(bp["xattn"], enc)
        if cache is not None:
            cache["xk"][l] = xk
            cache["xv"][l] = xv
        xa, _, _ = attention_block(
            cfg, bp["xattn"], rms_norm(h, bp["ln_x"], cfg.norm_eps),
            attn_impl, mode="bidir", kv_override=(xk, xv))
        h = h + xa
    f = _ffn(cfg, bp, h)
    if f is not None:
        h = h + f
    return h


def _blocks(cfg, params, h, attn_impl, ssd_impl, cache=None,
            remat: Optional[str] = None, mode="causal", prefix=0,
            enc=None):
    """Every layer over the full sequence (with ``cache``, ``mode``,
    ``prefix`` and ``enc``, see ``_block``). ``remat`` recomputes each
    layer in the backward as the reference's ``_scan_blocks``
    checkpoints its scan body: "full" keeps only the layer's input,
    "dots" also its unbatched matrix products, None keeps
    everything."""
    _check_remat(remat)
    for l, bp in enumerate(_layers(params["blocks"], cfg.num_layers)):
        h = _layer(functools.partial(
            _block, cfg, bp, attn_impl=attn_impl, ssd_impl=ssd_impl,
            cache=cache, l=l, mode=mode, prefix=prefix, enc=enc), h, remat)
    return h


def _check_remat(remat) -> None:
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")


def _layer(fn, h, remat: Optional[str]):
    """``fn(h)``, one layer; under ``remat`` recomputed in the backward
    ("full" keeps only ``h``, "dots" also the unbatched matrix
    products)."""
    if remat is None:
        return fn(h)
    extra = {"context_fn": _SAVE_DOTS} if remat == "dots" else {}
    return checkpoint(fn, h, use_reentrant=False, **extra)


def encode(cfg: ModelConfig, params, frames, attn_impl: str = "auto"):
    """The whisper encoder over the stub frontend's frame embeddings
    (B, Senc, D), Senc <= encoder_seq: the learned positions added, the
    encoder's dense blocks in mode "bidir" (K7 ``causal=False`` on the
    kernel path), then its final norm. Returns (B, Senc, D)."""
    enc = params["encoder"]
    h = frames + enc["pos_embed"][None, :frames.shape[1]]
    ecfg = encoder_config(cfg)
    for bp in _layers(enc["blocks"], cfg.encoder_layers):
        h = _block(ecfg, bp, h, attn_impl, "ref", mode="bidir")
    return rms_norm(h, enc["final_ln"], cfg.norm_eps)


def _prepare_inputs(cfg, params, batch, attn_impl):
    """The reference's ``_prepare_inputs``: (h, mode, prefix, enc). The
    VLM's projected patches go before the token embeddings under the
    prefix-LM mask (``prefix`` = P, the image positions); the
    encoder-decoder's frames go through ``encode`` (``enc``, else
    None)."""
    h = _embed_tokens(params, batch["tokens"])
    mode, prefix, enc = "causal", 0, None
    if cfg.family == "vlm":
        patches = batch["patches"].to(h.dtype)
        h = torch.cat([patches @ params["img_proj"], h], dim=1)
        mode, prefix = "prefix", patches.shape[1]
    if cfg.family == "encdec":
        enc = encode(cfg, params, batch["frames"], attn_impl)
    return h, mode, prefix, enc


def _check(cfg: ModelConfig, attn_impl: str) -> None:
    check_supported(cfg)
    if cfg.use_mla:
        check_mla_impl(attn_impl)


def forward(cfg: ModelConfig, params, batch, attn_impl: str = "auto",
            ssd_impl: str = "auto", *,
            policy: Optional[ShardingPolicy] = None):
    """Full-sequence logits (B, P + S, V) and final hidden states (after
    the final norm); P = 0 but for the VLM's image positions. Under an
    active ``policy`` (``params`` from ``shard_params``) the model runs
    over the mesh (``_forward_mesh``) and both come back whole on the
    mesh's first device."""
    if sm.on_mesh(policy):
        return _forward_mesh(cfg, params, batch, attn_impl, ssd_impl,
                             policy)
    _check(cfg, attn_impl)
    h, mode, prefix, enc = _prepare_inputs(cfg, params, batch, attn_impl)
    h = _blocks(cfg, params, h, attn_impl, ssd_impl, mode=mode,
                prefix=prefix, enc=enc)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _lm_logits(cfg, params, h), h


def forward_loss(cfg: ModelConfig, params, batch,
                 remat: Optional[str] = None, *,
                 policy: Optional[ShardingPolicy] = None):
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S): text
    position t (hidden position P + t, after the VLM's P image
    positions) predicts token t + 1, weighted by ``token != 0``
    (padding), summed in float32 and divided by max(sum of weights,
    1), plus 0.3 times ``_mtp_loss`` when the configuration has an MTP
    block: the reference's ``forward_loss``.

    Attention and the SSD run their plain versions ("ref"): the grouped
    einsum and ``ssd_chunked`` are the reference's own training path
    (its ``forward`` never reaches a Pallas kernel), and the CUDA
    kernels have no backward (their wrappers refuse grad mode).

    Under an active ``policy`` (``params`` from ``shard_params``) the
    model runs over the mesh (``_forward_loss_mesh``) and the loss, one
    scalar on the mesh's first device, is the global one: every data
    rank's weighted nll summed, divided by max(sum of every rank's
    weights, 1)."""
    if sm.on_mesh(policy):
        return _forward_loss_mesh(cfg, params, batch, remat, policy)
    check_supported(cfg)
    tokens = batch["tokens"]
    h, mode, n_img, enc = _prepare_inputs(cfg, params, batch, "ref")
    h = _blocks(cfg, params, h, "ref", "ref", remat=remat, mode=mode,
                prefix=n_img, enc=enc)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = _lm_logits(cfg, params, h)
    S = tokens.shape[1]
    labels = tokens[:, 1:].long()
    loss = _xent(logits[:, n_img:n_img + S - 1], labels,
                 (labels != 0).float())
    if cfg.mtp_depth:
        loss = loss + 0.3 * _mtp_loss(cfg, params, h[:, n_img:], tokens)
    return loss


def _mtp_loss(cfg: ModelConfig, params, h, tokens):
    """DeepSeek-V3 multi-token prediction: ``mtp_depth`` dense blocks
    (``mtp_config``: plain attention, the MLP; no checkpoint of their
    own, as the reference's ``_scan`` takes none) over
    ``[h_t ; embed(token_{t+1})]`` projected to ``d_model`` predict
    token t + 2. ``h``: the model's final-normed hidden states (B, S,
    D)."""
    mtp = params["mtp"]
    S = tokens.shape[1]
    emb_next = _embed_tokens(params, tokens[:, 1:])
    x = torch.cat([h[:, :S - 1], emb_next], dim=-1) @ mtp["proj"]
    mcfg = mtp_config(cfg)
    for bp in _layers(mtp["blocks"], cfg.mtp_depth):
        x = _block(mcfg, bp, x, "ref", "ref")
    x = rms_norm(x, mtp["final_ln"], cfg.norm_eps)
    logits = _lm_logits(cfg, params, x)
    labels = tokens[:, 2:].long()
    return _xent(logits[:, :S - 2], labels, (labels != 0).float())


def _nll(logits, labels, weights):
    """Each position's nll of its label, times its weight (float32)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - ll) * weights


def _xent(logits, labels, weights):
    nll = _nll(logits, labels, weights)
    return torch.sum(nll) / torch.clamp(torch.sum(weights), min=1.0)


def build_cache_spec(cfg: ModelConfig, batch_size: int, max_seq: int
                     ) -> dict:
    """{name: shape} of the decode cache, in the reference's layout."""
    check_supported(cfg)
    L, B = cfg.num_layers, batch_size
    spec = {}
    if cfg.use_mla:
        spec["ckv"] = (L, B, max_seq, cfg.kv_lora_rank)
        spec["krope"] = (L, B, max_seq, cfg.qk_rope_head_dim)
    elif cfg.family != "ssm":
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
    if cfg.family == "encdec":
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        spec["xk"] = (L, B, cfg.encoder_seq, K, hd)
        spec["xv"] = (L, B, cfg.encoder_seq, K, hd)
    return spec


# the reference's logical axes of each cache leaf
CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "slot_pos": ("layers", "batch", "kv_seq"),
    "ckv": ("layers", "batch", "kv_seq", None),
    "krope": ("layers", "batch", "kv_seq", None),
    "state": ("layers", "batch", None, None, None),
    "conv": ("layers", "batch", None, None),
    "xk": ("layers", "batch", None, "kv_heads", None),
    "xv": ("layers", "batch", None, "kv_heads", None),
}


# the leaves whose dimension 3 holds KV heads: a tensor-parallel rank
# holds those its query heads read (``sharding.model.kv_range``), but
# for a leaf split over the sequence (below), which holds every KV head
KV_LEAVES = ("k", "v", "xk", "xv")
# the leaves whose dimension 2 is ``kv_seq``: under ``shard_cache_seq``
# each tensor-parallel rank holds a slice of their positions
SEQ_LEAVES = ("k", "v", "slot_pos", "ckv", "krope")


def abstract_cache(cfg, batch_size, max_seq, dtype=torch.bfloat16) -> dict:
    """The cache as ``device="meta"`` tensors (``slot_pos`` int32)."""
    return {name: torch.empty(shape, dtype=torch.int32 if name == "slot_pos"
                              else dtype, device="meta")
            for name, shape in build_cache_spec(cfg, batch_size,
                                                max_seq).items()}


def cache_specs(cfg, batch_size, max_seq, policy: ShardingPolicy) -> dict:
    """PartitionSpecs per cache leaf; if two logical axes map to the
    same mesh axis (e.g. kv_seq AND kv_heads -> 'model'), the later one
    is dropped, so opting into shard_cache_seq overrides KV-head
    sharding, as in the reference."""
    return {name: sm.dedupe_spec(policy.spec(*CACHE_AXES[name]))
            for name in build_cache_spec(cfg, batch_size, max_seq)}


def init_cache(cfg, batch_size, max_seq, dtype=torch.float32,
               device="cuda", policy: Optional[ShardingPolicy] = None
               ) -> dict:
    """Zero K/V and ``slot_pos`` -1 (empty) on ``device``. Under an
    active ``policy`` every leaf is a ``sharding.model.Sharded`` over
    the mesh (``device`` unused): rows over the data-parallel ranks in
    chunks of ceil(batch_size / DP) (the batch padded to DP chunks,
    as ``Rows`` pads activations), each tensor-parallel rank holding
    the KV heads its query heads read, or under ``shard_cache_seq``
    (``sharding.model.seq_sharded``) the leaves of ``SEQ_LEAVES`` split
    over the sequence, each rank's slice of positions of every KV head
    (``seq_slice``). MLA's latent leaves are replicated over the
    tensor-parallel ranks without the knob: one tensor a device."""
    if sm.on_mesh(policy):
        _check_mesh(cfg, policy)
        g = sm.mesh_grid(policy)
        if not g.replicas:  # every data rank holds the whole batch
            batch_size = -(-batch_size // g.dp) * g.dp
        specs = cache_specs(cfg, batch_size, max_seq, policy)
        heads_tp = g.tp > 1 and policy.spec("heads")[0] == policy.tp_axis
        seq = sm.seq_sharded(policy)

        def kv(t):
            return sm.kv_range(cfg.num_heads, cfg.num_kv_heads, g.tp, t)

        def kv_dims(name):
            on_heads = heads_tp and name in KV_LEAVES
            return (3,) if on_heads and not (seq and name in SEQ_LEAVES) \
                else ()
        return {name: sm.zeros(
            shape, torch.int32 if name == "slot_pos" else dtype, g,
            specs[name], kv, kv_dims(name),
            fill=-1 if name == "slot_pos" else 0)
            for name, shape in build_cache_spec(cfg, batch_size,
                                                max_seq).items()}
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
            ssd_impl: str = "auto", *,
            policy: Optional[ShardingPolicy] = None):
    """Run the full prompt, build the decode cache (length ``max_seq``,
    default the prompt's P + S positions), return the logits of the
    last (padded) position. The hybrid keeps the last ``T =
    min(max_seq, attn_window)`` positions in ring layout (slot ``pos %
    T``); the VLM's cache holds its P image positions before the text;
    the encoder-decoder's ``xk``/``xv`` hold each layer's cross K/V of
    the Senc frames given. Under an active ``policy`` the logits come
    back whole on the mesh's first device and the cache per shard
    (``init_cache``)."""
    if sm.on_mesh(policy):
        return _prefill_mesh(cfg, params, batch, max_seq, attn_impl,
                             ssd_impl, policy)
    _check(cfg, attn_impl)
    h, mode, prefix, enc = _prepare_inputs(cfg, params, batch, attn_impl)
    B, S = h.shape[0], h.shape[1]
    cache = init_cache(cfg, B, max_seq or S, dtype=h.dtype, device=h.device)
    if enc is not None:  # the frames given, as the reference's cache
        for name in ("xk", "xv"):
            cache[name] = cache[name][:, :, :enc.shape[1]]
    h = _blocks(cfg, params, h, attn_impl, ssd_impl, cache=cache, mode=mode,
                prefix=prefix, enc=enc)
    if "slot_pos" in cache:
        first, slots = _ring_slots(S, cache["slot_pos"].shape[2], h.device)
        cache["slot_pos"][:, :, slots] = torch.arange(
            first, S, dtype=torch.int32, device=h.device)
    logits = _lm_logits(cfg, params,
                        rms_norm(h[:, -1:], params["final_ln"],
                                 cfg.norm_eps))
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                attn_impl: str = "auto", *,
                policy: Optional[ShardingPolicy] = None):
    """One decode step. tokens: (B,) int, pos: (B,) int32 absolute
    positions (each < T without a window). Writes the step's K/V (at
    slot ``pos``, or ``pos % window`` for the hybrid) or MLA latent (at
    slot ``pos``) and SSM state and conv tail into ``cache`` in place;
    the encoder-decoder's layers also attend over the cache's cross
    K/V, which stays as prefill wrote it. Returns (logits (B, V),
    cache); under an active ``policy`` the cache is per shard and the
    logits come back whole on the mesh's first device."""
    if sm.on_mesh(policy):
        return _decode_mesh(cfg, params, cache, tokens, pos, attn_impl,
                            policy), cache
    if cfg.use_mla:
        check_mla_impl(attn_impl)
    h = _embed_tokens(params, tokens[:, None])
    window = _window(cfg)
    for l, bp in enumerate(_layers(params["blocks"], cfg.num_layers)):
        x = rms_norm(h, bp["ln1"], cfg.norm_eps)
        if cfg.use_mla:
            a = mla_decode(cfg, bp["mla"], x, cache["ckv"][l],
                           cache["krope"][l], pos)
        elif cfg.family != "ssm":
            a = attention_decode(cfg, bp["attn"], x, cache["k"][l],
                                 cache["v"][l], cache["slot_pos"][l], pos,
                                 attn_impl, window)
        if cfg.family in ("ssm", "hybrid"):
            s, st, cv = ssm_decode(cfg, bp["ssm"], x, cache["state"][l],
                                   cache["conv"][l])
            cache["state"][l] = st
            cache["conv"][l] = cv
        if cfg.family == "ssm":
            mix = s
        elif cfg.family == "hybrid":
            mix = 0.5 * (rms_norm(a, bp["attn_norm"], cfg.norm_eps)
                         + rms_norm(s, bp["ssm_norm"], cfg.norm_eps))
        else:
            mix = a
        h = h + mix
        if cfg.family == "encdec":
            h = h + attention_decode(
                cfg, bp["xattn"], rms_norm(h, bp["ln_x"], cfg.norm_eps),
                cache["xk"][l], cache["xv"][l], None, pos, attn_impl,
                cross=True)
        f = _ffn(cfg, bp, h)
        if f is not None:
            h = h + f
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _lm_logits(cfg, params, h)[:, 0], cache


# ---------------------------------------------------------------------------
# the model over a model-parallel mesh
# ---------------------------------------------------------------------------


def _check_mesh(cfg: ModelConfig, policy: ShardingPolicy) -> None:
    """The families the model-parallel port serves and trains: dense,
    MoE, MLA (with its MTP loss), SSM, hybrid, encoder-decoder and VLM,
    under every policy knob ``sharding.model.check_policy`` admits (the
    hybrid's 25 query heads over 5 KV heads at tp > 1 split in ceil
    chunks, a rank attending in ``head_runs``)."""
    check_supported(cfg)
    sm.check_policy(policy)


def _norm_mesh(cfg, h: "sm.Rows", w: "sm.Sharded", last: bool = False):
    return sm.gmap(lambda hh, ww: rms_norm(hh[:, -1:] if last else hh, ww,
                                           cfg.norm_eps), h, w.parts)


def _embed_mesh(params, toks: "sm.Rows", g) -> "sm.Rows":
    """The vocab-sharded lookup: each tensor-parallel rank embeds the
    tokens of its vocabulary slice (zero elsewhere); the sum over the
    ranks is the embedding."""
    emb = params["embed"]

    def one(it, pl, tk):
        w = pl["embed"]
        ids = tk.long() - (emb.index[it][0].start or 0)
        ok = (ids >= 0) & (ids < w.shape[0])
        h = F.embedding(ids.clamp(0, max(w.shape[0] - 1, 0)), w)
        return torch.where(ok[..., None], h, h.new_zeros(()))

    return sm.all_reduce(sm.gmap(one, sm.positions(g),
                                 sm.local_grid({"embed": emb}, g), toks), g)


def _logit_parts(cfg, params, h: "sm.Rows", g) -> "sm.Rows":
    """Each rank's vocabulary slice of the logits."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    loc = sm.local_grid({name: params[name]}, g)
    return sm.gmap(lambda hh, pl: hh @ (pl[name].T if cfg.tie_embeddings
                                        else pl[name]), h, loc)


def _logits_mesh(cfg, params, h: "sm.Rows", g) -> "sm.Rows":
    """The logits, gathered over the tensor-parallel ranks."""
    return sm.all_gather(_logit_parts(cfg, params, h, g), g, dim=-1)


def _ssm_mesh(cfg, p, x: "sm.Rows", ssd_impl, g):
    """``ssm_block`` on each position's rows (its weights replicated
    over the tensor-parallel ranks, FSDP-gathered at use; positions
    sharing a device share one call): (out Rows, state grid, conv
    grid)."""
    out = sm.gmap(lambda pl, xl: ssm_block(cfg, pl, xl, ssd_impl),
                  sm.local_grid(p, g), x)
    s, state, conv = sm.unzip(out.grid, 3)
    return sm.Rows(s, x.n), state, conv


def _hybrid_mix(cfg, bp, a: "sm.Rows", s: "sm.Rows") -> "sm.Rows":
    """The hybrid's mixer: the mean of the normed attention and SSM
    outputs."""
    return sm.gmap(lambda aa, ss, wa, ws: 0.5 * (
        rms_norm(aa, wa, cfg.norm_eps) + rms_norm(ss, ws, cfg.norm_eps)),
        a, s, bp["attn_norm"].parts, bp["ssm_norm"].parts)


def _seq_span(leaf: "sm.Sharded", i: int, t: int) -> tuple[int, int]:
    """(lo, n): the positions [lo, lo + n) of dimension 2 (``kv_seq``)
    that the part of (i, t) holds."""
    lo, hi, _ = leaf.index[i, t][2].indices(leaf.shape[2])
    return lo, hi - lo


def _slice_slots(S: int, T: int, lo: int, n: int):
    """(slots, positions): the positions of a prefill of S positions into
    a T-slot cache (``_ring_slots``: the last T at slot ``pos % T``)
    whose slots lie in the slice [lo, lo + n), and those slots less lo,
    as host index lists (one contiguous run unless the ring wraps)."""
    first = max(S - T, 0)
    p = np.arange(first, S)
    keep = p[(p % T >= lo) & (p % T < lo + n)]
    return (keep % T - lo).tolist(), keep.tolist()


def _write_parts(leaf: "sm.Sharded", l: int, grid, name: str = "") -> None:
    """Write each position's value of ``grid`` into layer ``l`` of its
    part of the cache leaf, once a distinct part (positions sharing a
    part give the same value): ``_write_kv``'s ring layout for keys and
    values, or, for a leaf of ``SEQ_LEAVES`` split over the sequence,
    the part's slice [lo, lo + n) of that layout (the hybrid's ring
    included)."""
    done = set()
    for (i, t), val in np.ndenumerate(grid):
        part = leaf.parts[i, t]
        if id(part) in done:
            continue
        done.add(id(part))
        lo, n = (_seq_span(leaf, i, t) if name in SEQ_LEAVES
                 else (0, leaf.shape[2]))
        S, T = val.shape[1], leaf.shape[2]
        if (lo, n) == (0, T):
            _write_kv(part[l], val)
        elif S <= T:
            m = min(max(S - lo, 0), n)
            part[l][:, :m] = val[:, lo:lo + m]
        else:
            slots, p = _slice_slots(S, T, lo, n)
            part[l][:, slots] = val[:, p]


def _block_mesh(cfg, bp, h, attn_impl, ssd_impl, policy, cache=None, l=0,
                mode="causal", prefix=0, enc=None):
    """One layer over the mesh, as ``_block``: its mixer (attention,
    the SSM, or the hybrid's mean of both), the encoder-decoder's
    cross-attention over ``enc`` (``Rows`` of the encoder output), the
    FFN but for the SSM family; with ``cache`` each position's keys
    and values, SSM state and conv tail and cross K/V are written into
    its shard of layer l (MLA's latent once a card; under
    ``shard_cache_seq`` every KV head's keys and values, gathered over
    the tensor-parallel ranks, into each rank's slice of positions)."""
    g = sm.mesh_grid(policy)
    x = _norm_mesh(cfg, h, bp["ln1"])
    written = {}
    if cfg.use_mla:
        a, ckv, krope = mla_block(cfg, bp["mla"], x, policy=policy)
        written.update(ckv=ckv, krope=krope)
    elif cfg.family != "ssm":
        a, k, v = attention_block(cfg, bp["attn"], x, attn_impl,
                                  _window(cfg), mode, prefix, policy=policy)
        if cache is not None and sm.seq_sharded(policy):
            pieces = sm.kv_pieces(cfg.num_heads, cfg.num_kv_heads, g.tp)
            k, v = (sm.gather_ranks(a_, g, pieces, dim=2) for a_ in (k, v))
        written.update(k=k, v=v)
    if cfg.family in ("ssm", "hybrid"):
        s, state, conv = _ssm_mesh(cfg, bp["ssm"], x, ssd_impl, g)
        written.update(state=state, conv=conv)
        a = s if cfg.family == "ssm" else _hybrid_mix(cfg, bp, a, s)
    h = sm.gmap(torch.add, h, a)
    if enc is not None:
        kv = sm.gmap(_cross_kv, sm.local_grid(bp["xattn"], g), enc)
        written.update(zip(("xk", "xv"), sm.unzip(kv.grid, 2)))
        xa, _, _ = attention_block(
            cfg, bp["xattn"], _norm_mesh(cfg, h, bp["ln_x"]), attn_impl,
            mode="bidir", kv_override=kv.grid, policy=policy)
        h = sm.gmap(torch.add, h, xa)
    if cache is not None:
        for name, grid in written.items():
            _write_parts(cache[name], l, grid, name)
    if cfg.family == "ssm":
        return h
    x = _norm_mesh(cfg, h, bp["ln2"])
    f = (moe_block(cfg, bp["moe"], x, policy) if cfg.num_experts
         else mlp(cfg, bp["mlp"], x, policy))
    return sm.gmap(torch.add, h, f)


def _blocks_mesh(cfg, blocks, h, attn_impl, ssd_impl, policy, cache=None,
                 remat: Optional[str] = None, mode="causal", prefix=0,
                 enc=None, n_layers: Optional[int] = None):
    """Every layer of the stacked ``blocks`` (``n_layers``, default
    ``cfg.num_layers``) over the mesh (``_block_mesh``). ``remat``
    recomputes each layer in the backward as ``_blocks`` does; the FSDP
    gather at use is inside the layer, so it is recomputed too, as the
    reference's remat recomputes its all-gather."""
    _check_remat(remat)
    for l, bp in enumerate(_layers(blocks, n_layers or cfg.num_layers)):
        h = _layer(functools.partial(
            _block_mesh, cfg, bp, attn_impl=attn_impl, ssd_impl=ssd_impl,
            policy=policy, cache=cache, l=l, mode=mode, prefix=prefix,
            enc=enc), h, remat)
    return h


def _encode_mesh(cfg, params, frames: "sm.Rows", attn_impl, policy,
                 remat: Optional[str] = None):
    """``encode`` over the mesh: each position's frames plus the learned
    positions, the encoder's dense blocks in mode "bidir", its final
    norm."""
    g = sm.mesh_grid(policy)
    enc = params["encoder"]
    h = sm.gmap(lambda fr, pl: fr + pl["pos"][None, :fr.shape[1]], frames,
                sm.local_grid({"pos": enc["pos_embed"]}, g))
    h = _blocks_mesh(encoder_config(cfg), enc["blocks"], h, attn_impl, "ref",
                     policy, remat=remat, mode="bidir",
                     n_layers=cfg.encoder_layers)
    return _norm_mesh(cfg, h, enc["final_ln"])


def _prepare_mesh(cfg, params, batch, attn_impl, policy,
                  remat: Optional[str] = None):
    """``_prepare_inputs`` over the mesh: (h, toks, mode, prefix, enc),
    the token rows ``toks`` and every modality input scattered with
    them (``Rows``); the VLM's patches projected on each position and
    put before its rows' token embeddings; the encoder-decoder's frames
    through ``_encode_mesh``."""
    g = sm.mesh_grid(policy)
    toks = sm.scatter_rows(batch["tokens"], g)
    h = _embed_mesh(params, toks, g)
    mode, prefix, enc = "causal", 0, None
    if cfg.family == "vlm":
        pt = sm.scatter_rows(batch["patches"], g)
        img = sm.gmap(lambda pp, pl, hh: pp.to(hh.dtype) @ pl["w"], pt,
                      sm.local_grid({"w": params["img_proj"]}, g), h)
        h = sm.gmap(lambda a, b: torch.cat([a, b], dim=1), img, h)
        mode, prefix = "prefix", batch["patches"].shape[1]
    if cfg.family == "encdec":
        enc = _encode_mesh(cfg, params, sm.scatter_rows(batch["frames"], g),
                           attn_impl, policy, remat)
    return h, toks, mode, prefix, enc


def _forward_mesh(cfg, params, batch, attn_impl, ssd_impl, policy):
    _check_mesh(cfg, policy)
    g = sm.mesh_grid(policy)
    h, _, mode, prefix, enc = _prepare_mesh(cfg, params, batch, attn_impl,
                                            policy)
    h = _norm_mesh(cfg, _blocks_mesh(cfg, params["blocks"], h, attn_impl,
                                     ssd_impl, policy, mode=mode,
                                     prefix=prefix, enc=enc),
                   params["final_ln"])
    home = sm.home_device(policy)
    return _logits_mesh(cfg, params, h, g).gather(home), h.gather(home)


def _forward_loss_mesh(cfg, params, batch, remat, policy):
    """The global loss over the mesh: each data rank's rows (``Rows``'
    zero padding rows carry label 0, so weight 0; their frames or
    patches are zero too) through every layer on "ref" attention and
    SSD, its logits gathered over the tensor-parallel ranks onto the
    rank's position (i, 0) only, the text positions' weighted nll (the
    VLM's image positions skipped, as the reference's ``forward_loss``
    skips them) and weights summed there; the sums of every rank added
    in rank order on the mesh's first device; plus 0.3 times the MTP
    loss over the mesh (``_mtp_loss_mesh``) when the configuration has
    an MTP block."""
    _check_mesh(cfg, policy)
    g = sm.mesh_grid(policy)
    h, toks, mode, n_img, enc = _prepare_mesh(cfg, params, batch, "ref",
                                              policy, remat)
    h = _norm_mesh(cfg, _blocks_mesh(cfg, params["blocks"], h, "ref", "ref",
                                     policy, remat=remat, mode=mode,
                                     prefix=n_img, enc=enc),
                   params["final_ln"])
    S = batch["tokens"].shape[1]
    loss = _xent_mesh(_logit_parts(cfg, params, h, g), toks, n_img, S - 1,
                      1, policy)
    if cfg.mtp_depth:
        loss = loss + 0.3 * _mtp_loss_mesh(cfg, params, h, toks, n_img, S,
                                           policy)
    return loss


def _xent_mesh(part: "sm.Rows", toks: "sm.Rows", first: int, n: int,
               shift: int, policy) -> torch.Tensor:
    """The global cross-entropy of the logits' positions [first, first +
    n) against the tokens ``shift`` ahead (weight ``token != 0``): each
    data rank's vocabulary parts gathered onto its position (i, 0), its
    weighted nll and weights summed there, the sums of every rank added
    in rank order on the mesh's first device."""
    g = sm.mesh_grid(policy)
    home = sm.home_device(policy)
    num = den = None
    for i in range(1 if g.replicas else g.dp):  # replicas: one batch
        dev = g.devices[i, 0]
        logits = torch.cat([part.grid[i, u].to(dev) for u in range(g.tp)],
                           dim=-1)
        labels = toks.grid[i, 0][:, shift:].long()
        w = (labels != 0).float()
        n_i = torch.sum(_nll(logits[:, first:first + n], labels,
                             w)).to(home)
        d_i = torch.sum(w).to(home)
        num, den = (n_i, d_i) if num is None else (num + n_i, den + d_i)
    return num / torch.clamp(den, min=1.0)


def _mtp_loss_mesh(cfg, params, h: "sm.Rows", toks: "sm.Rows", n_img: int,
                   S: int, policy) -> torch.Tensor:
    """``_mtp_loss`` over the mesh (the reference's ``_mtp_loss`` under
    its policy): the next tokens' embeddings through the vocab-sharded
    lookup, ``[h_t ; emb_{t+1}] · proj`` on each position (``proj``
    FSDP-gathered), the MTP blocks through ``_block_mesh`` at
    ``mtp_config`` (no checkpoint of their own, as on one device), the
    final norm, the vocabulary parts of the logits and the global
    cross-entropy of token t + 2."""
    g = sm.mesh_grid(policy)
    mtp = params["mtp"]
    emb = _embed_mesh(params, sm.gmap(lambda tk: tk[:, 1:], toks), g)
    x = sm.gmap(lambda hh, ee, pl: torch.cat(
        [hh[:, n_img:n_img + S - 1], ee], dim=-1) @ pl["proj"], h, emb,
        sm.local_grid({"proj": mtp["proj"]}, g))
    x = _blocks_mesh(mtp_config(cfg), mtp["blocks"], x, "ref", "ref",
                     policy, n_layers=cfg.mtp_depth)
    x = _norm_mesh(cfg, x, mtp["final_ln"])
    return _xent_mesh(_logit_parts(cfg, params, x, g), toks, 0, S - 2, 2,
                      policy)


def _prefill_mesh(cfg, params, batch, max_seq, attn_impl, ssd_impl, policy):
    _check_mesh(cfg, policy)
    g = sm.mesh_grid(policy)
    h, _, mode, prefix, enc = _prepare_mesh(cfg, params, batch, attn_impl,
                                            policy)
    B, S = batch["tokens"].shape[0], h.grid[0, 0].shape[1]
    ccfg = cfg  # the cross K/V hold the frames given, as on one device
    if enc is not None:
        ccfg = cfg.replace(encoder_seq=batch["frames"].shape[1])
    cache = init_cache(ccfg, B, max_seq or S, dtype=h.grid[0, 0].dtype,
                       policy=policy)
    h = _blocks_mesh(cfg, params["blocks"], h, attn_impl, ssd_impl, policy,
                     cache, mode=mode, prefix=prefix, enc=enc)
    if "slot_pos" in cache:
        _write_slot_pos(cache["slot_pos"], S)
    h = _norm_mesh(cfg, h, params["final_ln"], last=True)
    logits = _logits_mesh(cfg, params, h, g).gather(sm.home_device(policy))
    return logits[:, 0], cache


def _write_slot_pos(leaf: "sm.Sharded", S: int) -> None:
    """Each distinct part of ``slot_pos`` after a prefill of S
    positions: ``_ring_slots``' positions over the whole sequence, or
    those of them whose slots lie in the part's slice [lo, lo + n)."""
    done = set()
    for (i, t), part in np.ndenumerate(leaf.parts):
        if id(part) in done:
            continue
        done.add(id(part))
        lo, n = _seq_span(leaf, i, t)
        T = leaf.shape[2]
        if (lo, n) == (0, T):
            first, slots = _ring_slots(S, n, part.device)
            part[:, :, slots] = torch.arange(first, S, dtype=torch.int32,
                                             device=part.device)
        elif S <= T:
            if S > lo:
                part[:, :, :min(S - lo, n)] = torch.arange(
                    lo, min(S, lo + n), dtype=torch.int32,
                    device=part.device)
        else:
            slots, p = _slice_slots(S, T, lo, n)
            part[:, :, slots] = torch.tensor(p, dtype=torch.int32,
                                             device=part.device)


def _decode_mesh(cfg, params, cache, tokens, pos, attn_impl, policy):
    """``decode_step`` over the mesh: each position's rows through every
    layer with its shard of the cache (its keys and values or MLA's
    latent, the hybrid's ring, its SSM state and conv tail updated in
    place, its cross K/V read)."""
    _check_mesh(cfg, policy)
    g = sm.mesh_grid(policy)
    L = cfg.num_layers
    h = _embed_mesh(params, sm.scatter_rows(tokens[:, None], g), g)
    posr = sm.scatter_rows(pos, g)
    layers = {n: [c.parts for c in leaf.layers(L)]
              for n, leaf in cache.items()}
    window = _window(cfg)
    for l, bp in enumerate(_layers(params["blocks"], L)):
        x = _norm_mesh(cfg, h, bp["ln1"])
        if cfg.use_mla:
            a = mla_decode(cfg, bp["mla"], x, layers["ckv"][l],
                           layers["krope"][l], posr, policy=policy)
        elif cfg.family != "ssm":
            a = attention_decode(cfg, bp["attn"], x, layers["k"][l],
                                 layers["v"][l], layers["slot_pos"][l], posr,
                                 attn_impl, window, policy=policy)
        if cfg.family in ("ssm", "hybrid"):
            out = sm.gmap(lambda pl, xl, st, cv: ssm_decode(cfg, pl, xl, st,
                                                            cv),
                          sm.local_grid(bp["ssm"], g), x,
                          layers["state"][l], layers["conv"][l])
            s, st, cv = sm.unzip(out.grid, 3)
            for name, new in (("state", st), ("conv", cv)):
                for (i, t), part in np.ndenumerate(layers[name][l]):
                    part.copy_(new[i, t])
            s = sm.Rows(s, x.n)
            a = s if cfg.family == "ssm" else _hybrid_mix(cfg, bp, a, s)
        h = sm.gmap(torch.add, h, a)
        if cfg.family == "encdec":
            h = sm.gmap(torch.add, h, attention_decode(
                cfg, bp["xattn"], _norm_mesh(cfg, h, bp["ln_x"]),
                layers["xk"][l], layers["xv"][l], None, posr, attn_impl,
                cross=True, policy=policy))
        if cfg.family != "ssm":
            x = _norm_mesh(cfg, h, bp["ln2"])
            f = (moe_block(cfg, bp["moe"], x, policy) if cfg.num_experts
                 else mlp(cfg, bp["mlp"], x, policy))
            h = sm.gmap(torch.add, h, f)
    h = _norm_mesh(cfg, h, params["final_ln"])
    return _logits_mesh(cfg, params, h, g).gather(
        sm.home_device(policy))[:, 0]
