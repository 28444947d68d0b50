"""Parameters of the LM of every family: the decoder-only LM (dense,
MoE, SSM and hybrid, and MLA with multi-token prediction), the
encoder-decoder (whisper) and the VLM (paligemma).

``build_axes_params(cfg, creator)`` walks the architecture and calls
``creator(path, shape, axes, scale)`` for each tensor, with the
reference's paths, shapes, logical sharding axes and stacked
``(L, ...)`` layer layout (``src/repro/models/params.py``);
``build_params(cfg, creator)`` calls ``creator(path, shape, scale)``.
The creators of the model-parallel mesh: ``abstract_params`` (meta
tensors), ``param_axes``, ``param_specs`` and ``param_shardings``
(``sharding/policy.py``), and ``shard_params``, which lays a tree out
over the mesh (``sharding/model.py``). Two creators of weights:

* ``init_params(cfg, generator, device)`` — random weights drawn from a
  ``torch.Generator`` at the reference's scales (norm gains 1, biases 0,
  otherwise normal / sqrt(fan_in)); the numbers are not the reference's;
* ``params_from_numpy(tree, device)`` — the reference's own parameters
  (``jax.tree.map(np.asarray, params)``) as tensors, unchanged in
  layout, so both packages compute the same function.

Every family is ported: dense, mixture-of-experts (with or without
shared experts), SSM (Mamba-2), hybrid (parallel attention + SSM
heads), with DeepSeek-V3's latent attention (MLA, an ``"mla"`` subtree
in place of ``"attn"``) and its multi-token-prediction block (the
``"mtp"`` subtree); the encoder-decoder, whose decoder blocks carry a
cross-attention (``ln_x``, ``xattn``) beside an ``"encoder"`` subtree
(dense blocks, ``final_ln``, ``pos_embed``); and the VLM, with its
``img_proj`` adapter over the stub frontend's patch embeddings.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..sharding.model import (
    check_policy,
    dedupe_spec,
    kv_range,
    mesh_grid,
    split,
)
from ..sharding.policy import Placement, ShardingPolicy
from .config import ModelConfig

Creator = Callable[[str, tuple, float], object]
AxesCreator = Callable[[str, tuple, tuple, float], object]


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# the families whose batches carry more than tokens: frames (B, Senc, D)
# beside the encoder-decoder's, patches (B, P, D) beside the VLM's
MULTIMODAL = {"encdec": "frames", "vlm": "patches"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port builds ``cfg``:
    every family of the reference, with sliding windows for the hybrid
    only (its attention heads), an encoder only for the
    encoder-decoder and an image prefix only for the VLM."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")
    if cfg.attn_window and cfg.family != "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: sliding windows are ported for the hybrid "
            f"family only")
    if bool(cfg.encoder_layers) != (cfg.family == "encdec") or \
            bool(cfg.num_image_tokens) != (cfg.family == "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: an encoder belongs to the encoder-decoder and "
            f"an image prefix to the VLM, each to it alone")


def check_tokens_only(cfg: ModelConfig, what: str) -> None:
    """Raise ``NotImplementedError`` for a family whose batches need
    frames or patches beside the tokens: ``what`` (the serving engine,
    ``launch/serve``, ``launch/train``) feeds tokens only, as the
    reference's does (its ``_prepare_inputs`` reads ``batch["frames"]``
    / ``batch["patches"]``, which neither its engine nor its
    ``TokenStream`` supplies). These families run through the model's
    entry points (``forward``, ``forward_loss``, ``prefill``,
    ``decode_step``)."""
    if cfg.family in MULTIMODAL:
        raise NotImplementedError(
            f"{cfg.name}: {what} feeds tokens only, and the {cfg.family} "
            f"family needs {MULTIMODAL[cfg.family]!r} beside them; call "
            f"the model's forward / prefill / decode_step instead")


def _attn_tree(cfg: ModelConfig, L, p, prefix: str):
    D = cfg.d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    t = {
        "wq": p(f"{prefix}/wq", (*L, D, H, hd),
                ("layers", "embed", "heads", None), D),
        "wk": p(f"{prefix}/wk", (*L, D, K, hd),
                ("layers", "embed", "kv_heads", None), D),
        "wv": p(f"{prefix}/wv", (*L, D, K, hd),
                ("layers", "embed", "kv_heads", None), D),
        "wo": p(f"{prefix}/wo", (*L, H, hd, D),
                ("layers", "heads", None, "embed"), H * hd),
    }
    if cfg.qkv_bias:
        t["bq"] = p(f"{prefix}/bq", (*L, H, hd), ("layers", "heads", None), 0)
        t["bk"] = p(f"{prefix}/bk", (*L, K, hd),
                    ("layers", "kv_heads", None), 0)
        t["bv"] = p(f"{prefix}/bv", (*L, K, hd),
                    ("layers", "kv_heads", None), 0)
    return t


def _mla_tree(cfg: ModelConfig, L, p):
    D, H = cfg.d_model, cfg.num_heads
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    qk_n, qk_r, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wdq": p("mla/wdq", (*L, D, qlr), ("layers", "embed", None), D),
        "q_ln": p("mla/q_ln", (*L, qlr), ("layers", None), -1),
        "wuq": p("mla/wuq", (*L, qlr, H, qk_n + qk_r),
                 ("layers", None, "heads", None), qlr),
        "wdkv": p("mla/wdkv", (*L, D, kvlr + qk_r),
                  ("layers", "embed", None), D),
        "kv_ln": p("mla/kv_ln", (*L, kvlr), ("layers", None), -1),
        "wuk": p("mla/wuk", (*L, kvlr, H, qk_n),
                 ("layers", None, "heads", None), kvlr),
        "wuv": p("mla/wuv", (*L, kvlr, H, vh),
                 ("layers", None, "heads", None), kvlr),
        "wo": p("mla/wo", (*L, H, vh, D),
                ("layers", "heads", None, "embed"), H * vh),
    }


def _mlp_tree(cfg: ModelConfig, L, p, d_ff=None, prefix="mlp"):
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    t = {
        "w_in": p(f"{prefix}/w_in", (*L, D, F), ("layers", "embed", "mlp"), D),
        "w_out": p(f"{prefix}/w_out", (*L, F, D),
                   ("layers", "mlp", "embed"), F),
    }
    if cfg.gated_mlp:
        t["w_gate"] = p(f"{prefix}/w_gate", (*L, D, F),
                        ("layers", "embed", "mlp"), D)
    return t


def _moe_tree(cfg: ModelConfig, L, p):
    D, E = cfg.d_model, cfg.num_experts
    Fe = cfg.moe_d_ff or cfg.d_ff
    t = {
        "router": p("moe/router", (*L, D, E), ("layers", "embed", None), D),
        "w_in": p("moe/w_in", (*L, E, D, Fe),
                  ("layers", "expert", "embed", None), D),
        "w_out": p("moe/w_out", (*L, E, Fe, D),
                   ("layers", "expert", None, "embed"), Fe),
    }
    if cfg.gated_mlp:
        t["w_gate"] = p("moe/w_gate", (*L, E, D, Fe),
                        ("layers", "expert", "embed", None), D)
    if cfg.num_shared_experts:
        t["shared"] = _mlp_tree(cfg, L, p, d_ff=Fe * cfg.num_shared_experts,
                                prefix="moe/shared")
    return t


def _ssm_tree(cfg: ModelConfig, L, p):
    D = cfg.d_model
    di = cfg.ssm_d_inner
    ns, nh = cfg.ssm_state, cfg.ssm_num_heads
    cw = cfg.ssm_conv_width
    conv_dim = di + 2 * ns
    return {
        # in_proj emits [z, x, B, C, dt]
        "w_in": p("ssm/w_in", (*L, D, 2 * di + 2 * ns + nh),
                  ("layers", "embed", None), D),
        "conv_w": p("ssm/conv_w", (*L, cw, conv_dim),
                    ("layers", None, None), cw),
        "conv_b": p("ssm/conv_b", (*L, conv_dim), ("layers", None), 0),
        "A_log": p("ssm/A_log", (*L, nh), ("layers", None), -2),
        "D": p("ssm/D", (*L, nh), ("layers", None), -1),
        "dt_bias": p("ssm/dt_bias", (*L, nh), ("layers", None), 0),
        "norm": p("ssm/norm", (*L, di), ("layers", None), -1),
        "w_out": p("ssm/w_out", (*L, di, D), ("layers", None, "embed"), di),
    }


def _block_tree(cfg: ModelConfig, L, p, cross_attn: bool = False) -> dict:
    t = {"ln1": p("ln1", (*L, cfg.d_model), ("layers", None), -1),
         "ln2": p("ln2", (*L, cfg.d_model), ("layers", None), -1)}
    if cfg.family == "ssm":
        t["ssm"] = _ssm_tree(cfg, L, p)
        return t  # no FFN: ln2 exists but feeds nothing
    if cfg.use_mla:
        t["mla"] = _mla_tree(cfg, L, p)
    else:
        t["attn"] = _attn_tree(cfg, L, p, "attn")
    if cfg.family == "hybrid":
        t["ssm"] = _ssm_tree(cfg, L, p)
        t["attn_norm"] = p("attn_norm", (*L, cfg.d_model),
                           ("layers", None), -1)
        t["ssm_norm"] = p("ssm_norm", (*L, cfg.d_model), ("layers", None), -1)
    if cross_attn:  # the encoder-decoder's decoder blocks
        t["ln_x"] = p("ln_x", (*L, cfg.d_model), ("layers", None), -1)
        t["xattn"] = _attn_tree(cfg, L, p, "xattn")
    if cfg.num_experts:
        t["moe"] = _moe_tree(cfg, L, p)
    else:
        t["mlp"] = _mlp_tree(cfg, L, p)
    return t


def build_params(cfg: ModelConfig, creator: Creator) -> dict:
    """The LM's parameter tree, one ``creator(path, shape, scale)`` call
    per leaf."""
    return build_axes_params(
        cfg, lambda path, shape, axes, scale: creator(path, shape, scale))


def build_axes_params(cfg: ModelConfig, creator: AxesCreator) -> dict:
    """The LM's parameter tree, one ``creator(path, shape, axes,
    scale)`` call per leaf, ``axes`` the leaf's logical sharding axes
    (the reference's ``build_params``)."""
    check_supported(cfg)
    p = creator
    D, V = cfg.d_model, cfg.vocab_size
    tree: dict = {
        "embed": p("embed", (V, D), ("vocab", "embed"), D),
        "blocks": _block_tree(cfg, (cfg.num_layers,), p),
        "final_ln": p("final_ln", (D,), (None,), -1),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = p("lm_head", (D, V), ("embed", "vocab"), D)
    if cfg.encoder_layers:
        tree["encoder"] = {
            "blocks": _block_tree(encoder_config(cfg),
                                  (cfg.encoder_layers,), p),
            "final_ln": p("enc_final_ln", (D,), (None,), -1),
            "pos_embed": p("enc_pos", (cfg.encoder_seq, D),
                           (None, "embed"), D),
        }
        # the decoder's blocks, remade with cross-attention (the
        # reference's order of creator calls, so ``count_params`` is
        # its count)
        tree["blocks"] = _block_tree(cfg, (cfg.num_layers,), p,
                                     cross_attn=True)
    if cfg.num_image_tokens:
        # the stub frontend's adapter: projects precomputed patch
        # embeddings
        tree["img_proj"] = p("img_proj", (D, D), ("embed", None), D)
    if cfg.mtp_depth:
        tree["mtp"] = {
            "proj": p("mtp/proj", (2 * D, D), (None, "embed"), 2 * D),
            "blocks": _block_tree(mtp_config(cfg), (cfg.mtp_depth,), p),
            "final_ln": p("mtp_final_ln", (D,), (None,), -1),
        }
    return tree


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The configuration of the encoder's blocks: dense blocks (plain
    attention, the MLP) at the model's widths, as the reference builds
    them."""
    return cfg.replace(family="dense", num_experts=0, use_mla=False)


def mtp_config(cfg: ModelConfig) -> ModelConfig:
    """The configuration of the MTP block: a dense block (plain
    attention at ``num_heads`` x ``d_model // num_heads``, the MLP) at
    the model's widths, as the reference builds it."""
    return cfg.replace(num_experts=0, use_mla=False, family="dense")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random float32 weights from ``generator`` (which must live on
    ``device``) at the reference's scales: norm gains 1, biases 0, the
    SSM's ``A_log`` the log of U[1, 16], other leaves normal /
    sqrt(fan_in)."""
    def make(path, shape, scale):
        if scale == -1:  # norm gains
            return torch.ones(shape, device=device)
        if scale == -2:  # ssm A_log init: A in [1, 16]
            u = torch.rand(shape, generator=generator, device=device)
            return torch.log(u.mul_(15.0).add_(1.0))
        if scale == 0:  # biases
            return torch.zeros(shape, device=device)
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(1.0 / np.sqrt(scale))

    return build_params(cfg, make)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's parameter tree, as numpy arrays, as tensors on
    ``device`` with the same nesting, shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """The tree as ``device="meta"`` tensors: shapes and dtypes, no
    memory (the reference's ``ShapeDtypeStruct`` tree)."""
    return build_params(cfg, lambda path, shape, scale: torch.empty(
        shape, dtype=dtype, device="meta"))


def param_axes(cfg: ModelConfig) -> dict:
    """Each leaf's logical sharding axes."""
    return build_axes_params(cfg, lambda path, shape, axes, scale:
                             tuple(axes))


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    """Each leaf's ``PartitionSpec`` under ``policy``."""
    return build_axes_params(cfg, lambda path, shape, axes, scale:
                             policy.spec(*axes))


def param_shardings(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    """Each leaf's ``Placement`` (mesh and spec) under ``policy``."""
    return build_axes_params(cfg, lambda path, shape, axes, scale:
                             Placement(policy.mesh, policy.spec(*axes)))


def shard_params(cfg: ModelConfig, params: dict,
                 policy: ShardingPolicy, *, consume: bool = False) -> dict:
    """``params`` laid out over ``policy``'s mesh, the counterpart of the
    reference's ``jax.device_put(params, param_shardings(cfg,
    policy))``: every leaf a ``sharding.model.Sharded`` split along
    each mesh axis its spec names (an axis named twice keeps its first
    use: ``dedupe_spec``), each part a copy on its position's device.
    Under tensor parallelism the KV heads follow ``kv_range`` (each
    rank holds the heads its query heads read), and a leaf's FSDP
    (``embed``) dimension is gathered over the data-parallel ranks when
    a layer uses it (``local_grid``). Every family's leaves follow their
    specs: the SSM's FSDP on ``embed`` only (replicated over the
    tensor-parallel ranks), the encoder's ``pos_embed`` FSDP on its
    second dimension, the cross-attention's heads as the
    self-attention's, ``img_proj`` FSDP on its first, a vocabulary that
    does not divide the model axis (whisper's 51865) in chunks of
    ceil(V / tp); MLA's ``wuq``/``wuk``/``wuv`` over ``heads`` on their
    third dimension and ``wo`` on its second, ``wdq``/``wdkv`` FSDP on
    ``embed``, its norms replicated; the MTP block's ``proj`` FSDP on its
    second dimension and its blocks as ``mtp_config``'s dense blocks;
    under ``dp_over_tp`` every leaf is whole at every position. Off a
    mesh the tree comes back as it is.

    With ``consume`` the tree is split leaf by leaf, each leaf taken out
    of ``params`` (whose dicts are left empty) as soon as its parts are
    made, so that a caller holding no other reference to it frees each
    whole leaf then: the whole tree and its parts are never on the card
    together (deepseek-v3-671b at one layer is 54.85 GB in float32, its
    routed experts' ``w_in``, ``w_gate`` and ``w_out`` 15.0 GB each)."""
    if not policy.active:
        return params
    check_policy(policy)
    g = mesh_grid(policy)
    heads_tp = g.tp > 1 and policy.spec("heads")[0] == policy.tp_axis
    fsdp = set(policy.fsdp_axes)

    def kv(t):
        return kv_range(cfg.num_heads, cfg.num_kv_heads, g.tp, t)

    def walk(node: dict, axes: dict) -> dict:
        out = {}
        for k in list(node):
            leaf = node.pop(k) if consume else node[k]
            out[k] = (walk(leaf, axes[k]) if isinstance(leaf, dict)
                      else lay_out(leaf, axes[k]))
            del leaf
        return out

    def lay_out(leaf, axes):
        spec = dedupe_spec(policy.spec(*axes))
        kv_dims = tuple(d for d, a in enumerate(axes)
                        if a == "kv_heads") if heads_tp else ()
        fsdp_dims = tuple(
            d for d, e in enumerate(spec) if g.dp > 1 and e is not None
            and set(e if isinstance(e, tuple) else (e,)) <= fsdp)
        return split(leaf, g, spec, kv, kv_dims, fsdp_dims)

    return walk(params, param_axes(cfg))


def count_params(cfg: ModelConfig) -> int:
    """Elements over every ``creator`` call of ``build_params``: the
    reference's count. For the encoder-decoder that counts the
    decoder's blocks twice, as the reference makes them once without
    cross-attention before it remakes them with it (whisper-small:
    363,998,208, where its tree holds 279,045,120)."""
    total = 0

    def make(path, shape, scale):
        nonlocal total
        total += int(np.prod(shape))

    build_params(cfg, make)
    return total
