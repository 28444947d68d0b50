"""Model configuration for the semantic-serving backends.

One dataclass covers every assigned architecture family:
dense / MoE / SSM / hybrid decoder-only LMs, encoder-decoder (Whisper) and
prefix-LM VLM (PaliGemma). Family-specific fields default to "off".

``tiny()`` derivations (few layers, narrow width, few experts) back the CPU
smoke tests; the full configs are exercised only through the compile-only
dry-run.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # --- MLP style ---
    gated_mlp: bool = True  # SwiGLU; False => GELU 2-matrix MLP
    qkv_bias: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64

    # --- attention details ---
    attn_window: int = 0  # >0: sliding-window attention
    rope_theta: float = 10000.0

    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend frames (post-conv)

    # --- VLM (PaliGemma) ---
    num_image_tokens: int = 0

    # --- multi-token prediction (DeepSeek MTP) ---
    mtp_depth: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def q_group(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM state or bounded-window attention."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.attn_window > 0
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def pad_heads_for_tp(self, tp: int) -> "ModelConfig":
        """Pad head counts so tensor parallelism divides them (DESIGN.md
        §4.4):
        * q heads -> next multiple of tp;
        * kv heads: already divisible -> shard; within 2x of tp -> pad to
          tp and shard (KV-cache memory dominates for decode shapes, so
          sharding beats replication); small kv counts -> next power of
          two (divides any pow2 q-head padding) and replicate over TP."""
        if self.num_heads == 0 or tp <= 1:
            return self
        h = math.ceil(self.num_heads / tp) * tp
        k = self.num_kv_heads
        if k % tp == 0:
            pass  # shardable as-is
        elif 2 * k >= tp:
            k = tp
        else:
            k = 1 << (k - 1).bit_length()  # next power of two, replicated
        if k and h % k != 0:
            h = math.ceil(h / k) * k
        assert h % tp == 0, (h, k, tp)
        return self.replace(num_heads=h, num_kv_heads=k,
                            head_dim=self.resolved_head_dim)

    def pad_vocab(self, multiple: int) -> "ModelConfig":
        """Round the vocabulary up so TP sharding divides it (MaxText
        practice; padding waste shows up in MODEL_FLOPS/HLO ratio)."""
        v = math.ceil(self.vocab_size / multiple) * multiple
        return self.replace(vocab_size=v)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        n = V * D  # embed
        if not self.tie_embeddings:
            n += D * V
        per_layer = 2 * D  # norms
        if self.family != "ssm":
            if self.use_mla:
                qlr, kvlr = self.q_lora_rank, self.kv_lora_rank
                qk = self.qk_nope_head_dim + self.qk_rope_head_dim
                per_layer += D * qlr + qlr * self.num_heads * qk
                per_layer += D * (kvlr + self.qk_rope_head_dim)
                per_layer += kvlr * self.num_heads * (self.qk_nope_head_dim
                                                      + self.v_head_dim)
                per_layer += self.num_heads * self.v_head_dim * D
            elif self.num_heads:
                per_layer += D * self.num_heads * hd  # q
                per_layer += 2 * D * self.num_kv_heads * hd  # k, v
                per_layer += self.num_heads * hd * D  # o
        if self.family in ("ssm", "hybrid"):
            di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_num_heads
            per_layer += D * (2 * di + 2 * ns + nh)  # in_proj (z,x,B,C,dt)
            per_layer += self.ssm_conv_width * (di + 2 * ns)
            per_layer += nh * 2 + di  # A, D, norm
            per_layer += di * D  # out_proj
        if self.num_experts:
            fe = self.moe_d_ff or F
            m = 3 if self.gated_mlp else 2
            per_layer += D * self.num_experts  # router
            per_layer += self.num_experts * m * D * fe
            per_layer += self.num_shared_experts * m * D * fe
        elif F:
            m = 3 if self.gated_mlp else 2
            per_layer += m * D * F
        n += L * per_layer
        if self.encoder_layers:
            # encoder blocks (self-attn + mlp) + decoder cross-attn
            enc = self.encoder_layers * (
                2 * D + 4 * D * self.num_heads * hd
                + (3 if self.gated_mlp else 2) * D * F)
            cross = L * (D + 4 * D * self.num_heads * hd)
            n += enc + cross
        if self.mtp_depth:
            n += self.mtp_depth * (2 * D + 4 * D * self.num_heads * hd
                                   + 2 * D * D)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        fe = self.moe_d_ff or self.d_ff
        m = 3 if self.gated_mlp else 2
        inactive = (self.num_experts - self.experts_per_tok)
        return self.param_count() \
            - self.num_layers * inactive * m * self.d_model * fe
