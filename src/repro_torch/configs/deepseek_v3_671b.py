"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 vocab=129280,
MoE 1 shared + 256 routed top-8, MLA, MTP. [arXiv:2412.19437; hf]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=2048, vocab_size=129280,
        num_experts=256, experts_per_tok=8, num_shared_experts=1,
        moe_d_ff=2048,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        mtp_depth=1,
        gated_mlp=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="deepseek-tiny", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=256,
        num_experts=8, experts_per_tok=2, num_shared_experts=1,
        moe_d_ff=96, moe_capacity_factor=8.0,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        mtp_depth=1,
        gated_mlp=True,
    )
