"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        num_experts=64, experts_per_tok=8, moe_d_ff=1024,
        gated_mlp=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="olmoe-tiny", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=256,
        num_experts=8, experts_per_tok=2, moe_d_ff=96,
        moe_capacity_factor=8.0,  # no drops at smoke scale
        gated_mlp=True,
    )
