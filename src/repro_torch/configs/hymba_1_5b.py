"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, parallel attn+mamba heads, ssm_state=16, sliding-window
attention. [arXiv:2411.13676; hf]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64,
        d_ff=5504, vocab_size=32001,
        ssm_state=16, ssm_head_dim=64, ssm_expand=2,
        attn_window=2048,
        gated_mlp=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="hymba-tiny", family="hybrid",
        num_layers=2, d_model=64, num_heads=5, num_kv_heads=5, head_dim=16,
        d_ff=128, vocab_size=256,
        ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
        attn_window=16,
        gated_mlp=True,
    )
